"""The segmentation U-Net, its training and checkpoints (port of
``imageprocess_tpu.models``), and Cellpose-SAM.

``unet``: the U-Net emitting a cell-probability map and two flow maps;
``train``: the AdamW training step, data-parallel over a device mesh;
``synthcells`` and ``golden``: training arrays from synthetic and
annotated frames; ``checkpoint``: flax-layout persistence, and Cellpose
state dicts; ``cpsam``: Cellpose-SAM, Cellpose 4's ViT-L network
(``roi-auto --backend cpsam``)."""

from .unet import UNet  # noqa: F401
from .train import (  # noqa: F401
    TrainConfig,
    create_train_state,
    make_sharded_train_step,
    train_step,
)
