"""Model FLOP utilisation of the segmentation network: the network's
operations in the traced calls (``work.tables_work``'s ops: the tokens of
every tile the reference forwards x the configuration's ``ops_per_px``,
FLOPs a token) over the traced wall x the card's dense bf16 peak
(``peaks_tensor.json``, by ``torch.cuda.get_device_name()``).  Nothing to
read without a card whose peak the file holds."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "peaks_tensor.json")


def read(rec):
    import torch

    ops = (rec.get("work") or {}).get("ops")
    if not ops or not rec.get("calls") or not torch.cuda.is_available():
        return None
    with open(PEAKS, encoding="utf-8") as f:
        pk = json.load(f).get(torch.cuda.get_device_name())
    if not pk:
        return None
    return 100.0 * ops * rec["calls"] / (rec["traced_s"] * pk["bf16_dense_flops_per_s"])
