"""The experiment generator: the same seed gives the same files, another
seed the same work in another order."""

import hashlib
import json
import os

import numpy as np

from benchmark import spec

from .conftest import REPO, TINY

def gen():
    return spec.module(spec.bench_dir(REPO), "generators", "tiff_experiment")


def digests(folder):
    out = {}
    for d, _, names in os.walk(folder):
        for n in names:
            if n != "manifest.json":
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), folder)] = \
                        hashlib.sha256(f.read()).hexdigest()
    return out


def test_same_seed_same_files(tmp_path):
    a = gen().generate(TINY["params"], 2**31 + 99, str(tmp_path / "a"))
    b = gen().generate(TINY["params"], 2**31 + 99, str(tmp_path / "b"))
    assert a["rois"] == b["rois"]
    assert digests(tmp_path / "a") == digests(tmp_path / "b")
    c = gen().generate(TINY["params"], 7, str(tmp_path / "c"))
    assert digests(tmp_path / "a") != digests(tmp_path / "c")


def test_every_seed_draws_the_same_outlines(tmp_path):
    """The multiset of (radius, vertices) per stage does not depend on the
    seed; the files decode to u16 frames of the stated shape."""
    from PIL import Image

    sizes = []
    for seed in (1, 2, -5):
        m = gen().generate(TINY["params"], seed, str(tmp_path / str(seed)))
        sizes.append(sorted(len(p) for p in m["rois"]["S01"]))
        with Image.open(tmp_path / str(seed) / "S02_3.TIF") as im:
            arr = np.array(im)
        assert arr.dtype == np.uint16 and arr.shape == (160, 224)
        with open(tmp_path / str(seed) / "roi" / "S01.json") as f:
            assert json.load(f)["rois"] == m["rois"]["S01"]
    assert sizes[0] == sizes[1] == sizes[2]
    # vertices on the 1/16 px lattice, inside the frame
    pts = np.array([v for p in m["rois"]["S03"] for v in p])
    assert np.all(pts * 16 == np.round(pts * 16))
    assert pts[:, 0].min() >= 0 and pts[:, 0].max() <= 223
    assert pts[:, 1].min() >= 0 and pts[:, 1].max() <= 159


def test_ensure_writes_anew_into_one_folder(tmp_path):
    """Every run writes its experiment again, over the last one, so that
    set-up does the same work whatever ran before it."""
    g = gen()
    m1 = g.ensure(TINY["params"], 3, str(tmp_path))
    first = digests(m1["folder"])
    stale = os.path.join(m1["folder"], "stale.txt")
    open(stale, "w").close()
    m2 = g.ensure(TINY["params"], 3, str(tmp_path))
    assert m2["folder"] == m1["folder"] and not os.path.exists(stale)
    assert digests(m2["folder"]) == first
    m3 = g.ensure(TINY["params"], 4, str(tmp_path))
    assert m3["folder"] == m1["folder"] and m3["seed"] == 4
    assert digests(m3["folder"]) != first
    assert os.listdir(tmp_path) == [os.path.basename(m1["folder"])]
