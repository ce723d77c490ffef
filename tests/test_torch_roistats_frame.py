"""Port parity: the frame form of the float per-ROI statistics
(``ops.roi_stats_kernel.roi_frame_rows`` / ``roi_frame_rows_plain`` behind
``ops.roistats.roi_stats_full``) against the JAX package's ``roi_stats`` of
full-frame masks on the CPU, and the frame kernel against its plain version
on a card.

Bars, and why:
- npx, area, vmin, vmax and the quantiles bit-equal against JAX: the same
  operations on the same values, run eagerly (as
  ``test_torch_background.test_roi_stats_full_matches_jax``);
- mean, std and vsum within 1e-5 relative: the sums run in another order
  (JAX's reduction, the plain version's over (N, C, H*W), the kernel's per
  thread, CTA and cluster rank);
- the unpadded plain route against the padded tile route (the route
  ``roi_stats_full`` took before the frame form): the exact fields bit-equal,
  the moments within 1e-5 relative, because zero padding changes how the
  CPU's vectorised sums group the values.
The cases are ``chip_smoke.frame_cases``, which the card's smoke run also
checks.  JAX is imported inside the CPU tests only, so the ``cuda`` tests,
which skip here, run on a card without it.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from imageprocess_tpu_torch.ops import roi_stats_kernel as rsk
from imageprocess_tpu_torch.ops import roistats as trs
from imageprocess_tpu_torch.ops.stats import STAT_FIELDS

EXACT = ("npx", "vmin", "vmax", "median", "p5", "p95")
ROW_EXACT = [STAT_FIELDS.index(f) for f in EXACT]
ROW_MOMENTS = [STAT_FIELDS.index(f) for f in ("mean", "std", "vsum")]
M_RTOL = 1e-5

# the CPU cases, once each (the kernel options do not change the plain rows)
CASES = {}
for _name, _frames, _masks, _opts, _moments in chip_smoke.frame_cases(bench=False):
    if not _opts:
        CASES[_name] = (_frames, _masks, bool(_moments))


def _padded_rows(frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """The route before the frame form: the frame and the masks zero-padded
    to one S x S tile, S = max(H, W), through the tile form's plain
    version."""
    C, H, W = frames.shape
    N, S = masks.shape[0], max(H, W)
    frame = frames.new_zeros((1, C, S, S))
    frame[0, :, :H, :W] = frames
    padded = masks.new_zeros((N, S, S))
    padded[:, :H, :W] = masks
    return rsk.roi_stat_rows_plain(frame, padded, torch.zeros((N, 3), dtype=torch.int32))


def _assert_rows(got: torch.Tensor, want: torch.Tensor, moments: bool, what: str):
    g, w = got.double().numpy(), want.double().numpy()
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    ok = ~np.isnan(w)
    ge, we = g[..., ROW_EXACT], w[..., ROW_EXACT]
    np.testing.assert_array_equal(ge[ok[..., ROW_EXACT]], we[ok[..., ROW_EXACT]],
                                  err_msg=what)
    if moments:
        gm, wm = g[..., ROW_MOMENTS], w[..., ROW_MOMENTS]
        okm = ok[..., ROW_MOMENTS]
        np.testing.assert_allclose(gm[okm], wm[okm], rtol=M_RTOL, atol=0, err_msg=what)


# XLA's CPU code flushes subnormal operands to zero, so a quantile
# interpolated between subnormal keys comes back 0 from JAX; the port keeps
# them, as numpy does.  That case is held to the plain version on the card.
JAX_CASES = sorted(c for c in CASES if "subnormals" not in c)


@pytest.mark.parametrize("case", JAX_CASES)
def test_frame_plain_matches_jax_roi_stats(case):
    """``roi_frame_rows_plain`` and ``roi_stats_full(device="cpu")`` against
    the JAX package's ``roi_stats`` on the same numpy inputs: non-square
    frames both ways, W not a multiple of 4, NaN and +-inf pixels, empty,
    sparse and full masks side by side, all-equal values, ties and signed
    zeros, n = 0, 1 and 2 and bin-edge ranks."""
    import jax.numpy as jnp

    from imageprocess_tpu.ops.stats import roi_stats

    frames, masks, moments = CASES[case]
    rows = rsk.roi_frame_rows_plain(torch.from_numpy(frames), torch.from_numpy(masks))
    assert rows.shape == (masks.shape[0], frames.shape[0], 9)
    stats, area = trs.roi_stats_full(torch.from_numpy(frames), torch.from_numpy(masks))
    np.testing.assert_array_equal(area.numpy(), masks.sum((1, 2)))
    js = roi_stats(jnp.asarray(frames), jnp.asarray(masks))
    want = torch.stack([torch.from_numpy(np.array(js[f], np.float32)).T
                        for f in STAT_FIELDS], -1)                 # (N, C, 9)
    _assert_rows(rows, want, moments, case)
    for k, f in enumerate(STAT_FIELDS):  # roi_stats_full hands the same rows on
        a = stats[f].T.to(torch.float32)
        torch.testing.assert_close(a, rows[..., k], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unpadded_plain_route_equals_padded_route(case):
    """The frame form's plain version on the unpadded frame against the
    tile form's plain version on the S x S zero-padded frame: the exact
    fields bit-equal, the moments within 1e-5 relative."""
    frames, masks, moments = CASES[case]
    fr, mk = torch.from_numpy(frames), torch.from_numpy(masks)
    _assert_rows(rsk.roi_frame_rows_plain(fr, mk), _padded_rows(fr, mk), moments, case)


def test_roi_stats_full_on_cpu_takes_the_unpadded_plain_version(monkeypatch):
    """On CPU tensors ``roi_stats_full`` runs ``roi_frame_rows_plain``: it
    neither pads to the tile form nor reaches a kernel wrapper."""
    frames, masks, _ = CASES["mixed masks H=40 W=130"]

    def refuse(*_a, **_k):
        raise AssertionError("roi_stats_full left the frame form's plain version")

    for name in ("roi_stat_rows", "roi_stat_rows_plain", "roi_frame_rows"):
        monkeypatch.setattr(rsk, name, refuse)
    before = dict(rsk.launches)
    stats, area = trs.roi_stats_full(torch.from_numpy(frames), torch.from_numpy(masks))
    assert stats["npx"].shape == (frames.shape[0], masks.shape[0])
    assert rsk.launches == before


def test_frame_wrapper_refuses_cpu_tensors_and_bad_inputs():
    """On CPU tensors the frame kernel's entry raises (it never runs the
    plain version quietly); malformed inputs raise before any launch."""
    frames, masks, _ = CASES["mixed masks H=64 W=128"]
    fr, mk = torch.from_numpy(frames), torch.from_numpy(masks)
    before = dict(rsk.launches)
    with pytest.raises(ValueError, match="CUDA"):
        rsk.roi_frame_rows(fr, mk)
    with pytest.raises(ValueError, match="CUDA"):
        trs.roi_frame_rows(fr.to("meta"), mk.to("meta"))
    with pytest.raises(ValueError, match=r"\(C, H, W\)"):
        rsk.roi_frame_rows_plain(fr[None], mk)
    with pytest.raises(ValueError, match="same"):
        rsk.roi_frame_rows_plain(fr, mk[:, :-1])
    with pytest.raises(ValueError, match="float32"):
        rsk.roi_frame_rows_plain(fr.double(), mk)
    with pytest.raises(ValueError, match="bool"):
        rsk.roi_frame_rows_plain(fr, mk.to(torch.uint8))
    with pytest.raises(ValueError, match="empty"):
        rsk.roi_frame_rows_plain(fr[:, :0], mk[:, :0])
    assert rsk.launches == before


@pytest.mark.parametrize("lanes, H, sms, max_cluster, want", [
    (2, 1536, 132, 16, 16),    # the whole-frame ROI 0 of two channels
    (2, 1536, 132, 8, 8),      # a card without non-portable clusters
    (48, 1536, 132, 16, 2),    # roi_union: 24 lanes x 2 channels
    (15, 64, 132, 16, 8),
    (1, 3, 132, 16, 2),        # no band of less than one row
    (1, 1, 132, 16, 1),
    (200, 1536, 132, 16, 1),   # more lanes than SMs
])
def test_frame_cluster_fills_one_wave(lanes, H, sms, max_cluster, want):
    g = rsk.frame_cluster(lanes, H, sms, max_cluster)
    assert g == want
    assert g & (g - 1) == 0 and (g == 1 or lanes * g <= sms)


# ------------------------------------------------------------------ on a card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


BENCH_CASE = "bench frame: full, 18 circles, one circle, empty"
CARD_CASES = [name for name, *_ in chip_smoke.frame_cases(bench=False)] + [BENCH_CASE]


@functools.lru_cache(maxsize=1)
def frame_cases():
    """The card's cases by name, the bench frame among them (made on first
    use, not when the module is imported)."""
    return {name: (frames, masks, opts, moments)
            for name, frames, masks, opts, moments in chip_smoke.frame_cases()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_cuda_frame_kernel_matches_plain(cuda_device, case):
    """On a card: the frame kernel against its plain version on the same
    device tensors -- every ``frame_cases`` case, among them the radix edge
    cases (+-0, n = 1 and 2, one valid pixel in the last row of the last
    band), an H that does not divide into the bands, overflowing lists and
    the bench frame -- two launches bit-equal."""
    frames, masks, opts, moments = frame_cases()[case]
    fr, mk = (torch.from_numpy(a).to(cuda_device) for a in (frames, masks))
    before = dict(rsk.launches)
    got = rsk.roi_frame_rows(fr, mk, **opts)
    again = rsk.roi_frame_rows(fr, mk, **opts)
    assert rsk.launches["roistats_f32_frame"] == before["roistats_f32_frame"] + 2
    assert rsk.launches["roistats_f32"] == before["roistats_f32"]
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _assert_rows(got.cpu(), rsk.roi_frame_rows_plain(fr, mk).cpu(), bool(moments), case)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cuda_frame_kernel_every_cluster_size(cuda_device, cluster):
    """On a card: the radix edge cases and a frame of 151 rows give the plain
    version's rows at every cluster size the card holds."""
    gmax = rsk.frame_props(cuda_device)[1]
    if cluster > gmax:
        pytest.skip(f"the card holds clusters of at most {gmax}")
    for case in ("n=0,1,2, bin-edge ranks, the last row of the last band",
                 "H=151 over 16 bands", "mixed masks H=97 W=53"):
        frames, masks, _, _ = frame_cases()[case]
        fr, mk = (torch.from_numpy(a).to(cuda_device) for a in (frames, masks))
        got = rsk.roi_frame_rows(fr, mk, cluster=cluster)
        _assert_rows(got.cpu(), rsk.roi_frame_rows_plain(fr, mk).cpu(), True,
                     f"{case} cluster={cluster}")


@pytest.mark.cuda
def test_cuda_roi_stats_full_launches_the_frame_form(cuda_device):
    """On a card: ``roi_stats_full`` launches the frame kernel once and the
    tile kernel never, and its rows equal the old padded route's exact
    fields (the tile kernel on the S x S frame)."""
    frames, masks, _, _ = frame_cases()[BENCH_CASE]
    fr, mk = (torch.from_numpy(a).to(cuda_device) for a in (frames, masks))
    rsk.reset_launches()
    stats, area = trs.roi_stats_full(fr, mk)
    assert rsk.launches == {"roistats_f32": 0, "roistats_f32_frame": 1}
    rows = torch.stack([stats[f].T.to(torch.float32) for f in STAT_FIELDS], -1)
    C, H, W = fr.shape
    S = max(H, W)
    frame = fr.new_zeros((1, C, S, S))
    frame[0, :, :H, :W] = fr
    padded = mk.new_zeros((mk.shape[0], S, S))
    padded[:, :H, :W] = mk
    old = rsk.roi_stat_rows(frame, padded,
                            torch.zeros((mk.shape[0], 3), dtype=torch.int32,
                                        device=cuda_device))
    _assert_rows(rows.cpu(), old.cpu(), True, "frame form vs the padded tile route")
    assert torch.equal(area.cpu(), mk.sum(dim=(1, 2), dtype=torch.int32).cpu())
