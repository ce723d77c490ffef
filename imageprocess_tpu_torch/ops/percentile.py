"""Exact ``np.percentile`` positions in int32 arithmetic.

Port of ``imageprocess_tpu/ops/percentile.py``.  The int32 derivation is
kept as it is (not widened to int64) so (k, g) are bit-equal with the JAX
function for every n, and with the same arithmetic in the CUDA kernels
(``kernels/tilestats_u16.cu``, ``kernels/roistats_f32.cu``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def p1000_of(p: float) -> int:
    """Host-side: encode a percentile as integer thousandths."""
    return int(round(float(p) * 1000))


def exact_quantile_pos(n, p1000) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, g) with k = floor((n-1)*p1000/100000) and g the exact fractional
    remainder in [0, 1) as float32, for ANY int32 *n* (a tensor) and
    p1000 <= 100000 (an int or an int32 tensor broadcasting against n).

    Write n-1 = q*100000 + r and r = r1*1000 + r0; then
    k = q*p1000 + C//100 and remainder = (C % 100)*1000 + B % 1000 with
    B = r0*p1000 and C = r1*p1000 + B//1000.  Every intermediate is below
    2^31 (B ~ 1e8, C ~ 1e7, q*p1000 < 2^31), and all operands are
    non-negative, so floor division equals the JAX version's.
    """
    nm1 = torch.clamp(torch.as_tensor(n) - 1, min=0).to(torch.int32)
    q = nm1 // 100000
    r = nm1 % 100000
    r1 = r // 1000
    r0 = r % 1000
    b = r0 * p1000
    c = r1 * p1000 + b // 1000
    k = q * p1000 + c // 100
    rem = (c % 100) * 1000 + b % 1000
    # a tensor divisor, not a Python scalar: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal, which can differ from the
    # correctly rounded quotient (the JAX function's and the kernels') by
    # one bit
    g = rem.to(torch.float32) / torch.tensor(100000.0, device=rem.device)
    return k, g


def quantile_from_sorted(xs: torch.Tensor, n, p1000: int) -> torch.Tensor:
    """Linear-interpolated quantile of the first *n* entries of ascending
    *xs* along its last axis (invalid entries sorted to the end).  *n*
    broadcasts against ``xs.shape[:-1]``; NaN where n == 0."""
    n = torch.as_tensor(n, dtype=torch.int32, device=xs.device)
    k, g = exact_quantile_pos(n, p1000)
    last = xs.shape[-1] - 1
    k = torch.clamp(k, 0, last)
    k1 = torch.clamp(k + 1, 0, last)
    k1 = torch.where(k + 1 <= n - 1, k1, k)  # don't read past the valid range
    shape = xs.shape[:-1]
    lo = torch.gather(xs, -1, k.to(torch.int64).expand(shape)[..., None])[..., 0]
    hi = torch.gather(xs, -1, k1.to(torch.int64).expand(shape)[..., None])[..., 0]
    val = lo + g * (hi - lo)
    return torch.where(n > 0, val, torch.full_like(val, float("nan")))


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, p1000: int) -> torch.Tensor:
    """Quantile of x[mask] (flattened row-major), NaN-free inputs assumed."""
    flat = torch.where(mask, x, torch.full_like(x, float("inf"))).reshape(-1)
    xs = torch.sort(flat).values
    n = mask.sum(dtype=torch.int32)
    return quantile_from_sorted(xs, n, p1000)


def strided_submask(mask: torch.Tensor, stride: int) -> torch.Tensor:
    """Every *stride*-th True pixel of *mask* in row-major order (the i-th
    True pixel survives iff i % stride == 0): the reference's
    ``vals[::stride]`` after mask scoping, without a ragged gather."""
    if stride <= 1:
        return mask
    flat = mask.reshape(-1)
    order = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32) - 1
    return (flat & (order % stride == 0)).reshape(mask.shape)
