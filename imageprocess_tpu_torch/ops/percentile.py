"""Exact ``np.percentile`` positions in int32 arithmetic.

Port of ``imageprocess_tpu/ops/percentile.py``.  The int32 derivation is
kept as it is (not widened to int64) so (k, g) are bit-equal with the JAX
function for every n, and with the same arithmetic in the CUDA kernel
(``kernels/tilestats_u16.cu``).
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
    g = rem.to(torch.float32) / 100000.0
    return k, g
