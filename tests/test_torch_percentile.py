"""Port parity: exact np.percentile positions (ops.percentile).

(k, g) must be bit-equal with the JAX function for every n, including 0
and 1, up to the int32 limit, and for every p1000 the runners use."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocess_tpu.ops import percentile as jref
from imageprocess_tpu_torch.ops import percentile as port

NS = [0, 1, 2, 3, 99, 100, 101, 1000, 16384, 99_999, 100_000, 100_001,
      786_432, 3_145_728, 20_000_000, 21_474_837, 21_474_838, 100_000_000,
      1_000_000_001, 2_147_483_646, 2_147_483_647]
# tile quantiles (p5, median, p95), background percentiles of the GUI and
# the bounds of the range
P1000S = [0, 100, 1000, 2500, 5000, 50000, 95000, 99000, 99900, 100000]


@pytest.mark.parametrize("p1000", P1000S)
def test_exact_quantile_pos_bit_equal(p1000):
    n = np.array(NS, np.int32)
    k_j, g_j = jref.exact_quantile_pos(jnp.asarray(n), p1000)
    k_t, g_t = port.exact_quantile_pos(torch.from_numpy(n), p1000)
    assert k_t.dtype == torch.int32 and g_t.dtype == torch.float32
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    # bit-equal floats, not merely close
    np.testing.assert_array_equal(g_t.numpy().view(np.uint32),
                                  np.asarray(g_j).view(np.uint32))
    # and exact against Python integers
    for i, nn in enumerate(NS):
        k_true, rem = divmod(max(nn - 1, 0) * p1000, 100000)
        assert int(k_t[i]) == k_true
        assert float(g_t[i]) == float(np.float32(rem) / np.float32(100000.0))


def test_exact_quantile_pos_per_lane_column():
    """A (R, 1) p1000 column broadcast against n, as the TPU kernel passes
    it: same values as the JAX function."""
    p = np.array([[5000], [50000], [95000], [1000]], np.int32)
    n = np.array([0, 1, 7, 16384, 2_147_483_647], np.int32)
    k_j, g_j = jref.exact_quantile_pos(jnp.asarray(n), jnp.asarray(p))
    k_t, g_t = port.exact_quantile_pos(torch.from_numpy(n), torch.from_numpy(p))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("p", [0.0, 0.1, 1.0, 2.5, 5.0, 50.0, 95.0, 99.9, 100.0])
def test_p1000_of_matches(p):
    assert port.p1000_of(p) == jref.p1000_of(p)
