"""``ops/order.py`` ``ordered_sum`` and ``ordered_cumsum`` against the float
order of the JAX package's compiled CPU programs: a float32 ``jnp.sum`` and
``jnp.cumsum`` along the leading axis under ``jax.jit``, on seeded vectors
and [n, 4] tables whose lengths sit on and around every window (32) and
block (16) edge of one, two and three levels.  Exact: the port's band
averages and K3's running totals rely on these bits (the CUDA kernels of
``csrc/ordered.cu`` are held against the plain versions on the card by
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.ops import order

LENGTHS = (1, 15, 16, 17, 31, 32, 33, 50, 200, 511, 512, 513, 1000, 1025, 4097, 16385)


def _data(n, cols, seed):
    """Mixed magnitudes and signs, so that the order of the adds shows."""
    rng = np.random.default_rng(seed)
    shape = (n,) if cols is None else (n, cols)
    mag = rng.exponential(1.0, shape) * 10.0 ** rng.integers(-3, 5, shape)
    return (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


@pytest.mark.parametrize("cols", [None, 4], ids=["vector", "table"])
@pytest.mark.parametrize("op", ["sum", "cumsum"])
def test_ordered_reductions_match_jax(op, cols):
    jax_fn = jax.jit((lambda a: jnp.sum(a, axis=0)) if op == "sum"
                     else (lambda a: jnp.cumsum(a, axis=0)))
    port_fn = order.ordered_sum if op == "sum" else order.ordered_cumsum
    for i, n in enumerate(LENGTHS):
        x = _data(n, cols, 100 + i)
        want = np.asarray(jax_fn(jnp.asarray(x)))
        got = port_fn(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape, n
        np.testing.assert_array_equal(got, want, err_msg=f"{op} of {x.shape}")


def test_ordered_sum_on_cpu_is_the_plain_version():
    x = torch.from_numpy(_data(200, 4, 7))
    before = order.ordered_sum.launches
    assert torch.equal(order.ordered_sum(x), order.ordered_sum_plain(x))
    assert order.ordered_sum.launches == before
