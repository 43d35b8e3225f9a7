"""The mid rung (50 brokers, 10 racks, 40 topics, seed 2026; bench.py's mid
rung) solved by the JAX package and by the port's plain path, unfused and
fused: the same steps, actions and satisfied flags per goal and the same
final placement.

The JAX programs run in a child process at XLA's default backend
optimization level, as bench.py and the service run them: tests/conftest.py
compiles at level 0, where XLA does not contract the distribution kinds'
squared deviations into fused multiply-adds, so their scores, and from
there the mid solve, differ in ulps from the program the service runs.
Marked ``slow`` (several minutes on the CPU: two JAX stack compiles and
two CPU solves of 10,233 replicas)."""

import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_mid_rung_matches_the_jax_package_fused_and_unfused():
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_backend_optimization_level")]
    env = dict(os.environ, XLA_FLAGS=" ".join(flags), JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import tests.test_torch_mid_parity as t; t.check_mid()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    assert done.returncode == 0, done.stdout + done.stderr


def check_mid():
    import numpy as np

    from cruise_control_tpu.analyzer import optimizer as jopt
    from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
    from cruise_control_tpu.model.generator import generate_cluster as jax_generate
    from cruise_control_tpu_torch.analyzer import optimizer as topt
    from tests.torch_port_helpers import PLACEMENT, STACK, goal_rows, to_torch

    jm = jax_generate(JaxSpec(num_brokers=50, num_racks=10, num_topics=40,
                              mean_partitions_per_topic=84.0, replication_factor=3,
                              distribution="exponential", seed=2026))
    tm = to_torch(jm)
    for kw in ({"fused": False, "frontier": False}, {"fused": True}):
        jrun = jopt.optimize(jm, STACK, raise_on_hard_failure=False, **kw)
        trun = topt.optimize(tm, STACK, raise_on_hard_failure=False, device="cpu",
                             fused=kw["fused"])
        assert goal_rows(trun, 4) == goal_rows(jrun, 4), kw
        for f in PLACEMENT:
            np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                          np.asarray(getattr(jrun.model, f)), err_msg=f)
