"""The warm pipelined solve at 100 brokers (100 brokers, 10 racks, 40
topics, 84 partitions per topic, RF 3, seed 2026), port against the JAX
package, on the CPU.

Recipe (chip_smoke.py's large warm cell, at 100 brokers): the JAX
package's cold default solve (``optimize(fused=True)``, the inter-goal
pipeline) gives the converged placement; a load-only change scales the
loads of up to 64 partitions whose replicas all lie on the first 16 brokers
by a seeded factor in [2, 3); ``model_delta`` of the converged model
against the changed one gives the seed mask.  Both packages then run the
warm solve seeded with that mask, and unseeded (``WarmStart`` without a
mask): per goal the same steps and actions, and the same placement.  The
test prints each package's steps seeded and unseeded.

The JAX programs run in a child process at XLA's default backend
optimization level, as the service runs them (see
tests/test_torch_mid_parity.py).  Marked ``slow``: minutes on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

HUNDRED = dict(num_brokers=100, num_racks=10, num_topics=40, mean_partitions_per_topic=84.0,
               replication_factor=3, distribution="exponential", seed=2026)
SEED = 2026


@pytest.mark.slow
def test_100_brokers_warm_pipelined_matches_the_jax_package():
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_backend_optimization_level")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("CRUISE_")}
    env.update(XLA_FLAGS=" ".join(flags), JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import tests.test_torch_warm_mid as t; t.check_warm_100()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    print(done.stdout)
    assert done.returncode == 0, done.stdout + done.stderr


def load_factor(rb, rp, rv, pvalid, num_brokers, seed):
    """f32[R, 1] — chip_smoke.py's ``perturb_partitions`` factor per
    replica, from host arrays."""
    rng = np.random.default_rng(seed)
    near = pvalid.copy()
    np.logical_and.at(near, rp[rv], rb[rv] < min(16, max(num_brokers // 4, 2)))
    hot = np.flatnonzero(near)[:64]
    factor = np.ones((pvalid.shape[0], 1), np.float32)
    factor[hot] = rng.uniform(2.0, 3.0, (hot.size, 1)).astype(np.float32)
    return factor[rp]


def check_warm_100():
    import jax.numpy as jnp
    import torch

    from cruise_control_tpu.analyzer import optimizer as jopt
    from cruise_control_tpu.analyzer.state import WarmStart as JaxWarm
    from cruise_control_tpu.analyzer.state import model_delta as jax_delta
    from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
    from cruise_control_tpu.model.generator import generate_cluster as jax_generate
    from cruise_control_tpu_torch.analyzer import optimizer as topt
    from cruise_control_tpu_torch.analyzer.state import WarmStart, model_delta
    from tests.torch_port_helpers import STACK, goal_rows, to_torch

    jm = jax_generate(JaxSpec(**HUNDRED))
    cold = jopt.optimize(jm, STACK, raise_on_hard_failure=False, fused=True)
    conv = cold.model
    f = load_factor(np.asarray(conv.replica_broker), np.asarray(conv.replica_partition),
                    np.asarray(conv.replica_valid), np.asarray(conv.partition_valid),
                    conv.num_brokers, SEED)
    jchanged = conv.replace(replica_load_leader=conv.replica_load_leader * jnp.asarray(f),
                            replica_load_follower=conv.replica_load_follower * jnp.asarray(f))
    tconv = to_torch(conv)
    ft = torch.from_numpy(f)
    tchanged = tconv.replace(replica_load_leader=tconv.replica_load_leader * ft,
                             replica_load_follower=tconv.replica_load_follower * ft)
    jmask = jax_delta(conv, jchanged).changed_mask
    tmask = model_delta(tconv, tchanged).changed_mask
    np.testing.assert_array_equal(tmask, jmask)
    steps = {}
    for label, mask in (("seeded", jmask), ("unseeded", None)):
        jrun = jopt.optimize(jchanged, STACK, raise_on_hard_failure=False, fused=True,
                             warm_start=JaxWarm(prev_model=conv, active_mask=mask))
        trun = topt.optimize(tchanged, STACK, raise_on_hard_failure=False, fused=True,
                             device="cpu",
                             warm_start=WarmStart(prev_model=tconv, active_mask=mask))
        assert jrun.warm and trun.warm and trun.pipelined == jrun.pipelined
        steps[label] = (sum(g.steps for g in jrun.goal_results),
                        sum(g.steps for g in trun.goal_results))
        print(label, "seed", trun.seed_frontier_size, "JAX steps", steps[label][0],
              "port steps", steps[label][1], "skipped", jrun.goals_skipped,
              trun.goals_skipped)
        print(label, "JAX per goal", [(g.name, g.steps, g.actions_applied)
                                      for g in jrun.goal_results])
        print(label, "port per goal", [(g.name, g.steps, g.actions_applied)
                                       for g in trun.goal_results])
        assert [(g.steps, g.actions_applied) for g in trun.goal_results] == \
            [(g.steps, g.actions_applied) for g in jrun.goal_results], label
        assert goal_rows(trun) == goal_rows(jrun), label
        for fld in ("replica_broker", "replica_is_leader", "replica_disk"):
            np.testing.assert_array_equal(getattr(trun.model, fld).numpy(),
                                          np.asarray(getattr(jrun.model, fld)),
                                          err_msg=f"{label} {fld}")
    print("steps seeded vs unseeded (JAX, port):", steps)
