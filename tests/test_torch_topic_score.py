"""The squared-deviation scores are bit-equal to the JAX package's jitted
ones on the mid rung (50 brokers, 10 racks, 40 topics, seed 2026; bench.py's
mid rung, no solve).

- TopicReplicaDistributionGoal, on the batch the JAX step builds there
  (cross legs plus the 4,096-wide matched topic legs, 14,592 lanes): the
  port's ``score`` and K5's plain twin equal the jitted score.
- CpuUsageDistributionGoal: its broker loads are float sums, which XLA and
  PyTorch add in different orders, so the port's score is compared on the
  JAX program's own metric and band values: the port's squared-deviation
  expression then equals the jitted score.  XLA contracts these squares at
  its default backend optimization level (as bench.py and the service run
  it) but not at level 0, which tests/conftest.py sets to keep compiles
  short, so this check runs in a child process at the default level.

XLA's CPU code generator contracts ``x ** 2 + y ** 2`` into
``fma(x, x, y * y)`` (the optimized HLO keeps multiply and add in one loop
fusion); the same ops run one by one round the product separately and
differ from the jitted score in about a third of the lanes.  The port's
``kernels._sq_sum`` computes the contracted form exactly, and so does K5."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from tests.torch_port_helpers import cand_to_torch, to_torch

MID = dict(num_brokers=50, num_racks=10, num_topics=40, mean_partitions_per_topic=84.0,
           replication_factor=3, distribution="exponential", seed=2026)
_MID = {}


def _mid():
    if not _MID:
        jm = jax_generate(JaxSpec(**MID))
        _MID.update(jm=jm, tm=to_torch(jm))
    return _MID["jm"], _MID["tm"]


def _batch(goal, jm):
    jspec, con = JAX_SPECS[goal], JaxBC.default()
    ns, nd = jc.default_num_sources(jm), jc.default_num_dests(jm)
    matched = max(1, min(jm.num_replicas_padded, max(16 * ns, 4096)))

    def batch(m, opts):
        arrays = JaxBrokerArrays.from_model(m)
        if jspec.kind == "topic_replica_distribution":
            return jc.combined_move_candidates(jspec, m, arrays, con, opts, ns, nd,
                                               num_matched=matched)
        return jc.concat_candidates(
            jc.combined_move_candidates(jspec, m, arrays, con, opts, ns, nd),
            jc.swap_candidates(jspec, m, arrays, con, opts, ns, 16))

    jcand = jax.jit(batch)(jm, JaxOptions.none(jm))
    want = np.asarray(jax.jit(lambda m, c: jk.score(
        jspec, m, JaxBrokerArrays.from_model(m), c, con))(jm, jcand))
    return jcand, want


def test_topic_score_equals_the_jitted_jax_score_bit_for_bit():
    goal = "TopicReplicaDistributionGoal"
    jm, tm = _mid()
    jcand, want = _batch(goal, jm)
    assert jcand.k == 14592
    tcand = cand_to_torch(jcand)
    ta = BrokerArrays.from_model(tm, True)
    got = tk.score(GOAL_SPECS[goal], tm, ta, tcand, BalancingConstraint.default())
    np.testing.assert_array_equal(got.numpy(), want)
    masks_score, _ = tk.goal_masks(GOAL_SPECS[goal], tm, ta, tcand,
                                   BalancingConstraint.default())
    np.testing.assert_array_equal(masks_score.numpy(), want)


def test_distribution_score_form_equals_the_jitted_jax_score_bit_for_bit():
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_backend_optimization_level")]
    env = dict(os.environ, XLA_FLAGS=" ".join(flags), JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import tests.test_torch_topic_score as t; t.check_distribution_score_form()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


def check_distribution_score_form():
    goal = "CpuUsageDistributionGoal"
    jm, _ = _mid()
    jcand, want = _batch(goal, jm)
    jspec, con = JAX_SPECS[goal], JaxBC.default()

    def parts(m, c):
        arrays = JaxBrokerArrays.from_model(m)
        metric = jk.broker_metric(jspec, m, arrays, con)
        lower, upper = jk.limits(jspec, m, arrays, con)
        target = jnp.where(upper >= jk._BIG, metric, (lower + upper) * 0.5)
        d_src, d_dest = jk._candidate_deltas(jspec, c)
        bonus = jnp.where(jk._src_unhealthy(m, c, arrays) & c.is_move(), 1e12, 0.0)
        return (metric[c.src], metric[c.dest], d_src, d_dest, target[c.src],
                target[c.dest], bonus.astype(jnp.float32))

    sm, dm, ds, dd, ts, td, bonus = (torch.from_numpy(np.array(x))
                                     for x in jax.jit(parts)(jm, jcand))
    got = (tk._sq_sum(sm - ts, dm - td) - tk._sq_sum(sm + ds - ts, dm + dd - td)) + bonus
    np.testing.assert_array_equal(got.numpy(), want)
