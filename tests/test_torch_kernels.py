"""The plain twins of the port's kernels K5, K6 and K13 against the JAX
package (the CUDA kernels themselves are held against these twins on the
card by chip_smoke.py).

- K5 ``goal_masks_plain``: per goal of the default stack, on a batch of
  moves, matched moves, leadership transfers and swaps built by the JAX
  package, the eligible mask equals JAX's ``valid & self_feasible &
  accepted & score > 1e-9`` (``optimizer.py:1154``, jitted as the JAX
  package runs it) lane for lane, with a random ``accepted`` mask; scores
  are bit-equal for the count, topic and rack kinds and within rtol 1e-5 of
  the largest |value| for the load kinds (XLA and PyTorch sum the broker
  loads in different orders).
- K6 ``transport_rank`` / ``transport_lookup``: exact against numpy
  references, and the matched legs they serve give the JAX package's index
  sets on a skewed cluster with a dead broker.
- K13 ``column_stats``: within rtol 1e-6 of JAX's ``_masked_stats``,
  including an all-false mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.model import stats as jstats
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.model.tensor_model import BrokerState
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import BrokerArrays, OptimizationOptions
from cruise_control_tpu_torch.model.stats import column_stats, column_stats_plain
from tests.torch_port_helpers import (SPEC_12, STACK, assert_float_close, cand_to_torch,
                                      to_torch)

_CASES = {}

# Kinds whose metric and deltas are integer-valued: scores are exact.
_EXACT_KINDS = ("rack", "topic_replica_distribution", "replica_capacity",
                "replica_distribution", "leader_replica_distribution")


def _jax_batch(jm, arrays, opts):
    con = JaxBC.default()
    rd, lrd, dud = (JAX_SPECS[n] for n in ("ReplicaDistributionGoal",
                                           "LeaderReplicaDistributionGoal",
                                           "DiskUsageDistributionGoal"))
    moves = jc.combined_move_candidates(rd, jm, arrays, con, opts, 24, 8, num_matched=64)
    lead = jc.leadership_candidates(lrd, jm, arrays, con, opts, 24)
    swaps = jc.swap_candidates(dud, jm, arrays, con, opts, 16, 8)
    return jc.concat_candidates(jc.concat_candidates(moves, lead), swaps)


def _case(dead: bool):
    if dead not in _CASES:
        jm = jax_generate(JaxSpec(**SPEC_12))
        if dead:
            jm = jm.set_broker_state(2, BrokerState.DEAD)
        arrays = JaxBrokerArrays.from_model(jm)
        cand = jax.jit(_jax_batch)(jm, arrays, JaxOptions.none(jm))
        tm = to_torch(jm)
        accepted = np.random.default_rng(3).random(cand.k) < 0.8
        _CASES[dead] = (jm, arrays, cand, tm, BrokerArrays.from_model(tm, True),
                        cand_to_torch(cand), accepted)
    return _CASES[dead]


@pytest.mark.parametrize("dead", [False, True], ids=["healthy", "dead"])
@pytest.mark.parametrize("goal", STACK)
def test_k5_plain_twin_matches_the_jax_masks(goal, dead):
    jm, ja, jcand, tm, ta, tcand, accepted = _case(dead)
    jspec, tspec = JAX_SPECS[goal], GOAL_SPECS[goal]
    jcon, tcon = JaxBC.default(), BalancingConstraint.default()
    jscore, jfeas = jax.jit(lambda m, a, c: (jk.score(jspec, m, a, c, jcon),
                                             jk.self_feasible(jspec, m, a, c, jcon)))(
        jm, ja, jcand)
    jscore = np.asarray(jscore)
    jelig = np.asarray(jcand.valid) & np.asarray(jfeas) & accepted & (jscore > 1e-9)
    before = tk.goal_masks.launches
    score, elig = tk.goal_masks(tspec, tm, ta, tcand, tcon,
                                accepted=torch.from_numpy(accepted))
    assert tk.goal_masks.launches == before  # the CPU takes the plain twin
    np.testing.assert_array_equal(elig.numpy(), jelig)
    if tspec.kind in _EXACT_KINDS:
        np.testing.assert_array_equal(score.numpy(), jscore)
    else:
        assert_float_close(score.numpy(), jscore, "score")
    plain_score, plain_elig = tk.goal_masks_plain(tspec, tm, ta, tcand, tcon,
                                                  accepted=torch.from_numpy(accepted))
    assert torch.equal(plain_score, score) and torch.equal(plain_elig, elig)


def test_transport_rank_matches_a_numpy_reference():
    rng = np.random.default_rng(0)
    for n, groups in ((1, 1), (97, 5), (4096, 300)):
        key = rng.integers(0, groups + 1, n).astype(np.int32)
        ordr = np.argsort(key, kind="stable")
        want = np.zeros(n, np.int32)
        for g in np.unique(key):
            rows = ordr[key[ordr] == g]
            want[rows] = np.arange(rows.size)
        got = tc.transport_rank(torch.from_numpy(ordr.astype(np.int64)),
                                torch.from_numpy(key), groups)
        np.testing.assert_array_equal(got.numpy(), want)


def test_transport_lookup_matches_a_numpy_reference():
    rng = np.random.default_rng(1)
    for windows, width, lanes in ((1, 12, 40), (7, 24, 300)):
        sizes = rng.integers(0, 4, windows * width).astype(np.int32)
        sizes[rng.random(sizes.size) < 0.3] = 0
        cum = np.cumsum(sizes).astype(np.int32)
        slot_broker = rng.integers(0, width, windows * width).astype(np.int32)
        win = rng.integers(0, windows, lanes).astype(np.int32)
        off = rng.integers(0, 3 * width, lanes).astype(np.int32)
        d1, d2, ok = tc.transport_lookup(*(torch.from_numpy(a) for a in (cum, slot_broker)),
                                         width, torch.from_numpy(win), torch.from_numpy(off))
        for i in range(lanes):
            lo, hi = win[i] * width, win[i] * width + width
            units = np.repeat(np.arange(lo, hi), sizes[lo:hi])
            j = units[off[i]] if off[i] < units.size else hi - 1
            assert ok[i] == (off[i] < units.size)
            assert d1[i] == slot_broker[j]
            assert d2[i] == slot_broker[min(j + 1, hi - 1)]


SKEWED = dict(num_brokers=24, num_racks=4, num_topics=9, mean_partitions_per_topic=30.0,
              replication_factor=3, distribution="exponential", seed=23)


@pytest.mark.parametrize("legs", ["_matched_move_legs", "_matched_topic_legs"])
def test_matched_legs_match_on_a_skewed_cluster_with_a_dead_broker(legs):
    jm = jax_generate(JaxSpec(**SKEWED)).set_broker_state(5, BrokerState.DEAD)
    tm = to_torch(jm)
    goal = ("ReplicaDistributionGoal" if legs == "_matched_move_legs"
            else "TopicReplicaDistributionGoal")
    jout = jax.jit(lambda m, o: getattr(jc, legs)(
        JAX_SPECS[goal], m, JaxBrokerArrays.from_model(m), JaxBC.default(), o, 256))(
        jm, JaxOptions.none(jm))
    tout = getattr(tc, legs)(GOAL_SPECS[goal], tm, BrokerArrays.from_model(tm, True),
                             BalancingConstraint.default(), OptimizationOptions.none(tm), 256)
    for name, t, j in zip(("replica", "dest", "ok"), tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert bool(tout[2].any())


@pytest.mark.parametrize("alive_share", [0.0, 0.7, 1.0])
def test_k13_plain_twin_matches_the_jax_stats(alive_share):
    rng = np.random.default_rng(4)
    values = rng.exponential(50.0, (37, 7)).astype(np.float32)
    mask = rng.random(37) < alive_share
    want = jstats._masked_stats(jnp.asarray(values), jnp.asarray(mask)[:, None])
    got = column_stats(torch.from_numpy(values), torch.from_numpy(mask))
    assert torch.equal(got, column_stats_plain(torch.from_numpy(values),
                                               torch.from_numpy(mask)))
    for row, w in zip(got.numpy(), want):
        assert_float_close(row, np.asarray(w), "stats", rtol=1e-6)
