"""Model-layer parity of the PyTorch port against the JAX package: the
generator's RNG stream, the numpy carry-over, every broker and partition
aggregate (K1's plain path included), stats, and the relocations / apply
(K7's plain path) on random masks with masked duplicate lanes.

Tolerances: integers, masks and placements exact; float aggregates within
rtol 1e-5 of the column's max |value|, because XLA and ``index_add_`` sum
in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.actions import Candidates as JaxCandidates
from cruise_control_tpu.analyzer.actions import apply_candidates as jax_apply
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.model.stats import compute_stats as jax_stats
from cruise_control_tpu.model.tensor_model import BrokerState
from cruise_control_tpu_torch.analyzer.actions import apply_candidates, apply_candidates_plain
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from cruise_control_tpu_torch.convert import model_from_numpy, model_to_numpy
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from cruise_control_tpu_torch.model.stats import compute_stats
from cruise_control_tpu_torch.model.tensor_model import TENSOR_FIELDS
from cruise_control_tpu_torch.ops.segment import broker_aggregates, broker_aggregates_plain
from tests.torch_port_helpers import (SPEC_6, SPEC_ENTRY, SPEC_SMALL, assert_float_close,
                                      cand_to_torch, to_torch)

SPECS = {"entry": (SPEC_ENTRY, 8), "optimizer6": (SPEC_6, None), "bench_small": (SPEC_SMALL, None)}


def _pair(name, dead_broker=None):
    kw, pad = SPECS[name]
    jm = jax_generate(JaxSpec(**kw), pad_replicas_to_multiple=pad)
    tm = generate_cluster(ClusterSpec(**kw), pad_replicas_to_multiple=pad, device="cpu")
    if dead_broker is not None:
        jm = jm.set_broker_state(dead_broker, BrokerState.DEAD)
        tm = tm.set_broker_state(dead_broker, BrokerState.DEAD)
    return jm, tm


@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_cluster_field_by_field(name):
    jm, tm = _pair(name)
    for f in TENSOR_FIELDS:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for s in ("num_brokers", "num_racks", "num_hosts", "num_topics", "num_partitions",
              "num_disks", "max_rf"):
        assert getattr(jm, s) == getattr(tm, s), s


@pytest.mark.parametrize("name", sorted(SPECS))
def test_convert_round_trip(name):
    jm, tm = _pair(name)
    carried = to_torch(jm)
    fields, static = model_to_numpy(model_from_numpy(*model_to_numpy(carried), device="cpu"))
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(fields[f], np.asarray(getattr(jm, f)), err_msg=f)
        assert fields[f].dtype == np.asarray(getattr(jm, f)).dtype, f
    assert static == {s: getattr(jm, s) for s in static}


@pytest.mark.parametrize("dead", [None, 1])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_aggregates_match(name, dead):
    jm, tm = _pair(name, dead)
    exact = ("broker_replica_counts", "broker_leader_counts", "topic_broker_replica_counts",
             "partition_rack_counts", "partition_replication_factor",
             "partition_leader_replica", "replica_offline_now", "alive_broker_mask")
    for fn in exact:
        np.testing.assert_array_equal(getattr(tm, fn)().numpy(), np.asarray(getattr(jm, fn)()),
                                      err_msg=fn)
    for fn in ("broker_load", "potential_leadership_load", "broker_leader_bytes_in"):
        assert_float_close(getattr(tm, fn)().numpy(), np.asarray(getattr(jm, fn)()), fn)
    ja, ta = JaxBrokerArrays.from_model(jm), BrokerArrays.from_model(tm)
    for f in ("replica_count", "leader_count", "alive", "valid", "num_alive"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(), np.asarray(getattr(ja, f)),
                                      err_msg=f)
    for f in ("load", "potential_nw_out", "leader_bytes_in", "capacity"):
        assert_float_close(getattr(ta, f).numpy(), np.asarray(getattr(ja, f)), f)


def test_k1_wrapper_takes_the_plain_path_on_cpu():
    _, tm = _pair("optimizer6")
    args = (tm.replica_broker, tm.replica_valid, tm.replica_is_leader,
            tm.replica_load_leader, tm.replica_load_follower, tm.num_brokers)
    before = broker_aggregates.launches
    for a, b in zip(broker_aggregates(*args), broker_aggregates_plain(*args)):
        assert torch.equal(a, b)
    assert broker_aggregates.launches == before  # no kernel ran


@pytest.mark.parametrize("name", sorted(SPECS))
def test_stats_match(name):
    jm, tm = _pair(name)
    js, ts = jax_stats(jm).to_dict(), compute_stats(tm).to_dict()
    assert js.keys() == ts.keys()
    for k in js:
        if isinstance(js[k], dict):
            for r in js[k]:
                assert_float_close(ts[k][r], js[k][r], f"{k}.{r}")
        else:
            assert_float_close(ts[k], js[k], k)


def _random_batch(tm, seed, k=96):
    """A candidate batch of all five action kinds on distinct replicas, with
    masked lanes duplicating applied ones; leadership lanes hand over from a
    leader to a follower (the selection's contract)."""
    rng = np.random.default_rng(seed)
    R, B = tm.num_replicas_padded, tm.num_brokers
    valid = tm.replica_valid.numpy()
    lead = tm.replica_is_leader.numpy()
    rb, rd = tm.replica_broker.numpy(), tm.replica_disk.numpy()
    pool = rng.permutation(np.nonzero(valid)[0])
    n = min(k, pool.size // 2)
    r1, r2 = pool[:n], pool[n:2 * n]
    kind = rng.integers(0, 5, n)
    kind[(kind == 1) & ~(lead[r1] & ~lead[r2])] = 0
    dest = rng.integers(0, B, n)
    dup = rng.integers(0, n, n // 3)
    kind = np.concatenate([kind, rng.integers(0, 5, dup.size)])
    r1 = np.concatenate([r1, r1[dup]])
    r2 = np.concatenate([r2, r2[dup]])
    dest = np.concatenate([dest, rng.integers(0, B, dup.size)])
    mask = np.concatenate([rng.random(n) < 0.7, np.zeros(dup.size, bool)])
    dest_replica = np.where(np.isin(kind, (1, 3, 4)), r2, -1)
    safe2 = np.where(dest_replica >= 0, dest_replica, r1)
    K = kind.size
    i32 = lambda a: jnp.asarray(np.asarray(a, np.int32))  # noqa: E731
    zf = jnp.zeros((K, 4), jnp.float32)
    z = jnp.zeros((K,), jnp.float32)
    zi = jnp.zeros((K,), jnp.int32)
    cand = JaxCandidates(
        action_type=i32(kind), replica=i32(r1), src=i32(rb[r1]), dest=i32(dest),
        dest_replica=i32(dest_replica), partition=zi, partition2=zi,
        valid=jnp.asarray(mask), delta_src=zf, delta_dest=zf, d_replica_count=zi,
        d_leader_count=zi, d_potential_nw_out=z, d_leader_bytes_in_src=z,
        d_leader_bytes_in_dest=z, src_disk=i32(rd[r1]),
        dest_disk=i32(np.where(kind == 4, rd[safe2], rng.integers(0, B, K))))
    return cand, jnp.asarray(mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_and_relocations_match(seed):
    jm, tm = _pair("optimizer6")
    cand, mask = _random_batch(tm, seed)
    tcand, tmask = cand_to_torch(cand), torch.from_numpy(np.array(mask))
    jout = jax_apply(jm, cand, mask)
    before = apply_candidates.launches
    for tout in (apply_candidates(tm, tcand, tmask), apply_candidates_plain(tm, tcand, tmask)):
        for f in ("replica_broker", "replica_disk", "replica_is_leader"):
            np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                          np.asarray(getattr(jout, f)), err_msg=f)
    assert apply_candidates.launches == before
    # The caller's model is never written.
    np.testing.assert_array_equal(tm.replica_broker.numpy(), np.asarray(jm.replica_broker))
    # The three relocations, one by one, on the same masked duplicate lanes.
    r = cand.replica
    jr = jm.relocate_replicas(r, cand.dest, mask)
    tr = tm.relocate_replicas(tcand.replica, tcand.dest, tmask)
    np.testing.assert_array_equal(tr.replica_broker.numpy(), np.asarray(jr.replica_broker))
    np.testing.assert_array_equal(tr.replica_disk.numpy(), np.asarray(jr.replica_disk))
    jd = jm.relocate_replicas_to_disk(r, cand.dest_disk, mask)
    td = tm.relocate_replicas_to_disk(tcand.replica, tcand.dest_disk, tmask)
    np.testing.assert_array_equal(td.replica_disk.numpy(), np.asarray(jd.replica_disk))
    safe = jnp.where(cand.dest_replica >= 0, cand.dest_replica, r)
    tsafe = torch.where(tcand.dest_replica >= 0, tcand.dest_replica, tcand.replica)
    jl = jm.relocate_leadership(r, safe, mask)
    tl = tm.relocate_leadership(tcand.replica, tsafe, tmask)
    np.testing.assert_array_equal(tl.replica_is_leader.numpy(), np.asarray(jl.replica_is_leader))
