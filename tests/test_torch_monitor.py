"""The port's monitor layer against the JAX package's, on the CPU.

The same samples, metadata and capacities, made from a seed with numpy, go
through both packages: the aggregator's arrays (``add_sample``,
``add_samples`` through the port's numpy ingest against the JAX package's
C++ ingest, ``aggregate()``) are equal field for field, a sampled
``LoadMonitor`` at 12 brokers with a dead broker and offline replicas builds
the same cluster model leaf for leaf, and ``cpu_model``, the capacity
resolvers and the synthetic sampler agree.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cruise_control_tpu import native as jnative
from cruise_control_tpu.model import cpu_model as jcpu
from cruise_control_tpu.monitor import aggregator as jagg
from cruise_control_tpu.monitor import capacity as jcap
from cruise_control_tpu.monitor import load_monitor as jlm
from cruise_control_tpu.monitor import metadata as jmeta
from cruise_control_tpu.monitor import sampling as jsamp
from cruise_control_tpu_torch import native as tnative
from cruise_control_tpu_torch.convert import (aggregation_from_numpy, aggregation_to_numpy,
                                              model_to_numpy)
from cruise_control_tpu_torch.model import cpu_model as tcpu
from cruise_control_tpu_torch.monitor import aggregator as tagg
from cruise_control_tpu_torch.monitor import capacity as tcap
from cruise_control_tpu_torch.monitor import load_monitor as tlm
from cruise_control_tpu_torch.monitor import metadata as tmeta
from cruise_control_tpu_torch.monitor import sampling as tsamp
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
from tests.torch_port_helpers import (WINDOW_MS, assert_aggregations_equal,  # noqa: F401
                                      assert_models_equal, jax_native,
                                      restore_jax_native)

# The reference's aggregator takes its native ingest in every test here.
pytestmark = pytest.mark.usefixtures("jax_native")

W = WINDOW_MS
NAMES = [i.name for i in KAFKA_METRIC_DEF.all_metric_infos()]


def _samples(seed, n=300, entities=9, windows=7, jitter=True):
    """(entity, time_ms, {metric: value}) triples: random entities, windows
    and metric subsets, times that tie and run backwards within a window,
    a few samples older than the retention horizon."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = int(rng.integers(0, windows))
        t = w * W + (int(rng.integers(0, 4)) * 1000 if jitter else 1)
        k = int(rng.integers(1, 6))
        names = rng.choice(len(NAMES), size=k, replace=False)
        out.append((f"e{int(rng.integers(0, entities))}", t,
                    {NAMES[j]: float(np.round(rng.normal(10.0, 4.0), 2)) for j in names}))
    return out


def _aggregators(**kw):
    return tagg.MetricSampleAggregator(**kw), jagg.MetricSampleAggregator(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_samples_and_aggregate_match(seed):
    assert jnative.available(), "the JAX package's batched path needs its native ingest"
    kw = dict(num_windows=4, window_ms=W, min_samples_per_window=2,
              max_allowed_extrapolations_per_entity=2)
    t, j = _aggregators(**kw)
    samples = _samples(seed)
    for lo in range(0, len(samples), 75):  # several batches, the windows rolling
        batch = sorted(samples[lo:lo + 75], key=lambda s: s[1] // W)
        assert t.add_samples(batch) == j.add_samples(batch)
        assert t.generation == j.generation
    for name in ("_sum", "_max", "_latest_val", "_latest_ts", "_count"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert_aggregations_equal(t.aggregate(), j.aggregate())
    assert t.valid_windows() == j.valid_windows()


@pytest.mark.parametrize("seed", [3, 4])
def test_add_sample_and_aggregate_match(seed):
    kw = dict(num_windows=3, window_ms=W, min_samples_per_window=3)
    t, j = _aggregators(**kw)
    for entity, time_ms, values in _samples(seed, n=200, windows=6):
        assert t.add_sample(entity, time_ms, values) == j.add_sample(entity, time_ms, values)
    assert t.generation == j.generation
    assert t.entities == j.entities
    assert_aggregations_equal(t.aggregate(), j.aggregate())
    t.clear(), j.clear()
    assert_aggregations_equal(t.aggregate(), j.aggregate())


def test_ingest_matches_native_on_random_batches():
    """The port's numpy ingest against the JAX package's C++ ingest on the
    raw window arrays: sums in sample order, the later sample winning a
    tie on time."""
    rng = np.random.default_rng(5)
    for trial in range(40):
        cap, w1, m = 6, 4, 5
        n = int(rng.integers(0, 50))
        init = np.random.default_rng(trial)
        arrays = [init.normal(size=(cap, w1, m)), np.full((cap, w1, m), -np.inf),
                  init.normal(size=(cap, w1, m)),
                  init.integers(-1, 5, size=(cap, w1)).astype(np.int64),
                  init.integers(0, 3, size=(cap, w1)).astype(np.int64)]
        batch = (rng.integers(0, cap, n), rng.integers(0, w1, n), rng.integers(0, 6, n),
                 rng.normal(size=(n, m)).round(1),
                 (rng.random((n, m)) < 0.7).astype(np.uint8))
        got = [a.copy() for a in arrays]
        want = [a.copy() for a in arrays]
        tnative.ingest_samples(*got, *batch)
        assert jnative.ingest_samples(*want, *batch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_aggregation_carries_between_packages():
    t, j = _aggregators(num_windows=4, window_ms=W)
    samples = sorted(_samples(6, n=120), key=lambda s: s[1] // W)
    t.add_samples(samples)
    j.add_samples(samples)
    jres = j.aggregate()
    carried = aggregation_from_numpy(aggregation_to_numpy(jres))
    assert isinstance(carried, tagg.AggregationResult)
    assert_aggregations_equal(carried, t.aggregate())
    assert carried.completeness() == jres.completeness()


# -- the load monitor --------------------------------------------------------

DEAD, OFFLINE_DISK_BROKER = 5, 2


def _metadata(meta, seed=11, brokers=12):
    """12 brokers on 4 racks, 3 topics of RF 2 and 3, broker 5 dead, and
    broker 2's replicas of topic "b" offline (a failed log directory)."""
    rng = np.random.default_rng(seed)
    infos = tuple(meta.BrokerInfo(i, rack=f"rack{i % 4}", host=f"host{i}",
                                  is_alive=(i != DEAD)) for i in range(brokers))
    parts = []
    for topic, count, rf in (("a", 10, 2), ("b", 14, 3), ("c", 6, 3)):
        for p in range(count):
            reps = tuple(int(b) for b in rng.choice(brokers, size=rf, replace=False))
            offline = tuple(b for b in reps if b == DEAD
                            or (topic == "b" and b == OFFLINE_DISK_BROKER))
            parts.append(meta.PartitionInfo(topic, p, leader=reps[0], replicas=reps,
                                            offline_replicas=offline))
    return meta.ClusterMetadata(brokers=infos, partitions=tuple(parts))


def _monitor(lm_mod, meta, cap_mod, samp_mod, **kw):
    lm = lm_mod.LoadMonitor(meta.MetadataClient(_metadata(meta)),
                            cap_mod.StaticCapacityResolver(cpu=400.0, disk=5e5),
                            num_partition_windows=3, partition_window_ms=W,
                            num_broker_windows=4, broker_window_ms=W, **kw)
    lm.start_up()
    sampler = samp_mod.SyntheticWorkloadSampler(mean_nw_kb=80.0, seed=3)
    for w in range(4):
        lm.fetch_once(sampler, w * W, w * W + 1)
    return lm


@pytest.fixture(scope="module")
def monitors():
    return (_monitor(tlm, tmeta, tcap, tsamp, device="cpu"),
            _monitor(jlm, jmeta, jcap, jsamp))


def test_cluster_model_matches_leaf_for_leaf(monitors):
    tm, jm = monitors
    model, naming = tm.cluster_model_and_naming()
    jmodel, jnaming = jm.cluster_model_and_naming()
    assert model.replica_broker.device.type == "cpu"
    assert_models_equal(model, jmodel)
    assert naming == jnaming
    off = model.replica_offline_now()
    assert bool(off.any()) and bool(model.replica_offline.any())
    padded = tm.cluster_model(pad_replicas_to=model.num_replicas_padded + 7)
    assert_models_equal(padded, jm.cluster_model(pad_replicas_to=model.num_replicas_padded + 7))
    assert model_to_numpy(tm.cluster_model())[1] == model_to_numpy(model)[1]


def test_monitor_state_and_histories_match(monitors):
    tm, jm = monitors
    assert tm.model_generation().as_tuple() == jm.model_generation().as_tuple()
    assert tm.monitored_partitions_percentage() == jm.monitored_partitions_percentage()
    assert tm.state().value == jm.state().value
    assert tm.broker_health_metrics() == jm.broker_health_metrics()
    assert_aggregations_equal(tm.broker_history(), jm.broker_history())
    assert_aggregations_equal(tm.partition_aggregator.aggregate(),
                              jm.partition_aggregator.aggregate())
    req = dict(min_required_num_windows=4, min_monitored_partitions_percentage=0.5)
    with pytest.raises(tlm.NotEnoughValidWindowsError):
        tm.cluster_model(tlm.ModelCompletenessRequirements(**req))
    with pytest.raises(jlm.NotEnoughValidWindowsError):
        jm.cluster_model(jlm.ModelCompletenessRequirements(**req))


def test_execution_mode_and_bootstrap_match():
    out = []
    for lm_mod, meta, cap_mod, samp_mod, kw in (
            (tlm, tmeta, tcap, tsamp, {"device": "cpu"}), (jlm, jmeta, jcap, jsamp, {})):
        store = samp_mod.InMemorySampleStore()
        lm = lm_mod.LoadMonitor(meta.MetadataClient(_metadata(meta)),
                                num_partition_windows=3, partition_window_ms=W,
                                on_execution_store=store, **kw)
        lm.start_up()
        added = lm.bootstrap(samp_mod.SyntheticWorkloadSampler(), 0, 3 * W)
        lm.set_execution_mode(True)
        during = lm.fetch_once(samp_mod.SyntheticWorkloadSampler(), 3 * W, 3 * W + 1)
        out.append((added, during, len(store.load_samples().partition_samples),
                    lm.pause_reason, lm.partition_aggregator.valid_windows(),
                    lm.model_generation().as_tuple()))
    assert out[0] == out[1]


def test_monitor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test checks the refusal without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.LoadMonitor(tmeta.MetadataClient(_metadata(tmeta)))


# -- cpu_model, capacity, sampling ------------------------------------------

def test_cpu_model_matches():
    rng = np.random.default_rng(9)
    for row in rng.gamma(2.0, 10.0, size=(50, 6)):
        a, b, c, d, e, f = (float(x) for x in row)
        assert tcpu.follower_cpu_util_from_leader_load(a, b, c) == \
            jcpu.follower_cpu_util_from_leader_load(a, b, c)
        assert tcpu.estimate_leader_cpu_util(a, b, c, d, e, f) == \
            jcpu.estimate_leader_cpu_util(a, b, c, d, e, f)
    assert tcpu.follower_cpu_util_from_leader_load(0.0, 0.0, 5.0) == 0.0
    t, j = tcpu.CpuModelTrainer(), jcpu.CpuModelTrainer()
    assert t.predict(1.0, 1.0, 1.0) is None
    for lbi, lbo, fbi in rng.gamma(2.0, 100.0, size=(300, 3)):
        cpu = 0.002 * lbi + 0.001 * lbo + 0.0005 * fbi
        t.add_observation(lbi, lbo, fbi, cpu)
        j.add_observation(lbi, lbo, fbi, cpu)
    assert dataclasses.asdict(t.train()) == dataclasses.asdict(j.train())
    assert t.predict(10.0, 20.0, 5.0) == j.predict(10.0, 20.0, 5.0)


def test_capacity_resolvers_match(tmp_path):
    doc = {"brokerCapacities": [
        {"brokerId": "-1", "capacity": {"DISK": "100000", "CPU": "100",
                                        "NW_IN": "10000", "NW_OUT": "10000"}},
        {"brokerId": "3", "capacity": {"DISK": {"/d1": "4000", "/d2": "6000"},
                                       "CPU": {"num.cores": "8"},
                                       "NW_IN": "5000", "NW_OUT": "7000"}}]}
    path = tmp_path / "cap.json"
    path.write_text(json.dumps(doc))
    for t, j in ((tcap.FileCapacityResolver(str(path)), jcap.FileCapacityResolver(str(path))),
                 (tcap.StaticCapacityResolver(cpu=50.0), jcap.StaticCapacityResolver(cpu=50.0))):
        for b in (0, 3, 7):
            got = t.capacity_for_broker("r", "h", b)
            want = j.capacity_for_broker("r", "h", b)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            np.testing.assert_array_equal(got.as_row(), want.as_row())
    with pytest.raises(ValueError):
        tcap.FileCapacityResolver(str(path)).capacity_for_broker("r", "h", 9, False)


def test_synthetic_sampler_and_assignment_match():
    tmd, jmd = _metadata(tmeta), _metadata(jmeta)
    for mode in tsamp.SamplingMode:
        got = tsamp.SyntheticWorkloadSampler(seed=4).get_samples(
            tmd, [p.tp for p in tmd.partitions], 0, 10, mode)
        want = jsamp.SyntheticWorkloadSampler(seed=4).get_samples(
            jmd, [p.tp for p in jmd.partitions], 0, 10, jsamp.SamplingMode(mode.value))
        assert [s.to_json() for s in got.partition_samples] == \
            [s.to_json() for s in want.partition_samples]
        assert [s.to_json() for s in got.broker_samples] == \
            [s.to_json() for s in want.broker_samples]
    assert tsamp.assign_partitions(tmd, 3) == jsamp.assign_partitions(jmd, 3)


def test_file_sample_store_replays_into_the_same_model(tmp_path):
    path = str(tmp_path / "samples.jsonl")
    first = _monitor(tlm, tmeta, tcap, tsamp, device="cpu",
                     sample_store=tsamp.FileSampleStore(path))
    replayed = tlm.LoadMonitor(tmeta.MetadataClient(_metadata(tmeta)),
                               tcap.StaticCapacityResolver(cpu=400.0, disk=5e5),
                               sample_store=tsamp.FileSampleStore(path),
                               num_partition_windows=3, partition_window_ms=W,
                               num_broker_windows=4, broker_window_ms=W, device="cpu")
    replayed.start_up()
    want, _ = model_to_numpy(first.cluster_model())
    got, _ = model_to_numpy(replayed.cluster_model())
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_native_fixture_recovers_a_failed_load(tmp_path):
    """The JAX loader's failed state (a worker that lost the race on the
    shared ``.tmp``: tried, nothing loaded) is repaired by the module
    fixture's helper: the native path loads again."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_TRIED", True)
        mp.setattr(jnative, "_LIB", None)
        assert not jnative.available()
        restore_jax_native(mp, tmp_path)
        assert jnative.available()
        ing = jnative.ingest_samples
        assert callable(ing)
