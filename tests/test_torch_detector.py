"""The port's anomaly detectors and their manager against the JAX package's,
on the CPU.

K14's plain version (``detector/device.py`` ``_device_scores_plain``)
gives the JAX package's jitted ``_device_scores`` flags and ratios exactly
on seeded histories and on the three fixtures of
tests/test_device_detector.py; the device finders equal the scalar oracle
under ``CRUISE_DETECTOR_ORACLE=1`` and keep one dispatch per aggregation
generation; every detector, the notifier and the manager give the JAX
package's results on the same sampled monitors and metadata, and call the
self-healing context the same way; and a few ticks of sampler, monitor,
detectors and manager, with a slow broker and a dead broker injected, give
the same anomaly sequence, states and context calls in both packages.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.detector import anomalies as janom
from cruise_control_tpu.detector import detectors as jdet
from cruise_control_tpu.detector import device as jdev
from cruise_control_tpu.detector import manager as jman
from cruise_control_tpu.detector import notifier as jnot
from cruise_control_tpu.executor.admin import InMemoryClusterAdmin as JaxAdmin
from cruise_control_tpu.monitor import capacity as jcap
from cruise_control_tpu.monitor import load_monitor as jlm
from cruise_control_tpu.monitor import metadata as jmeta
from cruise_control_tpu.monitor import sampling as jsamp
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.config import constants as C
from cruise_control_tpu_torch.convert import aggregation_from_numpy, aggregation_to_numpy
from cruise_control_tpu_torch.detector import anomalies as tanom
from cruise_control_tpu_torch.detector import detectors as tdet
from cruise_control_tpu_torch.detector import device as tdev
from cruise_control_tpu_torch.detector import manager as tman
from cruise_control_tpu_torch.detector import notifier as tnot
from cruise_control_tpu_torch.detector import provisioner as tprov
from cruise_control_tpu_torch.executor.admin import InMemoryClusterAdmin as PortAdmin
from cruise_control_tpu_torch.monitor import capacity as tcap
from cruise_control_tpu_torch.monitor import load_monitor as tlm
from cruise_control_tpu_torch.monitor import metadata as tmeta
from cruise_control_tpu_torch.monitor import sampling as tsamp
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
from tests.test_detector import (RecordingFacade, broker_agg_with_history, make_md,
                                 sampled_lm)
from tests.torch_port_helpers import (BORDERLINE, CLEAN, SINGLE_SLOW, WINDOW_MS,
                                      port_broker_agg_with_history, port_md,
                                      port_sampled_lm)

W = WINDOW_MS
FLUSH = "BROKER_LOG_FLUSH_TIME_MS_999TH"
MID = KAFKA_METRIC_DEF.metric_info(FLUSH).metric_id
BYTES_MID = KAFKA_METRIC_DEF.metric_info("LEADER_BYTES_IN").metric_id
DEFAULT_PARAMS = (95.0, 1.5, 90.0, 3.0, 50.0, 3.0, 0.0, 0.0)
FIXTURES = {"clean": CLEAN, "single_slow": SINGLE_SLOW, "borderline": BORDERLINE}


@pytest.fixture(autouse=True)
def _oracle_off(monkeypatch):
    monkeypatch.delenv("CRUISE_DETECTOR_ORACLE", raising=False)


def _jax_scores(vals, bts, wvalid, params):
    fn = jax.jit(partial(jdev._device_scores, **dict(zip(jdev._PARAM_NAMES, params))))
    return [np.asarray(a) for a in fn(vals, bts, wvalid)]


def _port_scores(vals, bts, wvalid, params):
    return [a.numpy() for a in tdev._device_scores_plain(
        torch.from_numpy(vals), torch.from_numpy(bts), torch.from_numpy(wvalid), params)]


def _history(seed, e=64, w=20):
    """Seeded f32[E, W] flush times and bytes-in with 80 % valid windows,
    integer-valued on even seeds; rows 0-2 with no valid history, one valid
    history window and an invalid latest window; rows 3-6 with a flush-time
    excursion in the latest window; a few ties."""
    rng = np.random.default_rng(seed)
    vals = rng.gamma(2.0, 5.0, size=(e, w)).astype(np.float32)
    if seed % 2 == 0:
        vals = np.round(vals)
    bts = rng.gamma(2.0, 50.0, size=(e, w)).astype(np.float32)
    wvalid = rng.random((e, w)) < 0.8
    wvalid[0, :-1] = False
    wvalid[1, :-1] = False
    wvalid[1, 4] = True
    wvalid[2, -1] = False
    wvalid[3:7, -1] = True
    vals[3:7, -1] *= 40.0
    vals[8, :] = vals[8, 0]
    return vals, bts, wvalid


PARAM_CASES = [DEFAULT_PARAMS, (99.0, 1.25, 75.0, 2.0, 90.0, 2.5, 90.0, 12.0),
               (100.0, 1.0, 0.0, 1.5, 0.0, 1.0, 0.0, 0.0)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k14_plain_matches_jax_on_seeded_histories(seed):
    vals, bts, wvalid = _history(seed)
    params = PARAM_CASES[seed % len(PARAM_CASES)]
    want = _jax_scores(vals, bts, wvalid, params)
    got = _port_scores(vals, bts, wvalid, params)
    for g, w, name in zip(got, want, ("metric_flag", "metric_ratio", "suspect")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)  # ratios exactly
    if params == DEFAULT_PARAMS:
        assert got[0][3:7].all() and got[2][3:7].any()


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_k14_plain_matches_jax_on_fixtures(fixture):
    res = broker_agg_with_history(FIXTURES[fixture]).aggregate()
    vals = np.ascontiguousarray(res.values[:, :, MID])
    bts = np.ascontiguousarray(res.values[:, :, BYTES_MID])
    want = _jax_scores(vals, bts, res.window_valid, DEFAULT_PARAMS)
    got = _port_scores(vals, bts, res.window_valid, DEFAULT_PARAMS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_k14_wrappers_take_the_plain_path_on_the_cpu_and_check_shapes():
    vals, bts, wvalid = (torch.from_numpy(a) for a in _history(5, e=16, w=6))
    c = tdev.ScoreConstants.of(DEFAULT_PARAMS)
    before = (tdev.peer_anchor.launches, tdev.row_scores.launches)
    peer = tdev.peer_anchor(vals, wvalid, c.peer_q)
    got = tdev.row_scores(vals, bts, wvalid, peer, c)
    want = tdev._device_scores_plain(vals, bts, wvalid, DEFAULT_PARAMS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tdev.peer_anchor.launches, tdev.row_scores.launches) == before
    with pytest.raises(ValueError, match="at least one history window"):
        tdev.row_scores(vals[:, :1].contiguous(), bts[:, :1].contiguous(),
                        wvalid[:, :1].contiguous(), peer, c)
    with pytest.raises(TypeError):
        tdev.peer_anchor(vals.double(), wvalid, c.peer_q)
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.peer_anchor(meta, torch.zeros(4, 3, dtype=torch.bool, device="meta"), 0.5)


def _device_pair(device="cpu"):
    scorer = tdev.DeviceScorer(device)
    return tdev.DeviceMetricAnomalyFinder(scorer=scorer), tdev.DeviceSlowBrokerFinder(
        scorer=scorer)


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_device_finders_match_oracle_and_jax(monkeypatch, fixture):
    monkeypatch.setenv("CRUISE_DETECTOR_ORACLE", "1")
    tagg = port_broker_agg_with_history(FIXTURES[fixture])
    jagg = broker_agg_with_history(FIXTURES[fixture])
    metric, slow = _device_pair()
    jscorer = jdev.DeviceScorer()
    jmetric = jdev.DeviceMetricAnomalyFinder(scorer=jscorer)
    jslow = jdev.DeviceSlowBrokerFinder(scorer=jscorer)
    assert metric.anomalies(tagg) == jmetric.anomalies(jagg)  # oracle-checked, ratios equal
    res, jres = tagg.aggregate(), jagg.aggregate()
    assert slow._suspects(res, MID, BYTES_MID) == jslow._suspects(jres, MID, BYTES_MID)
    got = slow.detect(tagg, now_ms=0)
    want = jslow.detect(jagg, now_ms=0)
    assert (got is None) == (want is None)
    # The carried aggregation scores like the port's own.
    carried = aggregation_from_numpy(aggregation_to_numpy(jres))
    s1 = tdev.DeviceScorer("cpu").scores(carried, MID, BYTES_MID)
    s2 = tdev.DeviceScorer("cpu").scores(res, MID, BYTES_MID)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k])


def test_oracle_raises_on_forced_divergence(monkeypatch):
    monkeypatch.setenv("CRUISE_DETECTOR_ORACLE", "1")
    agg = port_broker_agg_with_history(SINGLE_SLOW)
    metric, _ = _device_pair()
    real = tdev.DeviceScorer.scores

    def broken(self, res, mid, bytes_mid):
        out = dict(real(self, res, mid, bytes_mid))
        out["metric_flag"] = np.zeros_like(out["metric_flag"])
        return out

    monkeypatch.setattr(tdev.DeviceScorer, "scores", broken)
    with pytest.raises(AssertionError, match="diverge"):
        metric.anomalies(agg)


@pytest.mark.parametrize("num_brokers", [8, 64])
def test_one_scoring_dispatch_per_generation(num_brokers):
    history = {b: [5, 5, 5, 5, 5, 5] for b in range(num_brokers)}
    history[3] = [5, 5, 5, 5, 5, 500]
    agg = port_broker_agg_with_history(history)
    metric, slow = _device_pair()
    before = tdev.DEVICE_COUNTERS["dispatches"]
    assert set(metric.anomalies(agg)) == {3}
    slow.detect(agg, now_ms=0)
    assert tdev.DEVICE_COUNTERS["dispatches"] == before + 1
    metric.anomalies(agg)
    assert tdev.DEVICE_COUNTERS["dispatches"] == before + 1
    for b in history:
        agg.add_sample(b, 7 * W, {FLUSH: 5.0, "LEADER_BYTES_IN": 100.0})
    metric.anomalies(agg)
    slow.detect(agg, now_ms=1)
    assert tdev.DEVICE_COUNTERS["dispatches"] == before + 2


def test_device_finders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test checks the refusal without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.build_device_finders()


# -- goal violations ----------------------------------------------------------

GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
         "TopicReplicaDistributionGoal"]


def _violations(a):
    return None if a is None else (a.fixable_goals, a.unfixable_goals)


@pytest.mark.parametrize("case", ["healthy", "offline", "unfixable_rack"])
def test_goal_violation_detectors_match_jax(monkeypatch, case):
    """The scalar and the K9-sweep detector of the port give the JAX
    package's fixable and unfixable goals, balancedness score and
    provisioning verdict."""
    monkeypatch.setenv("CRUISE_DETECTOR_ORACLE", "1")
    kw, goals = {"num_brokers": 6}, GOALS
    if case == "offline":
        kw["alive"] = {0, 1, 2, 3, 4}
    if case == "unfixable_rack":
        kw, goals = {"num_brokers": 4, "rf": 3}, GOALS[:1]
    tmon, jmon = port_sampled_lm(port_md(**kw)), sampled_lm(make_md(**kw))
    prov = tprov.InMemoryProvisioner()
    for tcls, jcls in ((tdet.GoalViolationDetector, jdet.GoalViolationDetector),
                       (tdev.DeviceGoalViolationDetector, jdev.DeviceGoalViolationDetector)):
        t, j = tcls(tmon, goals, provisioner=prov), jcls(jmon, goals)
        sweeps = topt.SWEEP_COUNTERS["dispatches"]
        got, want = t.detect(now_ms=1), j.detect(now_ms=1)
        assert _violations(got) == _violations(want)
        assert t.balancedness_score == j.balancedness_score
        if tcls is tdev.DeviceGoalViolationDetector:
            assert topt.SWEEP_COUNTERS["dispatches"] == sweeps + 1
        if case == "offline":
            assert got is None and t.balancedness_score < 0
            continue
        assert t.last_provision_response.to_dict() == j.last_provision_response.to_dict()
        assert t.last_checked_generation == j.last_checked_generation
    if case == "unfixable_rack":
        assert got is not None and "RackAwareGoal" in got.unfixable_goals


# -- failures, topics, maintenance --------------------------------------------

def _kill(mc, md_mod, broker_id):
    cluster = mc.cluster()
    mc.refresh(dataclasses.replace(cluster, brokers=tuple(
        dataclasses.replace(b, is_alive=(b.broker_id != broker_id)) for b in cluster.brokers)))


def _anomaly(a):
    """An anomaly without its process-wide id."""
    if a is None:
        return None
    d = a.to_dict()
    d.pop("anomalyId")
    return d


def test_broker_and_disk_failure_detectors_match(tmp_path):
    out = []
    for meta, det, admin_cls, md in ((tmeta, tdet, PortAdmin, port_md()),
                                     (jmeta, jdet, JaxAdmin, make_md())):
        path = str(tmp_path / f"{det.__name__}.json")
        mc = meta.MetadataClient(md)
        bf = det.BrokerFailureDetector(mc, persist_path=path)
        seq = [_anomaly(bf.detect(now_ms=1000))]
        _kill(mc, meta, 2)
        seq.append(_anomaly(bf.detect(now_ms=2000)))
        seq.append(_anomaly(det.BrokerFailureDetector(mc, persist_path=path).detect(9000)))
        mc.refresh(md)
        seq.append(_anomaly(bf.detect(now_ms=10_000)))
        admin = admin_cls(mc)
        df = det.DiskFailureDetector(admin, mc)
        seq.append(_anomaly(df.detect(1)))
        admin.logdir_health = {0: {"/d1": True, "/d2": False}, 1: {"/d1": True}}
        seq.append(_anomaly(df.detect(2)))
        out.append(seq)
    assert out[0] == out[1]
    assert out[0][1]["reason"].endswith("[2]")


def test_topic_and_maintenance_detectors_match():
    out = []
    for meta, det, anom, lm in ((tmeta, tdet, tanom, port_sampled_lm(port_md(rf=2))),
                                (jmeta, jdet, janom, sampled_lm(make_md(rf=2)))):
        md = lm._metadata
        seq = [[_anomaly(a) for a in det.TopicAnomalyDetector(
            md, desired_rf=3, load_monitor=lm, partition_size_threshold_mb=120.0).detect(1)]]
        seq.append([_anomaly(a) for a in det.TopicAnomalyDetector(
            md, desired_rf=2, excluded_topics=["t1"], load_monitor=lm,
            partition_size_threshold_mb=120.0).detect(2)])
        ctx = RecordingFacade()
        seq.append([a.fix(ctx) for a in det.TopicAnomalyDetector(md, desired_rf=3).detect(3)])
        seq.append(ctx.calls)
        reader = det.MaintenanceEventReader()
        mdet = det.MaintenanceEventDetector(reader, idempotence_ttl_ms=10_000)
        plan = anom.MaintenancePlanType.REMOVE_BROKER
        for t, now in ((0, 100), (1, 100), (2, 200), (3, 20_000)):
            reader.publish(anom.MaintenanceEvent(detection_time_ms=t, plan_type=plan,
                                                 brokers=(3,)))
            if t != 0:
                seq.append([_anomaly(a) for a in mdet.detect(now_ms=now)])
        out.append(seq)
    assert out[0] == out[1]
    assert out[0][0] and out[0][4] and out[0][5] == [] and out[0][6]


# -- the manager --------------------------------------------------------------

def _state(mgr, notifier):
    st = mgr.state.to_dict(notifier)
    for rows in st["recentAnomalies"].values():
        for r in rows:
            r.pop("anomalyId")
    return st


def _manager_runs(anom, man, notif):
    """Priority and fix, deferral while the executor is busy, a failed heal:
    the context calls and states each package's manager produces."""
    out = []
    enabled = dict.fromkeys(anom.AnomalyType, True)
    ctx = RecordingFacade()
    n = notif.SelfHealingNotifier(self_healing_enabled=enabled,
                                  broker_failure_alert_threshold_ms=0,
                                  broker_failure_self_healing_threshold_ms=0)
    mgr = man.AnomalyDetectorManager(n, ctx)
    mgr.enqueue(anom.GoalViolations(detection_time_ms=1,
                                    fixable_goals=["ReplicaDistributionGoal"]), 1)
    mgr.enqueue(anom.BrokerFailures(detection_time_ms=1, failed_brokers={2: 0}), 1)
    mgr.enqueue(anom.SlowBrokers(detection_time_ms=1, slow_brokers={4: 5.0}), 1)
    out += [mgr.handle_anomalies_once(now_ms=10), ctx.calls, _state(mgr, n)]

    busy = {"v": True}
    ctx = RecordingFacade()
    mgr = man.AnomalyDetectorManager(notif.SelfHealingNotifier(self_healing_enabled=enabled),
                                     ctx, executor_busy=lambda: busy["v"])
    mgr.enqueue(anom.GoalViolations(detection_time_ms=1, fixable_goals=["X"]), 1)
    out += [mgr.handle_anomalies_once(now_ms=10), list(ctx.calls)]
    busy["v"] = False
    out += [mgr.handle_anomalies_once(now_ms=20_000), mgr.handle_anomalies_once(now_ms=50_000),
            ctx.calls]

    n = notif.SelfHealingNotifier(self_healing_enabled=enabled,
                                  broker_failure_alert_threshold_ms=0,
                                  broker_failure_self_healing_threshold_ms=0)

    class Boom:
        def __getattr__(self, name):
            def call(*args, **kwargs):
                raise RuntimeError("heal exploded")
            return call
    mgr = man.AnomalyDetectorManager(n, Boom())
    mgr.enqueue(anom.BrokerFailures(detection_time_ms=1, failed_brokers={2: 0}), 1)
    mgr.enqueue(anom.GoalViolations(detection_time_ms=1, fixable_goals=["X"]), 1)
    out += [mgr.handle_anomalies_once(now_ms=10), mgr.state.ongoing_self_healing,
            _state(mgr, n)]

    n = notif.SelfHealingNotifier(broker_failure_alert_threshold_ms=1000,
                                  broker_failure_self_healing_threshold_ms=5000)
    a = anom.BrokerFailures(detection_time_ms=0, failed_brokers={1: 0})
    out += [(r.action.value, r.delay_ms) for r in (n.on_anomaly(a, now_ms=t)
                                                   for t in (500, 2000, 6000))]
    return out


def test_manager_and_notifier_match_jax():
    got = _manager_runs(tanom, tman, tnot)
    want = _manager_runs(janom, jman, jnot)
    assert got == want
    assert got[1][0][0] == "remove_brokers" and got[1][1][0] == "demote_brokers"


# -- the slice as a whole -----------------------------------------------------

SLOW, DEAD = 1, 3
TICKS = range(4, 10)
SLOW_FROM, DEAD_AT = 6, 8


def _sampler(samp):
    class Flagged(samp.SyntheticWorkloadSampler):
        """The synthetic workload with bytes-in on every broker sample and
        broker 1's flush time 40x from tick 6."""

        def get_samples(self, cluster, partitions, start_ms, end_ms, mode):
            out = super().get_samples(cluster, partitions, start_ms, end_ms, mode)
            rows = []
            for bs in out.broker_samples:
                m = dict(bs.metrics, LEADER_BYTES_IN=100.0 + bs.broker_id)
                if bs.broker_id == SLOW and start_ms >= SLOW_FROM * W:
                    m[FLUSH] = 200.0
                rows.append(dataclasses.replace(bs, metrics=m))
            return samp.Samples(out.partition_samples, rows)
    return Flagged()


def _ticks(meta, samp, anom, det, dev, man, notif, lm_mod, cap, md, **kw):
    mc = meta.MetadataClient(md)
    lm = lm_mod.LoadMonitor(mc, cap.StaticCapacityResolver(), num_partition_windows=3,
                            partition_window_ms=W, **kw)
    lm.start_up()
    sampler = _sampler(samp)
    for w in range(TICKS[0]):
        lm.fetch_once(sampler, w * W, w * W + 1)
    finders = (dev.build_device_finders({C.SLOW_BROKER_DEMOTION_SCORE_CONFIG: 1},
                                        device="cpu") if dev is tdev else
               dev.build_device_finders({C.SLOW_BROKER_DEMOTION_SCORE_CONFIG: 1}))
    ctx = RecordingFacade()
    n = notif.SelfHealingNotifier(self_healing_enabled=dict.fromkeys(anom.AnomalyType, True),
                                  broker_failure_alert_threshold_ms=0,
                                  broker_failure_self_healing_threshold_ms=0)
    mgr = man.AnomalyDetectorManager(n, ctx)
    reader = det.MaintenanceEventReader()
    for d in (det.BrokerFailureDetector(mc),
              dev.DeviceGoalViolationDetector(lm, GOALS),
              det.MetricAnomalyDetector(lm, finders),
              det.TopicAnomalyDetector(mc, desired_rf=2, load_monitor=lm,
                                       partition_size_threshold_mb=150.0),
              det.MaintenanceEventDetector(reader)):
        mgr.register_detector(d, interval_ms=1)
    seq = []
    for k in TICKS:
        if k == DEAD_AT:
            _kill(mc, meta, DEAD)
        if k == SLOW_FROM:
            reader.publish(anom.MaintenanceEvent(
                detection_time_ms=k * W, plan_type=anom.MaintenancePlanType.DEMOTE_BROKER,
                brokers=(SLOW,)))
        lm.fetch_once(sampler, k * W, k * W + 1)
        dispatches = (tdev.DEVICE_COUNTERS["dispatches"] if dev is tdev else 0)
        found = mgr.run_detectors_once(k * W + 2)
        if dev is tdev:
            assert tdev.DEVICE_COUNTERS["dispatches"] == dispatches + 1
        queued = [_anomaly(e.anomaly) for e in sorted(mgr._queue)]
        handled = mgr.handle_anomalies_once(k * W + 3)
        seq.append((k, found, queued, handled, list(ctx.calls), _state(mgr, n),
                    mgr.balancedness_score()))
        ctx.calls.clear()
    return seq


def test_ticks_of_the_slice_match_jax(monkeypatch):
    """Sampler → monitor → detectors (K9's sweep and K14 from the port's
    plain path) → manager → context, for six ticks, with broker 1 turning
    slow and broker 3 dying: the same anomalies queued, the same states
    and the same context calls as the JAX package, tick for tick."""
    monkeypatch.setenv("CRUISE_DETECTOR_ORACLE", "1")
    got = _ticks(tmeta, tsamp, tanom, tdet, tdev, tman, tnot, tlm, tcap, port_md(6),
                 device="cpu")
    want = _ticks(jmeta, jsamp, janom, jdet, jdev, jman, jnot, jlm, jcap, make_md(6))
    assert got == want
    calls = [c[0] for tick in got for c in tick[4]]
    assert "demote_brokers" in calls and "remove_brokers" in calls
    slow_ticks = [tick[0] for tick in got
                  if any(q["type"] == "METRIC_ANOMALY" for q in tick[2])]
    # Both finder families report the slow broker: the percentile excursion
    # (its ratio) and the slow-broker finder (its score).
    reasons = [q["reason"] for tick in got for q in tick[2] if q["type"] == "METRIC_ANOMALY"]
    assert any("1: 1.0}" in r for r in reasons) and len(reasons) >= 2
    # The excursion sampled in tick 6's window is the latest complete one at tick 7.
    assert slow_ticks and slow_ticks[0] == SLOW_FROM + 1
    assert got[-1][6] < 0  # the balancedness score pinned while replicas are offline
