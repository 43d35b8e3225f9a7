"""Tensor-native anomaly detection: the whole fleet scored per tick as one
batched device program.

The scalar finders in ``detector/detectors.py`` walk brokers in Python and
call ``np.percentile`` per row — fine at 5 brokers, hopeless at 7,000.  This
module keeps their exact semantics (they remain the oracle, see below) but
vectorizes the hot scoring path over the load monitor's
(broker × window × metric) history tensor:

- ``DeviceScorer`` runs K14 once per aggregation generation and answers BOTH
  finder families at once — percentile-excursion flags/ratios for the
  metric-anomaly finder and own-history ∧ peer-anchor suspect flags for the
  slow-broker finder.  K14 is two launches on the card
  (``csrc/detector_scores.cu``): the peer pass (``peer_anchor``, the
  percentile across brokers of the valid latest values) and the row pass
  (``row_scores``, three masked row percentiles and the flags).  CPU
  tensors take their plain versions (``_device_scores_plain``).
  Variable-length valid-window histories are handled by a masked
  sort-based percentile that reproduces numpy's linear interpolation, so
  host and device agree bit-for-bit on engineered integer histories.
- ``DeviceMetricAnomalyFinder`` / ``DeviceSlowBrokerFinder`` subclass their
  scalar counterparts and override only the flagging stage; streak/score
  escalation, systemic guards, and ``configure()`` are inherited unchanged.
- ``DeviceGoalViolationDetector`` answers "which goals are violated" with
  the fused stack-satisfied sweep from ``analyzer/optimizer.py`` (K9) — one
  launch for the whole detection stack, instead of one per goal.

``CRUISE_DETECTOR_ORACLE=1`` makes every device flagging pass re-run the
scalar oracle on the same aggregate and raise on any divergence.

Dispatch economy is observable: ``DEVICE_COUNTERS["dispatches"]`` counts
scoring dispatches (one per generation regardless of fleet size) and both
finder families sharing one ``DeviceScorer`` share the dispatch; the
kernels' own launch counters are ``peer_anchor.launches`` and
``row_scores.launches``.

Arithmetic of the percentile, as the JAX package's program computes it at
the optimization level its tests run at: the rank is ``f32(pct / 100) *
f32(max(n - 1, 0))`` with ``pct / 100`` rounded to f32 once on the host,
invalid entries sort as ``FLT_MAX``, and the interpolation is an unfused
multiply then add, ``x_lo + frac * (x_hi - x_lo)``, each rounded to f32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Set, Tuple, Union

import numpy as np
import torch

from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.detector.detectors import (GoalViolationDetector,
                                                         PercentileMetricAnomalyFinder,
                                                         SlowBrokerFinder)
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
from cruise_control_tpu_torch.ops import cuda

#: Scoring dispatches (module counter, FETCH_COUNTERS-style).
DEVICE_COUNTERS = {"dispatches": 0}

#: The most windows (W) and brokers (E) K14 takes on the card: the row pass
#: keeps a row's W - 1 history keys in per-thread arrays, and the peer pass
#: sorts the E latest values in one block's shared memory (8 bytes each).
MAX_WINDOWS = 64
MAX_PEERS = 16384
_BIG = float(np.finfo(np.float32).max)
_EPS = 1e-9


def oracle_enabled() -> bool:
    return os.environ.get("CRUISE_DETECTOR_ORACLE", "0") == "1"


_PARAM_NAMES = ("a_pct", "a_margin", "pct", "hist_margin", "peer_pct",
                "peer_margin", "min_bytes", "min_flush")


@dataclasses.dataclass(frozen=True)
class ScoreConstants:
    """The thresholds as the f32 numbers the scorer computes with: each
    percentile as ``f32(pct / 100)`` (rounded once, here), each margin and
    floor rounded to f32."""

    a_q: float
    a_margin: float
    q: float
    hist_margin: float
    peer_q: float
    peer_margin: float
    min_bytes: float
    min_flush: float

    @classmethod
    def of(cls, params: Tuple[float, ...]) -> "ScoreConstants":
        p = dict(zip(_PARAM_NAMES, params))
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return cls(a_q=f32(p["a_pct"] / 100.0), a_margin=f32(p["a_margin"]),
                   q=f32(p["pct"] / 100.0), hist_margin=f32(p["hist_margin"]),
                   peer_q=f32(p["peer_pct"] / 100.0), peer_margin=f32(p["peer_margin"]),
                   min_bytes=f32(p["min_bytes"]), min_flush=f32(p["min_flush"]))


def _f32(x: float, dev: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _masked_percentile_plain(x: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """Row-wise ``np.percentile(x[row][valid[row]], pct)`` (linear
    interpolation) with ``q = f32(pct / 100)``: invalid entries sort to the
    top as ``FLT_MAX``, the fractional rank indexes only the first
    ``n_valid`` slots.  Rows with zero valid entries return 0 (callers mask
    them out)."""
    dev = x.device
    xs = torch.sort(torch.where(valid, x, _f32(_BIG, dev)), dim=1).values
    n = valid.sum(dim=1)
    nm1 = (n - 1).clamp_min(0)
    rank = _f32(q, dev) * nm1.to(torch.float32)
    lo = torch.floor(rank).to(torch.int64)
    hi = torch.minimum(lo + 1, nm1)
    frac = rank - lo.to(torch.float32)
    x_lo = xs.gather(1, lo[:, None])[:, 0]
    x_hi = xs.gather(1, hi[:, None])[:, 0]
    return torch.where(n > 0, x_lo + frac * (x_hi - x_lo), torch.zeros_like(x_lo))


def peer_anchor_plain(vals: torch.Tensor, wvalid: torch.Tensor, q: float) -> torch.Tensor:
    """f32[1]: the percentile ``q`` of every valid latest value (0 when none
    is valid)."""
    return _masked_percentile_plain(vals[:, -1][None, :], wvalid[:, -1][None, :], q)


def row_scores_plain(vals: torch.Tensor, bts: torch.Tensor, wvalid: torch.Tensor,
                     peer: torch.Tensor, c: ScoreConstants):
    """Per broker: metric-anomaly flag and ratio, slow-broker suspect.
    Mirrors ``PercentileMetricAnomalyFinder.anomalies`` and
    ``SlowBrokerFinder._suspects`` element-for-element."""
    dev = vals.device
    latest = vals[:, -1]
    latest_valid = wvalid[:, -1]
    hist_valid = wvalid[:, :-1]
    scorable = latest_valid & hist_valid.any(dim=1)
    eps = _f32(_EPS, dev)

    # Metric anomaly: latest exceeds own-history percentile × margin.
    a_thr = _masked_percentile_plain(vals[:, :-1], hist_valid, c.a_q) * _f32(c.a_margin, dev)
    a_flag = scorable & (latest > a_thr) & (latest > 0)
    a_ratio = latest / torch.maximum(a_thr, eps)

    # Slow broker: raw AND bytes-normalized flush above own history, plus
    # the peer anchor × margin.
    b = torch.maximum(bts, eps)
    norm = vals / b
    hist_margin = _f32(c.hist_margin, dev)
    raw_hist = _masked_percentile_plain(vals[:, :-1], hist_valid, c.q)
    norm_hist = _masked_percentile_plain(norm[:, :-1], hist_valid, c.q)
    own_slow = (latest > raw_hist * hist_margin) & (norm[:, -1] > norm_hist * hist_margin)
    floors = (b[:, -1] >= _f32(c.min_bytes, dev)) & (latest >= _f32(c.min_flush, dev))
    p = peer[0]
    peer_slow = (p > 0) & (latest > p * _f32(c.peer_margin, dev))
    suspect = scorable & floors & own_slow & peer_slow
    return a_flag, a_ratio, suspect


def _check_history(vals: torch.Tensor, bts: Optional[torch.Tensor],
                   wvalid: torch.Tensor) -> Tuple[int, int]:
    dev = vals.device
    e = vals.shape[0]
    w = vals.shape[1] if vals.dim() == 2 else -1
    cuda.check(vals, "vals", torch.float32, (e, w), dev)
    if bts is not None:
        cuda.check(bts, "bts", torch.float32, (e, w), dev)
    cuda.check(wvalid, "wvalid", torch.bool, (e, w), dev)
    if w < 2:
        raise ValueError("K14 needs a latest window and at least one history "
                         f"window, got W={w}")
    return e, w


@cuda.counted("detector_peer")
def peer_anchor(vals: torch.Tensor, wvalid: torch.Tensor, q: float) -> torch.Tensor:
    """K14's peer pass.  Replaces the peer percentile of
    ``cruise_control_tpu/detector/device.py:102`` (``_masked_percentile``
    over the valid latest values).  f32[1].  Bound on the card: bytes (E
    latest values and flags: 35 KB at 7,000 brokers), far below a launch.
    CPU tensors take ``peer_anchor_plain``; CUDA tensors launch one block
    that bitonic-sorts the E (key, row) pairs in shared memory and
    interpolates — exact against the plain version.  E at most
    ``MAX_PEERS``."""
    e, w = _check_history(vals, None, wvalid)
    cuda.record("detector_peer", (vals, wvalid, q))
    if cuda.on_cpu(vals):
        return peer_anchor_plain(vals, wvalid, q)
    out = torch.zeros(1, dtype=torch.float32, device=vals.device)
    if e == 0:
        return out
    if e > MAX_PEERS:
        raise ValueError(f"K14's peer pass takes at most {MAX_PEERS} brokers, got {e}")
    cuda.launch("detector_peer", vals, wvalid, e, w, q, out)
    peer_anchor.launches += 1
    return out


@cuda.counted("detector_rows")
def row_scores(vals: torch.Tensor, bts: torch.Tensor, wvalid: torch.Tensor,
               peer: torch.Tensor, c: ScoreConstants):
    """K14's row pass.  Replaces ``cruise_control_tpu/detector/device.py:77``
    ``_device_scores`` (its three row percentiles of ``_masked_percentile``,
    ``:60``, and the flags): ``(metric_flag bool[E], metric_ratio f32[E],
    suspect bool[E])``.  Bound on the card: bytes (E·W·9 read, E·6 written:
    1.3 MB at 7,000 × 20, ~0.4 µs), so a launch costs more than the work.
    CPU tensors take ``row_scores_plain``; CUDA tensors launch one thread
    per broker that ranks its W - 1 history keys by counting, picks the two
    order statistics of each percentile and interpolates with a separately
    rounded ``__fmul_rn`` then ``__fadd_rn`` (IEEE ``__fdiv_rn`` for the
    divisions) — exact against the plain version.  W at most
    ``MAX_WINDOWS``."""
    e, w = _check_history(vals, bts, wvalid)
    dev = vals.device
    cuda.check(peer, "peer", torch.float32, (1,), dev)
    cuda.record("detector_rows", (vals, bts, wvalid, peer, c))
    if cuda.on_cpu(vals):
        return row_scores_plain(vals, bts, wvalid, peer, c)
    if w > MAX_WINDOWS:
        raise ValueError(f"K14's row pass takes at most {MAX_WINDOWS} windows, got {w}")
    flag = torch.zeros(e, dtype=torch.bool, device=dev)
    ratio = torch.zeros(e, dtype=torch.float32, device=dev)
    suspect = torch.zeros(e, dtype=torch.bool, device=dev)
    if e > 0:
        cuda.launch("detector_rows", vals, bts, wvalid, peer, e, w, c.a_q, c.a_margin,
                    c.q, c.hist_margin, c.peer_margin, c.min_bytes, c.min_flush,
                    flag, ratio, suspect)
        row_scores.launches += 1
    return flag, ratio, suspect


def _device_scores_plain(vals, bts, wvalid, params: Tuple[float, ...]):
    """The fleet scorer in torch ops: ``_device_scores`` of the JAX package
    (``detector/device.py:77``) on f32[E, W] history slices."""
    c = ScoreConstants.of(params)
    peer = peer_anchor_plain(vals, wvalid, c.peer_q)
    return row_scores_plain(vals, bts, wvalid, peer, c)


def _device_scores(vals, bts, wvalid, params: Tuple[float, ...]):
    """K14: the peer pass then the row pass, on the tensors' device (the
    plain versions for CPU tensors)."""
    c = ScoreConstants.of(params)
    peer = peer_anchor(vals, wvalid, c.peer_q)
    return row_scores(vals, bts, wvalid, peer, c)


_gauge_fn = lambda: DEVICE_COUNTERS["dispatches"]  # noqa: E731 — stable
# callback identity so repeat registrations are recognized as the same one


def _register_dispatch_gauge() -> None:
    SENSORS.gauge("AnomalyDetector.device-score-dispatches", fn=_gauge_fn,
                  help="Device scoring dispatches (one per aggregation "
                       "generation, fleet-size independent)")


class DeviceScorer:
    """Shared per-tick scorer: one dispatch per (generation, thresholds),
    consumed by both device finder families.

    Holds the merged threshold set — finders sync their configured values in
    before each read — and caches the fetched host arrays keyed on the
    aggregator generation, so two finders scoring the same tick share one
    dispatch and one device fetch.  Scores on ``device`` (the card unless
    the caller asks for ``"cpu"``)."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        # Metric-anomaly thresholds (PercentileMetricAnomalyFinder).
        self.a_pct, self.a_margin = 95.0, 1.5
        # Slow-broker thresholds (SlowBrokerFinder).
        self.pct, self.hist_margin = 90.0, 3.0
        self.peer_pct, self.peer_margin = 50.0, 3.0
        self.min_bytes, self.min_flush = 0.0, 0.0
        self._cache: Optional[Tuple] = None
        _register_dispatch_gauge()

    def _params(self) -> Tuple[float, ...]:
        return (float(self.a_pct), float(self.a_margin), float(self.pct),
                float(self.hist_margin), float(self.peer_pct),
                float(self.peer_margin), float(self.min_bytes),
                float(self.min_flush))

    def scores(self, res, mid: int, bytes_mid: int):
        """Score an ``AggregationResult`` → host dict of per-broker arrays.
        ``res.generation`` keys the cache: re-reads within one tick are
        free, a new window invalidates."""
        key = (res.generation, self._params(), res.values.shape, mid,
               bytes_mid)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]

        def column(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        vals = column(res.values[:, :, mid])
        bts = column(res.values[:, :, bytes_mid])
        wvalid = column(res.window_valid)
        DEVICE_COUNTERS["dispatches"] += 1
        a_flag, a_ratio, suspect = _device_scores(vals, bts, wvalid, self._params())
        host = torch.stack([a_flag.to(torch.float32), a_ratio,
                            suspect.to(torch.float32)]).cpu().numpy()
        out = {"metric_flag": host[0] != 0, "metric_ratio": host[1],
               "suspect": host[2] != 0}
        self._cache = (key, out)
        return out


class DeviceMetricAnomalyFinder(PercentileMetricAnomalyFinder):
    """Batched ``PercentileMetricAnomalyFinder``: identical detect()
    escalation (streaks, systemic guard) over device-computed flags."""

    def __init__(self, *args, scorer: Optional[DeviceScorer] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._scorer = scorer or DeviceScorer()

    def anomalies(self, broker_agg) -> Dict[int, float]:
        res = broker_agg.aggregate()
        if res.values.shape[1] < 3 or res.values.shape[0] == 0:
            return {}
        self._scorer.a_pct, self._scorer.a_margin = self._pct, self._margin
        mid = KAFKA_METRIC_DEF.metric_info(self.metric).metric_id
        bmid = KAFKA_METRIC_DEF.metric_info(
            SlowBrokerFinder.BYTES_METRIC).metric_id
        s = self._scorer.scores(res, mid, bmid)
        out = {int(broker): float(s["metric_ratio"][row])
               for row, broker in enumerate(res.entities)
               if s["metric_flag"][row]}
        if oracle_enabled():
            want = super().anomalies(broker_agg)
            if set(want) != set(out):
                raise AssertionError(
                    f"device metric-anomaly flags {sorted(out)} diverge "
                    f"from scalar oracle {sorted(want)}")
        return out


class DeviceSlowBrokerFinder(SlowBrokerFinder):
    """Batched ``SlowBrokerFinder``: identical score escalation
    (demote/removal thresholds, systemic guard) over device suspects."""

    def __init__(self, *args, scorer: Optional[DeviceScorer] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._scorer = scorer or DeviceScorer()

    def _suspects(self, res, mid: int, bytes_mid: int) -> Set[int]:
        sc = self._scorer
        sc.pct, sc.hist_margin = self._pct, self._hist_margin
        sc.peer_pct, sc.peer_margin = self._peer_pct, self._peer_margin
        sc.min_bytes, sc.min_flush = self._min_bytes_in, self._min_flush_ms
        s = sc.scores(res, mid, bytes_mid)
        out = {int(broker) for row, broker in enumerate(res.entities)
               if s["suspect"][row]}
        if oracle_enabled():
            want = super()._suspects(res, mid, bytes_mid)
            if want != out:
                raise AssertionError(
                    f"device slow-broker suspects {sorted(out)} diverge "
                    f"from scalar oracle {sorted(want)}")
        return out


def build_device_finders(config: Optional[Dict[str, object]] = None,
                         device: Union[str, torch.device] = "cuda"):
    """The default device finder pair sharing ONE scorer (and therefore one
    scoring dispatch per tick), scoring on ``device``."""
    scorer = DeviceScorer(device)
    metric = DeviceMetricAnomalyFinder(scorer=scorer)
    slow = DeviceSlowBrokerFinder(scorer=scorer)
    if config:
        metric.configure(config)
        slow.configure(config)
    return metric, slow


class DeviceGoalViolationDetector(GoalViolationDetector):
    """Goal-violation detection through the fused stack-satisfied sweep.

    The scalar parent costs one ``kernels.goal_satisfied`` evaluation per
    detection goal plus a separate offline-replica check; this subclass
    runs ``optimizer._get_sweep_fn`` — K9's sweep on the model's device —
    so ONE launch returns every goal's verdict and the any-offline flag
    together, fetched in one transfer."""

    def _goal_satisfactions(self, model):
        from cruise_control_tpu_torch.analyzer import optimizer as opt
        from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
        specs = tuple(goals_by_priority(self._goals))
        sat_np, off = opt._get_sweep_fn(specs, self._constraint)(model)
        if off:
            return None, True
        sat = [bool(v) for v in sat_np]
        if oracle_enabled():
            want, want_off = super()._goal_satisfactions(model)
            if want != sat or want_off:
                raise AssertionError(
                    f"fused-sweep goal verdicts {sat} diverge from scalar "
                    f"oracle {want} (offline={want_off})")
        return sat, False
