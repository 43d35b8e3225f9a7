"""CPU estimation models.

Parity with the reference's CPU estimation (model/ModelUtils.java:61,92 and
model/LinearRegressionModelParameters.java:28):

- static heuristic splitting broker CPU to replicas weighted by bytes rates,
  and deriving follower CPU from leader load;
- an optionally *trained* linear-regression model over
  (LEADER_BYTES_IN, LEADER_BYTES_OUT, FOLLOWER_BYTES_IN) → CPU, fit by OLS
  on bucketed samples (the TRAIN endpoint feeds this).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

# Reference defaults (ModelUtils static init / MonitorConfig):
# fraction of leader CPU a follower replica costs.
DEFAULT_CPU_WEIGHT_OF_FOLLOWER = 0.4


def follower_cpu_util_from_leader_load(leader_bytes_in: float, leader_bytes_out: float,
                                       leader_cpu_util: float,
                                       follower_ratio: float = DEFAULT_CPU_WEIGHT_OF_FOLLOWER
                                       ) -> float:
    """Static heuristic (ModelUtils.getFollowerCpuUtilFromLeaderLoad,
    ModelUtils.java:61): a follower costs the leader's CPU scaled by the
    bytes-in share (followers only replicate inbound traffic) times a
    configured follower weight."""
    total = leader_bytes_in + leader_bytes_out
    if total <= 0:
        return 0.0
    return leader_cpu_util * follower_ratio * (leader_bytes_in / total)


def estimate_leader_cpu_util(broker_cpu_util: float, broker_leader_bytes_in: float,
                             broker_leader_bytes_out: float, broker_follower_bytes_in: float,
                             leader_bytes_in: float, leader_bytes_out: float) -> float:
    """Split broker CPU to one leader partition by its bytes-rate share
    (SamplingUtils.estimateLeaderCpuUtil, sampling/SamplingUtils.java:84-111)."""
    denom = broker_leader_bytes_in + broker_leader_bytes_out + broker_follower_bytes_in
    if denom <= 0:
        return 0.0
    share = (leader_bytes_in + leader_bytes_out) / denom
    return broker_cpu_util * share


@dataclasses.dataclass
class LinearRegressionModelParameters:
    """OLS CPU model over bucketed samples
    (model/LinearRegressionModelParameters.java:28).  Coefficients for
    LEADER_BYTES_IN, LEADER_BYTES_OUT, FOLLOWER_BYTES_IN."""

    coef_leader_bytes_in: float = 0.0
    coef_leader_bytes_out: float = 0.0
    coef_follower_bytes_in: float = 0.0
    trained: bool = False
    num_samples: int = 0


class CpuModelTrainer:
    """Accumulates (bytes rates → broker CPU) training rows and fits OLS.

    The reference buckets samples by total bytes rate to de-bias the fit
    toward the dense low-traffic region; we keep per-bucket reservoirs the
    same way (LinearRegressionModelParameters.addMetricObservation).
    """

    NUM_BUCKETS = 20
    BUCKET_CAP = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: list[list[Tuple[float, float, float, float]]] = \
            [[] for _ in range(self.NUM_BUCKETS)]
        self._max_rate = 1.0
        self.params = LinearRegressionModelParameters()

    def add_observation(self, leader_bytes_in: float, leader_bytes_out: float,
                        follower_bytes_in: float, cpu_util: float) -> None:
        with self._lock:
            rate = leader_bytes_in + leader_bytes_out + follower_bytes_in
            self._max_rate = max(self._max_rate, rate)
            b = min(int(rate / self._max_rate * (self.NUM_BUCKETS - 1)),
                    self.NUM_BUCKETS - 1)
            bucket = self._buckets[b]
            if len(bucket) >= self.BUCKET_CAP:
                bucket.pop(0)
            bucket.append((leader_bytes_in, leader_bytes_out, follower_bytes_in, cpu_util))

    def train(self) -> LinearRegressionModelParameters:
        with self._lock:
            rows = [r for b in self._buckets for r in b]
            if len(rows) < 4:
                return self.params
            arr = np.asarray(rows, np.float64)
            x, y = arr[:, :3], arr[:, 3]
            coef, *_ = np.linalg.lstsq(x, y, rcond=None)
            self.params = LinearRegressionModelParameters(
                coef_leader_bytes_in=float(coef[0]),
                coef_leader_bytes_out=float(coef[1]),
                coef_follower_bytes_in=float(coef[2]),
                trained=True, num_samples=len(rows))
            return self.params

    def predict(self, leader_bytes_in: float, leader_bytes_out: float,
                follower_bytes_in: float) -> Optional[float]:
        p = self.params
        if not p.trained:
            return None
        return (p.coef_leader_bytes_in * leader_bytes_in
                + p.coef_leader_bytes_out * leader_bytes_out
                + p.coef_follower_bytes_in * follower_bytes_in)
