"""Aggregate cluster statistics.

Counterpart of ``cruise_control_tpu/model/stats.py`` (reference:
ClusterModelStats.java:30): per-resource avg/max/min/std-dev of broker
utilization, replica and leader count statistics and potential NW_OUT over
alive brokers.  The reductions run as kernel K13 (``column_stats``,
``csrc/cluster_stats.cu``) with the plain twin ``column_stats_plain``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel
from cruise_control_tpu_torch.ops import cuda
from cruise_control_tpu_torch.ops.segment import broker_aggregates


@dataclasses.dataclass(frozen=True)
class ClusterModelStats:
    resource_util_mean: torch.Tensor  # f32[4]
    resource_util_max: torch.Tensor
    resource_util_min: torch.Tensor
    resource_util_std: torch.Tensor
    replica_count_mean: torch.Tensor
    replica_count_max: torch.Tensor
    replica_count_min: torch.Tensor
    replica_count_std: torch.Tensor
    leader_count_mean: torch.Tensor
    leader_count_max: torch.Tensor
    leader_count_min: torch.Tensor
    leader_count_std: torch.Tensor
    potential_nw_out_mean: torch.Tensor
    potential_nw_out_max: torch.Tensor
    num_alive_brokers: torch.Tensor
    num_replicas: torch.Tensor

    def to_dict(self) -> Dict[str, object]:
        def ser(x):
            x = x.detach().cpu()
            return x.item() if x.dim() == 0 else x.tolist()

        out: Dict[str, object] = {}
        for name in ("resource_util_mean", "resource_util_max", "resource_util_min",
                     "resource_util_std"):
            vals = ser(getattr(self, name))
            out[name] = {r.resource_name: vals[r.value] for r in Resource}
        for name in ("replica_count_mean", "replica_count_max", "replica_count_min",
                     "replica_count_std", "leader_count_mean", "leader_count_max",
                     "leader_count_min", "leader_count_std", "potential_nw_out_mean",
                     "potential_nw_out_max", "num_alive_brokers", "num_replicas"):
            out[name] = ser(getattr(self, name))
        return out


def column_stats_plain(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32[4, C] — (mean, max, min, std) of each column of ``values`` f32[B, C]
    over the rows where ``mask`` bool[B] is set (the JAX package's
    ``_masked_stats``, ``cruise_control_tpu/model/stats.py:70``)."""
    m = mask[:, None]
    n = m.sum(dim=0).clamp(min=1)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    mean = torch.where(m, values, zero).sum(dim=0) / n
    vmax = torch.where(m, values, -math.inf).amax(dim=0)
    vmin = torch.where(m, values, math.inf).amin(dim=0)
    var = torch.where(m, (values - mean) ** 2, zero).sum(dim=0) / n
    return torch.stack([mean, vmax, vmin, torch.sqrt(var)])


@cuda.counted("cluster_stats")
def column_stats(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K13.  Replaces ``cruise_control_tpu/model/stats.py:79``
    ``compute_stats``'s masked reductions.  Bound on the card: bytes
    (B·(4C+1) read, 16C written; a few KB, so a launch costs more than the
    work).  CPU tensors take ``column_stats_plain``; CUDA tensors launch one
    block per column: a fixed-order strided pass and fixed tree reductions
    for the count, sum, max and min, then a second pass for the squared
    deviations — deterministic, and within 1e-6 relative of the plain
    version (the sums are taken in another order)."""
    dev = values.device
    b = values.shape[0]
    c = values.shape[1] if values.dim() == 2 else -1
    cuda.check(values, "values", torch.float32, (b, c), dev)
    cuda.check(mask, "mask", torch.bool, (b,), dev)
    cuda.record("cluster_stats", (values, mask))
    if cuda.on_cpu(values):
        return column_stats_plain(values, mask)
    out = torch.empty((4, c), dtype=torch.float32, device=dev)
    if c > 0:
        cuda.launch("cluster_stats", values, mask, b, c, out)
        column_stats.launches += 1
    return out


def compute_stats(model: TensorClusterModel) -> ClusterModelStats:
    """Populate stats over alive brokers (ClusterModelStats.populate): one
    K1 call for the per-broker columns util[4], replica count, leader count
    and potential NW_OUT, one K13 call over them."""
    alive = model.alive_broker_mask()
    load, rc, lc, pnw, _ = broker_aggregates(
        model.replica_broker, model.replica_valid, model.replica_is_leader,
        model.replica_load_leader, model.replica_load_follower, model.num_brokers)
    cols = torch.cat([load, rc.to(torch.float32)[:, None], lc.to(torch.float32)[:, None],
                      pnw[:, None]], dim=1).contiguous()
    mean, vmax, vmin, std = column_stats(cols, alive)
    return ClusterModelStats(
        resource_util_mean=mean[:4], resource_util_max=vmax[:4],
        resource_util_min=vmin[:4], resource_util_std=std[:4],
        replica_count_mean=mean[4], replica_count_max=vmax[4],
        replica_count_min=vmin[4], replica_count_std=std[4],
        leader_count_mean=mean[5], leader_count_max=vmax[5],
        leader_count_min=vmin[5], leader_count_std=std[5],
        potential_nw_out_mean=mean[6], potential_nw_out_max=vmax[6],
        num_alive_brokers=alive.sum().to(torch.int32),
        num_replicas=model.replica_valid.sum().to(torch.int32),
    )
