"""Aggregate cluster statistics.

Counterpart of ``cruise_control_tpu/model/stats.py`` (reference:
ClusterModelStats.java:30): per-resource avg/max/min/std-dev of broker
utilization, replica and leader count statistics and potential NW_OUT over
alive brokers, as plain torch reductions (K13 stays plain in this slice).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel


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


def _masked_stats(values: torch.Tensor, mask: torch.Tensor):
    n = mask.sum(dim=0).clamp(min=1)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    mean = torch.where(mask, values, zero).sum(dim=0) / n
    vmax = torch.where(mask, values, -math.inf).amax(dim=0)
    vmin = torch.where(mask, values, math.inf).amin(dim=0)
    var = torch.where(mask, (values - mean) ** 2, zero).sum(dim=0) / n
    return mean, vmax, vmin, torch.sqrt(var)


def compute_stats(model: TensorClusterModel) -> ClusterModelStats:
    """Populate stats over alive brokers (ClusterModelStats.populate)."""
    alive = model.alive_broker_mask()
    util = model.broker_load()
    mean, vmax, vmin, std = _masked_stats(util, alive[:, None])
    rc = model.broker_replica_counts().to(torch.float32)
    rc_mean, rc_max, rc_min, rc_std = _masked_stats(rc, alive)
    lc = model.broker_leader_counts().to(torch.float32)
    lc_mean, lc_max, lc_min, lc_std = _masked_stats(lc, alive)
    pnw = model.potential_leadership_load()
    pnw_mean, pnw_max, _, _ = _masked_stats(pnw, alive)
    return ClusterModelStats(
        resource_util_mean=mean, resource_util_max=vmax, resource_util_min=vmin,
        resource_util_std=std,
        replica_count_mean=rc_mean, replica_count_max=rc_max, replica_count_min=rc_min,
        replica_count_std=rc_std,
        leader_count_mean=lc_mean, leader_count_max=lc_max, leader_count_min=lc_min,
        leader_count_std=lc_std,
        potential_nw_out_mean=pnw_mean, potential_nw_out_max=pnw_max,
        num_alive_brokers=alive.sum().to(torch.int32),
        num_replicas=model.replica_valid.sum().to(torch.int32),
    )
