"""Synthetic cluster generator.

Counterpart of ``cruise_control_tpu/model/generator.py``: the same numpy RNG
stream (``np.random.default_rng(spec.seed)``, the same draws in the same
order), so a spec gives field-by-field the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel, build_model


@dataclasses.dataclass
class ClusterSpec:
    """Knobs mirroring the reference's TestConstants/ClusterProperty maps."""

    num_brokers: int = 3
    num_racks: int = 3
    num_topics: int = 5
    mean_partitions_per_topic: float = 20.0
    replication_factor: int = 2
    distribution: str = "uniform"  # uniform | linear | exponential
    # Mean per-partition leader loads (CPU %, NW_IN KB/s, NW_OUT KB/s, DISK MB)
    mean_cpu: float = 0.1
    mean_nw_in: float = 100.0
    mean_nw_out: float = 100.0
    mean_disk: float = 100.0
    # Broker capacities
    cpu_capacity: float = 100.0
    nw_in_capacity: float = 200000.0
    nw_out_capacity: float = 200000.0
    disk_capacity: float = 1000000.0
    disks_per_broker: int = 1  # > 1 builds a JBOD topology
    seed: int = 0


def generate_cluster(spec: ClusterSpec, pad_replicas_to: Optional[int] = None,
                     pad_replicas_to_multiple: Optional[int] = None,
                     device: Union[str, torch.device] = "cuda") -> TensorClusterModel:
    """Generate a random, skewed cluster on ``device`` (raises when it names
    CUDA and none is present)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    B = spec.num_brokers
    rf = spec.replication_factor
    assert spec.num_racks <= B

    parts_per_topic = np.maximum(
        1, rng.poisson(spec.mean_partitions_per_topic, size=spec.num_topics))
    P = int(parts_per_topic.sum())
    partition_topic = np.repeat(np.arange(spec.num_topics, dtype=np.int32), parts_per_topic)

    if spec.distribution == "uniform":
        weights = np.ones(B)
    elif spec.distribution == "linear":
        weights = np.arange(1, B + 1, dtype=np.float64)
    elif spec.distribution == "exponential":
        weights = np.exp(np.linspace(0.0, 3.0, B))
    else:
        raise ValueError(f"unknown distribution {spec.distribution!r}")
    weights = weights / weights.sum()

    R = P * rf
    if pad_replicas_to_multiple:
        k = int(pad_replicas_to_multiple)
        pad_replicas_to = max(pad_replicas_to or 0, ((R + k - 1) // k) * k)
    replica_partition = np.repeat(np.arange(P, dtype=np.int32), rf)
    replica_topic = partition_topic[replica_partition]
    replica_is_leader = (np.arange(R) % rf) == 0

    replica_broker = np.empty(R, np.int32)
    for p in range(P):
        chosen = rng.choice(B, size=rf, replace=False, p=weights)
        replica_broker[p * rf:(p + 1) * rf] = chosen

    leader_load = np.empty((P, NUM_RESOURCES), np.float32)
    leader_load[:, Resource.CPU] = rng.exponential(spec.mean_cpu, P)
    leader_load[:, Resource.NW_IN] = rng.exponential(spec.mean_nw_in, P)
    leader_load[:, Resource.NW_OUT] = rng.exponential(spec.mean_nw_out, P)
    leader_load[:, Resource.DISK] = rng.exponential(spec.mean_disk, P)

    follower_load = leader_load.copy()
    follower_load[:, Resource.NW_OUT] = 0.0
    follower_load[:, Resource.CPU] *= 0.4  # follower CPU fraction heuristic

    broker_capacity = np.tile(
        np.array([spec.cpu_capacity, spec.nw_in_capacity, spec.nw_out_capacity,
                  spec.disk_capacity], np.float32), (B, 1))
    broker_rack = (np.arange(B) % spec.num_racks).astype(np.int32)

    disk_broker = disk_capacity = replica_disk = None
    if spec.disks_per_broker > 1:
        dpb = spec.disks_per_broker
        disk_broker = np.repeat(np.arange(B, dtype=np.int32), dpb)
        disk_capacity = np.full(B * dpb, spec.disk_capacity / dpb, np.float32)
        replica_disk = (replica_broker * dpb
                        + (rng.random(R) ** 2 * dpb).astype(np.int32)).astype(np.int32)

    return build_model(
        disk_broker=disk_broker,
        disk_capacity=disk_capacity,
        replica_disk=replica_disk,
        replica_broker=replica_broker,
        replica_partition=replica_partition,
        replica_topic=replica_topic,
        replica_is_leader=replica_is_leader,
        replica_load_leader=leader_load[replica_partition],
        replica_load_follower=follower_load[replica_partition],
        broker_capacity=broker_capacity,
        broker_rack=broker_rack,
        partition_topic=partition_topic,
        pad_replicas_to=pad_replicas_to,
        device=dev,
    )
