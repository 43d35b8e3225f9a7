"""The struct-of-arrays tensor cluster model.

Counterpart of ``cruise_control_tpu/model/tensor_model.py``: the whole
cluster state is a frozen dataclass of flat tensors over three axes —
replicas (R), brokers (B), partitions (P) — plus static Python ints, and
every aggregate is a segment reduction recomputed from it.  Mutations return
a new model (``replace``); nothing is updated in place.

Each replica carries a leader and a follower load row (f32[R, 4]); the
actual load is selected by the leadership flag, so moving leadership is an
index flip.  Padded rows are masked by ``*_valid``.  Types follow the JAX
package: int32 ids, bool masks, float32 loads, int8 broker states.

``replica_mesh`` (set by ``parallel.mesh.shard_model_replica_axis``) marks a
model whose replica axis is sharded over a search mesh.  It is a marker
only: the tensors stay whole, and the model's own queries reduce over all
rows on this process and issue no collective.  An optimizer running under
the same mesh splits its reductions into K1 over the rank's rows
(``aggregates(rows)``, ``disk_load(rows)``) and combines them across the
ranks with K15 (``parallel.collectives.sharded_broker_aggregates``,
``sharded_disk_load``, reached from ``BrokerArrays.from_model(...,
mesh=...)``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cruise_control_tpu_torch import native
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.ops import cuda
from cruise_control_tpu_torch.ops.segment import (broker_aggregates,
                                                  masked_segment_count,
                                                  masked_segment_sum, segment_sum)


class BrokerState:
    """Broker liveness states (reference: model/Broker.java:37)."""

    ALIVE = 0
    DEAD = 1
    NEW = 2
    DEMOTED = 3
    BAD_DISKS = 4


# Tensor fields in declaration order; ``STATIC_FIELDS`` are Python ints.
TENSOR_FIELDS = (
    "replica_broker", "replica_partition", "replica_topic", "replica_is_leader",
    "replica_load_leader", "replica_load_follower", "replica_valid",
    "replica_original_broker", "replica_offline", "replica_disk",
    "broker_capacity", "broker_rack", "broker_host", "broker_state",
    "broker_valid", "disk_broker", "disk_capacity", "disk_valid",
    "broker_first_disk", "broker_disks", "partition_topic", "partition_valid",
    "partition_replicas",
)
STATIC_FIELDS = ("num_brokers", "num_racks", "num_hosts", "num_topics",
                 "num_partitions", "num_disks", "max_rf")


@dataclasses.dataclass(frozen=True)
class TensorClusterModel:
    # --- replica axis (R) ---
    replica_broker: torch.Tensor  # i32[R] current broker id
    replica_partition: torch.Tensor  # i32[R] global partition id
    replica_topic: torch.Tensor  # i32[R] topic id
    replica_is_leader: torch.Tensor  # bool[R]
    replica_load_leader: torch.Tensor  # f32[R, 4] utilization if leader
    replica_load_follower: torch.Tensor  # f32[R, 4] utilization if follower
    replica_valid: torch.Tensor  # bool[R] padding mask
    replica_original_broker: torch.Tensor  # i32[R] broker at model build
    replica_offline: torch.Tensor  # bool[R] replica on dead broker/disk
    replica_disk: torch.Tensor  # i32[R] global disk index (-1 when not JBOD)
    # --- broker axis (B) ---
    broker_capacity: torch.Tensor  # f32[B, 4]
    broker_rack: torch.Tensor  # i32[B]
    broker_host: torch.Tensor  # i32[B]
    broker_state: torch.Tensor  # i8[B] BrokerState
    broker_valid: torch.Tensor  # bool[B]
    # --- disk axis (D) --- (D == B when not JBOD; one implicit disk/broker)
    disk_broker: torch.Tensor  # i32[D]
    disk_capacity: torch.Tensor  # f32[D], < 0 means dead disk
    disk_valid: torch.Tensor  # bool[D]
    broker_first_disk: torch.Tensor  # i32[B] default landing disk
    broker_disks: torch.Tensor  # i32[B, max_disks_per_broker] (-1 pad)
    # --- partition axis (P) ---
    partition_topic: torch.Tensor  # i32[P]
    partition_valid: torch.Tensor  # bool[P]
    partition_replicas: torch.Tensor  # i32[P, max_rf] replica ids (-1 pad)
    # --- static metadata ---
    num_brokers: int
    num_racks: int
    num_hosts: int
    num_topics: int
    num_partitions: int
    num_disks: int
    max_rf: int
    # The search mesh the replica axis is sharded over (None: unsharded).
    replica_mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    def replace(self, **changes) -> "TensorClusterModel":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.replica_broker.device

    def to(self, device) -> "TensorClusterModel":
        return self.replace(**{f: getattr(self, f).to(device)
                               for f in TENSOR_FIELDS})

    @property
    def num_replicas_padded(self) -> int:
        return self.replica_broker.shape[0]

    # ------------------------------------------------------------------
    # Load queries (reference: Load.java:29, ClusterModel.java:1299-1330)
    # ------------------------------------------------------------------
    def replica_load(self) -> torch.Tensor:
        """f32[R, 4] actual utilization given current leadership."""
        return torch.where(self.replica_is_leader[:, None],
                           self.replica_load_leader, self.replica_load_follower)

    def aggregates(self, rows: slice = slice(None)):
        """K1's five per-broker sums (load, replica count, leader count,
        potential NW-out, leader bytes-in) over the replica ``rows``:
        fixed-order, no float atomics on the card (``index_add_`` would add
        the loads with atomics there)."""
        return broker_aggregates(self.replica_broker[rows], self.replica_valid[rows],
                                 self.replica_is_leader[rows],
                                 self.replica_load_leader[rows],
                                 self.replica_load_follower[rows], self.num_brokers)

    def broker_load(self) -> torch.Tensor:
        """f32[B, 4] per-broker utilization."""
        if not cuda.on_cpu(self.replica_broker):
            return self.aggregates()[0]
        return masked_segment_sum(self.replica_load(), self.replica_broker,
                                  self.num_brokers, self.replica_valid)

    def potential_leadership_load(self) -> torch.Tensor:
        """f32[B] potential NW_OUT per broker if all its replicas led."""
        if not cuda.on_cpu(self.replica_broker):
            return self.aggregates()[3]
        return masked_segment_sum(self.replica_load_leader[:, Resource.NW_OUT],
                                  self.replica_broker, self.num_brokers,
                                  self.replica_valid)

    def broker_replica_counts(self) -> torch.Tensor:
        """i32[B] replicas per broker."""
        return masked_segment_count(self.replica_broker, self.num_brokers,
                                    self.replica_valid)

    def broker_leader_counts(self) -> torch.Tensor:
        """i32[B] leader replicas per broker."""
        return masked_segment_count(self.replica_broker, self.num_brokers,
                                    self.replica_valid & self.replica_is_leader)

    def broker_leader_bytes_in(self) -> torch.Tensor:
        """f32[B] leader NW_IN per broker."""
        if not cuda.on_cpu(self.replica_broker):
            return self.aggregates()[4]
        load = torch.where(self.replica_is_leader,
                           self.replica_load_leader[:, Resource.NW_IN],
                           torch.zeros((), device=self.device))
        return masked_segment_sum(load, self.replica_broker, self.num_brokers,
                                  self.replica_valid)

    def topic_broker_replica_counts(self) -> torch.Tensor:
        """i32[T, B] replicas of each topic on each broker."""
        flat = self.replica_topic * self.num_brokers + self.replica_broker
        counts = masked_segment_count(flat, self.num_topics * self.num_brokers,
                                      self.replica_valid)
        return counts.reshape(self.num_topics, self.num_brokers)

    def topic_leader_counts(self) -> torch.Tensor:
        """i32[T, B] leaders of each topic on each broker
        (MinTopicLeadersPerBrokerGoal's input)."""
        flat = self.replica_topic * self.num_brokers + self.replica_broker
        counts = masked_segment_count(flat, self.num_topics * self.num_brokers,
                                      self.replica_valid & self.replica_is_leader)
        return counts.reshape(self.num_topics, self.num_brokers)

    def disk_load(self, rows: slice = slice(None)) -> torch.Tensor:
        """f32[D] disk utilization (the DISK column of ``replica_load`` summed
        per disk over the valid replicas that sit on a disk), over the
        replica ``rows``.  On the card K1's ``segment_sum`` adds each disk's
        rows in the CPU's row order."""
        rd = self.replica_disk[rows]
        disk_ids = torch.where(rd >= 0, rd, 0)
        mask = self.replica_valid[rows] & (rd >= 0)
        disk = self.replica_load()[rows, Resource.DISK]
        return segment_sum(disk[:, None].contiguous(), disk_ids, mask, self.num_disks,
                           "disk")[:, 0]

    def preferred_leader_replica(self) -> torch.Tensor:
        """i32[P] the preferred (first-listed) replica of each partition
        (PreferredLeaderElectionGoal: replica[0] should lead)."""
        return self.partition_replicas[:, 0]

    # ------------------------------------------------------------------
    # Topology / placement queries
    # ------------------------------------------------------------------
    def partition_rack_counts(self) -> torch.Tensor:
        """i32[P, num_racks] replicas of each partition per rack."""
        replica_rack = self.broker_rack[self.replica_broker]
        flat = self.replica_partition * self.num_racks + replica_rack
        counts = masked_segment_count(flat, self.num_partitions * self.num_racks,
                                      self.replica_valid)
        return counts.reshape(self.num_partitions, self.num_racks)

    def partition_replication_factor(self) -> torch.Tensor:
        """i32[P] current replication factor per partition."""
        return masked_segment_count(self.replica_partition, self.num_partitions,
                                    self.replica_valid)

    def partition_leader_replica(self) -> torch.Tensor:
        """i32[P] replica index of each partition's leader (-1 if none)."""
        r_idx = torch.arange(self.num_replicas_padded, dtype=torch.int32,
                             device=self.device)
        mask = self.replica_valid & self.replica_is_leader
        seg = torch.where(mask, self.replica_partition, 0)
        out = torch.full((self.num_partitions,), -1, dtype=torch.int32,
                         device=self.device)
        return out.scatter_reduce_(0, seg.long(), torch.where(mask, r_idx, -1),
                                   "amax")

    def replica_offline_now(self) -> torch.Tensor:
        """bool[R] — replica sits on a dead broker or dead disk, or was
        reported offline at model build and has not moved since."""
        on_dead_broker = self.broker_state[self.replica_broker] == BrokerState.DEAD
        disk_ids = torch.where(self.replica_disk >= 0, self.replica_disk, 0)
        on_dead_disk = (self.replica_disk >= 0) & (self.disk_capacity[disk_ids] < 0.0)
        sticky = self.replica_offline & (self.replica_broker == self.replica_original_broker)
        return (on_dead_broker | on_dead_disk | sticky) & self.replica_valid

    def alive_broker_mask(self) -> torch.Tensor:
        """bool[B] brokers that can receive replicas (DEAD excluded)."""
        return self.broker_valid & (self.broker_state != BrokerState.DEAD)

    def new_broker_mask(self) -> torch.Tensor:
        return self.broker_valid & (self.broker_state == BrokerState.NEW)

    def demoted_broker_mask(self) -> torch.Tensor:
        return self.broker_valid & (self.broker_state == BrokerState.DEMOTED)

    # ------------------------------------------------------------------
    # Mutations (pure; return a new model)
    # ------------------------------------------------------------------
    def relocate_replicas(self, replica_ids: torch.Tensor, dest_brokers: torch.Tensor,
                          apply_mask: Optional[torch.Tensor] = None) -> "TensorClusterModel":
        """Move replicas to destination brokers.  Scatter-*add* of deltas, as
        in the JAX package: masked slots contribute 0, so duplicate replica
        ids in one batch (at most one unmasked) are well-defined."""
        if apply_mask is None:
            apply_mask = torch.ones(replica_ids.shape, dtype=torch.bool,
                                    device=self.device)
        dest = dest_brokers.to(torch.int32)
        current = self.replica_broker[replica_ids]
        delta = torch.where(apply_mask, dest - current, 0)
        new_broker = self.replica_broker.clone().index_add_(0, replica_ids, delta)
        cur_disk = self.replica_disk[replica_ids]
        dest_disk = self.broker_first_disk[dest]
        disk_delta = torch.where(apply_mask, dest_disk - cur_disk, 0)
        new_disk = self.replica_disk.clone().index_add_(0, replica_ids, disk_delta)
        return self.replace(replica_broker=new_broker, replica_disk=new_disk)

    def relocate_leadership(self, src_replica_ids: torch.Tensor,
                            dest_replica_ids: torch.Tensor,
                            apply_mask: Optional[torch.Tensor] = None) -> "TensorClusterModel":
        """Transfer leadership: -1 at the old leader, +1 at the new one, on an
        int view (masked duplicates contribute 0)."""
        if apply_mask is None:
            apply_mask = torch.ones(src_replica_ids.shape, dtype=torch.bool,
                                    device=self.device)
        lead = self.replica_is_leader.to(torch.int32)
        d = apply_mask.to(torch.int32)
        lead = lead.index_add_(0, src_replica_ids, -d)
        lead = lead.index_add_(0, dest_replica_ids, d)
        return self.replace(replica_is_leader=lead != 0)

    def relocate_replicas_to_disk(self, replica_ids: torch.Tensor,
                                  dest_disks: torch.Tensor,
                                  apply_mask: Optional[torch.Tensor] = None) -> "TensorClusterModel":
        """Intra-broker move: reassign replicas across a broker's disks."""
        if apply_mask is None:
            apply_mask = torch.ones(replica_ids.shape, dtype=torch.bool,
                                    device=self.device)
        cur = self.replica_disk[replica_ids]
        delta = torch.where(apply_mask, dest_disks.to(torch.int32) - cur, 0)
        return self.replace(
            replica_disk=self.replica_disk.clone().index_add_(0, replica_ids, delta))

    def set_broker_state(self, broker_id: int, state: int) -> "TensorClusterModel":
        """Set a broker's liveness state; DEAD marks its replicas offline."""
        new_state = self.broker_state.clone()
        new_state[broker_id] = state
        new_offline = self.replica_offline
        if state == BrokerState.DEAD:
            on_broker = (self.replica_broker == broker_id) & self.replica_valid
            new_offline = self.replica_offline | on_broker
        return self.replace(broker_state=new_state, replica_offline=new_offline)

    def with_placement(self, replica_broker: torch.Tensor, replica_is_leader: torch.Tensor,
                       replica_disk: Optional[torch.Tensor] = None) -> "TensorClusterModel":
        """Swap in a hypothetical replica placement (broker assignment,
        leadership, optionally disks) keeping every other axis untouched —
        the executor's balancedness scorer evaluates blends of the
        before/after placements this way.  Nothing is copied or written:
        the new model holds the given tensors."""
        kwargs = dict(replica_broker=replica_broker, replica_is_leader=replica_is_leader)
        if replica_disk is not None:
            kwargs["replica_disk"] = replica_disk
        return self.replace(**kwargs)

    # ------------------------------------------------------------------
    # Sanity (reference: ClusterModel.sanityCheck, ClusterModel.java:1144)
    # ------------------------------------------------------------------
    def sanity_check(self) -> None:
        """Host-side invariant checks; raises on violation."""
        rb = self.replica_broker.cpu().numpy()
        valid = self.replica_valid.cpu().numpy()
        bvalid = self.broker_valid.cpu().numpy()
        if not ((rb[valid] >= 0) & (rb[valid] < self.num_brokers)).all():
            raise ValueError("replica assigned to out-of-range broker")
        if not bvalid[rb[valid]].all():
            raise ValueError("replica assigned to invalid broker slot")
        rp = self.replica_partition.cpu().numpy()
        lead = self.replica_is_leader.cpu().numpy()
        leaders = np.bincount(rp[valid & lead], minlength=self.num_partitions)
        rf = np.bincount(rp[valid], minlength=self.num_partitions)
        bad = (rf > 0) & (leaders != 1)
        if bad.any():
            raise ValueError(f"partitions without exactly one leader: {np.nonzero(bad)[0][:10]}")
        pairs = rp[valid].astype(np.int64) * self.num_brokers + rb[valid]
        if pairs.size != np.unique(pairs).size:
            raise ValueError("partition has multiple replicas on one broker")
        rd = self.replica_disk.cpu().numpy()
        disk_owner = self.disk_broker.cpu().numpy()
        has_disk = valid & (rd >= 0)
        if not (disk_owner[rd[has_disk]] == rb[has_disk]).all():
            raise ValueError("replica assigned to a disk on a different broker")


def build_model(
    replica_broker: np.ndarray,
    replica_partition: np.ndarray,
    replica_topic: np.ndarray,
    replica_is_leader: np.ndarray,
    replica_load_leader: np.ndarray,
    replica_load_follower: np.ndarray,
    broker_capacity: np.ndarray,
    broker_rack: np.ndarray,
    device: torch.device,
    broker_host: Optional[np.ndarray] = None,
    broker_state: Optional[np.ndarray] = None,
    partition_topic: Optional[np.ndarray] = None,
    replica_disk: Optional[np.ndarray] = None,
    disk_broker: Optional[np.ndarray] = None,
    disk_capacity: Optional[np.ndarray] = None,
    pad_replicas_to: Optional[int] = None,
    pad_brokers_to: Optional[int] = None,
) -> TensorClusterModel:
    """Assemble a TensorClusterModel from host numpy arrays, with padding,
    on ``device`` (the JAX package's ``build_model``)."""
    R = int(replica_broker.shape[0])
    B = int(broker_capacity.shape[0])
    Rp = int(pad_replicas_to or R)
    Bp = int(pad_brokers_to or B)
    if Rp < R or Bp < B:
        raise ValueError("padding must not truncate")

    if broker_host is None:
        broker_host = np.arange(B, dtype=np.int32)
    if broker_state is None:
        broker_state = np.zeros(B, np.int8)
    num_topics = int(replica_topic.max()) + 1 if R else 1
    num_partitions = int(replica_partition.max()) + 1 if R else 1
    if partition_topic is None:
        partition_topic = np.zeros(num_partitions, np.int32)
        partition_topic[replica_partition] = replica_topic
    P = int(partition_topic.shape[0])
    num_racks = int(broker_rack.max()) + 1 if B else 1
    num_hosts = int(broker_host.max()) + 1 if B else 1

    if disk_broker is None:
        disk_broker = np.arange(Bp, dtype=np.int32)
        disk_capacity = np.zeros(Bp, np.float32)
        disk_capacity[:B] = broker_capacity[:, Resource.DISK]
        disk_valid = np.zeros(Bp, bool)
        disk_valid[:B] = True
        if replica_disk is None:
            replica_disk = replica_broker.astype(np.int32)
    else:
        assert disk_capacity is not None and replica_disk is not None
        disk_valid = np.ones(disk_broker.shape[0], bool)
    D = int(disk_broker.shape[0])
    broker_first_disk = np.zeros(Bp, np.int32)
    disks_of: dict = {}
    for d in range(D - 1, -1, -1):
        b = int(disk_broker[d])
        if 0 <= b < Bp:
            broker_first_disk[b] = d
            disks_of.setdefault(b, []).insert(0, d)
    max_dpb = max((len(v) for v in disks_of.values()), default=1)
    broker_disks = np.full((Bp, max_dpb), -1, np.int32)
    for b, ds in disks_of.items():
        broker_disks[b, : len(ds)] = ds

    def pad(arr, n, fill=0):
        out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    replica_valid = np.zeros(Rp, bool)
    replica_valid[:R] = True
    broker_valid = np.zeros(Bp, bool)
    broker_valid[:B] = True

    rf_counts = np.bincount(replica_partition, minlength=P)
    max_rf = int(rf_counts.max()) if R else 1
    partition_replicas = native.build_partition_replicas(
        replica_partition.astype(np.int32), P, max_rf)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TensorClusterModel(
        replica_broker=t(pad(replica_broker.astype(np.int32), Rp)),
        replica_partition=t(pad(replica_partition.astype(np.int32), Rp)),
        replica_topic=t(pad(replica_topic.astype(np.int32), Rp)),
        replica_is_leader=t(pad(replica_is_leader.astype(bool), Rp)),
        replica_load_leader=t(pad(replica_load_leader.astype(np.float32), Rp)),
        replica_load_follower=t(pad(replica_load_follower.astype(np.float32), Rp)),
        replica_valid=t(replica_valid),
        replica_original_broker=t(pad(replica_broker.astype(np.int32), Rp)),
        replica_offline=t(np.zeros(Rp, bool)),
        replica_disk=t(pad(replica_disk.astype(np.int32), Rp)),
        broker_capacity=t(pad(broker_capacity.astype(np.float32), Bp)),
        broker_rack=t(pad(broker_rack.astype(np.int32), Bp)),
        broker_host=t(pad(broker_host.astype(np.int32), Bp)),
        broker_state=t(pad(broker_state.astype(np.int8), Bp)),
        broker_valid=t(broker_valid),
        disk_broker=t(disk_broker.astype(np.int32)),
        disk_capacity=t(disk_capacity.astype(np.float32)),
        disk_valid=t(disk_valid),
        broker_first_disk=t(broker_first_disk),
        broker_disks=t(broker_disks),
        partition_topic=t(partition_topic.astype(np.int32)),
        partition_valid=t(np.ones(P, bool)),
        partition_replicas=t(partition_replicas),
        num_brokers=Bp,
        num_racks=num_racks,
        num_hosts=num_hosts,
        num_topics=num_topics,
        num_partitions=P,
        num_disks=D,
        max_rf=max_rf,
    )
