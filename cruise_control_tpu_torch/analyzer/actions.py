"""Balancing actions, batched, and K7.

Counterpart of ``cruise_control_tpu/analyzer/actions.py``: a batch of K
candidate actions is a struct-of-arrays ``Candidates`` carrying precomputed
load/count deltas, so every goal scores and vetoes all K with elementwise
math; the accepted subset is applied in one pass.

``apply_candidates`` is kernel K7 (``csrc/apply_actions.cu``); its plain
twin ``apply_candidates_plain`` is the JAX package's sequence of masked
add-of-delta relocations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel
from cruise_control_tpu_torch.ops import cuda


class ActionType:
    """Reference: analyzer/ActionType.java:24-29."""

    INTER_BROKER_REPLICA_MOVEMENT = 0
    LEADERSHIP_MOVEMENT = 1
    INTRA_BROKER_REPLICA_MOVEMENT = 2
    INTER_BROKER_REPLICA_SWAP = 3
    INTRA_BROKER_REPLICA_SWAP = 4


@dataclasses.dataclass(frozen=True)
class Candidates:
    """K candidate actions with per-broker deltas (f32[K, 4] resource axes)."""

    action_type: torch.Tensor  # i32[K]
    replica: torch.Tensor  # i32[K] replica being moved / losing leadership
    src: torch.Tensor  # i32[K] source broker
    dest: torch.Tensor  # i32[K] destination broker
    dest_replica: torch.Tensor  # i32[K] leadership target / swap partner, -1 for moves
    partition: torch.Tensor  # i32[K]
    partition2: torch.Tensor  # i32[K] swap partner's partition (== partition otherwise)
    valid: torch.Tensor  # bool[K]
    delta_src: torch.Tensor  # f32[K, 4] load change on src broker
    delta_dest: torch.Tensor  # f32[K, 4] load change on dest broker
    d_replica_count: torch.Tensor  # i32[K]
    d_leader_count: torch.Tensor  # i32[K]
    d_potential_nw_out: torch.Tensor  # f32[K]
    d_leader_bytes_in_src: torch.Tensor  # f32[K]
    d_leader_bytes_in_dest: torch.Tensor  # f32[K]
    src_disk: torch.Tensor  # i32[K]
    dest_disk: torch.Tensor  # i32[K]

    @property
    def k(self) -> int:
        return self.action_type.shape[0]

    def is_move(self) -> torch.Tensor:
        return self.action_type == ActionType.INTER_BROKER_REPLICA_MOVEMENT

    def is_leadership(self) -> torch.Tensor:
        return self.action_type == ActionType.LEADERSHIP_MOVEMENT

    def is_intra_move(self) -> torch.Tensor:
        return self.action_type == ActionType.INTRA_BROKER_REPLICA_MOVEMENT

    def is_swap(self) -> torch.Tensor:
        return self.action_type == ActionType.INTER_BROKER_REPLICA_SWAP

    def is_intra_swap(self) -> torch.Tensor:
        return self.action_type == ActionType.INTRA_BROKER_REPLICA_SWAP

    def map(self, fn) -> "Candidates":
        return Candidates(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def make_candidates(model: TensorClusterModel, replica_ids: torch.Tensor,
                    dest_brokers: torch.Tensor, action_type: torch.Tensor,
                    dest_replica: torch.Tensor, valid: torch.Tensor,
                    dest_disks: Optional[torch.Tensor] = None) -> Candidates:
    """Assemble the delta fields for a K-batch of raw (replica, dest) picks
    (moves, leadership transfers, intra-broker moves)."""
    is_lead = action_type == ActionType.LEADERSHIP_MOVEMENT
    is_intra = action_type == ActionType.INTRA_BROKER_REPLICA_MOVEMENT
    r = replica_ids
    r2 = torch.where(dest_replica >= 0, dest_replica, 0)

    src = model.replica_broker[r]
    dest = torch.where(is_lead, model.replica_broker[r2],
                  torch.where(is_intra, src, dest_brokers.to(torch.int32)))

    ll_r = model.replica_load_leader[r]
    lf_r = model.replica_load_follower[r]
    lead_r = model.replica_is_leader[r]
    cur_load = torch.where(lead_r[:, None], ll_r, lf_r)
    lead_delta_src = lf_r - ll_r
    lead_delta_dest = model.replica_load_leader[r2] - model.replica_load_follower[r2]

    zero = torch.zeros_like(cur_load)
    delta_src = torch.where(is_lead[:, None], lead_delta_src,
                       torch.where(is_intra[:, None], zero, -cur_load))
    delta_dest = torch.where(is_lead[:, None], lead_delta_dest,
                        torch.where(is_intra[:, None], zero, cur_load))

    is_move = ~is_lead & ~is_intra
    d_replica_count = is_move.to(torch.int32)
    d_leader_count = (is_lead | (is_move & lead_r)).to(torch.int32)
    fzero = torch.zeros((), dtype=torch.float32, device=r.device)
    d_potential = torch.where(is_move, ll_r[:, Resource.NW_OUT], fzero)
    leader_nw_in_r = ll_r[:, Resource.NW_IN]
    leader_nw_in_r2 = model.replica_load_leader[r2, Resource.NW_IN]
    d_lbi_src = torch.where(is_lead | (is_move & lead_r), leader_nw_in_r, fzero)
    d_lbi_dest = torch.where(is_lead, leader_nw_in_r2,
                        torch.where(is_move & lead_r, leader_nw_in_r, fzero))

    src_disk = model.replica_disk[r]
    if dest_disks is None:
        dest_disks = model.broker_first_disk[torch.where(dest >= 0, dest, 0)]
    dest_disk = torch.where(is_lead, src_disk, dest_disks.to(torch.int32))
    part = model.replica_partition[r]
    return Candidates(
        action_type=action_type.to(torch.int32),
        replica=r.to(torch.int32),
        src=src.to(torch.int32),
        dest=dest.to(torch.int32),
        dest_replica=dest_replica.to(torch.int32),
        partition=part,
        partition2=part,
        valid=valid,
        delta_src=delta_src,
        delta_dest=delta_dest,
        d_replica_count=d_replica_count,
        d_leader_count=d_leader_count,
        d_potential_nw_out=d_potential,
        d_leader_bytes_in_src=d_lbi_src,
        d_leader_bytes_in_dest=d_lbi_dest,
        src_disk=src_disk,
        dest_disk=dest_disk,
    )


def make_swap_candidates(model: TensorClusterModel, replica_out: torch.Tensor,
                         replica_in: torch.Tensor, valid: torch.Tensor,
                         intra: bool = False) -> Candidates:
    """K-batch of replica SWAPS: ``replica_out`` (on src) trades places with
    ``replica_in`` (on dest), INTER_BROKER_REPLICA_SWAP, or with ``intra``
    the two exchange disks on one broker, INTRA_BROKER_REPLICA_SWAP (the
    disk goals read the exchange through src_disk / dest_disk and the
    partner).  Broker-axis delta fields carry the net effect: zero for an
    intra-broker swap."""
    r1 = replica_out
    r2 = torch.where(replica_in >= 0, replica_in, 0)
    k = r1.shape[0]
    dev = r1.device
    src = model.replica_broker[r1]
    dest = model.replica_broker[r2]
    lead1 = model.replica_is_leader[r1]
    lead2 = model.replica_is_leader[r2]
    ll1, ll2 = model.replica_load_leader[r1], model.replica_load_leader[r2]
    l1 = torch.where(lead1[:, None], ll1, model.replica_load_follower[r1])
    l2 = torch.where(lead2[:, None], ll2, model.replica_load_follower[r2])
    fzero = torch.zeros((), dtype=torch.float32, device=dev)
    if intra:
        zeros = torch.zeros((k,), dtype=torch.float32, device=dev)
        delta_src = delta_dest = torch.zeros_like(l1)
        action = ActionType.INTRA_BROKER_REPLICA_SWAP
        d_leader = torch.zeros((k,), dtype=torch.int32, device=dev)
        d_pot = d_lbi = zeros
    else:
        lbi1 = torch.where(lead1, ll1[:, Resource.NW_IN], fzero)
        lbi2 = torch.where(lead2, ll2[:, Resource.NW_IN], fzero)
        delta_src, delta_dest = l2 - l1, l1 - l2
        action = ActionType.INTER_BROKER_REPLICA_SWAP
        d_leader = lead1.to(torch.int32) - lead2.to(torch.int32)
        d_pot = ll1[:, Resource.NW_OUT] - ll2[:, Resource.NW_OUT]
        d_lbi = lbi1 - lbi2
    return Candidates(
        action_type=torch.full((k,), action, dtype=torch.int32, device=dev),
        replica=r1.to(torch.int32),
        src=src.to(torch.int32),
        dest=dest.to(torch.int32),
        dest_replica=r2.to(torch.int32),
        partition=model.replica_partition[r1],
        partition2=model.replica_partition[r2],
        valid=valid & (replica_in >= 0),
        delta_src=delta_src,
        delta_dest=delta_dest,
        d_replica_count=torch.zeros((k,), dtype=torch.int32, device=dev),
        d_leader_count=d_leader,
        d_potential_nw_out=d_pot,
        d_leader_bytes_in_src=d_lbi,
        d_leader_bytes_in_dest=d_lbi,
        src_disk=model.replica_disk[r1],
        dest_disk=model.replica_disk[r2],
    )


# ---------------------------------------------------------------------------
# K7 — apply
# ---------------------------------------------------------------------------

def apply_candidates_plain(model: TensorClusterModel, cand: Candidates,
                           apply_mask: torch.Tensor) -> TensorClusterModel:
    """The JAX package's ``apply_candidates``: masked add-of-delta
    relocations for moves, disk moves, leaderships, swaps and intra-swaps."""
    model = model.relocate_replicas(cand.replica, cand.dest, apply_mask & cand.is_move())
    model = model.relocate_replicas_to_disk(cand.replica, cand.dest_disk,
                                            apply_mask & cand.is_intra_move())
    safe_dest = torch.where(cand.dest_replica >= 0, cand.dest_replica, cand.replica)
    model = model.relocate_leadership(cand.replica, safe_dest,
                                      apply_mask & cand.is_leadership())
    swap_mask = apply_mask & cand.is_swap()
    model = model.relocate_replicas(cand.replica, cand.dest, swap_mask)
    model = model.relocate_replicas(safe_dest, cand.src, swap_mask)
    iswap_mask = apply_mask & cand.is_intra_swap()
    model = model.relocate_replicas_to_disk(cand.replica, cand.dest_disk, iswap_mask)
    model = model.relocate_replicas_to_disk(safe_dest, cand.src_disk, iswap_mask)
    return model


@cuda.counted("apply_actions")
def apply_candidates(model: TensorClusterModel, cand: Candidates,
                     apply_mask: torch.Tensor) -> TensorClusterModel:
    """K7.  Replaces ``cruise_control_tpu/analyzer/actions.py:233``
    ``apply_candidates`` (with ``tensor_model.py:240,266,282``).  Bound on
    the card: bytes (K·33 read plus the placement copies).  CPU tensors take
    ``apply_candidates_plain``; CUDA tensors launch one thread per lane with
    direct stores into fresh copies of replica_broker, replica_disk and
    replica_is_leader (exact because the selection keeps partitions unique
    per step, so no replica has two unmasked lanes); the input model stays
    untouched."""
    dev = model.device
    k = cand.k
    for name in ("action_type", "replica", "src", "dest", "dest_replica",
                 "src_disk", "dest_disk"):
        cuda.check(getattr(cand, name), name, torch.int32, (k,), dev)
    cuda.check(apply_mask, "apply_mask", torch.bool, (k,), dev)
    cuda.record("apply_actions", (model, cand, apply_mask))
    if cuda.on_cpu(model.replica_broker):
        return apply_candidates_plain(model, cand, apply_mask)
    rb = model.replica_broker.clone()
    rd = model.replica_disk.clone()
    lead = model.replica_is_leader.clone()
    if k > 0:
        cuda.launch("apply_actions", cand.action_type, cand.replica, cand.src,
                    cand.dest, cand.dest_replica, cand.src_disk, cand.dest_disk,
                    apply_mask, model.broker_first_disk, k,
                    model.num_replicas_padded, model.num_brokers, rb, rd, lead)
        apply_candidates.launches += 1
    return model.replace(replica_broker=rb, replica_disk=rd, replica_is_leader=lead)
