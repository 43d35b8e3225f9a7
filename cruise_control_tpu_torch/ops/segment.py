"""Segment reductions used by the tensor cluster model, and K1.

Counterpart of ``cruise_control_tpu/ops/segment.py``.  The plain reductions
are ``index_add_`` with the JAX package's padding+mask idiom: masked rows
point at segment 0 and contribute zero.
Integer counts stay int32 and exact on every backend.

``broker_aggregates`` is kernel K1 (``csrc/broker_aggregates.cu``): the five
per-broker aggregates ``analyzer.state.BrokerArrays`` needs, in one pass
over the replica axis.  Its plain twin ``broker_aggregates_plain`` is the
five ``masked_segment_*`` calls of ``model/tensor_model.py``.
``segment_sum`` is the same fixed-order design for any f32[N, C] rows (the
selection's per-broker round sums, the replicas' DISK loads per disk and
the disks' sums per broker of the intra-broker disk goals); its plain twin
is ``masked_segment_sum``.
On the card neither adds floats with atomics, so both are run-to-run
identical and safe to replay in a CUDA graph.

``shard_combine`` is kernel K15 (``csrc/shard_combine.cu``): under a model
sharded along the replica axis (``parallel/mesh.py``
``shard_model_replica_axis``) each rank runs K1 or ``segment_sum`` over its
own rows, the ranks' partials are all-gathered and K15 sums them in rank
order (``parallel/collectives.py`` ``sharded_broker_aggregates``,
``sharded_disk_load``) — the psum XLA inserts into the JAX package's
sharded programs.  Its plain twin is ``shard_combine_plain``.  The split changes
the float order of the aggregates (each rank's rows, then the ranks), so
they agree with the unsharded ones within rtol 1e-5, the JAX package's
tolerance for the same split; with one rank they are equal bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.ops import cuda


def masked_segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``values`` rows into ``num_segments`` buckets, zeroing masked rows."""
    if mask is not None:
        m = mask.reshape((-1,) + (1,) * (values.dim() - 1))
        values = torch.where(m, values, torch.zeros((), dtype=values.dtype,
                                                    device=values.device))
        segment_ids = torch.where(mask, segment_ids, 0)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


def masked_segment_count(segment_ids: torch.Tensor, num_segments: int,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count rows per segment. Returns i32[num_segments]."""
    ones = torch.ones(segment_ids.shape[0], dtype=torch.int32,
                      device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0)
        segment_ids = torch.where(mask, segment_ids, 0)
    out = torch.zeros((num_segments,), dtype=torch.int32,
                      device=segment_ids.device)
    return out.index_add_(0, segment_ids, ones)


# ---------------------------------------------------------------------------
# K1 — broker aggregates
# ---------------------------------------------------------------------------

# What the segments of a ``segment_sum`` are: the selection's per-broker
# round sums, the replicas' DISK loads per disk (``disk_load``), or the
# disks' sums per broker (the intra-broker disk goals' bands and excess).
SEGMENT_MODES = ("round", "disk", "disk_broker")
_SUM_COUNTS = cuda.mode_counters("segment_sum", SEGMENT_MODES)


@cuda.counted("segment_sum")
def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                mask: torch.Tensor, num_segments: int,
                segments: str = "round") -> torch.Tensor:
    """f32[S, C] — the rows of ``values`` whose ``mask`` is set, summed per
    segment.  K1 family (``csrc/broker_aggregates.cu`` ``cc_segment_sum``);
    replaces the float scatter-adds of ``select_batched``'s round sums
    (``cruise_control_tpu/analyzer/optimizer.py:663-668``), of
    ``tensor_model.py:170`` ``disk_load`` and of the disk goals' per-broker
    sums (``goals/kernels.py:100,163-167``).  Bound on the card: bytes
    (N·(4C+5) read, S·4C written).  CPU tensors take ``masked_segment_sum``
    (``index_add_`` in row order); CUDA tensors launch one block per
    segment that adds its rows in that row order: deterministic, no float
    atomics, the CPU's bits.  ``segments`` names the mode
    (``SEGMENT_MODES``) for the launch counts."""
    dev = values.device
    n = values.shape[0]
    c = values.shape[1] if values.dim() == 2 else -1
    cuda.check(values, "values", torch.float32, (n, c), dev)
    cuda.check(segment_ids, "segment_ids", torch.int32, (n,), dev)
    cuda.check(mask, "mask", torch.bool, (n,), dev)
    cuda.record("segment_sum", (values, segment_ids, mask, num_segments, segments))
    if cuda.on_cpu(values):
        return masked_segment_sum(values, segment_ids, num_segments, mask)
    if not 1 <= c <= 16:
        raise ValueError(f"segment_sum takes 1..16 channels, got {c}")
    out = torch.empty((num_segments, c), dtype=torch.float32, device=dev)
    if num_segments > 0:
        cuda.launch("segment_sum", values, segment_ids, mask, n, c, num_segments, out)
        segment_sum.launches += 1
        _SUM_COUNTS[segments].launches += 1
    return out


BrokerAggregates = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor]


def broker_aggregates_plain(replica_broker: torch.Tensor,
                            replica_valid: torch.Tensor,
                            replica_is_leader: torch.Tensor,
                            load_leader: torch.Tensor,
                            load_follower: torch.Tensor,
                            num_brokers: int) -> BrokerAggregates:
    """(load f32[B,4], replica_count i32[B], leader_count i32[B],
    potential_nw_out f32[B], leader_bytes_in f32[B]) — the JAX package's
    ``broker_load``, ``broker_replica_counts``, ``broker_leader_counts``,
    ``potential_leadership_load`` and ``broker_leader_bytes_in``."""
    load = torch.where(replica_is_leader[:, None], load_leader, load_follower)
    lbi = torch.where(replica_is_leader, load_leader[:, Resource.NW_IN],
                      torch.zeros((), dtype=load_leader.dtype,
                                  device=load_leader.device))
    return (
        masked_segment_sum(load, replica_broker, num_brokers, replica_valid),
        masked_segment_count(replica_broker, num_brokers, replica_valid),
        masked_segment_count(replica_broker, num_brokers,
                             replica_valid & replica_is_leader),
        masked_segment_sum(load_leader[:, Resource.NW_OUT], replica_broker,
                           num_brokers, replica_valid),
        masked_segment_sum(lbi, replica_broker, num_brokers, replica_valid),
    )


@cuda.counted("broker_aggregates")
def broker_aggregates(replica_broker: torch.Tensor, replica_valid: torch.Tensor,
                      replica_is_leader: torch.Tensor, load_leader: torch.Tensor,
                      load_follower: torch.Tensor,
                      num_brokers: int) -> BrokerAggregates:
    """K1.  Replaces the masked segment sums/counts of
    ``cruise_control_tpu/ops/segment.py:22-42`` as reached through
    ``BrokerArrays.from_model`` (``analyzer/state.py:37``).  Bound on the
    card: bytes (R·38 read, B·32 written).  CPU tensors take
    ``broker_aggregates_plain``; CUDA tensors launch the kernel (one block
    per broker, fixed-order register + tree reduction: deterministic, no
    float atomics)."""
    dev = replica_broker.device
    r = replica_broker.shape[0]
    cuda.check(replica_broker, "replica_broker", torch.int32, (r,), dev)
    cuda.check(replica_valid, "replica_valid", torch.bool, (r,), dev)
    cuda.check(replica_is_leader, "replica_is_leader", torch.bool, (r,), dev)
    cuda.check(load_leader, "load_leader", torch.float32, (r, NUM_RESOURCES), dev)
    cuda.check(load_follower, "load_follower", torch.float32,
               (r, NUM_RESOURCES), dev)
    cuda.record("broker_aggregates",
                (replica_broker, replica_valid, replica_is_leader,
                 load_leader, load_follower, num_brokers))
    if cuda.on_cpu(replica_broker):
        return broker_aggregates_plain(replica_broker, replica_valid,
                                       replica_is_leader, load_leader,
                                       load_follower, num_brokers)
    load = torch.empty((num_brokers, NUM_RESOURCES), dtype=torch.float32, device=dev)
    replica_count = torch.empty((num_brokers,), dtype=torch.int32, device=dev)
    leader_count = torch.empty((num_brokers,), dtype=torch.int32, device=dev)
    pnw = torch.empty((num_brokers,), dtype=torch.float32, device=dev)
    lbi = torch.empty((num_brokers,), dtype=torch.float32, device=dev)
    if num_brokers > 0:
        cuda.launch("broker_aggregates", replica_broker, replica_valid,
                    replica_is_leader, load_leader, load_follower, r, load,
                    replica_count, leader_count, pnw, lbi, num_brokers)
        broker_aggregates.launches += 1
    return load, replica_count, leader_count, pnw, lbi


# ---------------------------------------------------------------------------
# K15 — the cross-shard combine of a replica-sharded model's aggregates
# ---------------------------------------------------------------------------

def shard_combine_plain(fparts: torch.Tensor, iparts: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(f32[B, Cf], i32[B, Ci] or None): the ranks' partials f32[n, B, Cf]
    and i32[n, B, Ci] summed over the ranks, in rank order
    ``((p0 + p1) + p2) + ...``."""
    fout = fparts[0].clone()
    for r in range(1, fparts.shape[0]):
        fout = fout + fparts[r]
    iout = None
    if iparts is not None:
        iout = iparts[0].clone()
        for r in range(1, iparts.shape[0]):
            iout = iout + iparts[r]
    return fout, iout


@cuda.counted("shard_combine")
def shard_combine(fparts: torch.Tensor, iparts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K15.  Replaces the psum of the JAX package's replica-sharded segment
    reductions (``cruise_control_tpu/parallel/mesh.py:16-20,69``; XLA
    inserts it).  Bound on the card: bytes (n·B·(Cf+Ci)·4 read,
    B·(Cf+Ci)·4 written).  CPU tensors take ``shard_combine_plain``; CUDA
    tensors launch one thread per output element that adds the n partials
    in rank order with ``__fadd_rn`` (the plain twin's bits) and the counts
    exactly."""
    dev = fparts.device
    n, b, cf = fparts.shape
    cuda.check(fparts, "fparts", torch.float32, (n, b, cf), dev)
    ci = 0
    if iparts is not None:
        ci = iparts.shape[2]
        cuda.check(iparts, "iparts", torch.int32, (n, b, ci), dev)
    cuda.record("shard_combine", (fparts, iparts))
    if cuda.on_cpu(fparts):
        return shard_combine_plain(fparts, iparts)
    fout = torch.empty((b, cf), dtype=torch.float32, device=dev)
    iout = torch.empty((b, ci), dtype=torch.int32, device=dev) if iparts is not None else None
    if b * (cf + ci) > 0:
        cuda.launch("shard_combine", fparts, iparts, n, b * cf, b * ci, fout, iout)
        shard_combine.launches += 1
    return fout, iout
