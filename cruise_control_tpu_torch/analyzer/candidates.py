"""Candidate action generation.

Counterpart of ``cruise_control_tpu/analyzer/candidates.py``: a goal ranks
every replica (``source_replica_relevance``) and every broker
(``dest_room``); the top-S replicas cross the top-D destinations, the
count goals add transport-matched legs, leadership candidates pair top
leaders with their followers, and swap candidates cross top out-replicas
with top in-replicas.  Legitimacy becomes a boolean mask over the batch.

Every ``jax.lax.top_k`` of the JAX package is ``ops.order.top_k`` here and
every ``jnp.argsort`` is ``ops.order.argsort``: both keep the JAX package's
tie order, so a given model yields identical index sets.  The intra-broker
builders (``intra_disk_candidates``, ``intra_swap_candidates``) pair replicas
with the other disks of their own broker.

The matched-transport legs run kernel K6 (``csrc/transport_match.cu``) for
their two non-library parts: ``transport_rank`` (each row's rank inside its
group, from a stable sort's order) and ``transport_lookup`` (each slot's
destination by a binary search of its window's prefix sums), with the plain
twins ``transport_rank_plain`` and ``transport_lookup_plain``.  The sorts
and top-k stay ``ops.order``.
"""

from __future__ import annotations

import math

import torch

from cruise_control_tpu_torch.analyzer.actions import (ActionType, Candidates,
                                                       make_candidates,
                                                       make_swap_candidates)
from cruise_control_tpu_torch.analyzer.goals import kernels
from cruise_control_tpu_torch.analyzer.state import (BrokerArrays, OptimizationOptions,
                                                     disk_loads, topic_counts)
from cruise_control_tpu_torch.model.tensor_model import BrokerState, TensorClusterModel
from cruise_control_tpu_torch.ops import cuda, order
from cruise_control_tpu_torch.parallel import collectives

_NEG = -1e29  # "irrelevant" sentinel threshold (relevance uses -1e30)


def default_num_sources(model: TensorClusterModel) -> int:
    want = max(64, 4 * model.num_brokers)
    return max(1, min(model.num_replicas_padded, min(want, 2048)))


def default_num_dests(model: TensorClusterModel) -> int:
    b = model.num_brokers
    return max(1, min(b, max(32, min(b // 8, 1024))))


def default_num_matched(model: TensorClusterModel, num_sources: int) -> int:
    r = model.num_replicas_padded
    return max(1, min(r, max(256, min(max(2048, r // 4), 16 * num_sources))))


def default_num_swap_sources(model: TensorClusterModel) -> int:
    return max(1, min(model.num_replicas_padded, 256))


def default_num_swap_partners(model: TensorClusterModel) -> int:
    return max(1, min(model.num_replicas_padded, 16))


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _repeat_each(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x.repeat_interleave(n)`` for an int ``n`` as a view expansion
    (no size computed on the host, so it can be recorded in a CUDA graph)."""
    return x[:, None].expand(x.shape[0], n).reshape(-1)


# ---------------------------------------------------------------------------
# K6 — matched-transport rank and slot lookup
# ---------------------------------------------------------------------------

def transport_rank_plain(ordr: torch.Tensor, key: torch.Tensor,
                         num_groups: int) -> torch.Tensor:
    """i32[N] — each row's position among the rows of its ``key`` group in
    the stable order ``ordr`` (keys lie in [0, num_groups])."""
    n = key.shape[0]
    sorted_key = key[ordr]
    pos = _arange(n, key)
    start = torch.full((num_groups + 1,), n, dtype=torch.int32,
                       device=key.device).scatter_reduce_(
        0, sorted_key.clamp(max=num_groups).long(), pos, "amin")
    rank = torch.zeros((n,), dtype=torch.int32, device=key.device)
    rank[ordr] = pos - start[sorted_key.clamp(max=num_groups)]
    return rank


@cuda.counted("transport_rank")
def transport_rank(ordr: torch.Tensor, key: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K6, rank part.  Replaces the segment-start scatter-min and rank
    scatter of ``cruise_control_tpu/analyzer/candidates.py:136,254``
    (``_matched_move_legs``, ``_matched_topic_legs``).  Bound on the card:
    bytes (N·12 read, N·4 written; the binary searches hit L2).  CPU
    tensors take ``transport_rank_plain``; CUDA tensors launch one thread
    per sorted position that finds its group's first position by a binary
    search of the sorted keys.  Integer output, exact."""
    dev = key.device
    n = key.shape[0]
    cuda.check(ordr, "ordr", torch.int64, (n,), dev)
    cuda.check(key, "key", torch.int32, (n,), dev)
    cuda.record("transport_rank", (ordr, key, num_groups))
    if cuda.on_cpu(key):
        return transport_rank_plain(ordr, key, num_groups)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:
        cuda.launch("transport_rank", ordr, key, n, rank)
        transport_rank.launches += 1
    return rank


def transport_lookup_plain(cum: torch.Tensor, slot_broker: torch.Tensor, width: int,
                           win: torch.Tensor, off: torch.Tensor):
    """(dest1 i32[L], dest2 i32[L], ok bool[L]) — lane i takes slot
    ``off[i]`` of window ``win[i]`` (``width`` slots each; ``cum`` is the
    inclusive prefix sum of the slot sizes over all windows): the broker of
    the slot it falls in, of the next slot of the window, and whether the
    window holds that many units."""
    base = torch.where(win > 0, cum[(win * width - 1).clamp(min=0)], 0)
    last = win * width + width - 1
    total = cum[last] - base
    j = torch.searchsorted(cum, base + off, right=True).to(torch.int32)
    j = torch.minimum(j, last)
    dest1 = slot_broker[j]
    dest2 = slot_broker[torch.minimum(j + 1, last)]
    return dest1, dest2, off < total


@cuda.counted("transport_lookup")
def transport_lookup(cum: torch.Tensor, slot_broker: torch.Tensor, width: int,
                     win: torch.Tensor, off: torch.Tensor):
    """K6, lookup part.  Replaces the slot counting (``index_add_`` count +
    cumsum, ``cruise_control_tpu/analyzer/candidates.py:136``) and the global
    ``searchsorted`` (``:254``) of the matched legs.  Bound on the card:
    bytes (L·8 read plus the window's prefix sums, L·9 written).  CPU
    tensors take ``transport_lookup_plain``; CUDA tensors launch one thread
    per lane with a binary search inside its window.  Integer output,
    exact."""
    dev = cum.device
    n_slots = cum.shape[0]
    n = off.shape[0]
    cuda.check(cum, "cum", torch.int32, (n_slots,), dev)
    cuda.check(slot_broker, "slot_broker", torch.int32, (n_slots,), dev)
    cuda.check(win, "win", torch.int32, (n,), dev)
    cuda.check(off, "off", torch.int32, (n,), dev)
    if width <= 0 or n_slots % width:
        raise ValueError(f"{n_slots} slots do not form windows of width {width}")
    cuda.record("transport_lookup", (cum, slot_broker, width, win, off))
    if cuda.on_cpu(cum):
        return transport_lookup_plain(cum, slot_broker, width, win, off)
    dest1 = torch.empty((n,), dtype=torch.int32, device=dev)
    dest2 = torch.empty((n,), dtype=torch.int32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    if n > 0:
        cuda.launch("transport_lookup", cum, slot_broker, win, off, n, width,
                    dest1, dest2, ok)
        transport_lookup.launches += 1
    return dest1, dest2, ok


def _recv_ok(arrays: BrokerArrays, options: OptimizationOptions) -> torch.Tensor:
    """bool[B] — brokers able to receive replicas for this request."""
    ok = arrays.alive & ~options.broker_excluded_replica_move
    any_requested = options.requested_dest_only.any()
    return ok & (~any_requested | options.requested_dest_only)


def _finish_move_legs(model, arrays, options, replica, dest, ok) -> Candidates:
    """One legitimacy mask + one make_candidates over concatenated move legs."""
    k = replica.shape[0]
    dev = replica.device
    action_type = torch.full((k,), ActionType.INTER_BROKER_REPLICA_MOVEMENT,
                             dtype=torch.int32, device=dev)
    dest_replica = torch.full((k,), -1, dtype=torch.int32, device=dev)
    valid = ok & _legit_move_mask(model, arrays, options, replica, dest)
    return make_candidates(model, replica, dest, action_type, dest_replica, valid)


def _cross_move_legs(spec, model, arrays, constraint, options, num_sources: int,
                     num_dests: int, relevance=None, bands=None, active=None):
    """(replica, dest, ok), each [S·D] — the top-S × top-D cross legs;
    ``active`` (the frontier mask, bool[B]) restricts the destinations."""
    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays,
                                                     constraint, bands=bands)
    rel_vals, src_replicas = order.top_k(relevance, num_sources)
    room = kernels.dest_room(spec, model, arrays, constraint, bands=bands)
    ninf = torch.full((), -math.inf, device=room.device)
    room = torch.where(_recv_ok(arrays, options), room, ninf)
    if active is not None:
        room = torch.where(active, room, ninf)
    _, dest_brokers = order.top_k(room, num_dests)
    replica = _repeat_each(src_replicas, num_dests)
    dest = dest_brokers.repeat(num_sources)
    src_ok = _repeat_each(rel_vals > _NEG, num_dests)
    return replica, dest, src_ok


def move_candidates(spec, model, arrays, constraint, options, num_sources: int,
                    num_dests: int, relevance=None, bands=None) -> Candidates:
    """K = S·D inter-broker replica-move candidates for this goal."""
    replica, dest, src_ok = _cross_move_legs(
        spec, model, arrays, constraint, options, num_sources, num_dests,
        relevance=relevance, bands=bands)
    return _finish_move_legs(model, arrays, options, replica, dest, src_ok)


def _matched_move_legs(spec, model, arrays, constraint, options, num_out: int,
                       relevance=None, bands=None, active=None):
    """(replica, dest, ok), each [2·num_out] — surplus replicas of
    over-band brokers matched onto receivers' room by a prefix-sum
    transport (replica-count distribution); under a frontier (``active``)
    only active brokers shed or receive."""
    B = model.num_brokers
    R = model.num_replicas_padded
    num_out = max(1, min(num_out, R))
    dev = model.device
    metric = kernels.broker_metric(spec, model, arrays, constraint)
    lower, upper = bands if bands is not None else \
        kernels.limits(spec, model, arrays, constraint)
    under_exists = (arrays.alive & (metric < lower)).any()
    shed_to = torch.where(under_exists, (lower + upper) * 0.5, upper)
    src_n = torch.ceil(torch.clamp(metric - shed_to, min=0.0)).to(torch.int32)
    recv_ok = _recv_ok(arrays, options)
    room_n = torch.where(recv_ok, torch.floor(torch.clamp(upper - metric, min=0.0)),
                         torch.zeros((), device=dev)).to(torch.int32)
    room_n = torch.where(src_n > 0, 0, room_n)
    if active is not None:
        src_n = torch.where(active, src_n, 0)
        room_n = torch.where(active, room_n, 0)

    rb = model.replica_broker
    key = torch.where(model.replica_valid, rb, B)
    rank = transport_rank(order.argsort(key), key, B)
    is_src = model.replica_valid & (rank < src_n[rb])

    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays,
                                                     constraint, bands=bands)
    rel = torch.where(is_src, relevance, torch.full((), -math.inf, device=dev))
    rel_vals, src_replicas = order.top_k(rel, num_out)
    src_ok = torch.isfinite(rel_vals)

    room_vals, room_order = order.top_k(room_n, B)
    cum = torch.cumsum(room_vals, dim=0, dtype=torch.int32)
    # One window of B slots; slot i of the surplus lands where the running
    # room first exceeds i.
    dest1, dest2, dest_ok = transport_lookup(
        cum, room_order, B, torch.zeros((num_out,), dtype=torch.int32, device=dev),
        _arange(num_out, cum))

    replica = torch.cat([src_replicas, src_replicas])
    dest = torch.cat([dest1, dest2])
    ok = torch.cat([src_ok & dest_ok, src_ok & dest_ok & (dest2 != dest1)])
    return replica, dest, ok


def matched_move_candidates(spec, model, arrays, constraint, options, num_out: int,
                            relevance=None, bands=None) -> Candidates:
    replica, dest, ok = _matched_move_legs(
        spec, model, arrays, constraint, options, num_out,
        relevance=relevance, bands=bands)
    return _finish_move_legs(model, arrays, options, replica, dest, ok)


def _matched_topic_legs(spec, model, arrays, constraint, options, num_out: int,
                        relevance=None):
    """(replica, dest, ok), each [2·num_out] — per-topic transport legs for
    TopicReplicaDistribution (topic-major [T, 2B] slot table, one global
    cumsum + searchsorted)."""
    B = model.num_brokers
    T = model.num_topics
    R = model.num_replicas_padded
    num_out = max(1, min(num_out, R))
    dev = model.device
    tbc = topic_counts(model, arrays).to(torch.float32)
    lower_t, upper_t = kernels._topic_limits(model, arrays, constraint)
    recv = _recv_ok(arrays, options)[None, :]
    fzero = torch.zeros((), device=dev)
    surplus = torch.ceil(torch.clamp(tbc - upper_t[:, None], min=0.0)).to(torch.int32)
    deficit = torch.where(recv, torch.ceil(torch.clamp(lower_t[:, None] - tbc, min=0.0)),
                          fzero).to(torch.int32)
    need_t = torch.clamp(deficit.sum(dim=1, dtype=torch.int32)
                         - surplus.sum(dim=1, dtype=torch.int32), min=0)
    mid_t = (lower_t + upper_t) * 0.5
    donor_cap = torch.floor(torch.clamp(torch.minimum(tbc, upper_t[:, None])
                                        - mid_t[:, None], min=0.0)).to(torch.int32)
    d_order = order.argsort(-donor_cap, dim=1)
    d_sorted = torch.gather(donor_cap, 1, d_order)
    d_cum = torch.cumsum(d_sorted, dim=1, dtype=torch.int32)
    prev_cum = d_cum - d_sorted
    admit_sorted = torch.minimum(torch.clamp(need_t[:, None] - prev_cum, min=0), d_sorted)
    donor_n = torch.zeros_like(donor_cap).scatter_(1, d_order, admit_sorted)
    src_n = surplus + donor_n
    spare = torch.where(recv, torch.floor(torch.clamp(
        upper_t[:, None] - torch.maximum(tbc, lower_t[:, None]), min=0.0)),
        fzero).to(torch.int32)

    pair = model.replica_topic * B + model.replica_broker
    key = torch.where(model.replica_valid, pair, T * B)
    rank = transport_rank(order.argsort(key), key, T * B)
    is_src = model.replica_valid & (rank < src_n.reshape(-1)[pair.clamp(max=T * B - 1)])

    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays, constraint)
    rel = torch.where(is_src, relevance, torch.full((), -math.inf, device=dev))
    rel_vals, src_replicas = order.top_k(rel, num_out)
    src_ok = torch.isfinite(rel_vals)

    t_src = model.replica_topic[src_replicas]
    t_key = torch.where(src_ok, t_src, T)
    p_in_topic = transport_rank(order.argsort(t_key), t_key, T)

    def_order = order.argsort(-deficit, dim=1)
    sp_order = order.argsort(-spare, dim=1)
    slot_vals = torch.cat([torch.gather(deficit, 1, def_order),
                           torch.gather(spare, 1, sp_order)], dim=1)
    slot_broker = torch.cat([def_order, sp_order], dim=1).to(torch.int32)
    cum = torch.cumsum(slot_vals.reshape(-1), dim=0, dtype=torch.int32)
    dest1, dest2, fits = transport_lookup(cum, slot_broker.reshape(-1), 2 * B,
                                          t_src, p_in_topic)
    dest_ok = src_ok & fits

    replica = torch.cat([src_replicas, src_replicas])
    dest = torch.cat([dest1, dest2])
    ok = torch.cat([dest_ok, dest_ok & (dest2 != dest1)])
    return replica, dest, ok


def matched_topic_candidates(spec, model, arrays, constraint, options, num_out: int,
                             relevance=None) -> Candidates:
    replica, dest, ok = _matched_topic_legs(
        spec, model, arrays, constraint, options, num_out, relevance=relevance)
    return _finish_move_legs(model, arrays, options, replica, dest, ok)


def combined_move_candidates(spec, model, arrays, constraint, options,
                             cross_sources: int, num_dests: int, num_matched: int = 0,
                             relevance=None, bands=None, active=None) -> Candidates:
    """One move batch: the cross legs plus the goal's matched legs.
    ``active`` (the frontier mask) restricts sources and destinations of
    the cross and replica-count legs; topic legs never see it (topic goals
    are not band kinds, so the frontier never engages there)."""
    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays,
                                                     constraint, bands=bands)
    replica, dest, ok = _cross_move_legs(
        spec, model, arrays, constraint, options, cross_sources, num_dests,
        relevance=relevance, bands=bands, active=active)
    legs = None
    if num_matched > 0 and spec.kind == "replica_distribution":
        legs = _matched_move_legs(spec, model, arrays, constraint, options,
                                  num_matched, relevance=relevance, bands=bands,
                                  active=active)
    elif num_matched > 0 and spec.kind == "topic_replica_distribution":
        legs = _matched_topic_legs(spec, model, arrays, constraint, options,
                                   num_matched, relevance=relevance)
    if legs is not None:
        replica = torch.cat([replica, legs[0]])
        dest = torch.cat([dest, legs[1]])
        ok = torch.cat([ok, legs[2]])
    return _finish_move_legs(model, arrays, options, replica, dest, ok)


def _legit_move_mask(model, arrays, options, replica, dest) -> torch.Tensor:
    """bool[K] — GoalUtils.legitMove semantics for inter-broker moves."""
    src = model.replica_broker[replica]
    part = model.replica_partition[replica]
    topic = model.replica_topic[replica]
    dest_alive = arrays.alive[dest]
    not_self = dest != src
    sib = model.partition_replicas[part]
    sib_valid = (sib >= 0) & (sib != replica[:, None])
    sib_broker = model.replica_broker[torch.where(sib >= 0, sib, 0)]
    already_there = (sib_valid & (sib_broker == dest[:, None])).any(dim=1)
    offline = model.replica_offline_now()[replica] | (~arrays.alive[src])
    topic_ok = ~options.topic_excluded[topic] | offline
    immigrant = src != model.replica_original_broker[replica]
    immigrant_ok = ~options.only_move_immigrants | immigrant | offline
    dest_ok = ~options.broker_excluded_replica_move[dest]
    any_requested = options.requested_dest_only.any()
    requested_ok = ~any_requested | options.requested_dest_only[dest]
    return (model.replica_valid[replica] & dest_alive & not_self & ~already_there
            & topic_ok & immigrant_ok & dest_ok & requested_ok)


def leadership_candidates(spec, model, arrays, constraint, options, num_sources: int,
                          relevance=None, bands=None) -> Candidates:
    """K = S·max_rf leadership-transfer candidates."""
    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays,
                                                     constraint, bands=bands)
    dev = model.device
    relevance = torch.where(model.replica_is_leader, relevance,
                            torch.full((), -math.inf, device=dev))
    rel_vals, src_replicas = order.top_k(relevance, num_sources)
    part = model.replica_partition[src_replicas]
    sib = model.partition_replicas[part]
    max_rf = sib.shape[1]
    replica = _repeat_each(src_replicas, max_rf)
    dest_replica = sib.reshape(-1)
    src_ok = _repeat_each(rel_vals > _NEG, max_rf)
    safe_dest = torch.where(dest_replica >= 0, dest_replica, 0)
    dest_broker = model.replica_broker[safe_dest]
    dest_state = model.broker_state[dest_broker]
    dest_ok = ((dest_replica >= 0)
               & (dest_replica != replica)
               & model.replica_valid[safe_dest]
               & ~model.replica_offline_now()[safe_dest]
               & arrays.alive[dest_broker]
               & (dest_state != BrokerState.DEMOTED)
               & ~options.broker_excluded_leadership[dest_broker])
    is_leader = model.replica_is_leader[replica]
    k = replica.shape[0]
    action_type = torch.full((k,), ActionType.LEADERSHIP_MOVEMENT, dtype=torch.int32,
                             device=dev)
    valid = src_ok & is_leader & dest_ok & model.replica_valid[replica]
    return make_candidates(model, replica, torch.zeros((k,), dtype=torch.int32, device=dev),
                           action_type, dest_replica, valid)


def intra_disk_candidates(spec, model, arrays, constraint, options, num_sources: int,
                          relevance=None, bands=None) -> Candidates:
    """K = S·max_disks_per_broker intra-broker disk moves: each top-ranked
    replica paired with every disk of its own broker (the JAX package's
    ``candidates.py:496``)."""
    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays,
                                                     constraint, bands=bands)
    dev = model.device
    rel_vals, src_replicas = order.top_k(relevance, num_sources)
    disks = model.broker_disks[model.replica_broker[src_replicas]]
    max_dpb = disks.shape[1]
    replica = _repeat_each(src_replicas, max_dpb)
    dest_disk = disks.reshape(-1)
    src_ok = _repeat_each(rel_vals > _NEG, max_dpb)
    safe_disk = torch.where(dest_disk >= 0, dest_disk, 0)
    dest_alive = (dest_disk >= 0) & (model.disk_capacity[safe_disk] > 0.0) & \
        model.disk_valid[safe_disk]
    not_self = dest_disk != model.replica_disk[replica]
    k = replica.shape[0]
    action_type = torch.full((k,), ActionType.INTRA_BROKER_REPLICA_MOVEMENT,
                             dtype=torch.int32, device=dev)
    dest_replica = torch.full((k,), -1, dtype=torch.int32, device=dev)
    valid = src_ok & dest_alive & not_self & model.replica_valid[replica]
    return make_candidates(model, replica, model.replica_broker[replica], action_type,
                           dest_replica, valid, dest_disks=dest_disk)


def intra_swap_candidates(spec, model, arrays, constraint, options, num_out: int,
                          num_in: int, relevance=None, bands=None) -> Candidates:
    """K = S_out·S_in intra-broker disk swaps: the top out-replicas cross
    partners ranked by their disk's load and their size (smallest on the
    least-loaded disks first), masked to the same broker and another disk
    (the JAX package's ``candidates.py:621``)."""
    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays,
                                                     constraint, bands=bands)
    dev = model.device
    _, out_replicas = order.top_k(relevance, num_out)
    out_vals = relevance[out_replicas]
    disk_load = disk_loads(model, arrays)
    rd = model.replica_disk
    size = model.replica_load()[:, 3]
    size_scale = size.max().clamp(min=1e-9)
    in_rank = -disk_load[rd.clamp(min=0)] - size / size_scale
    in_rank = torch.where(model.replica_valid & (rd >= 0), in_rank,
                          torch.full((), -math.inf, device=dev))
    _, in_replicas = order.top_k(in_rank, num_in)
    r1 = _repeat_each(out_replicas, num_in)
    r2 = in_replicas.repeat(num_out)
    src_ok = _repeat_each(out_vals > _NEG, num_in)
    same_broker = model.replica_broker[r1] == model.replica_broker[r2]
    diff_disk = (rd[r1] != rd[r2]) & (rd[r1] >= 0) & (rd[r2] >= 0)
    valid = src_ok & same_broker & diff_disk & \
        model.replica_valid[r1] & model.replica_valid[r2] & (r1 != r2)
    return make_swap_candidates(model, r1, r2, valid, intra=True)


def swap_candidates(spec, model, arrays, constraint, options, num_out: int,
                    num_in: int, relevance=None, bands=None, active=None) -> Candidates:
    """K = S_out·S_in inter-broker replica-SWAP candidates; ``active`` (the
    frontier mask) restricts the swap-in brokers."""
    if relevance is None:
        relevance = kernels.source_replica_relevance(spec, model, arrays,
                                                     constraint, bands=bands)
    dev = model.device
    _, out_replicas = order.top_k(relevance, num_out)
    out_vals = relevance[out_replicas]
    room = kernels.dest_room(spec, model, arrays, constraint, bands=bands)
    recv_ok = arrays.alive & ~options.broker_excluded_replica_move
    ninf = torch.full((), -math.inf, device=dev)
    room = torch.where(recv_ok, room, ninf)
    if active is not None:
        room = torch.where(active, room, ninf)
    metric_res = spec.resource if spec.resource >= 0 else 3
    size = model.replica_load()[:, metric_res]
    size_scale = size.max().clamp(min=1e-9)
    in_rank = room[model.replica_broker] - size / size_scale
    in_rank = torch.where(model.replica_valid, in_rank, ninf)
    _, in_replicas = order.top_k(in_rank, num_in)
    r1 = _repeat_each(out_replicas, num_in)
    r2 = in_replicas.repeat(num_out)
    src_ok = _repeat_each(out_vals > _NEG, num_in)
    valid = src_ok & _legit_swap_mask(model, arrays, options, r1, r2)
    return make_swap_candidates(model, r1, r2, valid)


def _legit_swap_mask(model, arrays, options, r1, r2) -> torch.Tensor:
    """bool[K] — both swap legs are legit moves."""
    b1 = model.replica_broker[r1]
    b2 = model.replica_broker[r2]
    p1 = model.replica_partition[r1]
    p2 = model.replica_partition[r2]
    both_alive = arrays.alive[b1] & arrays.alive[b2]
    different = (b1 != b2) & (p1 != p2)

    def no_sibling_on(replica, broker):
        sib = model.partition_replicas[model.replica_partition[replica]]
        sib_valid = (sib >= 0) & (sib != replica[:, None])
        sib_broker = model.replica_broker[torch.where(sib >= 0, sib, 0)]
        return ~(sib_valid & (sib_broker == broker[:, None])).any(dim=1)

    topic_ok = ~options.topic_excluded[model.replica_topic[r1]] & \
        ~options.topic_excluded[model.replica_topic[r2]]
    dest_ok = ~options.broker_excluded_replica_move[b1] & \
        ~options.broker_excluded_replica_move[b2]
    any_requested = options.requested_dest_only.any()
    requested_ok = ~any_requested | (options.requested_dest_only[b1] &
                                     options.requested_dest_only[b2])
    immigrant1 = b1 != model.replica_original_broker[r1]
    immigrant2 = b2 != model.replica_original_broker[r2]
    immigrants_ok = ~options.only_move_immigrants | (immigrant1 & immigrant2)
    return (model.replica_valid[r1] & model.replica_valid[r2]
            & both_alive & different
            & no_sibling_on(r1, b2) & no_sibling_on(r2, b1)
            & topic_ok & dest_ok & requested_ok & immigrants_ok)


def shard_candidate_batch(cand: Candidates, mesh) -> Candidates:
    """The rank's contiguous slice of every K-leading leaf of ``cand``
    (``collectives.lane_range``: ``ceil(K/n)`` candidates a rank, in rank
    order), the counterpart of the JAX package's ``P(search)`` constraint
    (``candidates.py:36-52``): each rank scores and masks its own
    candidates end to end, and ``collectives.gather_scores`` puts the
    results back in candidate order.  No-op without a mesh or on a one-rank
    mesh, as in ``candidates.py:48-49``."""
    if mesh is None or mesh.size <= 1:
        return cand
    lo, hi = collectives.lane_range(cand.k, mesh)
    return cand.map(lambda x: x[lo:hi])


def concat_candidates(a: Candidates, b: Candidates) -> Candidates:
    return Candidates(**{f: torch.cat([getattr(a, f), getattr(b, f)])
                         for f in a.__dataclass_fields__})


def take_candidates(cand: Candidates, idx: torch.Tensor) -> Candidates:
    """Gather the candidate subset ``idx`` along the K axis."""
    return cand.map(lambda x: x[idx])
