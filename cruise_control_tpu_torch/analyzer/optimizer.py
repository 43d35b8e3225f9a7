"""The batched greedy goal optimizer: the dense per-goal path, the fused
grouped-stack path, and K2.

Counterpart of the dense paths of ``cruise_control_tpu/analyzer/optimizer.py``:
each goal, in priority order, repeats ``_goal_step`` until no action applies.
A step builds the candidate batches, scores and masks them (K5), selects a
conflict-free subset inside every optimized goal's band budgets
(``select_batched``) and applies it (K7).

- ``optimize(fused=False)``: a Python loop per goal with one host read (the
  step's action count) per step (``_goal_fixpoint``).
- ``optimize(fused=True)`` at 64 brokers or fewer, or with an explicit
  ``fuse_group_size`` > 1: the JAX package's grouped stack
  (``_stack_fixpoint`` over ``_goal_fixpoint_budget``).  Every step is
  ``_gated_step``, which updates the working state in place and turns into
  a no-op once the goal has converged or spent its budget; the host reads
  the counters once per chunk of steps.  On the CPU the gated step runs
  eagerly; on the card it is captured once per goal as a CUDA graph and
  replayed (K8, ``analyzer/graphs.py``), and a stack is its goals' graphs
  replayed back to back (K12) with one fetch of the packed
  ``i32[PACKED_WIDTH, G]`` stats per group.

``_best_per_segment`` is kernel K2 (``csrc/best_per_segment.cu``) with the
plain twin ``_best_per_segment_plain``.

Not in this slice (``optimize`` raises): the per-goal fused path (the
chunked frontier driver, inter-goal pipelining and the stack sweep, which
the JAX package runs above 64 brokers or with ``fuse_group_size=1``), warm
starts, meshes, ``segment_steps``, the flight recorder, the repair oracle,
and multi-round selection (``moves_per_broker_step`` above ``SUBROUNDS``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import candidates as cgen
from cruise_control_tpu_torch.analyzer import graphs
from cruise_control_tpu_torch.analyzer.actions import Candidates, apply_candidates
from cruise_control_tpu_torch.analyzer.balancedness import (balancedness_cost_by_goal,
                                                            balancedness_score)
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels
from cruise_control_tpu_torch.analyzer.goals.specs import GoalSpec, goals_by_priority
from cruise_control_tpu_torch.analyzer.provisioning import (ProvisionResponse, host_view,
                                                            provision_verdict_for_goal)
from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_DEPTH, CTR_LANES,
                                                     CTR_LAST_N, CTR_REPAIR, CTR_STEPS,
                                                     CTR_TOTAL, MUTABLE_FIELDS,
                                                     PACKED_ACTIONS, PACKED_AFTER,
                                                     PACKED_BEFORE, PACKED_BISECT_DEPTH,
                                                     PACKED_CAPPED, PACKED_LANES_LIVE,
                                                     PACKED_REPAIR_STEPS, PACKED_STEPS,
                                                     BrokerArrays, OptimizationOptions,
                                                     StepInvariants, StepState,
                                                     pow2_bucket, topic_counts)
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.stats import ClusterModelStats, compute_stats
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel
from cruise_control_tpu_torch.ops import cuda, order
from cruise_control_tpu_torch.ops.segment import segment_sum

# Lanes per selection round (see the JAX package's SUBROUNDS).
SUBROUNDS = 128

# Below this K the selection runs on the full lane axis.
_LANE_DENSE_MIN = 4096

# The JAX package's dense-stack floor: at or below this many brokers a fused
# optimize runs the whole stack as one group (``optimizer.py:1385``).
_FRONTIER_DENSE_MIN = 64

# Gated steps run between two host reads of the counters grow 1, 2, 4, ...
# up to this many: a goal that is already satisfied costs one gated-off
# step, and a long one at most CHUNK_MAX - 1 steps past its fixpoint.
CHUNK_MAX = 8

_INF = math.inf


def _lane_bucket(k: int, nb_sel: int, subrounds: int) -> Optional[int]:
    """Live-candidate compaction bucket for a K-lane batch, or None."""
    if k <= _LANE_DENSE_MIN:
        return None
    target = min(k, max(_LANE_DENSE_MIN, 2 * nb_sel * subrounds))
    kc = pow2_bucket(target, _LANE_DENSE_MIN)
    return kc if kc < k else None


class OptimizationFailureException(Exception):
    """A hard goal could not be satisfied."""


# ---------------------------------------------------------------------------
# K2 — best per segment
# ---------------------------------------------------------------------------

def _best_per_segment_plain(score: torch.Tensor, seg: torch.Tensor,
                            num_segments: int, eligible: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_best_per_segment``: scatter-max of the scores,
    then scatter-min of the indices that reached it; a segment whose best
    is not finite keeps no lane."""
    k = score.shape[0]
    dev = score.device
    ninf = torch.full((), -_INF, dtype=score.dtype, device=dev)
    masked = torch.where(eligible, score, ninf)
    seg_safe = torch.where(eligible, seg, 0).long()
    best = torch.full((num_segments,), -_INF, dtype=score.dtype, device=dev)
    best = best.scatter_reduce_(0, seg_safe, masked, "amax")
    is_best = eligible & (masked >= best[seg_safe]) & torch.isfinite(masked)
    idx = torch.arange(k, dtype=torch.int32, device=dev)
    winner = torch.full((num_segments,), k, dtype=torch.int32, device=dev)
    winner = winner.scatter_reduce_(0, seg_safe, torch.where(is_best, idx, k), "amin")
    return is_best & (idx == winner[seg_safe])


@cuda.counted("best_per_segment")
def _best_per_segment(score: torch.Tensor, seg: torch.Tensor, num_segments: int,
                      eligible: torch.Tensor) -> torch.Tensor:
    """K2.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:210``
    ``_best_per_segment``: bool[K], each segment's single highest-scored
    eligible lane, ties to the lowest index.  Bound on the card: bytes
    (K·9 read, K written).  CPU tensors take ``_best_per_segment_plain``;
    CUDA tensors launch a 64-bit atomicMax of (ordered score bits, ~index)
    per segment and a winner pass — exact and deterministic."""
    dev = score.device
    k = score.shape[0]
    cuda.check(score, "score", torch.float32, (k,), dev)
    cuda.check(seg, "seg", torch.int32, (k,), dev)
    cuda.check(eligible, "eligible", torch.bool, (k,), dev)
    cuda.record("best_per_segment", (score, seg, num_segments, eligible))
    if cuda.on_cpu(score):
        return _best_per_segment_plain(score, seg, num_segments, eligible)
    keep = torch.empty((k,), dtype=torch.bool, device=dev)
    if k > 0:
        keys = torch.empty((max(num_segments, 1),), dtype=torch.int64, device=dev)
        cuda.launch("best_per_segment", score, seg, eligible, k, num_segments,
                    keys, keep)
        _best_per_segment.launches += 1
    return keep


# ---------------------------------------------------------------------------
# Band budgets
# ---------------------------------------------------------------------------

# The 8 budget channels: 0-3 resource load (CPU, NW_IN, NW_OUT, DISK);
# 4 replica count; 5 leader count; 6 potential NW_OUT; 7 leader bytes-in.
NUM_CHANNELS = 8

_CHANNEL_OF_KIND = {
    "replica_capacity": 4, "replica_distribution": 4,
    "leader_replica_distribution": 5,
    "potential_nw_out": 6,
    "leader_bytes_in": 7,
}


def _spec_channel(spec: GoalSpec):
    if spec.kind in ("capacity", "resource_distribution"):
        return spec.resource
    return _CHANNEL_OF_KIND.get(spec.kind)


def _channel_metrics(arrays: BrokerArrays) -> torch.Tensor:
    """f32[B, 8] — current value of every budget channel per broker."""
    return torch.cat([
        arrays.load,
        arrays.replica_count.to(torch.float32)[:, None],
        arrays.leader_count.to(torch.float32)[:, None],
        arrays.potential_nw_out[:, None],
        arrays.leader_bytes_in[:, None],
    ], dim=1)


def _channel_deltas(cand: Candidates):
    """(d_src f32[K, 8], d_dest f32[K, 8]) — per-candidate channel changes."""
    dc = cand.d_replica_count.to(torch.float32)[:, None]
    dl = cand.d_leader_count.to(torch.float32)[:, None]
    dp = cand.d_potential_nw_out[:, None]
    d_src = torch.cat([cand.delta_src, -dc, -dl, -dp,
                       -cand.d_leader_bytes_in_src[:, None]], dim=1)
    d_dest = torch.cat([cand.delta_dest, dc, dl, dp,
                        cand.d_leader_bytes_in_dest[:, None]], dim=1)
    return d_src, d_dest


def _band_sides(specs: Tuple[GoalSpec, ...], model: TensorClusterModel,
                arrays: BrokerArrays, constraint: BalancingConstraint):
    """(upper_min f32[B, 8], lower_max f32[B, 8]) — the folded band sides of
    every band goal in ``specs`` (step-invariant within a fixpoint)."""
    B = model.num_brokers
    dev = model.device
    upper_min = torch.full((B, NUM_CHANNELS), _INF, dtype=torch.float32, device=dev)
    lower_max = torch.full((B, NUM_CHANNELS), -_INF, dtype=torch.float32, device=dev)
    pad = torch.full((B, 4), _INF, dtype=torch.float32, device=dev)

    def sel_of(channels):
        sel = np.zeros((NUM_CHANNELS,), bool)
        sel[np.asarray(channels)] = True
        return torch.from_numpy(sel).to(dev)[None, :]

    cap_channels = [s.resource for s in specs if s.kind == "capacity"]
    if cap_channels:
        thresh = torch.tensor(constraint.capacity_threshold, dtype=torch.float32,
                              device=dev)
        upper_cap = arrays.capacity * thresh[None, :]
        upper_min = torch.minimum(
            upper_min, torch.where(sel_of(cap_channels),
                                   torch.cat([upper_cap, pad], dim=1), _INF))
    dist_channels = [s.resource for s in specs if s.kind == "resource_distribution"]
    soft_dist_channels = [s.resource for s in specs
                          if s.kind == "resource_distribution" and not s.is_hard]
    if dist_channels:
        bp = torch.tensor([constraint.balance_percentage(r) for r in range(4)],
                          dtype=torch.float32, device=dev)
        alive_col = arrays.alive[:, None]
        total_util = torch.where(alive_col, arrays.load, 0.0).sum(dim=0)
        total_cap = torch.where(alive_col, arrays.capacity, 0.0).sum(dim=0).clamp(min=1e-9)
        avg_pct = total_util / total_cap
        low = torch.tensor(constraint.low_utilization_threshold, dtype=torch.float32,
                           device=dev)
        gated = avg_pct <= low
        up_d = torch.where(gated[None, :],
                           torch.tensor(kernels._BIG, dtype=torch.float32, device=dev),
                           avg_pct[None, :] * bp[None, :] * arrays.capacity)
        upper_min = torch.minimum(
            upper_min, torch.where(sel_of(dist_channels),
                                   torch.cat([up_d, pad], dim=1), _INF))
    if soft_dist_channels:
        lo_d = torch.where(gated[None, :], 0.0,
                           torch.clamp(avg_pct[None, :] * (2.0 - bp)[None, :]
                                       * arrays.capacity, min=0.0))
        lower_max = torch.maximum(
            lower_max, torch.where(sel_of(soft_dist_channels),
                                   torch.cat([lo_d, -pad], dim=1), -_INF))
    rem = [s for s in specs
           if s.kind not in ("capacity", "resource_distribution")
           and _spec_channel(s) is not None]
    if rem:
        kinds = {s.kind for s in rem}
        if {"replica_distribution", "leader_replica_distribution"} & kinds:
            cnt2 = torch.where(arrays.alive[:, None],
                               torch.stack([arrays.replica_count,
                                            arrays.leader_count], dim=1), 0)
            avg_cnt = cnt2.sum(dim=0).to(torch.float32) / arrays.num_alive.to(torch.float32)
        ups, los = [], []
        if "replica_capacity" in kinds:
            ups.append((4, torch.full((B,), float(constraint.max_replicas_per_broker),
                                      dtype=torch.float32, device=dev)))
        if "potential_nw_out" in kinds:
            nw_out = Resource.NW_OUT
            ups.append((6, arrays.capacity[:, nw_out] * constraint.capacity_threshold[nw_out]))
        if "replica_distribution" in kinds:
            bp_r = kernels._margin_pct(constraint.replica_count_balance_threshold)
            ups.append((4, torch.ceil(avg_cnt[0] * bp_r).expand(B)))
            if any(s.kind == "replica_distribution" and not s.is_hard for s in rem):
                los.append((4, torch.floor(avg_cnt[0] * (2.0 - bp_r)).expand(B)))
        if "leader_replica_distribution" in kinds:
            bp_l = kernels._margin_pct(constraint.leader_replica_count_balance_threshold)
            ups.append((5, torch.ceil(avg_cnt[1] * bp_l).expand(B)))
            if any(s.kind == "leader_replica_distribution" and not s.is_hard for s in rem):
                los.append((5, torch.floor(avg_cnt[1] * (2.0 - bp_l)).expand(B)))
        if "leader_bytes_in" in kinds:
            nw_in = Resource.NW_IN
            bp_b = kernels._margin_pct(constraint.resource_balance_threshold[nw_in])
            avg_b = torch.where(arrays.alive, arrays.leader_bytes_in, 0.0).sum() \
                / arrays.num_alive.to(torch.float32)
            ups.append((7, (avg_b * bp_b).expand(B)))
        upper_min = upper_min.clone()
        lower_max = lower_max.clone()
        for ch, up in ups:
            upper_min[:, ch] = torch.minimum(upper_min[:, ch], up)
        for ch, lo in los:
            lower_max[:, ch] = torch.maximum(lower_max[:, ch], lo)
    return upper_min, lower_max


def _channel_budgets(arrays: BrokerArrays, sides):
    """(room_dest f32[B, 8], slack_src f32[B, 8]) — how much each broker may
    cumulatively gain / shed per channel this step inside every band."""
    metrics = _channel_metrics(arrays)
    upper_min, lower_max = sides
    room_dest = torch.clamp(upper_min - metrics, min=0.0)
    slack_src = torch.clamp(metrics - lower_max, min=0.0)
    slack_src = torch.where(arrays.alive[:, None], slack_src, _INF)
    return room_dest, slack_src


def _topic_budgets(all_specs: Tuple[GoalSpec, ...], model: TensorClusterModel,
                   arrays: BrokerArrays, inv: StepInvariants):
    """(gain_rep, shed_rep, shed_lead), each f32[T*B], or None when no
    topic-metric goal is in play."""
    if not any(s.kind == "topic_replica_distribution" for s in all_specs):
        return None
    n_tb = model.num_topics * model.num_brokers
    dev = model.device
    inf = torch.full((n_tb,), _INF, dtype=torch.float32, device=dev)
    tbc = topic_counts(model, arrays).to(torch.float32)
    gain = torch.clamp(inv.topic_upper[:, None] - tbc, min=0.0)
    shed = torch.clamp(tbc - inv.topic_lower[:, None], min=0.0)
    shed = torch.where(arrays.alive[None, :], shed, _INF)
    return gain.reshape(-1), shed.reshape(-1), inf


# ---------------------------------------------------------------------------
# Conflict-free selection
# ---------------------------------------------------------------------------

def _selection_hashes(k: int, subrounds: int):
    """The JAX package's host-constant jitter and subround lanes (numpy)."""
    idx_k = np.arange(k, dtype=np.uint32)
    jitter = ((idx_k * np.uint32(2654435761)) >> np.uint32(12)).astype(
        np.float32) / np.float32(1 << 20)
    factor = (1.0 + 1e-4 * jitter).astype(np.float32)
    lane = (((idx_k * np.uint32(0x9E3779B9)) >> np.uint32(4)) %
            np.uint32(subrounds)).astype(np.int32)
    return factor, lane


@functools.lru_cache(maxsize=64)
def _selection_consts(k: int, subrounds: int, device: torch.device):
    """``_selection_hashes`` as device tensors, uploaded once per shape: a
    host-to-device copy inside the step would break its CUDA-graph
    capture."""
    factor, lane = _selection_hashes(k, subrounds)
    return torch.from_numpy(factor).to(device), torch.from_numpy(lane).to(device)


def select_batched(score: torch.Tensor, cand: Candidates, eligible: torch.Tensor,
                   model: TensorClusterModel, room_dest: torch.Tensor,
                   slack_src: torch.Tensor, topic_budgets, subrounds: int,
                   has_swaps: bool, compact_k: Optional[int] = None):
    """(keep bool[K], sel_stats) — one round of the JAX package's greedy
    multi-accept selection: per-(broker, lane) and per-partition segment
    argmax passes (K2), per-(topic, broker) key lanes, then the
    bounded-depth exact repair (K3): two alternating dest/src prefix cuts
    and one subset-closed safe admit.  ``sel_stats`` is the JAX package's
    (repair fired i32, lanes live i32, bisect depth) — the first two are
    0-d tensors, the depth a Python int fixed by the shapes."""
    num_brokers, num_partitions = model.num_brokers, model.num_partitions
    dev = score.device
    k_full = score.shape[0]
    eps = 1e-6
    factor, lane = _selection_consts(k_full, subrounds, dev)
    score = score * factor
    sel_idx = None
    lanes_live = torch.zeros((), dtype=torch.int32, device=dev)
    rep_fired = torch.zeros((), dtype=torch.int32, device=dev)
    if compact_k is not None and compact_k < k_full:
        lanes_live = eligible.sum(dtype=torch.int32)
        _, sel_idx = order.top_k(torch.where(eligible, score, -_INF), compact_k)
        cand = cgen.take_candidates(cand, sel_idx)
        score = score[sel_idx]
        eligible = eligible[sel_idx]
        lane = lane[sel_idx]
    nb_sel = num_brokers
    src_b, dest_b = cand.src, cand.dest
    src_lane = src_b * subrounds + lane
    dest_lane = dest_b * subrounds + lane
    d_src, d_dest = _channel_deltas(cand)
    topic_on = topic_budgets is not None
    fzero = torch.zeros((), dtype=torch.float32, device=dev)
    if topic_on:
        gain_rep, shed_rep, shed_lead = topic_budgets
        n_tb = model.num_topics * nb_sel
        t1 = model.replica_topic[cand.replica]
        safe_r2 = torch.where(cand.dest_replica >= 0, cand.dest_replica, 0)
        t2 = model.replica_topic[safe_r2]
        moves_tb = cand.is_move() | cand.is_swap()
        swap = cand.is_swap()
        lead1 = (cand.is_leadership() |
                 (moves_tb & model.replica_is_leader[cand.replica])).to(torch.float32)
        if has_swaps:
            same_t = swap & (t1 == t2)
            rep1 = torch.where(same_t, fzero, moves_tb.to(torch.float32))
            rep2 = torch.where(same_t, fzero, swap.to(torch.float32))
            leg_keys = torch.stack([t1 * nb_sel + src_b, t1 * nb_sel + dest_b,
                                    t2 * nb_sel + dest_b, t2 * nb_sel + src_b])
            d_rep = torch.stack([-rep1, rep1, -rep2, rep2])
            lead2 = (swap & model.replica_is_leader[safe_r2]).to(torch.float32)
            l1 = torch.where(same_t, lead1 - lead2, lead1)
            l2 = torch.where(same_t, fzero, lead2)
            d_lead = torch.stack([-l1, l1, -l2, l2])
        else:
            mv = moves_tb.to(torch.float32)
            leg_keys = torch.stack([t1 * nb_sel + src_b, t1 * nb_sel + dest_b])
            d_rep = torch.stack([-mv, mv])
            d_lead = torch.stack([-lead1, lead1])
        num_legs = leg_keys.shape[0]
        eps_tb = 1e-6

        def tb_ok(d, gain, shed):
            return ((d <= gain[leg_keys] + eps_tb) &
                    (d >= -shed[leg_keys] - eps_tb)).all(dim=0)

    elig = eligible
    cum_net = torch.zeros((nb_sel, NUM_CHANNELS), dtype=torch.float32, device=dev)
    budget_ok = ((d_dest <= room_dest[dest_b] + eps) &
                 (d_dest >= -slack_src[dest_b] - eps) &
                 (d_src >= -slack_src[src_b] - eps) &
                 (d_src <= room_dest[src_b] + eps)).all(dim=1)
    elig = elig & budget_ok
    if topic_on:
        elig = elig & tb_ok(d_rep, gain_rep, shed_rep) & \
            tb_ok(d_lead, torch.full_like(gain_rep, _INF), shed_lead)
    keep = _best_per_segment(score, src_lane, nb_sel * subrounds, elig)
    keep = _best_per_segment(score, dest_lane, nb_sel * subrounds, keep)
    keep = _best_per_segment(score, cand.partition, num_partitions, keep)
    if has_swaps:
        keep = _best_per_segment(score, cand.partition2, num_partitions, keep)
        claim1 = torch.zeros((num_partitions,), dtype=torch.int32, device=dev)
        claim1 = claim1.scatter_reduce_(0, torch.where(keep, cand.partition, 0).long(),
                                        keep.to(torch.int32), "amax") > 0
        keep = keep & ~((cand.partition2 != cand.partition) & claim1[cand.partition2])

    # Per-broker sums of a round's kept deltas, dest legs then src legs, in
    # lane order (fixed-order on the card: no float atomics).
    d_both = torch.cat([d_dest, d_src], dim=0)
    seg_both = torch.cat([dest_b, src_b])

    def round_net(k):
        return segment_sum(d_both, seg_both, torch.cat([k, k]), nb_sel)

    if topic_on:
        def round_tb(k, d):
            keys = torch.where(k[None, :], leg_keys, 0)
            return torch.zeros((n_tb,), dtype=torch.float32, device=dev).index_add_(
                0, keys.reshape(-1), torch.where(k[None, :], d, fzero).reshape(-1))

        def tb_viol(k):
            rep = round_tb(k, d_rep)
            lead = round_tb(k, d_lead)
            return ((rep > gain_rep + eps_tb) | (rep < -shed_rep - eps_tb) |
                    (lead < -shed_lead - eps_tb))

        def leg_contrib(i, k):
            return k & ((d_rep[i] != 0.0) | (d_lead[i] != 0.0))

        nl = 16
        lane_tb = lane % nl
        for i in range(num_legs):
            contrib = leg_contrib(i, keep)
            sel = _best_per_segment(score, leg_keys[i] * nl + lane_tb, n_tb * nl, contrib)
            keep = keep & (~contrib | sel)

        hi_tb = torch.stack([gain_rep, torch.full_like(gain_rep, _INF)], 1)
        lo_tb = torch.stack([-shed_rep, -shed_lead], 1)
        cum_tb = torch.zeros_like(hi_tb)
        vt = tb_viol(keep)
        rep_fired = rep_fired + vt.any().to(torch.int32)
        for i in range(num_legs):
            contrib = leg_contrib(i, keep)
            admit = kernels.prefix_cut_admit(
                score, leg_keys[i], torch.stack([d_rep[i], d_lead[i]], 1),
                contrib, cum_tb, lo_tb, hi_tb, n_tb)
            keep = keep & (~(contrib & vt[leg_keys[i]]) | admit)

    def net_viol(k):
        total = cum_net + round_net(k)
        out = ((total > room_dest + eps) | (total < -slack_src - eps)).any(dim=1)
        if topic_on:
            tb_bad = tb_viol(k)
            # key = topic * nb_sel + broker: fold the topic axis away.
            out = out | tb_bad.reshape(-1, nb_sel).any(dim=0)
        return out

    v = net_viol(keep)
    rep_fired = rep_fired + v.any().to(torch.int32)
    neg_slack = -slack_src
    for _ in range(2):
        admit_d = kernels.prefix_cut_admit(score, dest_b, d_dest, keep, cum_net,
                                           neg_slack, room_dest, nb_sel)
        keep = keep & (~v[dest_b] | admit_d)
        v = net_viol(keep)
        admit_s = kernels.prefix_cut_admit(score, src_b, d_src, keep, cum_net,
                                           neg_slack, room_dest, nb_sel)
        keep = keep & (~v[src_b] | admit_s)
        v = net_viol(keep)
    any_left = v.any()
    kk = score.shape[0]
    safe2 = kernels.prefix_admit_safe(
        torch.cat([score, score]), torch.cat([src_b, dest_b]),
        torch.cat([d_src, d_dest], dim=0), torch.cat([keep, keep]),
        cum_net, neg_slack, room_dest, nb_sel)
    safe = safe2[:kk] & safe2[kk:]
    if topic_on:
        contribs = [leg_contrib(i, keep) for i in range(num_legs)]
        safe_t = kernels.prefix_admit_safe(
            torch.cat([score] * num_legs),
            torch.cat([leg_keys[i] for i in range(num_legs)]),
            torch.cat([torch.stack([d_rep[i], d_lead[i]], 1)
                       for i in range(num_legs)], dim=0),
            torch.cat(contribs), cum_tb, lo_tb, hi_tb, n_tb).reshape(num_legs, kk)
        for i in range(num_legs):
            safe = safe & (~contribs[i] | safe_t[i])
    keep = torch.where(any_left, keep & safe, keep)
    if sel_idx is not None:
        full = torch.zeros((k_full,), dtype=torch.bool, device=dev)
        full[sel_idx] = keep
        keep = full
    return keep, (rep_fired, lanes_live, kernels.bisect_depth(kk))


# ---------------------------------------------------------------------------
# The per-goal step
# ---------------------------------------------------------------------------

def compute_step_invariants(spec: GoalSpec, prev_specs: Tuple[GoalSpec, ...],
                            model: TensorClusterModel, arrays: BrokerArrays,
                            constraint: BalancingConstraint) -> StepInvariants:
    """All step-invariant tensors of one goal's fixpoint."""
    all_specs = (spec,) + tuple(prev_specs)
    upper_min, lower_max = _band_sides(all_specs, model, arrays, constraint)
    spec_lower, spec_upper = kernels.limits(spec, model, arrays, constraint)
    topic_lower = topic_upper = None
    if any(s.kind == "topic_replica_distribution" for s in all_specs):
        topic_lower, topic_upper = kernels._topic_limits(model, arrays, constraint)
    return StepInvariants(upper_min=upper_min, lower_max=lower_max,
                          spec_lower=spec_lower, spec_upper=spec_upper,
                          topic_lower=topic_lower, topic_upper=topic_upper)


def _goal_num_sources(spec: GoalSpec, model: TensorClusterModel,
                      num_sources: int) -> int:
    """Rack healing is source-bound, so it gets a wide batch."""
    if spec.kind == "rack":
        return max(1, min(model.num_replicas_padded, max(4 * num_sources, 1024)))
    return num_sources


def _step_select(model: TensorClusterModel, options: OptimizationOptions,
                 spec: GoalSpec, prev_specs: Tuple[GoalSpec, ...],
                 constraint: BalancingConstraint, num_sources: int, num_dests: int,
                 invariants: Optional[StepInvariants] = None):
    """The selecting half of one step: ``(cand, keep bool[K], sel_stats)``."""
    all_specs = (spec,) + tuple(prev_specs)
    for s in all_specs:
        kernels.require_supported(s)
    if constraint.moves_per_broker_step > SUBROUNDS:
        raise NotImplementedError("multi-round selection (moves_per_broker_step > "
                                  f"{SUBROUNDS}) is not ported yet")
    arrays = BrokerArrays.from_model(
        model, with_topic_counts=any(s.kind == "topic_replica_distribution"
                                     for s in all_specs))
    num_sources = _goal_num_sources(spec, model, num_sources)
    inv = invariants
    if inv is None:
        inv = compute_step_invariants(spec, prev_specs, model, arrays, constraint)
    bands = (inv.spec_lower, inv.spec_upper)
    relevance = kernels.source_replica_relevance(spec, model, arrays, constraint,
                                                 bands=bands)
    batches = []
    if spec.uses_moves:
        num_matched = 0
        if spec.kind == "replica_distribution":
            num_matched = cgen.default_num_matched(model, num_sources)
        elif spec.kind == "topic_replica_distribution":
            num_matched = max(1, min(model.num_replicas_padded,
                                     max(16 * num_sources, 4096)))
        cross_ns = (min(num_sources, max(64, num_sources // 4))
                    if spec.kind == "replica_distribution" else num_sources)
        batches.append(cgen.combined_move_candidates(
            spec, model, arrays, constraint, options, cross_ns, num_dests,
            num_matched=num_matched, relevance=relevance, bands=bands))
    if spec.uses_leadership:
        batches.append(cgen.leadership_candidates(spec, model, arrays, constraint,
                                                  options, num_sources,
                                                  relevance=relevance, bands=bands))
    if spec.uses_intra_moves or spec.uses_intra_swaps:
        raise NotImplementedError(f"intra-broker actions of {spec.name}")
    sw_s = min(cgen.default_num_swap_sources(model), num_sources)
    sw_p = min(cgen.default_num_swap_partners(model), max(2, num_dests),
               model.num_replicas_padded)
    if spec.uses_swaps:
        batches.append(cgen.swap_candidates(spec, model, arrays, constraint, options,
                                            sw_s, sw_p, relevance=relevance,
                                            bands=bands))
    cand = batches[0]
    for extra in batches[1:]:
        cand = cgen.concat_candidates(cand, extra)

    # Band-kind prev goals' vetoes are subsumed by the channel budgets; the
    # structural kinds keep their dedicated accepts (K5b, torch ops).
    accepted = None
    for prev in prev_specs:
        if not kernels.is_band_kind(prev):
            a = kernels.accepts(prev, model, arrays, cand, constraint)
            accepted = a if accepted is None else accepted & a
    score, eligible = kernels.goal_masks(spec, model, arrays, cand, constraint,
                                         bands=bands, accepted=accepted)
    room_dest, slack_src = _channel_budgets(arrays, (inv.upper_min, inv.lower_max))
    topic_budgets = _topic_budgets(all_specs, model, arrays, inv)
    subrounds = min(SUBROUNDS, max(1, int(constraint.moves_per_broker_step)))
    compact_k = _lane_bucket(cand.k, model.num_brokers, subrounds)
    keep, sel_stats = select_batched(score, cand, eligible, model, room_dest, slack_src,
                                     topic_budgets, subrounds,
                                     has_swaps=spec.uses_swaps, compact_k=compact_k)
    return cand, keep, sel_stats


def _goal_step(model: TensorClusterModel, options: OptimizationOptions,
               spec: GoalSpec, prev_specs: Tuple[GoalSpec, ...],
               constraint: BalancingConstraint, num_sources: int, num_dests: int,
               invariants: Optional[StepInvariants] = None):
    """One optimization step for ``spec``: ``(new_model, n_kept, sel_stats)``
    as the JAX package's ``_goal_step`` (``optimizer.py:1205-1214``)."""
    cand, keep, sel_stats = _step_select(model, options, spec, prev_specs, constraint,
                                         num_sources, num_dests, invariants)
    return apply_candidates(model, cand, keep), keep.sum(), sel_stats


def _gated_step(st: StepState, inv: StepInvariants, spec: GoalSpec,
                prev_specs: Tuple[GoalSpec, ...], constraint: BalancingConstraint,
                num_sources: int, num_dests: int) -> None:
    """One iteration of the JAX package's fixpoint ``lax.while_loop``
    (``optimizer.py:1628-1651``) as an in-place update of ``st``: the step
    runs while ``last_n > 0 and steps < budget`` and is a no-op after —
    model and counters unchanged — so a chunk of them can run, or replay as
    a CUDA graph, without a host read between steps."""
    c = st.counters
    steps, last_n = c[CTR_STEPS], c[CTR_LAST_N]
    active = (last_n > 0) & (steps < c[CTR_BUDGET])
    cand, keep, (rep, lanes, depth) = _step_select(
        st.model, st.options, spec, prev_specs, constraint, num_sources, num_dests, inv)
    keep = keep & active
    new = apply_candidates(st.model, cand, keep)
    for f in MUTABLE_FIELDS:
        getattr(st.model, f).copy_(getattr(new, f))
    n = keep.sum(dtype=torch.int32)
    a = active.to(torch.int32)
    c.copy_(torch.stack([
        steps + a, c[CTR_TOTAL] + n, torch.where(active, n, last_n),
        c[CTR_REPAIR] + a * rep,
        torch.where(active, c[CTR_DEPTH].clamp(min=depth), c[CTR_DEPTH]),
        c[CTR_LANES] + a * lanes, c[CTR_BUDGET]]))


def _goal_fixpoint(model: TensorClusterModel, options: OptimizationOptions,
                   spec: GoalSpec, prev_specs: Tuple[GoalSpec, ...],
                   constraint: BalancingConstraint, num_sources: int,
                   num_dests: int, max_steps: int):
    """Run ``spec`` to its fixpoint: ``(model, packed i32[5])`` with the
    steps, actions, satisfied before/after and capped flags at the
    ``PACKED_*`` slots.  The step loop reads one count per step."""
    arrays0 = BrokerArrays.from_model(model)
    before = kernels.goal_satisfied(spec, model, arrays0, constraint)
    any_offline = (model.replica_offline_now() & model.replica_valid).any()
    skip = bool(before & ~any_offline)
    inv = compute_step_invariants(spec, prev_specs, model, arrays0, constraint)
    steps = total = 0
    last_n = 0 if skip else 1
    while last_n > 0 and steps < max_steps:
        model, n, _ = _goal_step(model, options, spec, prev_specs, constraint,
                                 num_sources, num_dests, invariants=inv)
        last_n = int(n)
        steps += 1
        total += last_n
    after = kernels.goal_satisfied(spec, model, BrokerArrays.from_model(model),
                                   constraint)
    capped = steps >= max_steps and last_n > 0
    packed = torch.zeros((5,), dtype=torch.int32)
    packed[PACKED_STEPS] = steps
    packed[PACKED_ACTIONS] = total
    packed[PACKED_BEFORE] = int(before)
    packed[PACKED_AFTER] = int(after)
    packed[PACKED_CAPPED] = int(capped)
    return model, packed


# ---------------------------------------------------------------------------
# The fused grouped stack (K8 and K12)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _GoalRun:
    """Host-side accounting of one goal of a fused group."""

    wall_s: float
    gated_steps: int  # gated steps run (graph replays on the card)
    fetches: int      # host reads of the counters
    captured: bool    # a step graph was captured for this goal


def _goal_fixpoint_budget(st: StepState, spec: GoalSpec,
                          prev_specs: Tuple[GoalSpec, ...],
                          constraint: BalancingConstraint, num_sources: int,
                          num_dests: int, max_steps: int,
                          cache: Optional[graphs.GraphCache]):
    """One goal of the fused stack on ``st``, in place: the JAX package's
    ``_goal_fixpoint_budget`` (``optimizer.py:1572-1702``) with
    ``frontier=None, touched=None, next_mask=None, flight_capacity=0``.
    Returns ``(packed i32[PACKED_WIDTH] on the device, _GoalRun)``.

    Gated steps run in chunks of 1, 2, 4, ... ``CHUNK_MAX``, each chunk
    followed by one host read of (steps, last_n); the goal ends when the
    last step applied nothing or the budget is spent.  With ``cache`` (the
    card) a chunk is that many replays of the goal's step graph, captured
    on first use; without it the gated step runs eagerly."""
    t0 = time.monotonic()
    model = st.model
    arrays0 = BrokerArrays.from_model(model)
    before = kernels.goal_satisfied(spec, model, arrays0, constraint)
    any_offline = (model.replica_offline_now() & model.replica_valid).any()
    skip = before & ~any_offline
    inv = compute_step_invariants(spec, prev_specs, model, arrays0, constraint)
    c = st.counters
    c.zero_()
    c[CTR_LAST_N] = (~skip).to(torch.int32)
    c[CTR_BUDGET] = max_steps
    step = functools.partial(_gated_step, spec=spec, prev_specs=prev_specs,
                             constraint=constraint, num_sources=num_sources,
                             num_dests=num_dests)
    captured = False
    if cache is None:
        def advance(times):
            for _ in range(times):
                step(st, inv)
    else:
        key = graphs.goal_key(spec, prev_specs, constraint, num_sources, num_dests, st)
        g = cache.get(key)
        if g is None:
            g = cache.capture(key, st, inv, step)
            captured = True
        g.load(inv)
        advance = g.replay
    gated = fetches = 0
    chunk = 1
    while True:
        advance(chunk)
        gated += chunk
        steps, last_n = c[[CTR_STEPS, CTR_LAST_N]].tolist()
        fetches += 1
        if last_n == 0 or steps >= max_steps:
            break
        chunk = min(2 * chunk, CHUNK_MAX)
    arrays1 = BrokerArrays.from_model(model)
    after = kernels.goal_satisfied(spec, model, arrays1, constraint)
    off_after = (model.replica_offline_now() & model.replica_valid).any()
    capped = (c[CTR_STEPS] >= c[CTR_BUDGET]) & (c[CTR_LAST_N] > 0)
    if kernels.is_band_kind(spec):
        num_active = kernels.frontier_active(spec, model, arrays1, constraint).sum()
    else:
        num_active = torch.full((), -1, device=model.device)
    i32 = torch.int32
    packed = torch.stack([
        c[CTR_STEPS], c[CTR_TOTAL], before.to(i32), after.to(i32), capped.to(i32),
        c[CTR_REPAIR], c[CTR_DEPTH], c[CTR_LANES], num_active.to(i32),
        off_after.to(i32), torch.zeros((), dtype=i32, device=model.device)])
    return packed, _GoalRun(wall_s=time.monotonic() - t0, gated_steps=gated,
                            fetches=fetches, captured=captured)


def _stack_fixpoint(st: StepState, specs: Tuple[GoalSpec, ...],
                    constraint: BalancingConstraint, num_sources: int, num_dests: int,
                    max_steps: int, prev_specs: Tuple[GoalSpec, ...] = (),
                    cache: Optional[graphs.GraphCache] = None):
    """A group of goals chained in priority order on ``st`` (the JAX
    package's ``_stack_fixpoint``, ``optimizer.py:2491``): each goal runs
    under the acceptance of every goal before it.  Returns ``(packed
    i32[PACKED_WIDTH, G] on the host — one fetch for the group —,
    [_GoalRun])``."""
    packed_l, runs = [], []
    prev = tuple(prev_specs)
    for spec in specs:
        packed, run = _goal_fixpoint_budget(st, spec, prev, constraint, num_sources,
                                            num_dests, max_steps, cache)
        packed_l.append(packed)
        runs.append(run)
        prev = prev + (spec,)
    return torch.stack(packed_l, dim=1).cpu().numpy(), runs


# ---------------------------------------------------------------------------
# Goal orchestration (priority order)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GoalResult:
    name: str
    is_hard: bool
    satisfied_before: bool
    satisfied_after: bool
    steps: int
    actions_applied: int
    duration_s: float
    capped: bool = False
    # Fused path only (zeros on the unfused path): True when a step graph
    # was captured for this goal in this run; the repair counters of the
    # packed stats; host reads (counter reads, plus the group's packed
    # fetch on its lead goal); gated steps run (graph replays on the card),
    # of which ``replays - steps`` were gated off.
    fresh_compile: bool = False
    repair_steps: int = 0
    bisect_depth: int = 0
    lanes_live: int = 0
    fetches: int = 0
    replays: int = 0


@dataclasses.dataclass
class OptimizerRun:
    """Result bundle of one optimization pass (analyzer/OptimizerResult.java:34)."""

    model: TensorClusterModel
    goal_results: List[GoalResult]
    stats_before: ClusterModelStats
    stats_after: ClusterModelStats
    num_candidates_scored: int
    provision_response: object = None
    balancedness_before: float = 100.0
    balancedness_after: float = 100.0

    @property
    def violated_goals_before(self) -> List[str]:
        return [g.name for g in self.goal_results if not g.satisfied_before]

    @property
    def violated_goals_after(self) -> List[str]:
        return [g.name for g in self.goal_results if not g.satisfied_after]


def _optimize_fused(model: TensorClusterModel, options: OptimizationOptions,
                    specs: Sequence[GoalSpec], constraint: BalancingConstraint,
                    ns: int, nd: int, max_steps: int, group: int,
                    raise_on_hard_failure: bool, k_of,
                    cache: Optional[graphs.GraphCache]):
    """The grouped stack (``optimizer.py:3480-3618``): groups of ``group``
    goals in priority order over one working state, each group's packed
    stats fetched once.  Returns ``(final model, [GoalResult], candidates
    scored)``."""
    st = cache.state(model, options) if cache is not None else \
        StepState.working(model, options)
    results: List[GoalResult] = []
    scored = 0
    prev: Tuple[GoalSpec, ...] = ()
    for start in range(0, len(specs), group):
        chunk = tuple(specs[start:start + group])
        packed, runs = _stack_fixpoint(st, chunk, constraint, ns, nd, max_steps,
                                       prev_specs=prev, cache=cache)
        for i, (spec, run) in enumerate(zip(chunk, runs)):
            col = packed[:, i]
            steps = int(col[PACKED_STEPS])
            scored += steps * k_of(spec)
            results.append(GoalResult(
                name=spec.name, is_hard=spec.is_hard,
                satisfied_before=bool(col[PACKED_BEFORE]),
                satisfied_after=bool(col[PACKED_AFTER]), steps=steps,
                actions_applied=int(col[PACKED_ACTIONS]), duration_s=run.wall_s,
                capped=bool(col[PACKED_CAPPED]), fresh_compile=run.captured,
                repair_steps=int(col[PACKED_REPAIR_STEPS]),
                bisect_depth=int(col[PACKED_BISECT_DEPTH]),
                lanes_live=int(col[PACKED_LANES_LIVE]),
                fetches=run.fetches + (1 if i == 0 else 0),
                replays=run.gated_steps))
        for spec, res in zip(chunk, results[-len(chunk):]):
            if spec.is_hard and not res.satisfied_after and raise_on_hard_failure:
                raise OptimizationFailureException(
                    f"hard goal {spec.name} not satisfied after optimization")
        prev = prev + chunk
    return st.placement(model), results, scored


def optimize(model: TensorClusterModel, goal_names: Sequence[str],
             constraint: Optional[BalancingConstraint] = None,
             options: Optional[OptimizationOptions] = None,
             max_steps_per_goal: int = 256,
             num_sources: Optional[int] = None, num_dests: Optional[int] = None,
             raise_on_hard_failure: bool = True,
             fused: bool = False,
             fuse_group_size: Optional[int] = None,
             fast_mode: bool = False,
             max_candidates_per_step: Optional[int] = None,
             segment_steps: Optional[int] = None,
             balancedness_priority_weight: float = 1.1,
             balancedness_strictness_weight: float = 1.5,
             mesh=None, donate_model: bool = False,
             frontier: Optional[bool] = None,
             warm_start=None, pipeline: Optional[bool] = None,
             device: Union[str, torch.device] = "cuda") -> OptimizerRun:
    """Run the goal stack in priority order (GoalOptimizer.optimizations) on
    ``device`` (the model is moved there; raises when it names CUDA and
    none is present).  Each goal runs to its fixpoint under the acceptance
    of all previously optimized goals; a hard goal left unsatisfied raises
    unless ``raise_on_hard_failure`` is False.

    ``fused=False`` is the JAX package's unfused dense path.  ``fused=True``
    is its grouped stack: the whole stack as one group at 64 brokers or
    fewer, or groups of ``fuse_group_size`` > 1 goals at any size, each
    group's packed stats fetched once.  Above 64 brokers without such a
    group size, and with ``fuse_group_size=1``, the JAX package runs its
    per-goal frontier driver: not ported yet, so these raise
    ``NotImplementedError``, as do ``frontier=True``, ``pipeline=True``,
    ``warm_start``, ``mesh`` and ``segment_steps``.

    ``fast_mode`` halves the candidate widths and quarters the step budget,
    ``max_candidates_per_step`` caps the widths (the JAX package's host
    arithmetic); the balancedness weights price violated goals.  The
    caller's model is never written on either path: the fused path steps on
    a working copy (on the card, the step graphs' static buffers), so
    ``donate_model`` only records the caller's consent.  On the card the
    fused path replays the gated steps' CUDA graphs (``graphs.GRAPHS``)."""
    for name, value in (("mesh", mesh), ("warm_start", warm_start),
                        ("segment_steps", segment_steps)):
        if value is not None:
            raise NotImplementedError(f"optimize({name}=...) is not ported yet")
    if frontier or pipeline:
        raise NotImplementedError("optimize(frontier=True / pipeline=True) is not ported yet")
    dev = resolve_device(device)
    model = model.to(dev)
    constraint = constraint or BalancingConstraint.default()
    options = options if options is not None else OptimizationOptions.none(model)
    specs = goals_by_priority(goal_names)
    for s in specs:
        kernels.require_supported(s)
    if fused:
        if fuse_group_size is not None and fuse_group_size < 1:
            raise ValueError(f"fuse_group_size must be positive, got {fuse_group_size}")
        if fuse_group_size == 1 or (fuse_group_size is None
                                    and model.num_brokers > _FRONTIER_DENSE_MIN):
            raise NotImplementedError(
                "optimize(fused=True) runs the per-goal frontier driver here "
                f"({model.num_brokers} brokers, fuse_group_size={fuse_group_size}); "
                "only the grouped stack (fuse_group_size > 1, or at most "
                f"{_FRONTIER_DENSE_MIN} brokers) is ported yet")
    if fast_mode:
        num_sources = min(max(32, (num_sources or cgen.default_num_sources(model)) // 2),
                          model.num_replicas_padded)
        num_dests = max(min(8, model.num_brokers),
                        min((num_dests or cgen.default_num_dests(model)) // 2,
                            model.num_brokers))
        max_steps_per_goal = max(max_steps_per_goal // 4, 16)
    stats_before = compute_stats(model)
    ns = num_sources or cgen.default_num_sources(model)
    nd = num_dests or cgen.default_num_dests(model)
    if max_candidates_per_step:
        ns = max(1, min(ns, max_candidates_per_step))
        nd = max(1, min(nd, max_candidates_per_step // ns))

    def k_of(spec: GoalSpec) -> int:
        k = ns * nd * (1 if spec.uses_moves else 0)
        if spec.uses_leadership:
            k += ns * model.max_rf
        if spec.uses_swaps:
            k += min(cgen.default_num_swap_sources(model), ns) * \
                min(cgen.default_num_swap_partners(model), max(2, nd),
                    model.num_replicas_padded)
        return k

    results: List[GoalResult] = []
    scored = 0
    if fused:
        cache = graphs.GRAPHS if dev.type == "cuda" else None
        with cache.lock if cache is not None else contextlib.nullcontext():
            model, results, scored = _optimize_fused(
                model, options, specs, constraint, ns, nd, max_steps_per_goal,
                fuse_group_size or len(specs) or 1, raise_on_hard_failure, k_of, cache)
    else:
        prev = ()
        for spec in specs:
            t0 = time.monotonic()
            model, packed = _goal_fixpoint(model, options, spec, prev, constraint,
                                           ns, nd, max_steps_per_goal)
            steps, actions = int(packed[PACKED_STEPS]), int(packed[PACKED_ACTIONS])
            after = bool(packed[PACKED_AFTER])
            scored += steps * k_of(spec)
            results.append(GoalResult(name=spec.name, is_hard=spec.is_hard,
                                      satisfied_before=bool(packed[PACKED_BEFORE]),
                                      satisfied_after=after, steps=steps,
                                      actions_applied=actions,
                                      duration_s=time.monotonic() - t0,
                                      capped=bool(packed[PACKED_CAPPED])))
            if spec.is_hard and not after and raise_on_hard_failure:
                raise OptimizationFailureException(
                    f"hard goal {spec.name} not satisfied after optimization")
            prev = prev + (spec,)

    provision = ProvisionResponse()
    view = host_view(model)
    for spec, res in zip(specs, results):
        provision.aggregate(provision_verdict_for_goal(spec, model, constraint,
                                                       res.satisfied_after, view))
    costs = balancedness_cost_by_goal(specs, balancedness_priority_weight,
                                      balancedness_strictness_weight)
    return OptimizerRun(model=model, goal_results=results, stats_before=stats_before,
                        stats_after=compute_stats(model), num_candidates_scored=scored,
                        provision_response=provision,
                        balancedness_before=balancedness_score(
                            costs, [g.name for g in results if not g.satisfied_before]),
                        balancedness_after=balancedness_score(
                            costs, [g.name for g in results if not g.satisfied_after]))
