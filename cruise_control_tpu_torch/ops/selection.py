"""K4 — the selection glue of ``select_batched``, as six kernels.

Counterpart of the elementwise, gather and scatter passes around K2's and
K3's launches in ``cruise_control_tpu/analyzer/optimizer.py:410-871``: once
a step, after the live-lane compaction (``ops.order.masked_top_k``),

- ``select_legs`` (K4e, ``cc_select_legs``): the compacted lanes' fields,
  broker slots on the frontier, subround keys, channel deltas and (topic,
  broker) legs with their deltas and K2 keys, in the layouts the rounds
  read (``optimizer.py:514-580``);
- ``frontier_budgets`` (K4e, ``cc_frontier_budgets``): the broker and
  (topic, broker) budgets gathered onto the frontier's slots, the negated
  slack and K3's bounds of the topic cuts (``optimizer.py:521-531``);

and in every round of a step's selection (``rounds`` = ceil(moves per
broker and step / 128)):

- ``select_mask`` (K4a, ``cc_select_mask``): a round's eligibility — the
  broker channel budgets against each lane's deltas, the (topic, broker)
  replica and leader budgets against each of its legs, and from round 2 on
  the step's cumulative sums, its kept lanes, its used partitions and, under
  ``disk_guard``, its used disks (``optimizer.py:584-587,599-637``);
- ``topic_round_sums`` (K4b, ``cc_topic_round_sums``): the kept legs' replica
  and leader deltas summed by (topic, broker) key onto the cumulative sums,
  the keys over their budgets and those folded onto the brokers
  (``optimizer.py:671-682,745-749,859-860``);
- ``net_viol`` (K4c, ``cc_net_viol``): the brokers whose cumulative and
  round channel sums leave their budgets, or whose topic keys do
  (``optimizer.py:739-751``);
- ``partition_claims`` (K4d, ``cc_partition_claims``): the kept lanes
  OR-scattered onto their partitions — a swap round's cross-field claim
  (``optimizer.py:645-652``) or the used partitions and disks between rounds
  (``optimizer.py:851-864``).

Each wrapper checks its inputs, records them (``cuda.record``; each form
also as ``<name>[cum]``, ``[topic]`` or ``[cum,topic]``, K4d's two modes as
``partition_claims[claim]`` and ``[used]``, K4e's as ``select_legs[...]``
and ``frontier_budgets[...]`` with ``compact``, ``frontier`` and
``topic`` as they apply), takes its
plain twin (``*_plain``, the torch ops the selection ran before) when the
tensors lie on the CPU and launches ``csrc/selection.cu`` on the card.
Every output is a bool, an integer, a gathered float or its negation (-0.0
kept), or an exact integer-valued float, so the card equals the plain twin
bit for bit: the budget tests add with ``__fadd_rn`` and
compare in f32 as the twin does, and the (topic, broker) sums add the legs'
integer deltas (-1, 0 or +1; at most K·L in size) in int32 atomics, exact in
any order, and convert once.  Rows of an unkept lane are never visited.

Inputs that the kernels take as "None" are the JAX package's round-1
specialisation (no cumulative sums, no used sets): a cumulative sum of zeros
compares the same.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from cruise_control_tpu_torch.analyzer import candidates as cgen
from cruise_control_tpu_torch.ops import cuda

# The selection's comparison tolerance (``optimizer.py:482,582``).
EPS = 1e-6
# The 8 budget channels of a broker (``optimizer.NUM_CHANNELS``).
NUM_CHANNELS = 8

# (leg_keys i32[L, K], d_rep f32[L, K], d_lead f32[L, K], gain_rep, shed_rep,
# shed_lead f32[n_tb], cum_rep, cum_lead f32[n_tb] or None)
TopicLegs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]
# (keep_total bool[K], used_part bool[P], partition i32[K], partition2 i32[K])
UsedParts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (src_disk i32[K], dest_disk i32[K], used_sdisk bool[D], used_ddisk bool[D])
UsedDisks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _record(name: str, args: tuple, cum: bool, topic: bool) -> None:
    """``cuda.record`` under ``name`` and under the name of its form:
    ``[topic]`` with (topic, broker) budgets, ``[cum]`` in rounds 2 on (the
    step's cumulative sums given), ``[cum,topic]`` with both."""
    cuda.record(name, args)
    form = ",".join(f for f, on in (("cum", cum), ("topic", topic)) if on)
    if form:
        cuda.record(f"{name}[{form}]", args)


def _check_topic(topic: TopicLegs, k: int, dev: torch.device) -> Tuple[int, int]:
    leg_keys, d_rep, d_lead, gain_rep, shed_rep, shed_lead, cum_rep, cum_lead = topic
    legs, n_tb = leg_keys.shape[0], gain_rep.shape[0]
    cuda.check(leg_keys, "leg_keys", torch.int32, (legs, k), dev)
    cuda.check(d_rep, "d_rep", torch.float32, (legs, k), dev)
    cuda.check(d_lead, "d_lead", torch.float32, (legs, k), dev)
    for t, what in ((gain_rep, "gain_rep"), (shed_rep, "shed_rep"), (shed_lead, "shed_lead")):
        cuda.check(t, what, torch.float32, (n_tb,), dev)
    if (cum_rep is None) != (cum_lead is None):
        raise ValueError("cum_rep and cum_lead come together")
    if cum_rep is not None:
        cuda.check(cum_rep, "cum_rep", torch.float32, (n_tb,), dev)
        cuda.check(cum_lead, "cum_lead", torch.float32, (n_tb,), dev)
    return legs, n_tb


# ---------------------------------------------------------------------------
# K4a — a round's eligibility
# ---------------------------------------------------------------------------

def select_mask_plain(eligible: torch.Tensor, d_src: torch.Tensor, d_dest: torch.Tensor,
                      src_b: torch.Tensor, dest_b: torch.Tensor, room_dest: torch.Tensor,
                      slack_src: torch.Tensor, cum_net: Optional[torch.Tensor],
                      topic: Optional[TopicLegs] = None, used: Optional[UsedParts] = None,
                      disks: Optional[UsedDisks] = None) -> torch.Tensor:
    """``select_mask``'s plain twin: the JAX package's lines in torch ops."""
    elig = eligible
    if used is not None:
        keep_total, used_part, partition, partition2 = used
        elig = elig & ~keep_total & ~used_part[partition] & ~used_part[partition2]
    if disks is not None:
        src_disk, dest_disk, used_sdisk, used_ddisk = disks
        touches = dest_disk >= 0
        elig = elig & ~(touches & (used_sdisk[src_disk.clamp(min=0)] |
                                   used_ddisk[dest_disk.clamp(min=0)]))
    t_dest, t_src = d_dest, d_src
    if cum_net is not None:
        t_dest, t_src = cum_net[dest_b] + d_dest, cum_net[src_b] + d_src
    budget_ok = ((t_dest <= room_dest[dest_b] + EPS) &
                 (t_dest >= -slack_src[dest_b] - EPS) &
                 (t_src >= -slack_src[src_b] - EPS) &
                 (t_src <= room_dest[src_b] + EPS)).all(dim=1)
    elig = elig & budget_ok
    if topic is not None:
        leg_keys, d_rep, d_lead, gain_rep, shed_rep, shed_lead, cum_rep, cum_lead = topic
        rep, lead = d_rep, d_lead
        if cum_rep is not None:
            rep, lead = cum_rep[leg_keys] + d_rep, cum_lead[leg_keys] + d_lead
        rep_ok = ((rep <= gain_rep[leg_keys] + EPS) &
                  (rep >= -shed_rep[leg_keys] - EPS)).all(dim=0)
        # The leader legs have no gain budget (+inf): only NaN fails it.
        lead_ok = ((lead <= torch.full_like(gain_rep, torch.inf)[leg_keys] + EPS) &
                   (lead >= -shed_lead[leg_keys] - EPS)).all(dim=0)
        elig = elig & rep_ok & lead_ok
    return elig


@cuda.counted("select_mask")
def select_mask(eligible: torch.Tensor, d_src: torch.Tensor, d_dest: torch.Tensor,
                src_b: torch.Tensor, dest_b: torch.Tensor, room_dest: torch.Tensor,
                slack_src: torch.Tensor, cum_net: Optional[torch.Tensor],
                topic: Optional[TopicLegs] = None, used: Optional[UsedParts] = None,
                disks: Optional[UsedDisks] = None) -> torch.Tensor:
    """K4a.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:584-587,
    599-637``: bool[K], the lanes of a selection round that may compete —
    ``eligible``; every channel of ``d_dest`` (f32[K, 8], on broker
    ``dest_b``) and of ``d_src`` (on ``src_b``), added to ``cum_net``
    (f32[nb, 8], the step's cumulative net sums; None in round 1), inside
    [-slack_src - eps, room_dest + eps] of its broker; with ``topic`` every
    leg's replica delta, added to ``cum_rep`` at its (topic, broker) key,
    inside [-shed_rep - eps, gain_rep + eps] and its leader delta, added to
    ``cum_lead``, at least -shed_lead - eps; with ``used`` (rounds 2 on) not
    kept yet and neither partition used; with ``disks`` no lane landing on a
    disk whose source or destination disk is used.  Bound on the card:
    bytes (K·(1 + 72) read and K written, plus the legs' 12·L·K and the
    used sets' K·10; the budget rows are gathers of a few KB that stay in
    L2).  CPU tensors take ``select_mask_plain``; CUDA tensors launch one
    thread a lane that stops at its first failed test."""
    dev = eligible.device
    k = eligible.shape[0]
    nb = room_dest.shape[0]
    cuda.check(eligible, "eligible", torch.bool, (k,), dev)
    cuda.check(d_src, "d_src", torch.float32, (k, NUM_CHANNELS), dev)
    cuda.check(d_dest, "d_dest", torch.float32, (k, NUM_CHANNELS), dev)
    cuda.check(src_b, "src_b", torch.int32, (k,), dev)
    cuda.check(dest_b, "dest_b", torch.int32, (k,), dev)
    cuda.check(room_dest, "room_dest", torch.float32, (nb, NUM_CHANNELS), dev)
    cuda.check(slack_src, "slack_src", torch.float32, (nb, NUM_CHANNELS), dev)
    if cum_net is not None:
        cuda.check(cum_net, "cum_net", torch.float32, (nb, NUM_CHANNELS), dev)
    legs = n_tb = 0
    if topic is not None:
        legs, n_tb = _check_topic(topic, k, dev)
    num_parts = num_disks = 0
    if used is not None:
        keep_total, used_part, partition, partition2 = used
        num_parts = used_part.shape[0]
        cuda.check(keep_total, "keep_total", torch.bool, (k,), dev)
        cuda.check(used_part, "used_part", torch.bool, (num_parts,), dev)
        cuda.check(partition, "partition", torch.int32, (k,), dev)
        cuda.check(partition2, "partition2", torch.int32, (k,), dev)
    if disks is not None:
        src_disk, dest_disk, used_sdisk, used_ddisk = disks
        num_disks = used_sdisk.shape[0]
        cuda.check(src_disk, "src_disk", torch.int32, (k,), dev)
        cuda.check(dest_disk, "dest_disk", torch.int32, (k,), dev)
        cuda.check(used_sdisk, "used_sdisk", torch.bool, (num_disks,), dev)
        cuda.check(used_ddisk, "used_ddisk", torch.bool, (num_disks,), dev)
    args = (eligible, d_src, d_dest, src_b, dest_b, room_dest, slack_src, cum_net, topic, used,
            disks)
    _record("select_mask", args, cum_net is not None, topic is not None)
    if cuda.on_cpu(eligible):
        return select_mask_plain(eligible, d_src, d_dest, src_b, dest_b, room_dest, slack_src,
                                 cum_net, topic, used, disks)
    out = torch.empty((k,), dtype=torch.bool, device=dev)
    if k == 0:
        return out
    t = topic or (None,) * 8
    u = used or (None,) * 4
    dk = disks or (None,) * 4
    cuda.launch("select_mask", k, nb, legs, n_tb, num_parts, num_disks,
                eligible, d_src, d_dest, src_b, dest_b, room_dest, slack_src, cum_net,
                *t, *u, *dk, out)
    select_mask.launches += 1
    return out


# ---------------------------------------------------------------------------
# K4b — the (topic, broker) sums of a round's kept legs
# ---------------------------------------------------------------------------

def topic_round_sums_plain(keep: torch.Tensor, topic: TopicLegs, nb_sel: int,
                           write_cum: bool = False):
    """``topic_round_sums``'s plain twin: the JAX package's ``round_tb``
    scatter-adds (unkept legs add 0 at key 0) and ``tb_viol``."""
    leg_keys, d_rep, d_lead, gain_rep, shed_rep, shed_lead, cum_rep, cum_lead = topic
    n_tb = gain_rep.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    keys = torch.where(keep[None, :], leg_keys, 0).reshape(-1)

    def round_tb(d):
        return torch.zeros((n_tb,), dtype=torch.float32, device=keep.device).index_add_(
            0, keys, torch.where(keep[None, :], d, zero).reshape(-1))

    rep, lead = round_tb(d_rep), round_tb(d_lead)
    if cum_rep is not None:
        rep, lead = cum_rep + rep, cum_lead + lead
    vt = (rep > gain_rep + EPS) | (rep < -shed_rep - EPS) | (lead < -shed_lead - EPS)
    # key = topic * nb_sel + broker: fold the topic axis away.
    bad_b = vt.reshape(-1, nb_sel).any(dim=0)
    if not write_cum:
        return vt, bad_b, None, None
    return vt, bad_b, rep, lead


@cuda.counted("topic_round_sums")
def topic_round_sums(keep: torch.Tensor, topic: TopicLegs, nb_sel: int,
                     write_cum: bool = False):
    """K4b.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:671-682,
    745-749,859-860`` (``round_tb``, ``tb_viol``, the fold onto the brokers
    and the cumulative update): for the lanes set in ``keep`` (bool[K]),
    ``rep = cum_rep + Σ d_rep`` and ``lead = cum_lead + Σ d_lead`` over their
    legs by (topic, broker) key (``topic``, see ``select_mask``; no cum in
    round 1); returns (vt bool[n_tb]: rep > gain_rep + eps, rep < -shed_rep
    - eps or lead < -shed_lead - eps; bad_b bool[nb_sel]: any key of the
    broker in vt; rep and lead f32[n_tb], the next round's cumulative sums,
    with ``write_cum``, else None).  The deltas are -1, 0 or +1.  Bound on
    the card: bytes (K read and the kept legs' 12 each, n_tb·(12 + 8 with
    cum) read, n_tb + nb_sel written, and 8·n_tb with ``write_cum``).  CPU
    tensors take ``topic_round_sums_plain`` (``index_add_``); CUDA tensors
    launch one thread a (leg, lane) that adds a kept leg's non-zero deltas
    into int32 counts by atomics (exact in any order) and one thread a key
    that converts them once, adds the cum and tests the budgets."""
    dev = keep.device
    k = keep.shape[0]
    cuda.check(keep, "keep", torch.bool, (k,), dev)
    legs, n_tb = _check_topic(topic, k, dev)
    if nb_sel <= 0 or n_tb % nb_sel:
        raise ValueError(f"topic_round_sums: {n_tb} keys do not fold onto {nb_sel} brokers")
    _record("topic_round_sums", (keep, topic, nb_sel, write_cum), topic[6] is not None, False)
    if cuda.on_cpu(keep):
        return topic_round_sums_plain(keep, topic, nb_sel, write_cum)
    leg_keys, d_rep, d_lead, gain_rep, shed_rep, shed_lead, cum_rep, cum_lead = topic
    vt = torch.empty((n_tb,), dtype=torch.bool, device=dev)
    bad_b = torch.empty((nb_sel,), dtype=torch.bool, device=dev)
    rep = lead = None
    if write_cum:
        rep = torch.empty((n_tb,), dtype=torch.float32, device=dev)
        lead = torch.empty((n_tb,), dtype=torch.float32, device=dev)
    counts = torch.empty((2 * n_tb,), dtype=torch.int32, device=dev)
    cuda.launch("topic_round_sums", k, legs, n_tb, nb_sel, keep, leg_keys, d_rep, d_lead,
                gain_rep, shed_rep, shed_lead, cum_rep, cum_lead, counts, vt, bad_b, rep, lead)
    topic_round_sums.launches += 1
    return vt, bad_b, rep, lead


# ---------------------------------------------------------------------------
# K4c — the brokers out of their budgets
# ---------------------------------------------------------------------------

def net_viol_plain(cum_net: Optional[torch.Tensor], round_net: torch.Tensor,
                   room_dest: torch.Tensor, slack_src: torch.Tensor,
                   bad_b: Optional[torch.Tensor]) -> torch.Tensor:
    """``net_viol``'s plain twin: the JAX package's ``net_viol`` after its
    round sums."""
    total = round_net if cum_net is None else cum_net + round_net
    out = ((total > room_dest + EPS) | (total < -slack_src - EPS)).any(dim=1)
    return out if bad_b is None else out | bad_b


@cuda.counted("net_viol")
def net_viol(cum_net: Optional[torch.Tensor], round_net: torch.Tensor,
             room_dest: torch.Tensor, slack_src: torch.Tensor,
             bad_b: Optional[torch.Tensor]) -> torch.Tensor:
    """K4c.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:739-751``
    after its round sums: bool[nb], the brokers with a channel where
    ``cum_net + round_net`` (f32[nb, 8]; no ``cum_net`` in round 1) passes
    ``room_dest + eps`` or falls below ``-slack_src - eps``, or whose
    ``bad_b`` (K4b's fold; None without topic budgets) is set.  The round
    sums stay ``segment_sum`` (K1 family).  Bound on the card: bytes
    (nb·(96 + 32 with cum + 1) read, nb written).  CPU tensors take
    ``net_viol_plain``; CUDA tensors launch one thread a broker."""
    dev = round_net.device
    nb = round_net.shape[0]
    for t, what in ((round_net, "round_net"), (room_dest, "room_dest"),
                    (slack_src, "slack_src")):
        cuda.check(t, what, torch.float32, (nb, NUM_CHANNELS), dev)
    if cum_net is not None:
        cuda.check(cum_net, "cum_net", torch.float32, (nb, NUM_CHANNELS), dev)
    if bad_b is not None:
        cuda.check(bad_b, "bad_b", torch.bool, (nb,), dev)
    _record("net_viol", (cum_net, round_net, room_dest, slack_src, bad_b), cum_net is not None,
            bad_b is not None)
    if cuda.on_cpu(round_net):
        return net_viol_plain(cum_net, round_net, room_dest, slack_src, bad_b)
    out = torch.empty((nb,), dtype=torch.bool, device=dev)
    if nb > 0:
        cuda.launch("net_viol", nb, cum_net, round_net, room_dest, slack_src, bad_b, out)
        net_viol.launches += 1
    return out


# ---------------------------------------------------------------------------
# K4d — kept lanes onto their partitions (and disks)
# ---------------------------------------------------------------------------

# What a ``partition_claims`` call computes: a swap round's cross-field
# claim, or the used partitions and disks between rounds.
CLAIM_MODES = ("claim", "used")
_CLAIM_COUNTS = cuda.mode_counters("partition_claims", CLAIM_MODES)


def _or_scatter(flags: torch.Tensor, index: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``flags.at[where(keep, index, 0)].max(keep)``."""
    out = flags.to(torch.int32).scatter_reduce_(0, torch.where(keep, index, 0).long(),
                                                keep.to(torch.int32), "amax")
    return out > 0


def partition_claims_plain(keep: torch.Tensor, partition: torch.Tensor,
                           partition2: torch.Tensor, num_partitions: int,
                           used: Optional[torch.Tensor] = None,
                           disks: Optional[UsedDisks] = None) -> Optional[torch.Tensor]:
    """``partition_claims``'s plain twin: the JAX package's scatter-max
    lines; the used sets are updated in place."""
    if used is None:
        claim1 = _or_scatter(torch.zeros((num_partitions,), dtype=torch.bool,
                                         device=keep.device), partition, keep)
        return keep & ~((partition2 != partition) & claim1[partition2])
    used.copy_(_or_scatter(_or_scatter(used, partition, keep), partition2, keep))
    if disks is not None:
        src_disk, dest_disk, used_sdisk, used_ddisk = disks
        touches = keep & (dest_disk >= 0)
        used_sdisk.copy_(_or_scatter(used_sdisk, src_disk.clamp(min=0), touches))
        used_ddisk.copy_(_or_scatter(used_ddisk, dest_disk.clamp(min=0), touches))
    return None


@cuda.counted("partition_claims")
def partition_claims(keep: torch.Tensor, partition: torch.Tensor, partition2: torch.Tensor,
                     num_partitions: int, used: Optional[torch.Tensor] = None,
                     disks: Optional[UsedDisks] = None) -> Optional[torch.Tensor]:
    """K4d.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:645-652``
    (``claim1``) and ``:851-852,862-864`` (the used sets): with ``used``
    None, the claim of a swap round — bool[K], ``keep`` without the lanes
    whose ``partition2`` differs from their ``partition`` and is another
    kept lane's ``partition``; with ``used`` (bool[P]), the kept lanes'
    ``partition`` and ``partition2`` are set in it in place, and with
    ``disks`` the source and destination disks (clamped at 0) of the kept
    lanes that land on a disk in ``used_sdisk`` and ``used_ddisk``; returns
    None.  Bound on the card: bytes (K·9 read; P + K written for a claim,
    the kept lanes' few bytes for the used sets).  CPU tensors take
    ``partition_claims_plain``; CUDA tensors launch one thread a lane that
    stores a 1 for each of its claims (every store writes the same byte, so
    the order does not matter), after a memset of the claim flags and
    before one thread a lane that drops the claimed lanes."""
    dev = keep.device
    k = keep.shape[0]
    cuda.check(keep, "keep", torch.bool, (k,), dev)
    cuda.check(partition, "partition", torch.int32, (k,), dev)
    cuda.check(partition2, "partition2", torch.int32, (k,), dev)
    num_disks = 0
    if used is not None:
        cuda.check(used, "used", torch.bool, (num_partitions,), dev)
    elif disks is not None:
        raise ValueError("partition_claims: the used disks go with the used partitions")
    if disks is not None:
        src_disk, dest_disk, used_sdisk, used_ddisk = disks
        num_disks = used_sdisk.shape[0]
        cuda.check(src_disk, "src_disk", torch.int32, (k,), dev)
        cuda.check(dest_disk, "dest_disk", torch.int32, (k,), dev)
        cuda.check(used_sdisk, "used_sdisk", torch.bool, (num_disks,), dev)
        cuda.check(used_ddisk, "used_ddisk", torch.bool, (num_disks,), dev)
    args = (keep, partition, partition2, num_partitions, used, disks)
    cuda.record("partition_claims", args)
    cuda.record(f"partition_claims[{'claim' if used is None else 'used'}]", args)
    if cuda.on_cpu(keep):
        return partition_claims_plain(keep, partition, partition2, num_partitions, used, disks)
    mode = "claim" if used is None else "used"
    out = claims = None
    if used is None:
        out = torch.empty((k,), dtype=torch.bool, device=dev)
        claims = torch.empty((num_partitions,), dtype=torch.bool, device=dev)
    else:
        claims = used
    if k == 0 or num_partitions == 0:
        return None if out is None else out.zero_()
    d = disks or (None,) * 4
    cuda.launch("partition_claims", k, num_partitions, num_disks, keep, partition, partition2,
                claims, out, *d)
    partition_claims.launches += 1
    _CLAIM_COUNTS[mode].launches += 1
    return out


# ---------------------------------------------------------------------------
# K4e — the leg build and the compaction gathers
# ---------------------------------------------------------------------------

# K2's subround lanes of a (topic, broker) key (``optimizer.py:672``).
LEG_LANES = 16
# ``analyzer/actions.py`` ActionType, as ``csrc/selection.cu`` reads it.
ACTION_MOVE, ACTION_LEADERSHIP, ACTION_SWAP = 0, 1, 3


class Legs(NamedTuple):
    """A step's selection inputs over its kc compacted lanes.  The three-row
    layouts hold [dest; src; dest], so that the round sums read [dest; src]
    (``seg_both``, ``d_both``) and the safe admit [src; dest] (``seg_safe``,
    ``d_safe``) as views; the score copies back the safe admits'
    (``safe_score``, ``leg_score``).  Only these properties know the
    layout."""

    score: torch.Tensor  # f32[max(2, L) * kc]: the lanes' scores, copied
    eligible: torch.Tensor  # bool[kc]
    partition: torch.Tensor  # i32[kc]
    partition2: torch.Tensor  # i32[kc]
    src_disk: torch.Tensor  # i32[kc]
    dest_disk: torch.Tensor  # i32[kc]
    seg3: torch.Tensor  # i32[3 kc]: dest_b, src_b, dest_b (broker slots)
    src_lane: torch.Tensor  # i32[kc]: src_b * subrounds + lane
    dest_lane: torch.Tensor  # i32[kc]
    d3: torch.Tensor  # f32[3 kc, 8]: d_dest, d_src, d_dest (channel deltas)
    leg_keys: Optional[torch.Tensor]  # i32[L, kc] (topic, broker) keys; None: no legs
    d_rep: Optional[torch.Tensor]  # f32[L, kc]
    d_lead: Optional[torch.Tensor]  # f32[L, kc]
    d_rl: Optional[torch.Tensor]  # f32[L, kc, 2]: (d_rep, d_lead), K3's deltas
    leg_nz: Optional[torch.Tensor]  # bool[L, kc]: a non-zero delta on the leg
    leg_lane_keys: Optional[torch.Tensor]  # i32[L, kc]: leg_keys * 16 + lane % 16

    @property
    def kc(self) -> int:
        return self.eligible.shape[0]

    @property
    def dest_b(self) -> torch.Tensor:
        return self.seg3[:self.kc]

    @property
    def src_b(self) -> torch.Tensor:
        return self.seg3[self.kc:2 * self.kc]

    @property
    def d_dest(self) -> torch.Tensor:
        return self.d3[:self.kc]

    @property
    def d_src(self) -> torch.Tensor:
        return self.d3[self.kc:2 * self.kc]

    @property
    def lane_score(self) -> torch.Tensor:
        """f32[kc]: the lanes' scores."""
        return self.score[:self.kc]

    @property
    def seg_both(self) -> torch.Tensor:
        """i32[2 kc]: the round sums' slots, dest legs then src legs."""
        return self.seg3[:2 * self.kc]

    @property
    def d_both(self) -> torch.Tensor:
        """f32[2 kc, 8]: the round sums' deltas, dest legs then src legs."""
        return self.d3[:2 * self.kc]

    @property
    def seg_safe(self) -> torch.Tensor:
        """i32[2 kc]: the safe admit's slots, src legs then dest legs."""
        return self.seg3[self.kc:]

    @property
    def d_safe(self) -> torch.Tensor:
        """f32[2 kc, 8]: the safe admit's deltas, src legs then dest legs."""
        return self.d3[self.kc:]

    @property
    def safe_score(self) -> torch.Tensor:
        """f32[2 kc]: the scores of the safe admit's rows."""
        return self.score[:2 * self.kc]

    @property
    def leg_score(self) -> torch.Tensor:
        """f32[L kc]: the scores of the topic safe admit's rows, leg by leg."""
        return self.score[:self.leg_keys.shape[0] * self.kc]


def channel_deltas_plain(cand):
    """(d_src f32[K, 8], d_dest f32[K, 8]) — per-candidate channel changes
    (``cruise_control_tpu/analyzer/optimizer.py:260`` ``_channel_deltas``)."""
    dc = cand.d_replica_count.to(torch.float32)[:, None]
    dl = cand.d_leader_count.to(torch.float32)[:, None]
    dp = cand.d_potential_nw_out[:, None]
    d_src = torch.cat([cand.delta_src, -dc, -dl, -dp,
                       -cand.d_leader_bytes_in_src[:, None]], dim=1)
    d_dest = torch.cat([cand.delta_dest, dc, dl, dp,
                        cand.d_leader_bytes_in_dest[:, None]], dim=1)
    return d_src, d_dest


def select_legs_plain(cand, sel_idx: Optional[torch.Tensor], score: torch.Tensor,
                      eligible: torch.Tensor, lane: torch.Tensor,
                      compact_of_full: Optional[torch.Tensor], replica_topic: torch.Tensor,
                      replica_is_leader: torch.Tensor, nb_sel: int, subrounds: int,
                      legs: int) -> Legs:
    """``select_legs``'s plain twin: the JAX package's lines in torch ops."""
    if sel_idx is not None:
        cand = cgen.take_candidates(cand, sel_idx)
        score, eligible, lane = score[sel_idx], eligible[sel_idx], lane[sel_idx]
    if compact_of_full is not None:
        c_of_f = torch.clamp(compact_of_full, min=0)
        src_b, dest_b = c_of_f[cand.src], c_of_f[cand.dest]
    else:
        src_b, dest_b = cand.src, cand.dest
    d_src, d_dest = channel_deltas_plain(cand)
    out = dict(score=torch.cat([score] * max(2, legs)), eligible=eligible,
               partition=cand.partition, partition2=cand.partition2,
               src_disk=cand.src_disk, dest_disk=cand.dest_disk,
               seg3=torch.cat([dest_b, src_b, dest_b]), src_lane=src_b * subrounds + lane,
               dest_lane=dest_b * subrounds + lane, d3=torch.cat([d_dest, d_src, d_dest]),
               leg_keys=None, d_rep=None, d_lead=None, d_rl=None, leg_nz=None,
               leg_lane_keys=None)
    if not legs:
        return Legs(**out)
    fzero = torch.zeros((), dtype=torch.float32, device=score.device)
    t1 = replica_topic[cand.replica]
    safe_r2 = torch.where(cand.dest_replica >= 0, cand.dest_replica, 0)
    t2 = replica_topic[safe_r2]
    moves_tb = cand.is_move() | cand.is_swap()
    swap = cand.is_swap()
    lead1 = (cand.is_leadership() |
             (moves_tb & replica_is_leader[cand.replica])).to(torch.float32)
    if legs == 4:
        same_t = swap & (t1 == t2)
        rep1 = torch.where(same_t, fzero, moves_tb.to(torch.float32))
        rep2 = torch.where(same_t, fzero, swap.to(torch.float32))
        leg_keys = torch.stack([t1 * nb_sel + src_b, t1 * nb_sel + dest_b,
                                t2 * nb_sel + dest_b, t2 * nb_sel + src_b])
        d_rep = torch.stack([-rep1, rep1, -rep2, rep2])
        lead2 = (swap & replica_is_leader[safe_r2]).to(torch.float32)
        l1 = torch.where(same_t, lead1 - lead2, lead1)
        l2 = torch.where(same_t, fzero, lead2)
        d_lead = torch.stack([-l1, l1, -l2, l2])
    else:
        mv = moves_tb.to(torch.float32)
        leg_keys = torch.stack([t1 * nb_sel + src_b, t1 * nb_sel + dest_b])
        d_rep = torch.stack([-mv, mv])
        d_lead = torch.stack([-lead1, lead1])
    out.update(leg_keys=leg_keys, d_rep=d_rep, d_lead=d_lead,
               d_rl=torch.stack([d_rep, d_lead], -1), leg_nz=(d_rep != 0.0) | (d_lead != 0.0),
               leg_lane_keys=leg_keys * LEG_LANES + lane % LEG_LANES)
    return Legs(**out)


def _field(t: torch.Tensor, what: str, dtype: torch.dtype, shape, dev) -> torch.Tensor:
    """``t`` contiguous, after checking its dtype, shape and device."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{what}: expected {dtype}{tuple(shape)} on {dev}, got "
                         f"{t.dtype}{tuple(t.shape)} on {t.device}")
    return t.contiguous()


# The candidate fields K4e reads, in the C entry's order, with their dtypes
# and trailing shapes.
_LEG_FIELDS = (("action_type", torch.int32, ()), ("replica", torch.int32, ()),
               ("src", torch.int32, ()), ("dest", torch.int32, ()),
               ("dest_replica", torch.int32, ()), ("partition", torch.int32, ()),
               ("partition2", torch.int32, ()), ("src_disk", torch.int32, ()),
               ("dest_disk", torch.int32, ()), ("delta_src", torch.float32, (4,)),
               ("delta_dest", torch.float32, (4,)), ("d_replica_count", torch.int32, ()),
               ("d_leader_count", torch.int32, ()), ("d_potential_nw_out", torch.float32, ()),
               ("d_leader_bytes_in_src", torch.float32, ()),
               ("d_leader_bytes_in_dest", torch.float32, ()))


@cuda.counted("select_legs")
def select_legs(cand, sel_idx: Optional[torch.Tensor], score: torch.Tensor,
                eligible: torch.Tensor, lane: torch.Tensor,
                compact_of_full: Optional[torch.Tensor], replica_topic: torch.Tensor,
                replica_is_leader: torch.Tensor, nb_sel: int, subrounds: int,
                legs: int) -> Legs:
    """K4e.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:514-580``
    (``take_candidates`` and the gathers of the score, eligibility and
    subround lane through ``sel_idx``, the frontier's ``c_of_f`` slots,
    ``src_lane`` and ``dest_lane``, ``_channel_deltas``, and the (topic,
    broker) legs: ``t1``, ``t2``, ``lead1``, ``lead2``, ``same_t``,
    ``leg_keys``, ``d_rep``, ``d_lead``) and the K2 keys and K3 deltas the
    rounds built from them: the ``Legs`` of the kc lanes ``sel_idx`` (i32[kc]
    into the K candidates; None: all K) picks, their brokers' slots through
    ``compact_of_full`` (i32[B]; None: the broker ids), with ``legs`` (0, 2,
    or 4 with swaps) (topic, broker) legs a lane over ``nb_sel`` slots.
    Bound on the card: bytes (a lane's 85 bytes of inputs, 4 more through
    ``sel_idx`` and 8 or 12 more with 2 or 4 legs, and 101 + 17·L bytes of
    distinct outputs; the tables' entries once).  CPU tensors take ``select_legs_plain``; CUDA tensors launch
    one thread a compacted lane."""
    dev = score.device
    k_full = score.shape[0]
    if legs not in (0, 2, 4):
        raise ValueError(f"select_legs: {legs} legs a lane (0, 2 or 4)")
    fields = [_field(getattr(cand, f), f"cand.{f}", dt, (k_full,) + tail, dev)
              for f, dt, tail in _LEG_FIELDS]
    score = _field(score, "score", torch.float32, (k_full,), dev)
    eligible = _field(eligible, "eligible", torch.bool, (k_full,), dev)
    lane = _field(lane, "lane", torch.int32, (k_full,), dev)
    kc = k_full
    if sel_idx is not None:
        kc = sel_idx.shape[0]
        sel_idx = _field(sel_idx, "sel_idx", torch.int32, (kc,), dev)
    nb_full = 0
    if compact_of_full is not None:
        nb_full = compact_of_full.shape[0]
        compact_of_full = _field(compact_of_full, "compact_of_full", torch.int32, (nb_full,),
                                 dev)
    num_r = replica_topic.shape[0]
    if legs:
        replica_topic = _field(replica_topic, "replica_topic", torch.int32, (num_r,), dev)
        replica_is_leader = _field(replica_is_leader, "replica_is_leader", torch.bool,
                                   (num_r,), dev)
    args = (tuple(getattr(cand, f.name) for f in dataclasses.fields(cand)), sel_idx, score,
            eligible, lane, compact_of_full, replica_topic, replica_is_leader, nb_sel,
            subrounds, legs)
    cuda.record("select_legs", args)
    form = ",".join(f for f, on in (("compact", sel_idx is not None),
                                    ("frontier", compact_of_full is not None),
                                    ("topic", legs > 0)) if on)
    if form:
        cuda.record(f"select_legs[{form}]", args)
    if cuda.on_cpu(score):
        return select_legs_plain(cand, sel_idx, score, eligible, lane, compact_of_full,
                                 replica_topic, replica_is_leader, nb_sel, subrounds, legs)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    out = Legs(score=empty((max(2, legs) * kc,), f32), eligible=empty((kc,), b8),
               partition=empty((kc,), i32), partition2=empty((kc,), i32),
               src_disk=empty((kc,), i32), dest_disk=empty((kc,), i32),
               seg3=empty((3 * kc,), i32), src_lane=empty((kc,), i32),
               dest_lane=empty((kc,), i32), d3=empty((3 * kc, NUM_CHANNELS), f32),
               leg_keys=empty((legs, kc), i32) if legs else None,
               d_rep=empty((legs, kc), f32) if legs else None,
               d_lead=empty((legs, kc), f32) if legs else None,
               d_rl=empty((legs, kc, 2), f32) if legs else None,
               leg_nz=empty((legs, kc), b8) if legs else None,
               leg_lane_keys=empty((legs, kc), i32) if legs else None)
    if kc == 0:
        return out
    cuda.launch("select_legs", kc, k_full, nb_sel, subrounds, legs, nb_full, num_r, sel_idx,
                score, eligible, lane, *fields, compact_of_full,
                replica_topic if legs else None, replica_is_leader if legs else None, *out)
    select_legs.launches += 1
    return out


def frontier_budgets_plain(room_dest: torch.Tensor, slack_src: torch.Tensor,
                           full_of_compact: Optional[torch.Tensor], topic_budgets,
                           num_topics: int):
    """``frontier_budgets``'s plain twin: the JAX package's gathers, and the
    stacks the rounds built from them."""
    topic = topic_budgets
    num_brokers = room_dest.shape[0]
    if full_of_compact is not None:
        gather = torch.clamp(full_of_compact, min=0)
        room_dest, slack_src = room_dest[gather], slack_src[gather]
        if topic is not None:
            topic = tuple(b.reshape(num_topics, num_brokers)[:, gather].reshape(-1)
                          for b in topic)
    hi_tb = lo_tb = None
    if topic is not None:
        gain_rep, shed_rep, shed_lead = topic
        hi_tb = torch.stack([gain_rep, torch.full_like(gain_rep, torch.inf)], 1)
        lo_tb = torch.stack([-shed_rep, -shed_lead], 1)
    return room_dest, slack_src, -slack_src, topic, hi_tb, lo_tb


@cuda.counted("frontier_budgets")
def frontier_budgets(room_dest: torch.Tensor, slack_src: torch.Tensor,
                     full_of_compact: Optional[torch.Tensor], topic_budgets,
                     num_topics: int):
    """K4e's budgets.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:
    521-531`` (the frontier's gathers of ``room_dest``, ``slack_src`` and the
    three (topic, broker) budgets) and the rounds' ``-slack_src``, ``hi_tb``
    and ``lo_tb``: (room f32[nb, 8], slack f32[nb, 8], -slack, (gain_rep,
    shed_rep, shed_lead) f32[T·nb] or None, hi_tb f32[T·nb, 2] = (gain_rep,
    +inf) and lo_tb = (-shed_rep, -shed_lead), or None), on the slots of
    ``full_of_compact`` (i32[nb], clamped at 0; None: every broker, nb = B).
    Bound on the card: bytes (nb·64 + 12·T·nb read, nb·96 + 20·T·nb of
    distinct outputs written: ``hi_tb`` copies ``gain_rep`` beside a
    constant).  CPU tensors take ``frontier_budgets_plain``; CUDA tensors
    launch one thread a (slot, channel) and a (topic, slot) key."""
    dev = room_dest.device
    nb_full = room_dest.shape[0]
    room_dest = _field(room_dest, "room_dest", torch.float32, (nb_full, NUM_CHANNELS), dev)
    slack_src = _field(slack_src, "slack_src", torch.float32, (nb_full, NUM_CHANNELS), dev)
    nb = nb_full
    if full_of_compact is not None:
        nb = full_of_compact.shape[0]
        full_of_compact = _field(full_of_compact, "full_of_compact", torch.int32, (nb,), dev)
    if topic_budgets is not None:
        topic_budgets = tuple(_field(b, what, torch.float32, (num_topics * nb_full,), dev)
                              for b, what in zip(topic_budgets,
                                                 ("gain_rep", "shed_rep", "shed_lead")))
    args = (room_dest, slack_src, full_of_compact, topic_budgets, num_topics)
    cuda.record("frontier_budgets", args)
    form = ",".join(f for f, on in (("frontier", full_of_compact is not None),
                                    ("topic", topic_budgets is not None)) if on)
    if form:
        cuda.record(f"frontier_budgets[{form}]", args)
    if cuda.on_cpu(room_dest):
        return frontier_budgets_plain(room_dest, slack_src, full_of_compact, topic_budgets,
                                      num_topics)
    room = torch.empty((nb, NUM_CHANNELS), dtype=torch.float32, device=dev)
    slack = torch.empty_like(room)
    neg_slack = torch.empty_like(room)
    topic = hi_tb = lo_tb = None
    if topic_budgets is not None:
        topic = tuple(torch.empty((num_topics * nb,), dtype=torch.float32, device=dev)
                      for _ in range(3))
        hi_tb = torch.empty((num_topics * nb, 2), dtype=torch.float32, device=dev)
        lo_tb = torch.empty_like(hi_tb)
    cuda.launch("frontier_budgets", nb, nb_full, num_topics, room_dest, slack_src,
                full_of_compact, *(topic_budgets or (None,) * 3), room, slack, neg_slack,
                *(topic or (None,) * 3), hi_tb, lo_tb)
    frontier_budgets.launches += 1
    return room, slack, neg_slack, topic, hi_tb, lo_tb
