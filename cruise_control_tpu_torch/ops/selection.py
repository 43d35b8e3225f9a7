"""K4 — the selection glue of ``select_batched``, as four kernels.

Counterpart of the elementwise and scatter passes between K2's and K3's
launches in ``cruise_control_tpu/analyzer/optimizer.py:410-871``, in every
round of a step's selection (``rounds`` = ceil(moves per broker and step /
128)):

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
``partition_claims[claim]`` and ``[used]``), takes its
plain twin (``*_plain``, the torch ops the selection ran before) when the
tensors lie on the CPU and launches ``csrc/selection.cu`` on the card.
Every output is a bool or an exact integer-valued float, so the card equals
the plain twin bit for bit: the budget tests add with ``__fadd_rn`` and
compare in f32 as the twin does, and the (topic, broker) sums add the legs'
integer deltas (-1, 0 or +1; at most K·L in size) in int32 atomics, exact in
any order, and convert once.  Rows of an unkept lane are never visited.

Inputs that the kernels take as "None" are the JAX package's round-1
specialisation (no cumulative sums, no used sets): a cumulative sum of zeros
compares the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
