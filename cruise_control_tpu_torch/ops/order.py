"""Ordering primitives with the JAX package's exact tie semantics.

- ``top_k`` matches ``jax.lax.top_k`` on float32 and int32: descending,
  ties keep the lower index first, and floats compare in IEEE total order
  (+0.0 ranks above -0.0).  ``torch.topk`` gives no order for ties, so the
  plain twin ``top_k_plain`` is a stable descending sort of an
  order-preserving integer key, then a slice; on CUDA tensors ``top_k`` and
  ``masked_top_k`` (the live-lane compaction's form, with the mask and its
  count in the call) launch ``cc_top_k`` (``csrc/top_k.cu``): a radix
  select of the k-th key, an ordered compaction and a stable radix sort of
  the winners, with the plain twin's result bit for bit.
- ``argsort`` matches ``jnp.argsort(..., stable=True)``: ascending, stable,
  -0.0 equal to +0.0, NaN last (float keys are canonicalised before the
  sort).  The plain twin ``argsort_plain`` is torch's stable sort; on CUDA
  tensors ``argsort`` launches ``cc_argsort`` (1-D) or ``cc_row_argsort``
  (dim 1 of an int32 [T, B]), stable LSD radix sorts of an order-preserving
  uint32 key (``csrc/argsort.cu``, on the radix stage of ``csrc/radix.cuh``
  that ``cc_top_k`` shares), with a declared key range (``num_keys``)
  cutting the passes.
- ``lexsort2_plain`` matches ``jnp.lexsort((minor, major))`` in torch ops
  on any device: the plain twins' lexsort.
- ``ordered_sum`` matches a float32 ``jnp.sum`` along the leading axis as
  the JAX package's compiled CPU programs add: XLA splits a reduction over
  more than 32 elements into windows of 32 (the input padded with zeros to
  a multiple of 32, the padding split evenly before and after, the odd
  element after), sums each window in order from 0 and reduces the window
  sums the same way, down to one ordered sum of at most 32.  It is built
  from elementwise adds only, so the CPU and the card give the same bits.
  On CUDA tensors it launches ``cc_ordered_sum`` (``csrc/ordered.cu``,
  the order of ``csrc/ordered.cuh``): the same adds in one launch for all
  columns.
- ``ordered_cumsum`` matches a float32 ``jnp.cumsum`` along the leading
  axis the same way: XLA scans more than 16 elements as blocks of 16 (the
  input padded with zeros at the end), each scanned in order, plus the
  inclusive scan of the block totals — itself scanned so — shifted by one
  block.  Elementwise adds only, the same bits on any device; K3's kernel
  (``csrc/prefix_cut.cu``) rebuilds its values in the same order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from cruise_control_tpu_torch.ops import cuda

_I32_MAX = 0x7FFFFFFF


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose integer order is the IEEE total order of float32 ``x``."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ _I32_MAX, bits)


def top_k_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the ``k`` largest entries of 1-D ``x``: the
    CPU path and ``cc_top_k``'s plain twin."""
    key = _total_order_key(x) if x.dtype == torch.float32 else x
    idx = torch.sort(key, descending=True, stable=True).indices[:k]
    return x[idx], idx.to(torch.int32)


# The radix stage of csrc/radix.cuh that cc_top_k and cc_argsort share: the
# most items one block sorts alone (kSmall); above, the one-sweep sort's
# items a tile and digits a pass.
_RADIX_SMALL = 2048
_SWEEP_TILE = 1024
_SWEEP_BINS = 256


def _sweep_words(m: int) -> int:
    """int32 words of the one-sweep sort's scratch for ``m`` items: the
    passes' tile counters (8 words), their digit counts, their look-back
    status (a word a pass, tile and digit)."""
    return 8 + 4 * _SWEEP_BINS + 4 * _SWEEP_BINS * -(-m // _SWEEP_TILE)


# cc_top_k's select (csrc/top_k.cu): entries a block handles a pass, its
# state words.
_TOPK_TILE = 4096
_TOPK_STATE = 8 + 256


def _top_k_work_words(n: int, k: int) -> int:
    """int32 words of ``cc_top_k``'s scratch (0 for a one-block input): the
    select's state, the sweep's words above ``_RADIX_SMALL`` winners, the
    compaction's tile counts and two buffers of keys and indices."""
    if n <= _RADIX_SMALL:
        return 0
    sweep = _sweep_words(k) if k > _RADIX_SMALL else 0
    return _TOPK_STATE + sweep + -(-n // _TOPK_TILE) + 4 * k


def _top_k_form(n: int, k: int) -> str:
    """The kernel's path for these sizes: one block sorts the input
    ("small"), every entry wins ("full"), or a select and compaction first
    with one block ("select") or radix passes ("select,sort") sorting the
    winners."""
    if n <= _RADIX_SMALL:
        return "small"
    if k == n:
        return "full"
    return "select" if k <= _RADIX_SMALL else "select,sort"


def _top_k_args(x: torch.Tensor, k: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.int32) or x.dim() != 1:
        raise TypeError(f"top_k takes 1-D float32 or int32, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    n = x.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"top_k: k = {k} outside [1, {n}]")
    x = x.contiguous()
    if mask is not None:
        if x.dtype != torch.float32:
            raise TypeError("masked_top_k takes float32")
        cuda.check(mask, "mask", torch.bool, (n,), x.device)
    form = _top_k_form(n, k)
    args = (x, k) if mask is None else (x, mask, k)
    cuda.record("top_k", args)
    cuda.record(f"top_k[{form}]", args)
    if mask is not None:
        cuda.record("top_k[mask]", args)
    return x


def _top_k_launch(x: torch.Tensor, k: int, mask: Optional[torch.Tensor]):
    n = x.shape[0]
    if k >= 2 ** 30:
        raise ValueError(f"top_k on the card sorts fewer than 2**30 winners, got {k}")
    vals = torch.empty((k,), dtype=x.dtype, device=x.device)
    idx = torch.empty((k,), dtype=torch.int32, device=x.device)
    live = None if mask is None else torch.empty((), dtype=torch.int32, device=x.device)
    words = _top_k_work_words(n, k)
    work = torch.empty((words,), dtype=torch.int32, device=x.device) if words else None
    cuda.launch("top_k", n, k, int(x.dtype == torch.int32), x, mask, vals, idx, live, work,
                words)
    top_k.launches += 1
    return vals, idx, live


@cuda.counted("top_k")
def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 top-k.  Replaces ``jax.lax.top_k`` of the candidate builders
    (``cruise_control_tpu/analyzer/candidates.py:111,117,195,200,312,460,
    506,555,570,631,643``): (values[k], int32 indices) of the ``k`` largest
    entries of 1-D ``x`` (1 <= k <= n; float32 in descending IEEE total
    order, or int32: the room order's counts), ties to the lower index.
    Bound on the card: bytes (n·4 read, k·8 written).  CPU tensors take
    ``top_k_plain``; CUDA tensors launch ``cc_top_k`` (one block up to 2,048
    entries; else a radix select, an ordered compaction and a stable radix
    sort of the winners)."""
    x = _top_k_args(x, k, None)
    if cuda.on_cpu(x):
        return top_k_plain(x, k)
    vals, idx, _ = _top_k_launch(x, k, None)
    return vals, idx


def masked_top_k(x: torch.Tensor, mask: torch.Tensor, k: int):
    """K6 top-k in the live-lane compaction's form (``cruise_control_tpu/
    analyzer/optimizer.py:510-513``): ``top_k`` of ``where(mask, x, -inf)``
    and the count of set ``mask`` entries (i32, 0-d) — (values, indices,
    live).  Counted as ``top_k``'s launches.  Bound on the card: bytes (n·5
    read, k·8 + 4 written).  CPU tensors take the plain twin's ops; CUDA
    tensors launch ``cc_top_k`` with the mask."""
    x = _top_k_args(x, k, mask)
    if cuda.on_cpu(x):
        live = mask.sum(dtype=torch.int32)
        vals, idx = top_k_plain(torch.where(mask, x, -math.inf), k)
        return vals, idx, live
    return _top_k_launch(x, k, mask)


def _canonical(x: torch.Tensor) -> torch.Tensor:
    return x + 0.0 if x.is_floating_point() else x  # -0.0 -> +0.0


# cc_argsort's key kinds: float32, int32, int32 in a declared [0, num_keys).
_KEY_FLOAT, _KEY_INT, _KEY_RANGED = 0, 1, 2
# The call sites, each counted as ``argsort[<mode>]``: the matched builders'
# [R] sorts by broker, by (topic, broker) pair and by topic and their [T, B]
# row sorts; K3's score sort and its regroup above
# ``COUNTING_MAX_SEGMENTS``.
ARGSORT_MODES = ("broker", "pair", "topic", "rows", "score", "regroup")
_ARGSORT_COUNTS = cuda.mode_counters("argsort", ARGSORT_MODES)


def argsort_passes(num_keys: Optional[int]) -> int:
    """The 8-bit radix passes ``cc_argsort`` runs: enough for the bits of
    ``num_keys - 1`` (at least one) with a declared range, else 4."""
    if num_keys is None:
        return 4
    return max(1, -(-(int(num_keys) - 1).bit_length() // 8))


def argsort_work_words(n: int) -> int:
    """int32 words of ``cc_argsort``'s scratch for ``n`` entries (0 for a
    one-block input): the one-sweep's words and two buffers of keys and
    indices."""
    if n <= _RADIX_SMALL:
        return 0
    return _sweep_words(n) + 4 * n


def key_kind(x: torch.Tensor, num_keys: Optional[int]) -> int:
    """``cc_argsort``'s key kind of ``x``: float32, int32, or int32 in a
    declared range."""
    if x.dtype == torch.float32:
        return _KEY_FLOAT
    return _KEY_INT if num_keys is None else _KEY_RANGED


def _check_num_keys(x: torch.Tensor, num_keys: Optional[int]) -> None:
    """``num_keys`` declares int32 keys in [0, num_keys); checked against the
    data on CPU tensors (a card's check would read back to the host)."""
    if num_keys is None:
        return
    if x.dtype != torch.int32:
        raise TypeError(f"argsort: num_keys takes int32 keys, got {x.dtype}")
    if not 1 <= num_keys <= 2 ** 31:
        raise ValueError(f"argsort: num_keys = {num_keys} outside [1, 2**31]")
    if x.device.type == "cpu" and x.numel() and (int(x.min()) < 0
                                                 or int(x.max()) >= num_keys):
        raise ValueError(f"argsort: keys outside [0, {num_keys})")


def _record(name: str, x: torch.Tensor, num_keys: Optional[int], mode: Optional[str]):
    """Record a sort's inputs as ``name`` and ``name[mode]`` (``cuda.record``)."""
    args = (x, num_keys, mode)
    cuda.record(name, args)
    if mode is not None:
        cuda.record(f"{name}[{mode}]", args)


def argsort_plain(x: torch.Tensor, dim: int = -1, descending: bool = False,
                  num_keys: Optional[int] = None) -> torch.Tensor:
    """Stable argsort (int64 indices) along ``dim``, -0.0 equal to +0.0 and
    NaN last: the CPU path and ``cc_argsort``'s and ``cc_row_argsort``'s
    plain twin."""
    _check_num_keys(x, num_keys)
    return torch.sort(_canonical(x), dim=dim, descending=descending,
                      stable=True).indices


def argsort_into(x: torch.Tensor, num_keys: Optional[int], out_idx: Optional[torch.Tensor],
                 work: Optional[torch.Tensor], out_idx32: Optional[torch.Tensor] = None,
                 out_keys: Optional[torch.Tensor] = None,
                 mode: Optional[str] = None) -> None:
    """One ``cc_argsort`` launch of 1-D CUDA ``x`` (float32 or int32) into
    the given outputs: int64 indices ``out_idx``, int32 indices
    ``out_idx32``, the sorted keys ``out_keys`` (int32 with ``num_keys``;
    any may be None) and ``work`` (``argsort_work_words(n)`` int32 words).
    Counted as ``argsort``'s launches and its ``mode``'s."""
    if x.dim() != 1 or x.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"argsort takes 1-D float32 or int32 on the card, got {x.dtype} of "
                        f"shape {tuple(x.shape)}")
    n = x.shape[0]
    if n >= 2 ** 30:
        raise ValueError(f"argsort on the card takes fewer than 2**30 entries, got {n}")
    _check_num_keys(x, num_keys)
    x = x.contiguous()
    for what, t, dtype in (("out_idx", out_idx, torch.int64),
                           ("out_idx32", out_idx32, torch.int32),
                           ("out_keys", out_keys, x.dtype)):
        if t is not None:
            cuda.check(t, what, dtype, (n,), x.device)
    words = argsort_work_words(n)
    if words and (work is None or work.dtype != torch.int32 or work.numel() < words):
        raise ValueError(f"argsort: {n} entries need {words} int32 words of scratch")
    _record("argsort", x, num_keys, mode)
    if n == 0:
        return
    cuda.launch("argsort", n, argsort_passes(num_keys), key_kind(x, num_keys), x, out_idx,
                out_idx32, out_keys, work if words else None, words)
    argsort.launches += 1
    if mode is not None:
        _ARGSORT_COUNTS[mode].launches += 1


@cuda.counted("row_argsort")
def _row_argsort(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """``argsort`` along dim 1 of a CUDA int32 [T, B]: ``cc_row_argsort``
    (one block a row) up to ``_RADIX_SMALL`` a row, else two ``cc_argsort``
    launches in ``lexsort2_plain``'s order: by key, then stably by row."""
    T, B = x.shape
    if x.dtype != torch.int32:
        raise TypeError(f"argsort along dim 1 takes int32 on the card, got {x.dtype}")
    x = x.contiguous()
    _record("row_argsort", x, None, mode)
    out = torch.empty((T, B), dtype=torch.int64, device=x.device)
    if T == 0 or B == 0:
        return out
    if mode is not None:
        _ARGSORT_COUNTS[mode].launches += 1
    if B > _RADIX_SMALL:
        by_key = argsort(x.reshape(-1))
        by_row = argsort((by_key // B).to(torch.int32), num_keys=T)
        flat = by_key[by_row].reshape(T, B)
        return flat - torch.arange(T, device=x.device)[:, None] * B
    cuda.launch("row_argsort", T, B, x, out)
    _row_argsort.launches += 1
    return out


@cuda.counted("argsort")
def argsort(x: torch.Tensor, dim: int = -1, descending: bool = False,
            num_keys: Optional[int] = None, mode: Optional[str] = None) -> torch.Tensor:
    """K6 argsort.  Replaces the stable ``jnp.argsort`` of the matched
    builders (``cruise_control_tpu/analyzer/candidates.py:177,280,297,319,
    330,331``) and K3's sorts (``cruise_control_tpu/analyzer/goals/
    kernels.py:1006-1007``): int64 indices sorting ``x`` ascending along
    ``dim``, stable, -0.0 equal to +0.0, NaN of either sign last.
    ``num_keys`` declares int32 keys in [0, num_keys) (checked on CPU
    tensors): the kernel then runs ``argsort_passes(num_keys)`` radix passes.
    ``mode`` names the call site for the launch counts (``ARGSORT_MODES``).
    Bound on the card: bytes (n·4 read, n·8 written).  CPU tensors take
    ``argsort_plain``; CUDA tensors launch ``cc_argsort`` (1-D float32 or
    int32 of fewer than 2**30 entries: one block up to 2,048 entries, else a
    memset, a histogram of every pass and a one-sweep launch a pass) or
    ``cc_row_argsort`` (dim 1 of an int32 [T, B]); anything else, and
    ``descending``, raises on the card (the call sites negate)."""
    if mode is not None and mode not in ARGSORT_MODES:
        raise ValueError(f"argsort: unknown mode {mode!r}")
    if cuda.on_cpu(x):
        if x.dim() == 1:
            _record("argsort", x, num_keys, mode)
        elif x.dim() == 2 and dim in (1, -1):
            _record("row_argsort", x, None, mode)
        return argsort_plain(x, dim, descending, num_keys)
    if descending:
        raise ValueError("argsort: the card sorts ascending only (negate the key)")
    if x.dim() == 2 and dim in (1, -1) and num_keys is None:
        return _row_argsort(x, mode)
    if x.dim() != 1 or dim not in (0, -1):
        raise ValueError(f"argsort on the card takes dim 0 of 1-D or dim 1 of 2-D int32, got "
                         f"dim {dim} of shape {tuple(x.shape)}")
    n = x.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=x.device)
    words = argsort_work_words(n)
    work = torch.empty((words,), dtype=torch.int32, device=x.device) if words else None
    argsort_into(x, num_keys, out, work, mode=mode)
    return out


def lexsort2_plain(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Indices sorting by ``major`` then ``minor``, both ascending, stable:
    two ``argsort_plain`` calls (torch ops on any device, for the plain
    twins)."""
    o1 = argsort_plain(minor)
    o2 = argsort_plain(major[o1])
    return o1[o2]


_SUM_WINDOW = 32
_SUM_MAX_ROWS = 32 * 512  # cc_ordered_sum: at most 512 windows


@cuda.counted("ordered_sum")
def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` along dim 0, in XLA's windowed order (see the module
    docstring); the result has ``x.shape[1:]``.  Replaces the alive-broker
    sums of the band averages (``cruise_control_tpu/analyzer/goals/
    kernels.py:190``, ``analyzer/optimizer.py:311``).  Bound on the card:
    bytes (the input once).  CPU tensors take ``ordered_sum_plain``; CUDA
    tensors (float32, at most 16,384 rows) launch one kernel for all
    columns, with one C call and no copy of a contiguous input."""
    cuda.record("ordered_sum", (x,))
    if cuda.on_cpu(x):
        return ordered_sum_plain(x)
    n = x.shape[0]
    if x.dtype != torch.float32 or n > _SUM_MAX_ROWS:
        raise ValueError(f"ordered_sum takes float32 with at most {_SUM_MAX_ROWS} rows, "
                         f"got {x.dtype} with {n}")
    out = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    cuda.launch("ordered_sum", x if x.is_contiguous() else x.contiguous(), out, n,
                out.numel())
    ordered_sum.launches += 1
    return out


def ordered_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """``ordered_sum`` in elementwise torch ops: the CPU path and the
    kernel's plain twin."""
    rest = tuple(x.shape[1:])
    while x.shape[0] > _SUM_WINDOW:
        n = x.shape[0]
        m = -(-n // _SUM_WINDOW) * _SUM_WINDOW
        lo = (m - n) // 2
        x = torch.cat([x.new_zeros((lo,) + rest), x, x.new_zeros((m - n - lo,) + rest)])
        x = x.reshape((m // _SUM_WINDOW, _SUM_WINDOW) + rest)
        acc = x.new_zeros((m // _SUM_WINDOW,) + rest)
        for i in range(_SUM_WINDOW):
            acc = acc + x[:, i]
        x = acc
    acc = x.new_zeros(rest)
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


_SCAN_BLOCK = 16


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of ``x`` along dim 0, in XLA's blocked order
    (see the module docstring)."""
    n = x.shape[0]
    rest = tuple(x.shape[1:])
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[i] += out[i - 1]
        return out
    m = -(-n // _SCAN_BLOCK) * _SCAN_BLOCK
    xp = torch.cat([x, x.new_zeros((m - n,) + rest)]).reshape(
        (m // _SCAN_BLOCK, _SCAN_BLOCK) + rest)
    for j in range(1, _SCAN_BLOCK):
        xp[:, j] += xp[:, j - 1]
    totals = ordered_cumsum(xp[:, -1])
    xp[1:] += totals[:-1].unsqueeze(1)
    return xp.reshape((m,) + rest)[:n]
