"""The collectives of the sharded search: what GSPMD inserted into the JAX
package's sharded programs, issued explicitly over ``torch.distributed``.

- ``all_gather_lanes``: each rank holds a contiguous slice of a K-wide
  tensor (``lane_range``: ``ceil(K/n)`` lanes a rank, the last ranks
  shorter or empty); the slices are padded to ``ceil(K/n)`` lanes,
  gathered in rank order and trimmed back to K, which is the candidate
  order.  ``gather_scores`` packs a step's score (f32 bits) and
  eligibility into one i32[2, K/n] buffer for one such call.
- ``all_gather_partials``: the ranks' per-broker partial aggregates of a
  replica-sharded model, f32 and i32 parts packed into one i32 buffer,
  returned as [n, rows, C] each for K15 (``ops.segment.shard_combine``).
- ``sharded_broker_aggregates``, ``sharded_disk_load``: the reductions of
  a replica-sharded model under its mesh — K1 over the rank's rows, one
  ``all_gather_partials``, K15.  Only the optimizer layer calls them
  (``BrokerArrays.from_model(..., mesh=...)``): the model's own queries
  issue no collective.
- ``check_agree``: the divergence guard — a checksum of each rank's
  placement fields gathered at every chunk boundary; a mismatch raises.

Transport: an NCCL group gathers CUDA tensors on the card
(``all_gather_into_tensor``).  A gloo group gathers host tensors: a CUDA
tensor is staged through pinned host memory and copied back — several
ranks that share one card cannot form an NCCL group, and that staging is
the transport of such a mesh, not a fallback.

``COUNTERS`` counts the collectives this process issued and the bytes
each gathered (n times the rank's contribution); the drivers record their
deltas per chunk (``info["mesh"]``, ``GoalOptimizer.mesh-collective-ops``).
Every rank must issue the same collectives in the same order: the sharded
search keeps every rank's control flow identical.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.ops.segment import shard_combine

COUNTERS = {"collectives": 0, "bytes": 0}


def lane_range(k: int, mesh) -> Tuple[int, int]:
    """The rank's contiguous lanes ``[lo, hi)`` of a K-wide axis:
    ``ceil(K/n)`` lanes a rank in rank order, clipped to K."""
    per = -(-k // mesh.size)
    lo = min(mesh.rank * per, k)
    return lo, min(lo + per, k)


def _gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` in rank order, on ``x``'s device."""
    n = mesh.size
    x = x.contiguous()
    COUNTERS["collectives"] += 1
    COUNTERS["bytes"] += n * x.numel() * x.element_size()
    if mesh.backend == "nccl":
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    host = x
    if x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.stack(parts).to(x.device)


def all_gather_lanes(mesh, local: torch.Tensor, k: int) -> torch.Tensor:
    """[C, K] from every rank's ``local`` [C, hi - lo] slice of ``lane_range``."""
    per = -(-k // mesh.size)
    pad = per - local.shape[-1]
    if pad:
        local = F.pad(local, (0, pad))
    g = _gather(mesh, local)
    return g.permute(1, 0, 2).reshape(local.shape[0], mesh.size * per)[:, :k]


def gather_scores(mesh, score: torch.Tensor, eligible: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score f32[K], eligible bool[K]) from the ranks' slices: one
    ``all_gather_lanes`` of the packed i32[2, K/n] buffer, bit for bit."""
    packed = torch.stack([score.view(torch.int32), eligible.to(torch.int32)])
    full = all_gather_lanes(mesh, packed, k)
    return full[0].contiguous().view(torch.float32), full[1] != 0


def all_gather_partials(mesh, *parts: torch.Tensor) -> List[torch.Tensor]:
    """Each of ``parts`` (2-D, f32 or i32, the same rows) from every rank,
    as [n, rows, C] in rank order: one gather of the parts packed side by
    side as i32."""
    packed = torch.cat([p.view(torch.int32) for p in parts], dim=1)
    g = _gather(mesh, packed)
    out, c0 = [], 0
    for p in parts:
        c1 = c0 + p.shape[1]
        out.append(g[:, :, c0:c1].contiguous().view(p.dtype))
        c0 = c1
    return out


def check_agree(mesh, tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise unless every rank holds the same ``tensors`` (integer or bool),
    compared by an exact position-weighted sum of each: the replicated
    selection must keep the ranks' placements identical."""
    sums = []
    for t in tensors:
        flat = t.reshape(-1).to(torch.int64)
        w = torch.arange(1, flat.numel() + 1, dtype=torch.int64, device=flat.device)
        sums.append((flat * w).sum())
    g = _gather(mesh, torch.stack(sums)).cpu()
    if not bool((g == g[0]).all()):
        raise RuntimeError(f"ranks diverged at {what}: placement checksums "
                           f"{g.tolist()} (rank {mesh.rank} of {mesh.size})")


def sharded_broker_aggregates(model, mesh):
    """K1's five aggregates (``model.aggregates``) of a model sharded along
    the replica axis over ``mesh``: K1 over the rank's own rows
    (``lane_range``), the ranks' f32[B, 6] and i32[B, 2] partials gathered
    and summed in rank order by K15.  Every rank gets the same result."""
    lo, hi = lane_range(model.num_replicas_padded, mesh)
    load, rc, lc, pnw, lbi = model.aggregates(slice(lo, hi))
    fparts, iparts = all_gather_partials(
        mesh, torch.cat([load, pnw[:, None], lbi[:, None]], dim=1),
        torch.stack([rc, lc], dim=1))
    f, i = shard_combine(fparts, iparts)
    return (f[:, :NUM_RESOURCES].contiguous(), i[:, 0].contiguous(),
            i[:, 1].contiguous(), f[:, NUM_RESOURCES].contiguous(),
            f[:, NUM_RESOURCES + 1].contiguous())


def sharded_disk_load(model, mesh) -> torch.Tensor:
    """f32[D] ``model.disk_load`` of a model sharded along the replica axis
    over ``mesh``: the rank's rows, then K15 over the ranks' partials."""
    lo, hi = lane_range(model.num_replicas_padded, mesh)
    (fparts,) = all_gather_partials(mesh, model.disk_load(slice(lo, hi))[:, None])
    return shard_combine(fparts)[0][:, 0]
