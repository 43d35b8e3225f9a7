"""The sharded candidate search over ``torch.distributed``: the counterpart
of ``cruise_control_tpu/parallel/mesh.py``.

One optimizer step scores a K-wide candidate batch, and K splits cleanly
over ranks: the JAX package annotates the batch with ``P(search)`` and
lets GSPMD insert the collectives.  The port issues them itself
(``collectives.py``):

- **The candidate split** (``optimizer._step_select``): every rank builds
  the whole batch, scores and masks its contiguous slice (K5b, K5), and
  one all-gather of the packed score bits and eligibility puts the slices
  back in candidate order.  K5 and K5b are per-candidate, so every rank
  then holds the one-device ``score`` and ``eligible`` bit for bit; the
  selection runs replicated, every rank keeps the same set, and K7 keeps
  the ranks' models identical without a further collective.  Under a
  replicated model the integer outputs and the placement equal the
  one-device run's.
- **The replica-axis split** (``shard_model_replica_axis``): under the
  mesh, the optimizer's reductions over the replica axis (K1's aggregates,
  the disk loads: ``BrokerArrays.from_model(..., mesh=...)``) cover the
  rank's own rows ``[r·R/n, (r+1)·R/n)``; the partials are all-gathered and
  summed in rank order by K15 (``ops.segment.shard_combine``,
  ``csrc/shard_combine.cu``) — XLA's psum.  The model's own queries
  (``broker_load`` and the rest) stay local and issue no collective, so a
  rank may call them alone.  This changes the float order
  of the aggregates: they agree with the unsharded ones within rtol 1e-5,
  the JAX package's tolerance for the same split (``tests/test_parallel.py:71``).
  The tensors stay whole on every rank (a million replicas take about
  100 MB), so the split saves neither memory nor compute yet — it pays off
  once the tensors are sharded at rest, which is later work.
- **The divergence guard**: at every chunk boundary the ranks gather a
  checksum of their placement and raise on a mismatch.

Under a mesh the gated steps run eagerly, with no ``graphs.GRAPHS``
cache: a captured CUDA graph cannot hold a gloo collective, and several
ranks that share one card talk over gloo (NCCL refuses two ranks on one
device).  A gloo mesh on the card stages its tensors through pinned host
memory (``collectives._gather``); an NCCL mesh gathers on the card.

A mesh is one process per rank: ``init_search_mesh`` in each spawned rank
(``Ranks`` spawns them on one host and collects their results), or
``make_search_mesh`` in a process whose ``torch.distributed`` group is
already initialised, or as a one-rank group.  AOT prelowering
(``CRUISE_AOT_PRELOWER``) works around the TPU's remote compiler and is not
ported: ``prelower_goal_programs`` returns ``[]``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from cruise_control_tpu_torch.analyzer import candidates as cgen
from cruise_control_tpu_torch.analyzer import optimizer as opt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GoalSpec
from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel

SEARCH_AXIS = "search"


@dataclasses.dataclass(frozen=True)
class SearchMesh:
    """A 1-D mesh over the ``search`` axis: this process's rank of
    ``world``, its device and its process group (the port's
    ``jax.sharding.Mesh``).  Equal and hashable by (rank, world, device,
    backend), the identity the optimizer's caches may key on."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def size(self) -> int:
        return self.world


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_search_mesh(rank: int, world: int, device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> SearchMesh:
    """Join (or, with ``world`` = 1, form) the process group of a search
    mesh as ``rank`` of ``world`` and return the rank's mesh.  ``backend``
    defaults to NCCL on the card and gloo on the CPU; ranks that share one
    card use gloo.  ``init_method`` defaults to ``env://`` (``MASTER_ADDR``
    and ``MASTER_PORT``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None else 0)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return SearchMesh(rank=rank, world=world, device=dev, backend=backend,
                      group=dist.group.WORLD)


def make_search_mesh(num_devices: Optional[int] = None,
                     device: Union[str, torch.device] = "cuda") -> SearchMesh:
    """The mesh of this process: the initialised ``torch.distributed``
    group (``num_devices``, if given, must be its size), or else a one-rank
    group on ``device``, which defaults to the card and raises without one
    (``make_search_mesh`` never picks the CPU by itself)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_devices is not None and num_devices != world:
            raise ValueError(f"the process group has {world} ranks, not {num_devices}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return SearchMesh(rank=dist.get_rank(), world=world, device=dev,
                          backend=dist.get_backend(), group=dist.group.WORLD)
    if num_devices not in (None, 1):
        raise ValueError("without an initialised process group the mesh has one rank; "
                         "spawn ranks with Ranks or init_search_mesh")
    return init_search_mesh(0, 1, dev, init_method=f"tcp://127.0.0.1:{_free_port()}")


# ---------------------------------------------------------------------------
# Ranks on one host
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, device, backend, port, args, out) -> None:
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        mesh = init_search_mesh(rank, world, device, backend,
                                init_method=f"tcp://127.0.0.1:{port}")
        out.put((rank, True, fn(mesh, *args)))
    except Exception:  # every failure goes to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``world`` ranks of one search mesh spawned on this host, each running
    ``fn(mesh, *args)`` (``fn`` importable by name, ``args`` picklable),
    over a process group on a free port of 127.0.0.1; ``join`` waits for
    their results.  Build the CUDA kernels before (``ops.cuda.build_all``)
    so that the ranks load them."""

    def __init__(self, fn: Callable, world: int, device: str = "cuda",
                 backend: Optional[str] = None, args: Sequence = ()):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self._out = ctx.Queue()
        port = _free_port()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(fn, r, world, device, backend, port, tuple(args),
                                         self._out), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def join(self, timeout: float = 600.0) -> List[Any]:
        """Every rank's return value, in rank order; raises (and stops every
        rank) when one fails, dies or outlasts ``timeout`` seconds."""
        results: List[Any] = [None] * self.world
        deadline = time.monotonic() + timeout
        try:
            for _ in range(self.world):
                while True:
                    try:
                        rank, ok, value = self._out.get(timeout=1.0)
                        break
                    except queue_mod.Empty:
                        dead = [p.exitcode for p in self._procs
                                if p.exitcode not in (None, 0)]
                        if dead or time.monotonic() > deadline:
                            raise RuntimeError(f"search ranks failed: exit codes {dead}, "
                                               f"{deadline - time.monotonic():.0f} s left")
                if not ok:
                    raise RuntimeError(f"search rank {rank} of {self.world} failed:\n{value}")
                results[rank] = value
            for p in self._procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in self._procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return results


# ---------------------------------------------------------------------------
# The drivers (``cruise_control_tpu/parallel/mesh.py:55-227``)
# ---------------------------------------------------------------------------

def make_sharded_step(spec: GoalSpec, prev_specs: Tuple[GoalSpec, ...],
                      constraint: BalancingConstraint, num_sources: int,
                      num_dests: int, mesh: SearchMesh):
    """One optimizer step with its candidate scoring split over ``mesh``:
    ``step(model, options) -> (model, num_applied, sel_stats)``, the
    one-device ``optimizer._goal_step`` otherwise.  The model may be
    replicated or replica-sharded (``shard_model_replica_axis``)."""
    def step(model: TensorClusterModel, options: OptimizationOptions):
        return opt._goal_step(model, options, spec, tuple(prev_specs), constraint,
                              num_sources, num_dests, mesh=mesh)
    return step


def shard_model_replica_axis(model: TensorClusterModel, mesh: SearchMesh
                             ) -> TensorClusterModel:
    """``model`` with its replica axis sharded over ``mesh``
    (``replica_mesh``): under that mesh the optimizer's reductions over the
    replica axis cover the rank's rows ``[r·R/n, (r+1)·R/n)`` and K15
    combines them across the ranks; the broker, disk and partition axes
    stay replicated.  Every tensor stays whole on every rank, so the
    values round-trip bit for bit.  The padded replica axis must divide the
    mesh size (``generate_cluster(pad_replicas_to_multiple=...)``)."""
    r = model.num_replicas_padded
    n = mesh.size
    if r % n != 0:
        raise ValueError(f"padded replica axis {r} not divisible by mesh size {n}")
    return model.replace(replica_mesh=mesh)


def distributed_optimize_goal(model: TensorClusterModel, spec: GoalSpec,
                              prev_specs: Tuple[GoalSpec, ...],
                              constraint: BalancingConstraint,
                              options: OptimizationOptions, mesh: SearchMesh,
                              max_steps: int = 256,
                              num_sources: Optional[int] = None,
                              num_dests: Optional[int] = None):
    """One goal to its fixpoint with the candidate scoring split over
    ``mesh``: the unfused step loop (``optimizer._goal_fixpoint``).
    Returns ``(model, steps, actions)``."""
    ns = num_sources or cgen.default_num_sources(model)
    nd = num_dests or cgen.default_num_dests(model)
    model, packed = opt._goal_fixpoint(model.to(mesh.device), options, spec,
                                       tuple(prev_specs), constraint, ns, nd, max_steps,
                                       mesh)
    return model, int(packed[opt.PACKED_STEPS]), int(packed[opt.PACKED_ACTIONS])


def bucket_ladder(num_brokers: int) -> Tuple[int, ...]:
    """The power-of-two frontier buckets a ``num_brokers`` cluster can
    ever dispatch (the doubling ladder from ``_FRONTIER_DENSE_MIN`` up to
    the dense fallback)."""
    out = []
    b = opt._FRONTIER_DENSE_MIN
    while b < num_brokers:
        out.append(b)
        b *= 2
    return tuple(out)


def prelower_goal_programs(model: TensorClusterModel, spec: GoalSpec,
                           prev_specs: Tuple[GoalSpec, ...],
                           constraint: BalancingConstraint,
                           options: OptimizationOptions, mesh: SearchMesh,
                           num_sources: int, num_dests: int,
                           pipelined: bool = False,
                           flight_capacity: int = 0) -> list:
    """``[]``: AOT prelowering (``CRUISE_AOT_PRELOWER``) works around the
    TPU's remote compiler and is not ported; a sharded step runs eagerly
    and has no program to lower."""
    return []


def distributed_frontier_fixpoint(model: TensorClusterModel, spec: GoalSpec,
                                  prev_specs: Tuple[GoalSpec, ...],
                                  constraint: BalancingConstraint,
                                  options: OptimizationOptions, mesh: SearchMesh,
                                  max_steps: int = 256, chunk_steps: int = 32,
                                  num_sources: Optional[int] = None,
                                  num_dests: Optional[int] = None,
                                  on_chunk=None, frontier: bool = True,
                                  speculate: Optional[bool] = None,
                                  seed_active=None, next_goal=None,
                                  prelaunch=None, min_chunk: int = 4):
    """The chunked per-goal driver (``optimizer.frontier_fixpoint``) with
    every step's candidate scoring split over ``mesh``: the same chunks,
    compaction buckets, speculative follow-ups and openers, the compacted
    widths rounded up to multiples of the mesh size
    (``optimizer._frontier_widths(..., lanes=n)``), one host fetch per
    boundary and the ranks' placements checked equal there.  Returns
    ``(model, info)`` with the driver's info and ``info["mesh"]`` =
    {devices, fetch_bytes, collectives}: the mesh
    size, the bytes of the boundary fetches and the collectives this rank
    issued.  ``on_chunk`` callbacks are not ported (the port's driver has
    none) and must be None.  The JAX package's ``prelower`` option (AOT
    prelowering) is not ported and not accepted."""
    n = mesh.size
    r = model.num_replicas_padded
    if r % n != 0:
        raise ValueError(f"padded replica axis {r} not divisible by mesh size {n}")
    if on_chunk is not None:
        raise NotImplementedError("on_chunk callbacks are not ported")
    model, info = opt.frontier_fixpoint(
        model.to(mesh.device), options, spec, tuple(prev_specs), constraint,
        num_sources=num_sources, num_dests=num_dests, max_steps=max_steps,
        chunk_steps=chunk_steps, frontier=frontier, min_chunk=min_chunk,
        speculate=speculate, seed_active=seed_active, next_goal=next_goal,
        prelaunch=prelaunch, mesh=mesh)
    info["mesh"] = {
        "devices": n,
        "fetch_bytes": sum(c.get("fetch_bytes", 0) for c in info.get("chunks", [])),
        "collectives": sum(c.get("collectives", 0) for c in info.get("chunks", [])),
    }
    return model, info
