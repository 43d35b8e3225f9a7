"""CUDA graphs of the gated goal step (K8) and of the goal chain (K12).

The Hopper form of the JAX package's device-resident loops — the
``lax.while_loop`` of ``_goal_fixpoint_budget``
(``cruise_control_tpu/analyzer/optimizer.py:1572``) and the goal chain of
``_stack_fixpoint`` (``:2491``) — and of its program caches
(``_budget_cache``, ``_stack_cache``).  It has no JAX counterpart as a
module.  Per (goal, previous goals, constraint, widths, shapes, frontier
bucket) the cache holds one ``torch.cuda.CUDAGraph`` of the gated step
(``optimizer._gated_step``), captured once and replayed a chunk of times
between host reads; a stack runs its goals' graphs back to back, and the
per-goal frontier driver replays the graph of each chunk's bucket and
compacted widths.

A captured graph reads and writes fixed addresses, so everything the step
touches is a static buffer:

- every model field, the options and the counters: one ``StepState`` per
  shape, loaded from each new snapshot before its first replay
  (``GraphCache.state``), so a cached graph never replays against an
  earlier snapshot's memory;
- each graph's step invariants: its own buffers, refreshed before each
  goal or chunk (``StepGraph.load``);
- with the flight recorder on, the flight buffer of the chunk's capacity
  (``StepState.flight_buffer``) and its row index, the step counter: a
  recorder-on graph has a key of its own (``goal_key``'s ``flight_cap``),
  and the recorder-off graphs stay the recorder-less ones;
- each bucket's frontier maps (``FrontierInvariants``): one set of buffers
  per (shape, bucket), shared by every goal's graph of that bucket and
  written when a chunk that uses a new frontier is dispatched
  (``GraphCache.frontier``) — in stream order, from pinned host memory
  without a host sync, so a chunk already queued on the previous frontier
  still reads it.  The buffer set remembers the frontier it was last
  given, whichever goal's driver gave it: the inter-goal pipeline's opener
  of the next goal, compacted onto its seed frontier, writes the buffers
  behind the current goal's queued chunks, and replays the next goal's own
  graph for its (bucket, widths), so the pipeline keys no graph of its
  own.

All graphs capture into one memory pool.  That is safe because they leave
no live outputs in it (the step writes its results into the static
buffers) and never run concurrently: a solve holds ``GraphCache.lock``
from loading its snapshot to copying its placement out, so two solves in
one process take turns on the shared buffers and on the pool, whatever
their shapes.

Retention: the cache keeps the ``MAX_SHAPES`` most recently solved
shapes.  A shape costs one copy of the model and the options on the
device, at most one graph per (goal, previous goals, constraint, widths,
bucket) and one set of frontier buffers per bucket; one shape more evicts
the least recently used one with all its graphs and frontier buffers, so
a service whose cluster shape drifts holds a bounded set.  The evicted
graphs' blocks stay in the pool for later captures to reuse.

The kernel wrappers' launch counters run once per capture while nothing is
launched, so a capture takes its increments back off and every replay
credits them again (``StepGraph.replay``).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from cruise_control_tpu_torch.analyzer.state import (CTR_LAST_N, FrontierInvariants,
                                                     StepInvariants, StepState)
from cruise_control_tpu_torch.model.tensor_model import STATIC_FIELDS, TENSOR_FIELDS
from cruise_control_tpu_torch.ops import cuda

# Shapes whose static state and graphs the cache keeps.
MAX_SHAPES = 4


def _copy_invariants(inv: StepInvariants) -> StepInvariants:
    return StepInvariants(**{f.name: (None if getattr(inv, f.name) is None
                                      else getattr(inv, f.name).contiguous().clone())
                             for f in dataclasses.fields(inv)})


class StepGraph:
    """One captured gated step and the invariant buffers it reads."""

    def __init__(self, graph: torch.cuda.CUDAGraph, invariants: StepInvariants,
                 launches: Dict[str, int]):
        self.graph = graph
        self.invariants = invariants
        # Kernel launches one replay makes, by wrapper name.
        self.launches = launches

    def load(self, inv: StepInvariants) -> None:
        for f in dataclasses.fields(inv):
            src = getattr(inv, f.name)
            if src is not None:
                getattr(self.invariants, f.name).copy_(src)

    def replay(self, times: int) -> None:
        for _ in range(times):
            self.graph.replay()
        cuda.add_launches(self.launches, times)


class GraphCache:
    """Static step states per shape and step graphs per goal key."""

    def __init__(self):
        # Shape key -> static state, least recently used first.
        self._states: "collections.OrderedDict[tuple, StepState]" = \
            collections.OrderedDict()
        # Goal key (its last element is the shape key) -> graph.
        self._graphs: Dict[tuple, StepGraph] = {}
        # (shape key, bucket) -> [static frontier buffers, the host frontier
        # they hold].
        self._frontiers: Dict[tuple, list] = {}
        self._pool = None
        # Held by a solve for as long as it uses the static buffers.
        self.lock = threading.Lock()

    @staticmethod
    def shape_key(model, options) -> tuple:
        return (str(model.device),
                tuple(tuple(getattr(model, f).shape) for f in TENSOR_FIELDS),
                tuple(getattr(model, s) for s in STATIC_FIELDS),
                tuple(tuple(getattr(options, f.name).shape)
                      for f in dataclasses.fields(options)))

    def state(self, model, options) -> StepState:
        """The static state of ``model``'s shape, loaded with ``model`` and
        ``options``; evicts the least recently used shape beyond
        ``MAX_SHAPES``."""
        key = self.shape_key(model, options)
        st = self._states.get(key)
        if st is None:
            st = StepState.alloc_like(model, options)
            self._states[key] = st
            while len(self._states) > MAX_SHAPES:
                old, _ = self._states.popitem(last=False)
                for k in [k for k in self._graphs if k[-1] == old]:
                    del self._graphs[k]
                for k in [k for k in self._frontiers if k[0] == old]:
                    del self._frontiers[k]
        else:
            self._states.move_to_end(key)
        st.load(model, options)
        return st

    def frontier(self, st: StepState, fr: FrontierInvariants) -> FrontierInvariants:
        """The static frontier buffers of ``st``'s shape and ``fr``'s
        bucket, holding ``fr`` (host tensors), copied in on the stream when
        they held another frontier."""
        key = (self.shape_key(st.model, st.options), fr.bucket)
        entry = self._frontiers.get(key)
        if entry is None:
            dev = st.model.device
            bufs = FrontierInvariants(**{
                f.name: torch.empty(getattr(fr, f.name).shape,
                                    dtype=getattr(fr, f.name).dtype, device=dev)
                for f in dataclasses.fields(fr)})
            entry = self._frontiers[key] = [bufs, None]
        if entry[1] is not fr:
            for f in dataclasses.fields(fr):
                buf, src = getattr(entry[0], f.name), getattr(fr, f.name)
                if buf.is_cuda:
                    buf.copy_(src.pin_memory(), non_blocking=True)
                else:
                    buf.copy_(src)
            entry[1] = fr
        return entry[0]

    def num_frontiers(self) -> int:
        return len(self._frontiers)

    def get(self, key: tuple) -> Optional[StepGraph]:
        return self._graphs.get(key)

    def capture(self, key: tuple, st: StepState, inv: StepInvariants,
                step: Callable[[StepState, StepInvariants], None]) -> StepGraph:
        """Capture ``step(st, invariants)`` as the graph of ``key``.  One
        eager run first, with the step gated off so it changes nothing,
        loads every kernel library and fills every constant cache the
        capture must not create; the capture itself launches nothing."""
        static_inv = _copy_invariants(inv)
        saved = st.counters.clone()
        st.counters[CTR_LAST_N] = 0
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(st, static_inv)
        torch.cuda.current_stream().wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = cuda.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            step(st, static_inv)
        after = cuda.launch_counts()
        delta = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        cuda.add_launches(delta, -1)
        st.counters.copy_(saved)
        g = StepGraph(graph, static_inv, delta)
        self._graphs[key] = g
        return g

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        self._graphs.clear()
        self._frontiers.clear()
        self._states.clear()
        self._pool = None


# The process's graph cache (the JAX package keeps its program caches at
# module level too).
GRAPHS = GraphCache()


def goal_key(spec, prev_specs: Tuple, constraint, num_sources: int, num_dests: int,
             st: StepState, bucket: Optional[int] = None, flight_cap: int = 0,
             oracle: bool = False, no_budgets: bool = False) -> tuple:
    """The graph key of a goal's gated step: ``bucket`` is the frontier's
    compacted axis (None: dense); ``flight_cap`` the flight recorder's
    buffer rows (0: off), ``oracle`` and ``no_budgets`` the repair oracle's
    and the budget ablation's flags, so that a graph of one mode is never
    replayed for another; the shape key comes last."""
    return (spec, tuple(prev_specs), constraint, num_sources, num_dests, bucket,
            int(flight_cap), bool(oracle), bool(no_budgets),
            GraphCache.shape_key(st.model, st.options))
