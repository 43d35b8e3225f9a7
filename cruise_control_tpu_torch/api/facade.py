"""The CruiseControl facade: one object tying monitor → analyzer → executor
→ detectors together.

Counterpart of ``cruise_control_tpu/api/facade.py`` on the port's modules:
every solve runs on the facade's ``device`` (the card unless the caller
asks for the CPU), the request option masks are tensors there, and the
standing proposal's sweep is one fetch.

Parity with ``KafkaCruiseControl`` (KafkaCruiseControl.java:73) +
``GoalOptimizer``'s proposal cache (GoalOptimizer.java:63: precomputed
proposals invalidated by model generation, ``optimizations`` cached path
:291-339): admin operations (rebalance, add/remove/demote brokers, fix
offline replicas, topic RF update) each build a cluster model, run the goal
stack under operation-specific options, and optionally execute — exactly
the servlet runnables' computeResult flow
(GoalBasedOperationRunnable.java:153-186, RebalanceRunnable.java:109-123,
AddBrokersRunnable / RemoveBrokersRunnable / DemoteBrokerRunnable /
FixOfflineReplicasRunnable / UpdateTopicConfigurationRunnable).

This facade is also the self-healing context consumed by
``detector.anomalies`` fix() methods.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.common.timeseries import (FETCHES_SERIES,
                                                  STANDING_HIT_SERIES,
                                                  TELEMETRY)
from cruise_control_tpu_torch.common.tracing import TRACE
from cruise_control_tpu_torch.device import resolve_device

from cruise_control_tpu_torch.analyzer import optimizer as opt
from cruise_control_tpu_torch.analyzer import proposals as props
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import (DEFAULT_GOAL_ORDER,
                                                     DEFAULT_HARD_GOALS,
                                                     GOAL_SPECS,
                                                     INTRA_BROKER_GOAL_ORDER)
from cruise_control_tpu_torch.analyzer.state import (OptimizationOptions, WarmStart,
                                               model_delta)
from cruise_control_tpu_torch.analyzer.verifier import VerificationError, verify_run
from cruise_control_tpu_torch.executor.admin import ClusterAdmin, ReassignmentRequest
from cruise_control_tpu_torch.executor.executor import (Executor,
                                                  OngoingExecutionError,
                                                  ReplanDirective)
from cruise_control_tpu_torch.executor.strategy import resolve_strategy
from cruise_control_tpu_torch.model.stats import compute_stats
from cruise_control_tpu_torch.model.tensor_model import BrokerState, TensorClusterModel
from cruise_control_tpu_torch.monitor.load_monitor import (LoadMonitor,
                                                     ModelCompletenessRequirements)


@dataclasses.dataclass
class OperationResult:
    """OptimizationResult JSON payload (servlet/response/OptimizationResult)."""

    ok: bool
    dryrun: bool
    proposals: List[props.ExecutionProposal]
    violated_goals_before: List[str]
    violated_goals_after: List[str]
    provision_status: str
    stats_before: Dict[str, object]
    stats_after: Dict[str, object]
    execution: Optional[object] = None  # ExecutionResult when not dryrun
    reason: str = ""
    # Goals whose step loop hit max_steps while still applying actions: the
    # run may not be a true fixpoint for them (GoalResult.capped).
    capped_goals: List[str] = dataclasses.field(default_factory=list)
    # On-demand balancedness (OptimizerResult.java:117-118).
    balancedness_before: float = 100.0
    balancedness_after: float = 100.0

    def to_dict(self) -> Dict[str, object]:
        out = {
            "ok": self.ok,
            "dryrun": self.dryrun,
            "numProposals": len(self.proposals),
            "proposals": [p.to_dict() for p in self.proposals[:200]],
            "violatedGoalsBefore": self.violated_goals_before,
            "violatedGoalsAfter": self.violated_goals_after,
            "provisionStatus": self.provision_status,
            "statsBefore": self.stats_before,
            "statsAfter": self.stats_after,
            "reason": self.reason,
            "cappedGoals": self.capped_goals,
            "onDemandBalancednessScoreBefore": round(self.balancedness_before, 3),
            "onDemandBalancednessScoreAfter": round(self.balancedness_after, 3),
        }
        if self.execution is not None:
            out["execution"] = dataclasses.asdict(self.execution)
        return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host (one copy)."""
    return t.detach().cpu().numpy()


def _traced_op(fn):
    """Wrap an admin operation in a ``facade.<op>`` span.  Under a user
    task this nests below the task's ``request.<endpoint>`` root; called
    directly (tests, self-healing fixes) it becomes its own root trace."""
    name = f"facade.{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        attrs = {k: kwargs[k] for k in ("dryrun", "reason", "self_healing")
                 if k in kwargs}
        with TRACE.span(name, **attrs) as sp:
            out = fn(self, *args, **kwargs)
            if isinstance(out, OperationResult):
                sp.annotate(ok=out.ok, proposals=len(out.proposals))
            elif isinstance(out, bool):
                sp.annotate(ok=out)
            return out

    return wrapper


class CruiseControl:
    def __init__(self, load_monitor: LoadMonitor, executor: Executor,
                 admin: ClusterAdmin,
                 goals: Optional[Sequence[str]] = None,
                 hard_goals: Optional[Sequence[str]] = None,
                 constraint: Optional[BalancingConstraint] = None,
                 requirements: Optional[ModelCompletenessRequirements] = None,
                 proposal_expiration_ms: int = 60_000,
                 max_steps_per_goal: int = 256,
                 max_candidates_per_step: Optional[int] = None,
                 balancedness_priority_weight: float = 1.1,
                 balancedness_strictness_weight: float = 1.5,
                 supported_goals: Optional[Sequence[str]] = None,
                 intra_broker_goals: Optional[Sequence[str]] = None,
                 allow_capacity_estimation: bool = True,
                 excluded_topics_pattern: Optional[str] = None,
                 self_healing_exclude_recently_demoted: bool = True,
                 self_healing_exclude_recently_removed: bool = True,
                 warm_start_enabled: bool = False,
                 warm_start_delta_threshold: float = 0.05,
                 replan_interval_polls: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        # The device every solve runs on: the card unless the caller asks
        # for the CPU (raises without CUDA).  Models are moved there and the
        # request option masks are made there.
        self.device = resolve_device(device)
        self.load_monitor = load_monitor
        self.executor = executor
        self.admin = admin
        self.goals = list(goals or DEFAULT_GOAL_ORDER)
        self.hard_goals = list(hard_goals or DEFAULT_HARD_GOALS)
        # goals (AnalyzerConfig GOALS_CONFIG): every requestable goal; a
        # request naming a goal outside it is rejected up front.
        self.supported_goals = list(supported_goals or GOAL_SPECS)
        # intra.broker.goals: the stack for rebalance_disk=true requests.
        self.intra_broker_goals = list(intra_broker_goals or
                                       INTRA_BROKER_GOAL_ORDER)
        self.allow_capacity_estimation = allow_capacity_estimation
        # topics.excluded.from.partition.movement (a regex in the reference).
        self._excluded_topics_pattern = (re.compile(excluded_topics_pattern)
                                         if excluded_topics_pattern else None)
        self._self_heal_exclude_demoted = self_healing_exclude_recently_demoted
        self._self_heal_exclude_removed = self_healing_exclude_recently_removed
        self.constraint = constraint or BalancingConstraint.default()
        self.requirements = requirements or ModelCompletenessRequirements()
        self._proposal_expiration_ms = proposal_expiration_ms
        self._max_steps_per_goal = max_steps_per_goal
        self._max_candidates_per_step = max_candidates_per_step
        self._balancedness_weights = (balancedness_priority_weight,
                                      balancedness_strictness_weight)
        # analyzer.warm.start.*: per-request warm seeding policy.  Off by
        # default for direct requests (warm=None resolves to this flag);
        # the cruise loop passes warm=True explicitly, so cruise refreshes
        # are warm even when requests stay cold.
        self._warm_start_enabled = warm_start_enabled
        self._warm_delta_threshold = warm_start_delta_threshold
        # execution.replan.interval.polls: 0 (default) executes plans
        # statically; N > 0 re-solves against the partially-moved cluster
        # every N executor polls and patches the live task queue.
        self._replan_interval_polls = replan_interval_polls
        # The run whose converged model the LAST successful mid-execution
        # replan targeted — what _absorb_execution should re-base onto
        # instead of the original run when a replanned execution lands ok.
        # Written by the executor's replan hook (executor poll thread) and
        # consumed by _absorb_execution (request thread).
        self._executed_run_override: Optional[opt.OptimizerRun] = None  # guarded-by: _cache_lock
        self._cache_lock = threading.Lock()
        # The STANDING PROPOSAL: (model_generation, monotonic time,
        # pre-optimization model, converged run, renumbered proposals).
        # The pre-model is the delta-probe baseline (the converged
        # run.model differs from it by exactly the proposed moves, so
        # diffing fresh-vs-pre answers "did the cluster move under us"),
        # and the run.model is the warm seed.
        self._cached: Optional[Tuple[Tuple[int, int], float,
                                     TensorClusterModel, opt.OptimizerRun,
                                     List[props.ExecutionProposal]]] = None  # guarded-by: _cache_lock

    # ------------------------------------------------------------------
    # Model + optimization plumbing
    # ------------------------------------------------------------------
    def _model(self) -> TensorClusterModel:
        return self.load_monitor.cluster_model(
            self.requirements,
            allow_capacity_estimation=self.allow_capacity_estimation).to(self.device)

    def _dev(self, mask: np.ndarray) -> torch.Tensor:
        """A host option mask on the facade's device."""
        return torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)

    def _model_naming(self) -> Tuple[TensorClusterModel, Dict[str, object]]:
        """Model + id↔name maps from ONE metadata snapshot.  The tensor model
        uses dense broker indices (sorted-id order); the cluster protocol uses
        real, possibly non-contiguous ids.  All translation in an operation
        must use this naming — a fresh ``naming()`` read could reflect a
        membership change and misaddress every proposal."""
        model, naming = self.load_monitor.cluster_model_and_naming(self.requirements)
        return model.to(self.device), naming

    @staticmethod
    def _to_dense(naming: Dict[str, object], broker_ids: Sequence[int]) -> List[int]:
        to_dense = {b: i for i, b in enumerate(naming["brokers"])}
        missing = [b for b in broker_ids if b not in to_dense]
        if missing:
            raise ValueError(f"unknown broker ids {missing}")
        return [to_dense[b] for b in broker_ids]

    def _base_options(self, model: TensorClusterModel,
                      naming: Dict[str, object],
                      excluded_topics_pattern: Optional[str] = None
                      ) -> OptimizationOptions:
        """Default per-request options with the excluded topics applied.
        A per-request ``excluded_topics`` regex OVERRIDES the boot-time
        topics.excluded.from.partition.movement pattern (the reference's
        param-else-config resolution, ParameterUtils.java:898)."""
        options = OptimizationOptions.none(model)
        pattern = (re.compile(excluded_topics_pattern)
                   if excluded_topics_pattern
                   else self._excluded_topics_pattern)
        if pattern is not None:
            tmask = np.array([bool(pattern.fullmatch(t))
                              for t in naming["topics"]], bool)
            if tmask.any():
                options = options.replace(topic_excluded=self._dev(tmask))
        return options

    @staticmethod
    def _request_strategy(names: Optional[Sequence[str]]):
        """Resolve a per-request movement-strategy chain (None -> use the
        executor's boot-time strategy)."""
        return resolve_strategy(list(names)) if names else None

    def _validate_goals(self, goals: Sequence[str]) -> None:
        """User-requested goals must be in goals= (the supported set);
        short and fully-qualified names both resolve, as in
        goals_by_priority.  Internal stacks (demote's
        PreferredLeaderElectionGoal, self-healing) are not gated — the
        reference only sanity-checks request parameters against
        GOALS_CONFIG."""
        supported = {g.rsplit(".", 1)[-1] for g in self.supported_goals}
        unsupported = [g for g in goals
                       if g.rsplit(".", 1)[-1] not in supported]
        if unsupported:
            raise ValueError(
                f"goals {unsupported} are not supported; supported: "
                f"{sorted(supported)}")

    def _self_heal_excludes(self, options: OptimizationOptions,
                            naming: Dict[str, object]) -> OptimizationOptions:
        """self.healing.exclude.recently.{removed,demoted}.brokers
        (AnomalyDetectorConfig): an autonomous fix must not undo a recent
        operator decision by moving replicas back onto a just-removed broker
        or leadership onto a just-demoted one.  Applied by every
        self-healing entry point (rebalance, fix_offline_replicas)."""
        to_dense = {b: i for i, b in enumerate(naming["brokers"])}
        if self._self_heal_exclude_removed:
            removed = [to_dense[b] for b in
                       self.executor.recently_removed_brokers()
                       if b in to_dense]
            if removed:
                emask = _host(options.broker_excluded_replica_move).copy()
                emask[removed] = True
                options = options.replace(
                    broker_excluded_replica_move=self._dev(emask))
        if self._self_heal_exclude_demoted:
            demoted = [to_dense[b] for b in
                       self.executor.recently_demoted_brokers()
                       if b in to_dense]
            if demoted:
                lmask = _host(options.broker_excluded_leadership).copy()
                lmask[demoted] = True
                options = options.replace(
                    broker_excluded_leadership=self._dev(lmask))
        return options

    def _optimize(self, model: TensorClusterModel, goals: Optional[Sequence[str]],
                  options: Optional[OptimizationOptions] = None,
                  fast_mode: bool = False,
                  naming: Optional[Dict[str, object]] = None,
                  warm_start: Optional[WarmStart] = None) -> opt.OptimizerRun:
        goal_list = list(goals) if goals else self.goals
        if options is None and naming is not None:
            # Config-excluded topics apply to EVERY goal-based operation,
            # not just /rebalance (the reference applies them in all
            # GoalBasedOperationRunnables).
            options = self._base_options(model, naming)
        # Requested non-hard-only goal subsets still honor hard goals first
        # (GoalBasedOperationRunnable skip-hard-goal-check semantics are an
        # explicit flag in the reference; default keeps them).
        with SENSORS.timer(
                "GoalOptimizer.proposal-computation-timer",
                help="End-to-end goal-stack optimization wall time").time():
            # The port's solve steps on a working copy (or the step graphs'
            # static buffers) and never writes ``model``, which
            # proposals.diff / verify_run read afterwards: no donation copy.
            return opt.optimize(model, goal_list, constraint=self.constraint,
                                options=options, raise_on_hard_failure=False,
                                fused=True, fast_mode=fast_mode,
                                max_steps_per_goal=self._max_steps_per_goal,
                                max_candidates_per_step=self._max_candidates_per_step,
                                balancedness_priority_weight=self._balancedness_weights[0],
                                balancedness_strictness_weight=self._balancedness_weights[1],
                                donate_model=True, warm_start=warm_start,
                                device=self.device)

    def _finish(self, model: TensorClusterModel, run: opt.OptimizerRun,
                dryrun: bool, reason: str, naming: Dict[str, object],
                verify: bool = True, strategy=None,
                replication_throttle: Optional[int] = None) -> OperationResult:
        # Verification runs on dense indices (the model's own numbering);
        # everything leaving the facade — REST payloads and the executor's
        # ReassignmentRequests / throttle entries — carries cluster ids from
        # the SAME snapshot the model was built from.
        with TRACE.span("analyzer.proposals", verify=verify) as sp:
            dense_proposals = props.diff(model, run.model)
            capped = [g.name for g in run.goal_results if g.capped]
            if verify:
                try:
                    verify_run(model, run, [g.name for g in run.goal_results],
                               constraint=self.constraint,
                               proposals=dense_proposals)
                except VerificationError as e:
                    sp.annotate(verification_failed=True)
                    return OperationResult(
                        ok=False, dryrun=dryrun,
                        proposals=props.renumber_brokers(
                            dense_proposals, naming["brokers"]),
                        violated_goals_before=run.violated_goals_before,
                        violated_goals_after=run.violated_goals_after,
                        provision_status=run.provision_response.status.value,
                        stats_before=run.stats_before.to_dict(),
                        stats_after=run.stats_after.to_dict(),
                        reason=f"{reason} [verification failed: {e}]",
                        capped_goals=capped,
                        balancedness_before=run.balancedness_before,
                        balancedness_after=run.balancedness_after)
            proposals = props.renumber_brokers(dense_proposals,
                                               naming["brokers"])
            sp.annotate(proposals=len(proposals))
        execution = None
        ok = True
        if not dryrun and proposals:
            # The scorer re-scores balancedness over the ledger's landed-set
            # checkpoints (dense partition ids survive renumber_brokers, so
            # ledger masks address the model directly).
            scorer = opt.PlacementScorer.for_run(
                model, run, self.constraint, *self._balancedness_weights)
            # Live broker health feeds the ConcurrencyAdjuster during the
            # wait loop (Executor.java:335-447 reads request-queue depth /
            # handler idle ratio each interval).
            with self._cache_lock:
                self._executed_run_override = None
            replanner = (self._make_replanner(run, naming)
                         if self._replan_interval_polls > 0 else None)
            execution = self.executor.execute_proposals(
                proposals, naming["partitions"],
                concurrency_adjust_metrics=self.load_monitor.broker_health_metrics,
                strategy=strategy, replication_throttle=replication_throttle,
                balancedness_scorer=scorer,
                replanner=replanner,
                replan_interval_polls=self._replan_interval_polls)
            ok = execution.ok
        return OperationResult(
            ok=ok, dryrun=dryrun, proposals=proposals,
            violated_goals_before=run.violated_goals_before,
            violated_goals_after=run.violated_goals_after,
            provision_status=run.provision_response.status.value,
            stats_before=run.stats_before.to_dict(),
            stats_after=run.stats_after.to_dict(),
            execution=execution, reason=reason, capped_goals=capped,
            balancedness_before=run.balancedness_before,
            balancedness_after=run.balancedness_after)

    def _make_replanner(self, run: opt.OptimizerRun,
                        naming: Dict[str, object]):
        """Build the executor's replan-while-executing hook.

        Called at phase boundaries (where ``score_checkpoints`` already
        dispatches) with the ledger's landed/in-flight partition sets; the
        fresh load-monitor model IS the partially-moved blend — landed
        moves are in the cluster metadata, so the warm re-solve (seeded
        from the previous converged placement, frontier = the delta the
        execution + churn created) targets exactly the remaining work.
        Returns ``None`` on any soundness failure (membership/naming
        drift, incompatible delta, verification failure) — the executor
        counts a fallback and keeps the current plan."""
        state = {"run": run}

        def replanner(landed: frozenset, inflight: frozenset
                      ) -> Optional[ReplanDirective]:
            fresh, naming2 = self._model_naming()
            if (list(naming2["brokers"]) != list(naming["brokers"])
                    or list(naming2["partitions"]) != list(naming["partitions"])):
                # Mid-execution membership/naming drift: task partition ids
                # would no longer address the same partitions — keep the
                # static plan and let an anomaly path deal with it.
                return None
            crun = state["run"]
            delta = model_delta(crun.model, fresh)
            if delta is None:
                return None
            goal_names = [g.name for g in crun.goal_results]
            run2 = self._optimize(
                fresh, goal_names, naming=naming2,
                warm_start=WarmStart(prev_model=crun.model,
                                     active_mask=delta.changed_mask))
            dense = props.diff(fresh, run2.model)
            try:
                verify_run(fresh, run2, goal_names,
                           constraint=self.constraint, proposals=dense)
            except VerificationError:
                return None
            proposals = props.renumber_brokers(dense, naming2["brokers"])
            scorer = opt.PlacementScorer.for_run(
                fresh, run2, self.constraint, *self._balancedness_weights)
            state["run"] = run2
            with self._cache_lock:
                self._executed_run_override = run2
            return ReplanDirective(
                proposals=proposals, scorer=scorer,
                info={"landed": len(landed), "inflight": len(inflight)})

        return replanner

    # ------------------------------------------------------------------
    # Standing proposal (cruise mode / warm start)
    # ------------------------------------------------------------------
    def _warm_allowed(self, warm: Optional[bool]) -> bool:
        """Resolve the tri-state per-request ``warm`` parameter: None
        defers to analyzer.warm.start.enabled; the cruise loop passes
        True explicitly (warm is default-on only for cruise)."""
        return self._warm_start_enabled if warm is None else bool(warm)

    def _confirm_standing(self, crun: opt.OptimizerRun) -> bool:
        """ONE fused on-device satisfaction sweep over the standing
        converged placement: every goal the standing run left satisfied
        must still pass, and no replica may have gone offline.  This is
        the entire device cost of a zero-delta request — no fixpoint
        program is dispatched and no frontier-driver fetch happens."""
        specs = opt.goals_by_priority([g.name for g in crun.goal_results])
        sweep_fn = opt._get_sweep_fn(tuple(specs), self.constraint)
        sat_np, off_np = sweep_fn(crun.model)  # one fetch, counted by the sweep
        if bool(off_np):
            return False
        sat = {s.name: bool(v) for s, v in zip(specs, np.asarray(sat_np))}
        return all(sat.get(g.name, False)
                   for g in crun.goal_results if g.satisfied_after)

    def _absorb_execution(self, run: opt.OptimizerRun, execution) -> None:
        """Executor completion feeds the standing baseline: once a
        default-stack plan fully lands, the cluster's placement IS the
        converged ``run.model``, so the standing entry re-bases onto it —
        pre-model = converged model, no outstanding proposals — instead of
        the next tick's delta probe re-discovering the very moves the
        executor just made (each executed partition showed up as "cluster
        changed under us" and forced a warm re-solve).  A failed or partial
        execution absorbs nothing: the placement is then neither the old
        baseline nor the converged model, and the ordinary delta probe is
        the honest path."""
        with self._cache_lock:
            override = self._executed_run_override
            self._executed_run_override = None
        if execution is None or not getattr(execution, "ok", False):
            return
        if override is not None:
            # The execution was replanned mid-flight: the placement that
            # actually landed is the LAST re-solve's converged model, not
            # the original run's.
            run = override
        gen = self.load_monitor.model_generation().as_tuple()
        with self._cache_lock:
            self._cached = (gen, time.monotonic(), run.model, run, [])

    def _consult_standing(self, model: TensorClusterModel,
                          warm: Optional[bool], ignore_proposal_cache: bool,
                          op: str):
        """Decide how a default-stack request uses the standing proposal.

        Returns ``("hit", standing_entry)`` when the fresh model is
        delta-free against the standing baseline and the confirm sweep
        passes (serve the cached proposals outright), ``("warm",
        WarmStart)`` when the delta is small enough to seed a warm solve,
        and ``("cold", None)`` otherwise (warm disabled, no standing entry,
        incompatible membership, or delta above the threshold)."""
        labels = {"op": op}
        hits = SENSORS.counter(
            "CruiseControl.standing-hits", labels=labels,
            help="Requests answered from the standing proposal after a "
                 "zero-delta confirm sweep")
        warms = SENSORS.counter(
            "CruiseControl.warm-solves", labels=labels,
            help="Requests solved warm — seeded from the standing "
                 "converged placement")
        SENSORS.counter(
            "CruiseControl.warm-fallbacks", labels=labels,
            help="Warm solves that failed verification and fell back to a "
                 "cold solve")
        if not self._warm_allowed(warm):
            return "cold", None
        with self._cache_lock:
            standing = self._cached
        if standing is None:
            return "cold", None
        _cgen, ctime, pre_model, crun, _cprops = standing
        delta = model_delta(pre_model, model)
        if delta is None:
            return "cold", None  # membership/shape drift: warm unsound
        fresh = (time.monotonic() - ctime) * 1000 < self._proposal_expiration_ms
        if delta.is_zero and fresh and not ignore_proposal_cache:
            if self._confirm_standing(crun):
                hits.inc(1)
                return "hit", standing
            return "cold", None
        if delta.magnitude <= self._warm_delta_threshold:
            # Seed frontier = brokers the cluster changed under us ∪
            # brokers the standing proposal itself touches (its moves are
            # not applied yet, so they stay live optimization surface).
            active = delta.changed_mask.copy()
            touched = model_delta(pre_model, crun.model)
            if touched is not None:
                active |= touched.changed_mask
            warms.inc(1)
            return "warm", WarmStart(prev_model=crun.model,
                                     active_mask=active)
        return "cold", None

    def _heal_warm_start(self, model: TensorClusterModel,
                         options: OptimizationOptions,
                         op: str) -> Optional[WarmStart]:
        """Seed a self-healing solve from the standing proposal.

        A detected anomaly mutates a small part of the fleet, so a heal is
        exactly the small-delta warm case cruise mode already handles: diff
        the wounded model against the standing CONVERGED placement and seed
        the fixpoint from it.  Every dead/demoted broker force-joins the
        seed frontier — ``model_delta``'s state clause only catches state
        *changes*, but a broker that was already dead when the standing
        entry was built must still be live optimization surface (its
        offline replicas are the heal's whole point).  No delta-magnitude
        gate: the dense confirm chunk validates convergence, so an
        oversized delta costs steps, never correctness.  Falls cold when
        self-heal exclusions are active — the standing placement predates
        them and could seed moves onto excluded brokers."""
        labels = {"op": op}
        warms = SENSORS.counter(
            "CruiseControl.heal-warm-solves", labels=labels,
            help="Self-healing solves seeded warm from the standing "
                 "proposal's converged placement")
        colds = SENSORS.counter(
            "CruiseControl.heal-cold-solves", labels=labels,
            help="Self-healing solves that ran cold (no standing entry, "
                 "membership drift, warm start disabled, or active "
                 "self-heal exclusions)")
        excluded = bool(
            _host(options.broker_excluded_replica_move).any()
            or _host(options.broker_excluded_leadership).any())
        if not self._warm_start_enabled or excluded:
            colds.inc(1)
            return None
        with self._cache_lock:
            standing = self._cached
        if standing is None:
            colds.inc(1)
            return None
        crun = standing[3]
        delta = model_delta(crun.model, model)
        if delta is None:
            colds.inc(1)
            return None  # membership/shape drift: warm unsound
        active = delta.changed_mask.copy()
        active |= ((_host(model.broker_state) != BrokerState.ALIVE)
                   & _host(model.broker_valid))
        warms.inc(1)
        TRACE.annotate(heal_warm=True,
                       heal_seed_frontier=int(active.sum()))
        return WarmStart(prev_model=crun.model, active_mask=active)

    @staticmethod
    def _standing_result(crun: opt.OptimizerRun,
                         cprops: List[props.ExecutionProposal],
                         reason: str) -> OperationResult:
        """OperationResult view of a cached/standing run (always a
        verified-ok run — only those are stored)."""
        return OperationResult(
            ok=True, dryrun=True, proposals=cprops,
            violated_goals_before=crun.violated_goals_before,
            violated_goals_after=crun.violated_goals_after,
            provision_status=crun.provision_response.status.value,
            stats_before=crun.stats_before.to_dict(),
            stats_after=crun.stats_after.to_dict(),
            reason=reason,
            capped_goals=[g.name for g in crun.goal_results if g.capped],
            balancedness_before=crun.balancedness_before,
            balancedness_after=crun.balancedness_after)

    def refresh_standing_proposals(self, force: bool = False,
                                   warm: Optional[bool] = None
                                   ) -> OperationResult:
        """The cruise loop's tick: bring the standing proposal up to the
        current model generation.  With ``force=False`` an unchanged
        generation is a pure cache read; an advanced generation runs the
        delta probe → zero-delta confirm / warm solve / cold solve.
        ``force=True`` recomputes even on an unchanged generation
        (ignore-cache semantics — which also repopulate the cache).

        This tick is the cruise loop's telemetry publish boundary: the
        tick wall time, whether the standing proposal answered (hit), and
        the device-fetch delta across the tick land in :data:`TELEMETRY`
        as points — host floats already on hand, no extra device work."""
        hits = SENSORS.counter("CruiseControl.standing-hits",
                               labels={"op": "proposals"})
        h0 = hits.count
        f0 = opt.FETCH_COUNTERS["device_fetches"]
        t0 = time.monotonic()
        result = self.proposals(ignore_proposal_cache=force, warm=warm)
        TELEMETRY.record("cruise.tick-wall-s", time.monotonic() - t0)
        TELEMETRY.record(STANDING_HIT_SERIES,
                         1.0 if hits.count > h0 else 0.0)
        TELEMETRY.record(FETCHES_SERIES,
                         opt.FETCH_COUNTERS["device_fetches"] - f0)
        TELEMETRY.record("cruise.proposal-count", len(result.proposals))
        return result

    # ------------------------------------------------------------------
    # Proposals (cached)
    # ------------------------------------------------------------------
    @_traced_op
    def proposals(self, goals: Optional[Sequence[str]] = None,
                  ignore_proposal_cache: bool = False,
                  excluded_topics_pattern: Optional[str] = None,
                  warm: Optional[bool] = None) -> OperationResult:
        """GET /proposals — cached while the model generation is unchanged
        and the cache is younger than proposal.expiration.ms.

        When warm start applies (config default or ``warm=True``), a
        generation bump first runs the host-side delta probe against the
        standing proposal: a zero-delta model serves the standing
        proposals after one confirm sweep (no fixpoint dispatch), a small
        delta seeds a warm solve from the standing converged placement,
        and a large delta (or a warm solve failing verification) falls
        back to the cold path."""
        gen = self.load_monitor.model_generation().as_tuple()
        default_stack = not goals and not excluded_topics_pattern
        use_cache = not ignore_proposal_cache and default_stack
        if use_cache:
            with self._cache_lock:
                if self._cached is not None:
                    cgen, ctime, _cmodel, crun, cprops = self._cached
                    fresh = (time.monotonic() - ctime) * 1000 < self._proposal_expiration_ms
                    if cgen == gen and fresh:
                        return self._standing_result(crun, cprops, "cached")
        model, naming = self._model_naming()
        if goals:
            self._validate_goals(goals)
        options = self._base_options(model, naming, excluded_topics_pattern)
        warm_start = None
        if default_stack:
            mode, payload = self._consult_standing(
                model, warm, ignore_proposal_cache, "proposals")
            if mode == "hit":
                _cgen, ctime, pre_model, crun, cprops = payload
                with self._cache_lock:
                    # Re-key the standing entry to the advanced generation
                    # so the next request takes the pure gen fast path.
                    self._cached = (gen, ctime, pre_model, crun, cprops)
                return self._standing_result(crun, cprops, "standing")
            if mode == "warm":
                warm_start = payload
        run = self._optimize(model, goals, options, warm_start=warm_start)
        result = self._finish(model, run, dryrun=True, reason="proposals",
                              naming=naming)
        if warm_start is not None and not result.ok:
            # Warm solve failed verification: cold fallback (correctness
            # never rests on the seed).
            SENSORS.counter(
                "CruiseControl.warm-fallbacks", labels={"op": "proposals"},
                help="Warm solves that failed verification and fell back "
                     "to a cold solve").inc(1)
            run = self._optimize(model, goals, options)
            result = self._finish(model, run, dryrun=True,
                                  reason="proposals", naming=naming)
        # Only verified-good runs are cacheable: a cached entry is always
        # served with ok=True.  ignore_proposal_cache recomputes AND
        # repopulates (reference semantics) — only the read is skipped.
        if default_stack and result.ok:
            with self._cache_lock:
                self._cached = (gen, time.monotonic(), model, run,
                                result.proposals)
        return result

    def invalidate_proposal_cache(self) -> None:
        with self._cache_lock:
            self._cached = None

    # ------------------------------------------------------------------
    # Admin operations (also the self-healing context SPI)
    # ------------------------------------------------------------------
    @_traced_op
    def rebalance(self, goals: Optional[Sequence[str]] = None, dryrun: bool = False,
                  destination_broker_ids: Optional[Sequence[int]] = None,
                  excluded_topics: Optional[Sequence[int]] = None,
                  reason: str = "rebalance",
                  fast_mode: bool = False,
                  rebalance_disk: bool = False,
                  self_healing: bool = False,
                  excluded_topics_pattern: Optional[str] = None,
                  replica_movement_strategies: Optional[Sequence[str]] = None,
                  replication_throttle: Optional[int] = None,
                  warm: Optional[bool] = None) -> OperationResult:
        model, naming = self._model_naming()
        if goals and not self_healing:
            # Self-healing fixes run detection goals, which an operator may
            # configure beyond the request-facing goals= set — internal
            # stacks are not gated (see _validate_goals).
            self._validate_goals(goals)
        strategy = self._request_strategy(replica_movement_strategies)
        options = self._base_options(model, naming, excluded_topics_pattern)
        if destination_broker_ids:
            mask = np.zeros(model.num_brokers, bool)
            mask[self._to_dense(naming, destination_broker_ids)] = True
            options = options.replace(requested_dest_only=self._dev(mask))
        if excluded_topics:
            tmask = _host(options.topic_excluded).copy()
            tmask[list(excluded_topics)] = True
            options = options.replace(topic_excluded=self._dev(tmask))
        warm_start = None
        if self_healing:
            options = self._self_heal_excludes(options, naming)
            # Heal pipeline: detector fired → delta probe → warm solve
            # seeded from the standing converged placement.
            warm_start = self._heal_warm_start(model, options, "rebalance")
        if rebalance_disk and goals is None:
            # rebalance_disk=true runs the intra-broker (JBOD) stack
            # (intra.broker.goals) instead of the inter-broker default.
            goals = self.intra_broker_goals
        # Standing-proposal consult applies only to the default stack with
        # no per-request model/constraint tweaks — anything else must solve
        # against its own options.
        default_stack = (not goals and not destination_broker_ids
                         and not excluded_topics and not rebalance_disk
                         and not self_healing and not excluded_topics_pattern
                         and not fast_mode)
        if default_stack:
            mode, payload = self._consult_standing(model, warm, False,
                                                   "rebalance")
            if mode == "hit":
                _cgen, _ctime, pre_model, crun, cprops = payload
                result = self._standing_result(crun, cprops, reason)
                result.dryrun = dryrun
                if not dryrun and cprops:
                    scorer = opt.PlacementScorer.for_run(
                        pre_model, crun, self.constraint,
                        *self._balancedness_weights)
                    execution = self.executor.execute_proposals(
                        cprops, naming["partitions"],
                        concurrency_adjust_metrics=self.load_monitor.broker_health_metrics,
                        strategy=strategy,
                        replication_throttle=replication_throttle,
                        balancedness_scorer=scorer)
                    result.execution = execution
                    result.ok = execution.ok
                    self._absorb_execution(crun, execution)
                return result
            if mode == "warm":
                warm_start = payload
        run = self._optimize(model, goals, options, fast_mode=fast_mode,
                             warm_start=warm_start)
        result = self._finish(model, run, dryrun, reason, naming,
                              strategy=strategy,
                              replication_throttle=replication_throttle)
        if warm_start is not None and not result.ok \
                and result.execution is None:
            # Warm solve failed verification (not an execution failure):
            # cold fallback.
            SENSORS.counter(
                "CruiseControl.warm-fallbacks", labels={"op": "rebalance"},
                help="Warm solves that failed verification and fell back "
                     "to a cold solve").inc(1)
            run = self._optimize(model, goals, options, fast_mode=fast_mode)
            result = self._finish(model, run, dryrun, reason, naming,
                                  strategy=strategy,
                                  replication_throttle=replication_throttle)
        if default_stack and not dryrun and result.ok:
            self._absorb_execution(run, result.execution)
        return result

    @_traced_op
    def add_brokers(self, broker_ids: Sequence[int], dryrun: bool = False,
                    reason: str = "add_brokers",
                    excluded_topics_pattern: Optional[str] = None,
                    replica_movement_strategies: Optional[Sequence[str]] = None,
                    replication_throttle: Optional[int] = None) -> OperationResult:
        """Move load onto NEW brokers (AddBrokersRunnable)."""
        model, naming = self._model_naming()
        for b in self._to_dense(naming, broker_ids):
            model = model.set_broker_state(b, BrokerState.NEW)
        self.executor.drop_recently_removed_brokers(list(broker_ids))
        strategy = self._request_strategy(replica_movement_strategies)
        options = self._base_options(model, naming, excluded_topics_pattern)
        run = self._optimize(model, self.goals, options)
        return self._finish(model, run, dryrun, reason, naming,
                            strategy=strategy,
                            replication_throttle=replication_throttle)

    @_traced_op
    def remove_brokers(self, broker_ids: Sequence[int], dryrun: bool = False,
                       reason: str = "remove_brokers",
                       self_healing: bool = False,
                       excluded_topics_pattern: Optional[str] = None,
                       replica_movement_strategies: Optional[Sequence[str]] = None,
                       replication_throttle: Optional[int] = None) -> bool:
        """Decommission: drain all replicas off the brokers
        (RemoveBrokersRunnable)."""
        model, naming = self._model_naming()
        for b in self._to_dense(naming, broker_ids):
            model = model.set_broker_state(b, BrokerState.DEAD)
        strategy = self._request_strategy(replica_movement_strategies)
        options = self._base_options(model, naming, excluded_topics_pattern)
        warm_start = None
        if self_healing:
            options = self._self_heal_excludes(options, naming)
            warm_start = self._heal_warm_start(model, options,
                                               "remove_brokers")
        run = self._optimize(model, self.goals, options,
                             warm_start=warm_start)
        result = self._finish(model, run, dryrun, reason, naming,
                              strategy=strategy,
                              replication_throttle=replication_throttle)
        if warm_start is not None and not result.ok \
                and result.execution is None:
            # Warm heal failed verification: cold fallback.
            SENSORS.counter(
                "CruiseControl.warm-fallbacks",
                labels={"op": "remove_brokers"},
                help="Warm solves that failed verification and fell back "
                     "to a cold solve").inc(1)
            run = self._optimize(model, self.goals, options)
            result = self._finish(model, run, dryrun, reason, naming,
                                  strategy=strategy,
                                  replication_throttle=replication_throttle)
        if result.ok and not dryrun:
            self.executor.add_recently_removed_brokers(list(broker_ids))
        return result.ok

    @_traced_op
    def demote_brokers(self, broker_ids: Sequence[int], dryrun: bool = False,
                       reason: str = "demote_brokers") -> bool:
        """Transfer ALL leadership off the brokers (DemoteBrokerRunnable →
        PreferredLeaderElectionGoal).  Reference parity: the runnable moves
        demoted brokers' replicas to the end of the replica list and elects
        new leaders; here every leader replica on a DEMOTED broker becomes a
        mandatory leadership-transfer source (preferred_leader kernel), any
        eligible non-demoted sibling the destination.  Reports ok only when
        zero leaders remain on the demoted brokers."""
        model, naming = self._model_naming()
        dense = self._to_dense(naming, broker_ids)
        for b in dense:
            model = model.set_broker_state(b, BrokerState.DEMOTED)
        options = OptimizationOptions.none(model)
        mask = np.zeros(model.num_brokers, bool)
        mask[dense] = True
        options = options.replace(broker_excluded_leadership=self._dev(mask))
        run = self._optimize(model, ["PreferredLeaderElectionGoal"], options)
        # Demotion must actually have happened: a no-op "ok" (leaders still
        # on demoted brokers inside the leader-balance band) was a round-1
        # advisory finding.  Leaders with no eligible non-demoted online
        # sibling (e.g. RF=1 partitions) are unmovable and don't count
        # against success — the reference succeeds after moving all movable
        # leadership (DemoteBrokerRunnable skips URPs likewise).
        leaders_left = self._movable_leaders_on(run.model, dense)
        result = self._finish(model, run, dryrun, reason, naming)
        ok = result.ok and leaders_left == 0
        if ok and not dryrun:
            self.executor.add_recently_demoted_brokers(list(broker_ids))
        return ok

    @staticmethod
    def _movable_leaders_on(model: TensorClusterModel, dense: Sequence[int]) -> int:
        """Count leader replicas on the given (dense-index) brokers that have
        at least one valid, online sibling on an alive non-demoted broker."""
        rb = _host(model.replica_broker)
        lead = _host(model.replica_is_leader)
        valid = _host(model.replica_valid)
        part = _host(model.replica_partition)
        pr = _host(model.partition_replicas)
        state = _host(model.broker_state)
        offline = _host(model.replica_offline_now())
        count = 0
        for r in np.nonzero(lead & valid & np.isin(rb, list(dense)))[0]:
            for s in pr[part[r]]:
                if s < 0 or s == r or not valid[s] or offline[s]:
                    continue
                if state[rb[s]] not in (BrokerState.DEAD, BrokerState.DEMOTED):
                    count += 1
                    break
        return count

    @_traced_op
    def fix_offline_replicas(self, dryrun: bool = False,
                             reason: str = "fix_offline_replicas",
                             self_healing: bool = False) -> bool:
        """Heal offline replicas via the hard-goal stack
        (FixOfflineReplicasRunnable)."""
        model, naming = self._model_naming()
        options = self._base_options(model, naming)
        warm_start = None
        if self_healing:
            options = self._self_heal_excludes(options, naming)
            warm_start = self._heal_warm_start(model, options,
                                               "fix_offline_replicas")
        run = self._optimize(model, self.hard_goals, options,
                             warm_start=warm_start)
        result = self._finish(model, run, dryrun, reason, naming)
        if warm_start is not None and not result.ok \
                and result.execution is None:
            SENSORS.counter(
                "CruiseControl.warm-fallbacks",
                labels={"op": "fix_offline_replicas"},
                help="Warm solves that failed verification and fell back "
                     "to a cold solve").inc(1)
            run = self._optimize(model, self.hard_goals, options)
            result = self._finish(model, run, dryrun, reason, naming)
        return result.ok

    @_traced_op
    def update_topic_replication_factor(self, topics_rf: Dict[str, int],
                                        dryrun: bool = False,
                                        reason: str = "topic_rf_update") -> bool:
        """Set topics to the desired RF (UpdateTopicConfigurationRunnable):
        grow rack-aware onto least-loaded brokers, shrink by dropping
        non-leader replicas from most-loaded brokers."""
        cluster = self.load_monitor._metadata.cluster()
        model = self._model()
        load = _host(model.broker_load()).sum(axis=1)
        naming = self.load_monitor.naming()
        broker_rack = {b.broker_id: b.rack for b in cluster.brokers}
        alive = set(cluster.alive_broker_ids())
        requests = []
        for p in cluster.partitions:
            want = topics_rf.get(p.topic)
            if want is None or len(p.replicas) == want:
                continue
            replicas = list(p.replicas)
            if len(replicas) < want:
                used_racks = {broker_rack[b] for b in replicas}
                pool = [b for b in alive if b not in replicas]
                while len(replicas) < want and pool:
                    # Re-rank each pick so freshly used racks are deprioritized
                    # (rack-aware growth, not just a one-shot sort).
                    pool.sort(key=lambda b: (broker_rack[b] in used_racks,
                                             load[naming["brokers"].index(b)]))
                    b = pool.pop(0)
                    replicas.append(b)
                    used_racks.add(broker_rack[b])
            else:
                followers = [b for b in replicas if b != p.leader]
                followers.sort(key=lambda b: -load[naming["brokers"].index(b)])
                for b in followers[: len(replicas) - want]:
                    replicas.remove(b)
            requests.append(ReassignmentRequest(tp=p.tp, new_replicas=tuple(replicas)))
        if not requests:
            return False
        if dryrun:
            return True
        self.admin.alter_partition_reassignments(requests)
        deadline = time.monotonic() + 600.0
        while self.admin.ongoing_reassignments():
            if time.monotonic() > deadline:
                return False  # stalled reassignment; leave it to the operator
            time.sleep(0.01)
        self.load_monitor._metadata.refresh(self.load_monitor._metadata.cluster())
        return True

    # ------------------------------------------------------------------
    # State / control
    # ------------------------------------------------------------------
    def state(self, detector_manager=None) -> Dict[str, object]:
        """GET /state payload (monitor + executor + analyzer + detector)."""
        lm = self.load_monitor
        out: Dict[str, object] = {
            "MonitorState": {
                "state": lm.state().value,
                "validWindows": lm.partition_aggregator.valid_windows(),
                "monitoredPartitionsPercentage": lm.monitored_partitions_percentage(),
                "pauseReason": lm.pause_reason,
            },
            "ExecutorState": self.executor.state_summary(),
            "AnalyzerState": {
                "goals": self.goals,
                "proposalsCached": self._cached is not None,
                # Whether the NEXT optimization records per-step flight
                # telemetry (CRUISE_FLIGHT_RECORDER env, possibly seeded
                # from analyzer.flight.recorder config) — operators check
                # here before expecting /flight data.
                "flightRecorder": opt._flight_recorder(),
                # Warm-start / standing-proposal policy and the generation
                # the standing entry was computed at (None = no standing).
                "warmStart": {
                    "enabled": self._warm_start_enabled,
                    "deltaThreshold": self._warm_delta_threshold,
                    "standingGeneration": (list(self._cached[0])
                                           if self._cached else None),
                },
            },
        }
        if detector_manager is not None:
            out["AnomalyDetectorState"] = detector_manager.state_dict()
        # Windowed SLA rollups from the telemetry time-series store (1 h
        # default window) — the long-horizon view next to the point-in-time
        # substates; see docs/OBSERVABILITY.md "Telemetry time-series & SLA".
        out["Sla"] = TELEMETRY.sla()
        sensors = SENSORS.snapshot()
        # Per-operation trace rollup (count/totalMs/maxMs by root span name)
        # rides inside the Sensors block so /state answers "where does a
        # rebalance spend its time" without a separate /trace query.
        sensors["traces"] = TRACE.rollup()
        out["Sensors"] = sensors
        return out

    def kafka_cluster_state(self) -> Dict[str, object]:
        """GET /kafka_cluster_state payload."""
        cluster = self.load_monitor._metadata.cluster()
        return {
            "brokers": [dataclasses.asdict(b) for b in cluster.brokers],
            "partitions": [
                {"topic": p.topic, "partition": p.partition, "leader": p.leader,
                 "replicas": list(p.replicas),
                 "offlineReplicas": list(p.offline_replicas)}
                for p in cluster.partitions],
        }

    def partition_load(self, max_entries: int = 100) -> List[Dict[str, object]]:
        """GET /partition_load: partitions sorted by utilization."""
        agg = self.load_monitor.partition_aggregator.aggregate()
        from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
        rows = []
        for row, tp in enumerate(agg.entities):
            if not agg.entity_valid[row]:
                continue
            m = {info.name: float(agg.collapsed[row, info.metric_id])
                 for info in KAFKA_METRIC_DEF.all_metric_infos()[:4]}
            rows.append({"topic": tp[0], "partition": tp[1], **m})
        rows.sort(key=lambda r: -r.get("DISK_USAGE", 0.0))
        return rows[:max_entries]

    def broker_load(self) -> Dict[str, object]:
        """GET /load: per-broker utilization + stats."""
        model = self._model()
        load = _host(model.broker_load())
        cap = _host(model.broker_capacity)
        valid = _host(model.broker_valid)
        brokers = []
        naming = self.load_monitor.naming()
        for i, b in enumerate(naming["brokers"]):
            if not valid[i]:
                continue
            brokers.append({
                "broker": b,
                "cpu": float(load[i, 0]), "networkInbound": float(load[i, 1]),
                "networkOutbound": float(load[i, 2]), "disk": float(load[i, 3]),
                "diskPct": float(load[i, 3] / max(cap[i, 3], 1e-9) * 100),
                "replicas": int(_host(model.broker_replica_counts())[i]),
                "leaders": int(_host(model.broker_leader_counts())[i]),
            })
        return {"brokers": brokers, "stats": compute_stats(model).to_dict()}

    def stop_proposal_execution(self, force: bool = False) -> None:
        self.executor.stop_execution(force=force)

    def pause_sampling(self, reason: str = "") -> None:
        self.load_monitor.pause_sampling(reason)

    def resume_sampling(self) -> None:
        self.load_monitor.resume_sampling()
