"""The executor on the simulated fleet in the PyTorch port against the JAX
package's, on the CPU.

One JAX solve of two goals at 12 brokers (a module fixture) gives the
proposals; both packages execute them against their simulated admin on the
same virtual clock, with the balancedness scorer riding along.  The
``ExecutionResult``, the final placement and the whole verbose progress
payload — the ledger's checkpoints (scored balancedness included), phases,
task durations, events and adjuster decisions — are equal field for field.
No field is left out: under the simulated admin every time the executor
and its ledger record is the fleet's virtual time, never the host's wall
clock.
"""

import dataclasses

import pytest

from cruise_control_tpu.executor import simulate as jsim
from cruise_control_tpu_torch.analyzer import proposals as tprops
from cruise_control_tpu_torch.executor import simulate as tsim
from cruise_control_tpu_torch.executor.executor import SimulatedCrash
from tests.torch_port_helpers import (SPEC_12, JaxSpec, jax_generate, jopt, jprops,
                                      to_torch)

GOALS = ["ReplicaDistributionGoal", "LeaderReplicaDistributionGoal"]
# The rate of tests/test_execution_ledger.py: the execution outlasts the
# health feed's stress window, so the concurrency adjuster halves and
# doubles.
RATE = 10_000_000.0


@pytest.fixture(scope="module")
def solved():
    """(JAX before, JAX run, port before, port after, port proposals)."""
    jm = jax_generate(JaxSpec(**SPEC_12))
    jrun = jopt.optimize(jm, GOALS, raise_on_hard_failure=False)
    tm, ta = to_torch(jm), to_torch(jrun.model)
    proposals = tprops.diff(tm, ta)
    assert proposals == jprops.diff(jm, jrun.model)
    return jm, jrun, tm, ta, proposals


def _signature(admin):
    return sorted((p.tp, p.leader, tuple(sorted(p.replicas)))
                  for p in admin.metadata_client.cluster().partitions)


def test_simulated_execution_matches_jax(solved):
    jm, jrun, tm, ta, proposals = solved
    jres, jex, jadmin = jsim.run_simulated_execution(
        jm, proposals, model_after=jrun.model, goal_names=GOALS, tick_ms=1000,
        rate_bytes_per_sec=RATE)
    tres, tex, tadmin = tsim.run_simulated_execution(
        tm, proposals, model_after=ta, goal_names=GOALS, tick_ms=1000,
        rate_bytes_per_sec=RATE)
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    assert tres.ok and tres.dead == 0 and tres.aborted == 0
    assert _signature(tadmin) == _signature(jadmin)
    assert tadmin.now_ms() == jadmin.now_ms()
    tprog, jprog = tex.progress(verbose=True), jex.progress(verbose=True)
    assert tprog.keys() == jprog.keys()
    for key in jprog:
        assert tprog[key] == jprog[key], key
    # The ledger's own checks (tests/test_execution_ledger.py): totals
    # reconcile, off-target bytes never grow and end at 0, the curve runs
    # from the run's balancedness before to its balancedness after.
    assert tprog["taskCounts"]["completed"] == tres.completed
    off = [c["offTargetBytes"] for c in tprog["checkpoints"]]
    assert all(b <= a for a, b in zip(off, off[1:])) and off[-1] == 0
    scored = [c["balancedness"] for c in tprog["checkpoints"] if c["balancedness"] is not None]
    assert len(scored) >= 2
    assert scored[0] == pytest.approx(jrun.balancedness_before, abs=1e-6)
    assert scored[-1] == pytest.approx(jrun.balancedness_after, abs=1e-6)
    assert {p["phase"] for p in tprog["phases"]} >= {"inter_broker"}
    adj = tprog["adjusterDecisions"]
    assert adj["halve"] > 0 and adj["double"] > 0


def test_ledger_off_is_bit_identical(solved):
    _, _, tm, ta, proposals = solved
    on, ex_on, admin_on = tsim.run_simulated_execution(
        tm, proposals, model_after=ta, goal_names=GOALS, tick_ms=500)
    off, ex_off, admin_off = tsim.run_simulated_execution(
        tm, proposals, model_after=ta, goal_names=GOALS, tick_ms=500, ledger_enabled=False)
    assert dataclasses.asdict(on) == dataclasses.asdict(off)
    assert _signature(admin_on) == _signature(admin_off)
    assert ex_off.progress(verbose=True) == {"state": "no_task_in_progress",
                                             "ledgerEnabled": False}


def test_crash_and_resume_matches_the_uninterrupted_run(solved, tmp_path):
    """tests/test_interruptible.py's recipe in the port: kill the executor
    mid inter-broker phase, resume from the journal, and get the placement,
    ledger totals and curve of an uninterrupted run — which equals the JAX
    package's."""
    jm, _, tm, _, _ = solved
    proposals = tsim.sample_move_proposals(tm, moves=3, leadership=2)
    assert proposals == jsim.sample_move_proposals(jm, moves=3, leadership=2)
    kw = dict(tick_ms=500, rate_bytes_per_sec=RATE, adjuster_churn=False)
    ref, ex_ref, admin_ref = tsim.run_simulated_execution(
        tm, proposals, journal_path=str(tmp_path / "ref.journal"), **kw)
    jref, jex_ref, jadmin_ref = jsim.run_simulated_execution(
        jm, proposals, journal_path=str(tmp_path / "jax.journal"), **kw)
    assert ref.ok and dataclasses.asdict(ref) == dataclasses.asdict(jref)
    assert _signature(admin_ref) == _signature(jadmin_ref)
    ref_prog = ex_ref.progress(verbose=True)
    assert ref_prog == jex_ref.progress(verbose=True)
    inter = next(ph["polls"] for ph in ref_prog["phases"] if ph["phase"] == "inter_broker")
    assert inter > 4

    jp = str(tmp_path / "crash.journal")
    ex, admin, names, _ = tsim.build_simulated_execution(
        tm, proposals, tick_ms=500, rate_bytes_per_sec=RATE)
    with pytest.raises(SimulatedCrash):
        ex.execute_proposals(proposals, names, max_polls=200_000, poll_interval_s=0.0,
                             replication_throttle=int(RATE), journal_path=jp,
                             crash_after_polls=2)
    assert not ex.has_ongoing_execution
    result = ex.resume(jp, poll_interval_s=0.0)
    assert result.ok and result.completed == ref.completed
    assert _signature(admin) == _signature(admin_ref)
    prog = ex.progress(verbose=True)
    for key in ("taskCounts", "totalTasks", "totalBytes", "bytesMoved", "bytesInFlight",
                "checkpoints", "finishedMs"):
        assert prog[key] == ref_prog[key], key


def test_metadata_from_model_matches_jax(solved):
    jm, _, tm, _, _ = solved
    tmc, tnames = tsim.metadata_from_model(tm)
    jmc, jnames = jsim.metadata_from_model(jm)
    assert tnames == jnames
    tcl, jcl = tmc.cluster(), jmc.cluster()
    assert [dataclasses.astuple(b) for b in tcl.brokers] == \
        [dataclasses.astuple(b) for b in jcl.brokers]
    assert [dataclasses.astuple(p) for p in tcl.partitions] == \
        [dataclasses.astuple(p) for p in jcl.partitions]
