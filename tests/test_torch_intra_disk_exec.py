"""Executing an intra-broker disk solve in the PyTorch port against the JAX
package, on the CPU: the 12-broker cluster with 4 disks a broker and the
first disk of broker 1 dead, solved by the JAX package with
``INTRA_BROKER_GOAL_ORDER``; both packages execute the proposals (the
executor's intra-broker phase, ``alter_replica_logdirs``) on the simulated
fleet with the balancedness scorer riding along, which scores the two disk
goals over each checkpoint's blended disks (K10's plain twins, the blends'
disk loads included).  The ``ExecutionResult``, the fleet's final
placement and the whole verbose progress payload, the ledger's scored
checkpoints included, are equal field for field."""

import dataclasses

import pytest

from cruise_control_tpu.executor import simulate as jsim
from cruise_control_tpu_torch.analyzer import proposals as tprops
from cruise_control_tpu_torch.executor import simulate as tsim
from tests.torch_port_helpers import (INTRA_GOALS, SPEC_12, jbod_model, jopt, jprops,
                                      to_torch)


@pytest.fixture(scope="module")
def solved():
    """(JAX before, JAX run, port before, port after, proposals)."""
    jm = jbod_model(SPEC_12, dead=(1,))
    jrun = jopt.optimize(jm, INTRA_GOALS, raise_on_hard_failure=False, fused=True)
    tm, ta = to_torch(jm), to_torch(jrun.model)
    proposals = tprops.diff(tm, ta)
    assert proposals == jprops.diff(jm, jrun.model)
    assert proposals and all(not p.replicas_to_add for p in proposals)
    return jm, jrun, tm, ta, proposals


def _signature(admin):
    return sorted((p.tp, p.leader, tuple(sorted(p.replicas)))
                  for p in admin.metadata_client.cluster().partitions)


def test_intra_broker_execution_matches_jax(solved):
    jm, jrun, tm, ta, proposals = solved
    jres, jex, jadmin = jsim.run_simulated_execution(
        jm, proposals, model_after=jrun.model, goal_names=INTRA_GOALS, tick_ms=1000,
        rate_bytes_per_sec=1e6)
    tres, tex, tadmin = tsim.run_simulated_execution(
        tm, proposals, model_after=ta, goal_names=INTRA_GOALS, tick_ms=1000,
        rate_bytes_per_sec=1e6)
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    assert tres.ok and tres.dead == 0 and tres.aborted == 0
    assert _signature(tadmin) == _signature(jadmin)
    tprog, jprog = tex.progress(verbose=True), jex.progress(verbose=True)
    assert tprog.keys() == jprog.keys()
    for key in jprog:
        assert tprog[key] == jprog[key], key
    scored = [c["balancedness"] for c in tprog["checkpoints"] if c["balancedness"] is not None]
    assert len(scored) >= 2 and scored[0] != scored[-1]
    assert scored[0] == pytest.approx(jrun.balancedness_before, abs=1e-6)
    assert scored[-1] == pytest.approx(jrun.balancedness_after, abs=1e-6)
    assert {p["phase"] for p in tprog["phases"]} >= {"intra_broker"}
