"""The port's sharded 15-goal stack against the JAX package's own sharded
run (tests/test_parallel.py:84-111): the replica-sharded model over the
port's 2 gloo ranks and over the JAX package's 8-device virtual CPU mesh,
on the default (unfused) path — per goal (steps, actions, satisfied after,
capped) and the proposal set identical.  Slow: it compiles the JAX
package's 15-goal sharded program family."""

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer import proposals as jprops
from cruise_control_tpu.parallel import mesh as jmesh
from cruise_control_tpu_torch.analyzer import proposals as tprops
from cruise_control_tpu_torch.convert import model_to_numpy
from cruise_control_tpu_torch.parallel import mesh as pmesh
from tests.test_parallel import FULL_STACK
from tests.test_torch_mesh import RANK_TIMEOUT_S, _jax_fixture
from tests.torch_mesh_ranks import ND, NS, PLACEMENT, sharded_stack
from tests.torch_port_helpers import clear_cruise_env, to_torch

pytestmark = pytest.mark.slow


def test_full_stack_sharded_matches_jax_sharded(monkeypatch):
    clear_cruise_env(monkeypatch)
    jm = _jax_fixture()
    ranks = pmesh.Ranks(sharded_stack, 2, "cpu", "gloo",
                        (model_to_numpy(to_torch(jm)), FULL_STACK))
    try:
        mesh = jmesh.make_search_mesh()
        want = jopt.optimize(jmesh.shard_model_replica_axis(jm, mesh), FULL_STACK,
                             num_sources=NS, num_dests=ND, raise_on_hard_failure=False,
                             mesh=mesh)
    finally:
        results = ranks.join(RANK_TIMEOUT_S)
    want_rows = [(g.name, g.steps, g.actions_applied, g.satisfied_after, g.capped)
                 for g in want.goal_results]
    want_props = {(p.partition, tuple(r.broker for r in p.new_replicas), p.new_leader.broker)
                  for p in jprops.diff(jm, want.model)}
    tm = to_torch(jm)
    for rows, pl in results:
        assert rows == want_rows
        final = tm.replace(**{f: torch.from_numpy(pl[f]) for f in PLACEMENT})
        got_props = {(p.partition, tuple(r.broker for r in p.new_replicas),
                      p.new_leader.broker) for p in tprops.diff(tm, final)}
        assert got_props == want_props
        np.testing.assert_array_equal(pl["replica_broker"],
                                      np.asarray(want.model.replica_broker))
