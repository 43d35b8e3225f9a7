"""The port's service front (``cruise_control_tpu_torch/api``) against the
JAX package's, on the CPU.

``torch_port_helpers.port_build_stack`` is the port twin of
tests/test_api.py ``build_stack`` (5 brokers, the same seeded metadata and
sampler windows, the same goals), with the load monitor and the facade on
the CPU.  Each case drives both
stacks through ``CruiseControlApi.handle`` with the same requests and holds
the port to the JAX package's statuses, proposals and cluster mutations:
the endpoint inventory, ``/state``, cached ``/proposals``, ``/rebalance``
dry run then execute, ``/remove_broker``, non-contiguous broker ids,
demotion, a topic replication-factor change, user tasks, the purgatory's
two-step flow, basic-security roles and ``/admin`` and ``/train``.
``/add_broker``, ``GET /flight`` and ``serve`` are in
tests/test_torch_api_flight.py.
"""

import base64

import pytest

from cruise_control_tpu.api import server as jserver
from tests.test_api import build_stack as jax_build_stack
from tests.torch_port_helpers import (WAIT, both, clear_cruise_env, jax_native,  # noqa: F401
                                      placement, port_build_stack, same_call, same_operation)
from cruise_control_tpu_torch.api import server as tserver
from cruise_control_tpu_torch.api.facade import CruiseControl

# The reference's monitors ingest through its native library.
pytestmark = pytest.mark.usefixtures("jax_native")

@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    clear_cruise_env(monkeypatch)


def test_endpoint_inventory():
    assert tserver.GET_ENDPOINTS == jserver.GET_ENDPOINTS
    assert tserver.POST_ENDPOINTS == jserver.POST_ENDPOINTS
    assert len(tserver.GET_ENDPOINTS - {"metrics", "trace", "flight", "executor_state",
                                        "timeseries", "stream"}) \
        + len(tserver.POST_ENDPOINTS) == 20


def test_facade_needs_cuda_unless_asked_for_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CruiseControl(None, None, None)
    assert CruiseControl(None, None, None, device="cpu").device.type == "cpu"


def test_state_endpoint():
    stacks = both()
    jbody, tbody = same_call(stacks, "GET", "state", {})
    assert tbody["MonitorState"]["validWindows"] == jbody["MonitorState"]["validWindows"] == 3
    assert tbody["ExecutorState"] == jbody["ExecutorState"]
    assert "AnomalyDetectorState" in tbody
    assert tbody["AnalyzerState"]["flightRecorder"] is False
    jbody, tbody = same_call(stacks, "GET", "state", {"substates": "monitor"})
    assert "MonitorState" in tbody and "ExecutorState" not in tbody


def test_unknown_endpoint_and_bad_params():
    stacks = both()
    same_call(stacks, "GET", "nope", {})
    jbody, tbody = same_call(stacks, "POST", "rebalance", {"dryrun": "maybe"})
    assert tbody == jbody
    same_call(stacks, "POST", "add_broker", {})


def test_proposals_cached_then_invalidated():
    stacks = both()
    j1, t1 = same_call(stacks, "GET", "proposals", WAIT)
    assert t1["reason"] != "cached"
    same_operation(j1, t1)
    j2, t2 = same_call(stacks, "GET", "proposals", {"_": "2", **WAIT})
    assert t2["reason"] == j2["reason"] == "cached"
    for (_, cc, _) in stacks:
        cc.invalidate_proposal_cache()
    j3, t3 = same_call(stacks, "GET", "proposals", {"_": "3", **WAIT})
    assert t3["reason"] != "cached"
    same_operation(j3, t3)


def test_rebalance_dryrun_then_execute():
    stacks = both()
    jdry, tdry = same_call(stacks, "POST", "rebalance", WAIT)
    assert tdry["dryrun"] and tdry["numProposals"] > 0
    same_operation(jdry, tdry)
    jwet, twet = same_call(stacks, "POST", "rebalance", {"dryrun": "false", **WAIT})
    same_operation(jwet, twet)
    assert twet["execution"]["completed"] == jwet["execution"]["completed"] > 0
    assert placement(stacks[1][2]) == placement(stacks[0][2])


def test_remove_broker_via_api():
    stacks = both()
    jbody, tbody = same_call(stacks, "POST", "remove_broker",
                             {"brokerid": "4", "dryrun": "false", **WAIT})
    same_operation(jbody, tbody)
    (_, _, jmc), (_, tcc, tmc) = stacks
    assert placement(tmc) == placement(jmc)
    assert not any(4 in p.replicas for p in tmc.cluster().partitions)
    assert 4 in tcc.executor.recently_removed_brokers()


def test_noncontiguous_broker_ids_rebalance_and_remove():
    ids = [10, 25, 31, 47, 52]
    stacks = both(broker_ids=ids)
    jdry, tdry = same_call(stacks, "POST", "rebalance", WAIT)
    same_operation(jdry, tdry)
    assert {b for p in tdry["proposals"] for b in p["newReplicas"]} <= set(ids)
    same_call(stacks, "POST", "rebalance", {"dryrun": "false", **WAIT})
    jbody, tbody = same_call(stacks, "POST", "remove_broker",
                             {"brokerid": "52", "dryrun": "false", **WAIT})
    same_operation(jbody, tbody)
    assert placement(stacks[1][2]) == placement(stacks[0][2])
    assert 52 in stacks[1][1].executor.recently_removed_brokers()


def test_demote_moves_all_leadership_off_broker():
    ids = [7, 11, 13, 19, 23]
    stacks = both(broker_ids=ids)
    jbody, tbody = same_call(stacks, "POST", "demote_broker",
                             {"brokerid": "11", "dryrun": "false", **WAIT})
    assert tbody["ok"], tbody
    same_operation(jbody, tbody)
    tmc = stacks[1][2]
    assert placement(tmc) == placement(stacks[0][2])
    assert not any(p.leader == 11 for p in tmc.cluster().partitions)
    assert 11 in stacks[1][1].executor.recently_demoted_brokers()


def test_topic_configuration_rf_change():
    stacks = both()
    jbody, tbody = same_call(stacks, "POST", "topic_configuration",
                             {"topic": "t0", "replication_factor": "3", "dryrun": "false",
                              **WAIT})
    assert tbody["ok"] == jbody["ok"] is True
    tmc = stacks[1][2]
    assert placement(tmc) == placement(stacks[0][2])
    assert all(len(set(p.replicas)) == 3 for p in tmc.cluster().partitions if p.topic == "t0")


def test_user_tasks_listed():
    stacks = both()
    same_call(stacks, "GET", "load", {})
    jbody, tbody = same_call(stacks, "GET", "user_tasks", {})
    assert [(t["RequestURL"], t["Status"]) for t in tbody["userTasks"]] == \
        [(t["RequestURL"], t["Status"]) for t in jbody["userTasks"]]
    assert any(t["RequestURL"] == "load" for t in tbody["userTasks"])


def test_purgatory_two_step_flow():
    stacks = both(two_step=True)
    jp, tp = same_call(stacks, "POST", "rebalance", {"dryrun": "false"})
    assert tp["status"] == jp["status"] == "PENDING_REVIEW"
    rid = str(tp["reviewId"])
    assert rid == str(jp["reviewId"])
    same_call(stacks, "POST", "rebalance", {"review_id": rid})  # not approved: 400
    same_call(stacks, "POST", "review", {"approve": rid})
    jb, tb = same_call(stacks, "GET", "review_board", {})
    assert tb["requests"][0]["Status"] == jb["requests"][0]["Status"] == "APPROVED"
    jx, tx = same_call(stacks, "POST", "rebalance", {"review_id": rid, **WAIT})
    same_operation(jx, tx)
    jr, tr = same_call(stacks, "POST", "rebalance", {"review_id": rid, "dryrun": "true"})
    assert tr == tx and jr == jx
    same_call(stacks, "POST", "rebalance", {"review_id": "999"})
    assert placement(stacks[1][2]) == placement(stacks[0][2])


def test_basic_security_roles():
    def hdr(user, pw):
        return {"Authorization": "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()}
    creds = {"viewer": ("v", "VIEWER"), "admin": ("a", "ADMIN")}
    japi = jax_build_stack(security=jserver.BasicSecurityProvider(creds))[0]
    tapi = port_build_stack(security=tserver.BasicSecurityProvider(creds))[0]
    for method, ep, h in (("GET", "state", {}), ("GET", "state", hdr("viewer", "wrong")),
                          ("GET", "state", hdr("viewer", "v")),
                          ("POST", "rebalance", hdr("viewer", "v")),
                          ("GET", "user_tasks", hdr("viewer", "v")),
                          ("POST", "pause_sampling", hdr("admin", "a"))):
        assert tapi.handle(method, ep, {}, h)[0] == japi.handle(method, ep, {}, h)[0], ep
    assert tapi.handle("GET", "state", {}, {})[0] == 401


def test_credentials_file_loads_as_the_app_does(tmp_path):
    from cruise_control_tpu.app import _load_credentials
    from cruise_control_tpu_torch.api.security import load_credentials
    path = tmp_path / "realm"
    path.write_text("# users\nalice: secret, ADMIN\n\nbob:pw\n")
    assert load_credentials(str(path)) == _load_credentials(str(path)) == {
        "alice": ("secret", "ADMIN"), "bob": ("pw", "VIEWER")}


def test_admin_endpoint():
    stacks = both()
    jbody, tbody = same_call(stacks, "POST", "admin",
                             {"enable_self_healing_for": "broker_failure",
                              "concurrent_partition_movements_per_broker": "5"})
    assert tbody["selfHealing"] == jbody["selfHealing"]
    assert tbody["selfHealing"]["BROKER_FAILURE"]["after"] is True
    assert stacks[1][1].executor._limits.inter_broker_per_broker == 5


def test_train_endpoint():
    stacks = both()
    jbody, tbody = same_call(stacks, "GET", "train", {})
    assert tbody["trained"] == jbody["trained"] is True
