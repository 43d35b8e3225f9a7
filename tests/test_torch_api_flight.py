"""The port's service front against the JAX package's, on the CPU (see
tests/test_torch_api.py): ``/add_broker`` onto a broker added to the
metadata, the ``GET /flight`` round trip of a ``/rebalance`` task with the
flight recorder on and off (tests/test_flight_recorder.py:145-170: the
per-goal timelines equal the JAX package's row for row, and sum to each
goal's actions), and an HTTP round trip through ``serve`` with
``urllib``."""

import dataclasses
import json
import urllib.error
import urllib.request

import pytest

from cruise_control_tpu.monitor.metadata import BrokerInfo as JaxBrokerInfo
from tests.test_api import W
from tests.torch_port_helpers import (WAIT, both, clear_cruise_env, jax_native,  # noqa: F401
                                      placement, port_build_stack, same_call, same_operation)
from cruise_control_tpu_torch.api import server as tserver
from cruise_control_tpu_torch.monitor.metadata import BrokerInfo
from cruise_control_tpu_torch.monitor.sampling import SyntheticWorkloadSampler

# The reference's monitors ingest through its native library.
pytestmark = pytest.mark.usefixtures("jax_native")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    clear_cruise_env(monkeypatch)


def test_add_broker_moves_load_onto_new_broker():
    stacks = both()
    for (_, cc, mc), info in zip(stacks, (JaxBrokerInfo, BrokerInfo)):
        cluster = mc.cluster()
        mc.refresh(dataclasses.replace(cluster, brokers=cluster.brokers + (
            info(99, rack="r9", host="h9"),)))
        sampler = SyntheticWorkloadSampler()
        for wdx in range(4):
            cc.load_monitor.fetch_once(sampler, wdx * W, wdx * W + 1)
    jbody, tbody = same_call(stacks, "POST", "add_broker",
                             {"brokerid": "99", "dryrun": "false", "max_wait_s": "120"})
    same_operation(jbody, tbody)
    tmc = stacks[1][2]
    assert placement(tmc) == placement(stacks[0][2])
    assert any(99 in p.replicas for p in tmc.cluster().partitions)


@pytest.mark.parametrize("recorder", [False, True], ids=["recorder-off", "recorder-on"])
def test_flight_endpoint_round_trip(monkeypatch, recorder):
    if recorder:
        monkeypatch.setenv("CRUISE_FLIGHT_RECORDER", "1")
    stacks = both()
    tids = []
    for api, _, _ in stacks:
        s, _, headers = api.handle("POST", "rebalance", {"dryrun": "true", **WAIT})
        assert s == 200
        tids.append(headers["User-Task-ID"])
    (japi, _, _), (tapi, _, _) = stacks
    assert tapi.handle("GET", "flight", {})[0] == 400
    assert tapi.handle("GET", "flight", {"task_id": "nope"})[0] == 404
    js, jbody, _ = japi.handle("GET", "flight", {"task_id": tids[0]})
    ts, tbody, _ = tapi.handle("GET", "flight", {"task_id": tids[1]})
    assert ts == js
    if not recorder:
        assert ts == 404 and "CRUISE_FLIGHT_RECORDER" in tbody["error"]
        return
    assert ts == 200 and tbody["userTaskId"] == tids[1]
    assert [g["goal"] for g in tbody["goals"]] == [g["goal"] for g in jbody["goals"]]
    assert tbody["goals"]
    for tg, jg in zip(tbody["goals"], jbody["goals"]):
        assert (tg["steps"], tg["actions"]) == (jg["steps"], jg["actions"])
        assert tg["flight"]["steps"] == jg["flight"]["steps"], tg["goal"]
        assert len(tg["flight"]["steps"]) == tg["steps"]
        assert sum(st["actions"] for st in tg["flight"]["steps"]) == tg["actions"]
    assert tapi.handle("GET", "state", {})[1]["AnalyzerState"]["flightRecorder"] is True


def test_http_server_round_trip():
    api, _, _ = port_build_stack()
    server = tserver.serve(api, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}/kafkacruisecontrol"

    def call(method, endpoint, query=""):
        req = urllib.request.Request(f"{base}/{endpoint}{query}", method=method)
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    try:
        status, body = call("GET", "state")
        assert status == 200 and "MonitorState" in body
        status, body = call("POST", "rebalance", "?dryrun=true&max_wait_s=300")
        assert status == 200 and body["numProposals"] > 0
        status, body = call("GET", "nope")
        assert status == 404
    finally:
        server.shutdown()
