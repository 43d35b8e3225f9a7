"""The port's configuration layer against the JAX package's, on the CPU.

Every key of the full ``ConfigDef`` has the JAX package's type, default,
importance, group and validator; class-valued defaults name the port's own
classes (the JAX package's names with the package prefix mapped) and load
without the JAX package; both layers refuse the same bad values; and
``BalancingConstraint.from_config`` gives the JAX package's constraint on
default and overridden configs.
"""

import dataclasses
import importlib

import pytest

from cruise_control_tpu.analyzer.balancing_constraint import \
    BalancingConstraint as JaxConstraint
from cruise_control_tpu.config import ConfigException as JaxConfigException
from cruise_control_tpu.config import constants as JC
from cruise_control_tpu.config import cruise_control_config as jax_config
from cruise_control_tpu.config import load_properties as jax_load_properties
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.config import (ConfigDef, ConfigException, Type,
                                             cruise_control_config, load_properties)
from cruise_control_tpu_torch.config import configdef
from cruise_control_tpu_torch.config import constants as C

JAX_PREFIX, PORT_PREFIX = "cruise_control_tpu.", "cruise_control_tpu_torch."
# Class-valued defaults whose class comes with a later slice of the port
# (none since the service slice ported ``api.server``: every default loads).
LATER_SLICES: dict = {}
GROUPS = ("analyzer", "monitor", "executor", "anomaly_detector", "webserver")


def _keys(defn):
    return {k.name: k for k in defn.keys.values()}


def _validator_fields(v):
    return None if v is None else (type(v).__name__,
                                   {f: getattr(v, f) for f in ("min", "max", "valid")
                                    if hasattr(v, f)})


def _port_name(value):
    if isinstance(value, str) and value.startswith(JAX_PREFIX):
        return PORT_PREFIX + value[len(JAX_PREFIX):]
    if isinstance(value, list):
        return [_port_name(v) for v in value]
    return value


@pytest.mark.parametrize("group", GROUPS)
def test_every_key_of_each_group_matches_jax(group):
    port = getattr(C, f"{group}_config_def")()
    jax = getattr(JC, f"{group}_config_def")()
    pk, jk = _keys(port), _keys(jax)
    assert list(pk) == list(jk)
    for name, want in jk.items():
        got = pk[name]
        assert got.type.value == want.type.value, name
        assert got.importance.value == want.importance.value, name
        assert got.group == want.group, name
        assert got.has_default == want.has_default, name
        assert got.default == _port_name(want.default), name
        assert _validator_fields(got.validator) == _validator_fields(want.validator), name
    # The constant names that hold the keys are the JAX package's too.
    consts = {n: getattr(JC, n) for n in dir(JC) if n.endswith("_CONFIG")}
    assert {n: getattr(C, n) for n in consts} == consts


def _class_defaults():
    out = []
    for key in C.cruise_control_config_def().keys.values():
        values = key.default if isinstance(key.default, list) else [key.default]
        out += [(key.name, v) for v in values
                if isinstance(v, str) and v.startswith("cruise_control_tpu")]
    return out


def test_class_defaults_name_port_classes_that_load():
    defaults = _class_defaults()
    assert len(defaults) >= 8
    for name, value in defaults:
        assert value.startswith(PORT_PREFIX), (name, value)
        module = value.rpartition(".")[0]
        if module in LATER_SLICES:
            with pytest.raises(ConfigException):
                configdef.parse_type(name, value, Type.CLASS)
            continue
        cls = configdef.parse_type(name, value, Type.CLASS)
        assert cls.__module__.startswith(PORT_PREFIX), (name, cls)
        assert cls is getattr(importlib.import_module(module), value.rpartition(".")[2])


BAD = [
    {C.CPU_CAPACITY_THRESHOLD_CONFIG: 1.5},
    {C.CPU_BALANCE_THRESHOLD_CONFIG: 0.5},
    {C.MAX_REPLICAS_PER_BROKER_CONFIG: "not-a-number"},
    {C.SELF_HEALING_ENABLED_CONFIG: "maybe"},
    {C.NUM_CACHED_RECENT_ANOMALY_STATES_CONFIG: 0},
    {C.SLOW_BROKER_METRIC_HISTORY_PERCENTILE_THRESHOLD_CONFIG: 101.0},
    {C.METRIC_ANOMALY_UPPER_MARGIN_CONFIG: -0.5},
    {C.ANOMALY_DETECTION_INTERVAL_MS_CONFIG: True},
]


@pytest.mark.parametrize("props", BAD, ids=lambda p: next(iter(p)))
def test_same_bad_values_raise(props):
    with pytest.raises(JaxConfigException):
        jax_config(props)
    with pytest.raises(ConfigException):
        cruise_control_config(props)


def test_config_def_errors_and_values_match():
    with pytest.raises(ConfigException):
        ConfigDef().define("k", Type.INT, 1).define("k", Type.INT, 2)
    with pytest.raises(ConfigException):
        configdef.Config(ConfigDef().define("required.key", Type.STRING), {})
    props = {C.CPU_BALANCE_THRESHOLD_CONFIG: "1.5", C.DEFAULT_GOALS_CONFIG:
             "RackAwareGoal, ReplicaCapacityGoal", "some.unknown.key": "x"}
    got, want = cruise_control_config(props), jax_config(props)
    assert got.merged_values() == {k: _port_name(v) for k, v in want.merged_values().items()}


def test_load_properties_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("PORT_TEST_DIR", "/var/x")
    path = tmp_path / "c.properties"
    path.write_text("# comment\n! bang\ncpu.balance.threshold=1.2\n"
                    "log.dir : ${env:PORT_TEST_DIR}/y\nempty=\n\nbare\n")
    assert load_properties(str(path)) == jax_load_properties(str(path))


CONSTRAINT_PROPS = [
    {},
    {C.CPU_BALANCE_THRESHOLD_CONFIG: "1.3", C.DISK_CAPACITY_THRESHOLD_CONFIG: "0.75",
     C.NETWORK_INBOUND_LOW_UTILIZATION_THRESHOLD_CONFIG: "0.1",
     C.MAX_REPLICAS_PER_BROKER_CONFIG: "7000", C.MOVES_PER_STEP_CONFIG: "64",
     C.REPLICA_COUNT_BALANCE_THRESHOLD_CONFIG: "1.05",
     C.OVERPROVISIONED_MIN_BROKERS_CONFIG: "5"},
]


@pytest.mark.parametrize("props", CONSTRAINT_PROPS, ids=("default", "overridden"))
def test_balancing_constraint_from_config_matches(props):
    got = BalancingConstraint.from_config(cruise_control_config(props))
    want = JaxConstraint.from_config(jax_config(props))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not props:
        assert got == BalancingConstraint.default()
