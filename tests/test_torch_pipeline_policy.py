"""The pipeline policy of the port's ``optimize(fused=True)`` against the
JAX package's on the cases of tests/test_pipeline.py:142-169, on the skewed
16-broker model: below the dense floor the default does not pipeline; with
the floor lowered to 8 a manual ``fuse_group_size=1`` opts out, the default
pipelines, ``CRUISE_PIPELINE=0`` turns it off, and ``pipeline=True`` with
``fuse_group_size=2`` or with ``fused=False`` raises ``ValueError`` in both
packages.  Each run equals the JAX package's in ``pipelined`` and
placement."""

import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu_torch.analyzer import optimizer as topt
from tests.torch_port_helpers import PLACEMENT, clear_cruise_env, skewed_models

STACK2 = ["RackAwareGoal", "ReplicaDistributionGoal"]


@pytest.mark.parametrize("floor,env,kwargs,pipelined", [
    (64, None, {}, False),
    (8, None, {"fuse_group_size": 1}, False),
    (8, None, {}, True),
    (8, "0", {}, False),
    (8, "off", {"pipeline": True}, False),
], ids=["below-floor", "manual-group", "default", "env-off", "env-off-forced"])
def test_pipeline_policy_matches_jax(floor, env, kwargs, pipelined, monkeypatch):
    clear_cruise_env(monkeypatch)
    if env is not None:
        monkeypatch.setenv("CRUISE_PIPELINE", env)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", floor)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", floor)
    jm, tm = skewed_models(7)
    kw = dict(fused=True, raise_on_hard_failure=False, **kwargs)
    jrun = jopt.optimize(jm, STACK2, **kw)
    trun = topt.optimize(tm, STACK2, device="cpu", **kw)
    assert jrun.pipelined == trun.pipelined == pipelined
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)


@pytest.mark.parametrize("kwargs", [{"fused": True, "fuse_group_size": 2},
                                    {"fused": False}], ids=["group-2", "unfused"])
def test_forced_pipeline_clashes_raise_like_jax(kwargs, monkeypatch):
    clear_cruise_env(monkeypatch)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", 8)
    jm, tm = skewed_models(7)
    with pytest.raises(ValueError):
        jopt.optimize(jm, STACK2, pipeline=True, raise_on_hard_failure=False, **kwargs)
    with pytest.raises(ValueError):
        topt.optimize(tm, STACK2, pipeline=True, raise_on_hard_failure=False,
                      device="cpu", **kwargs)
