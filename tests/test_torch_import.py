"""The PyTorch port stands alone: it imports neither JAX, flax nor the JAX
package, its entry points refuse to run without CUDA unless asked for the
CPU, and its kernel wrappers never fall back to the plain path on a device
that is not the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cruise_control_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cruise_control_tpu")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import importlib, sys\n"
            f"for m in {list(_port_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


def test_no_string_constant_names_a_jax_package_module():
    """Class-valued config defaults and any other string the port hands to
    ``importlib`` name the port's own modules: no string constant of the
    port, docstrings aside, names a ``cruise_control_tpu.`` module path."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = _docstrings(tree)
        found += [f"{path.relative_to(REPO)}:{node.lineno}: {node.value[:60]!r}"
                  for node in ast.walk(tree)
                  if isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and id(node) not in docs and "cruise_control_tpu." in node.value]
    assert not found, found


def _need_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test checks the refusal without it")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _need_no_cuda()
    from cruise_control_tpu_torch.analyzer import optimizer
    from cruise_control_tpu_torch.convert import model_from_numpy, model_to_numpy
    from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
    spec = ClusterSpec(num_brokers=3, num_racks=3, num_topics=2, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_cluster(spec)
    model = generate_cluster(spec, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        optimizer.optimize(model, ["ReplicaDistributionGoal"])
    with pytest.raises(RuntimeError, match="CUDA"):
        model_from_numpy(*model_to_numpy(model))


def test_wrappers_raise_on_a_non_cpu_device_without_cuda():
    """A tensor that is not on the CPU never takes the plain path."""
    from cruise_control_tpu_torch.analyzer.optimizer import _best_per_segment
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        _best_per_segment(t, torch.zeros(4, dtype=torch.int32, device="meta"), 2,
                          torch.zeros(4, dtype=torch.bool, device="meta"))


def test_wrappers_check_dtype_and_shape():
    from cruise_control_tpu_torch.analyzer.goals.kernels import prefix_cut_admit
    from cruise_control_tpu_torch.ops.segment import broker_aggregates
    r = 5
    with pytest.raises(TypeError):
        broker_aggregates(torch.zeros(r, dtype=torch.int64), torch.ones(r, dtype=torch.bool),
                          torch.ones(r, dtype=torch.bool), torch.zeros(r, 4),
                          torch.zeros(r, 4), 2)
    with pytest.raises(ValueError):
        prefix_cut_admit(torch.zeros(3), torch.zeros(3, dtype=torch.int32),
                         torch.zeros(3, 2), torch.ones(3, dtype=torch.bool),
                         torch.zeros(2, 3), torch.zeros(2, 2), torch.zeros(2, 2), 2)


def test_chip_smoke_refuses_without_cuda_and_alone(tmp_path):
    _need_no_cuda()
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_the_ports_registries_are_its_own():
    """The port's sensor, trace and telemetry registries are separate
    objects from the JAX package's when both are imported in one process:
    what one records, the other does not see."""
    from cruise_control_tpu.common.sensors import SENSORS as JAX_SENSORS
    from cruise_control_tpu.common.timeseries import TELEMETRY as JAX_TELEMETRY
    from cruise_control_tpu.common.tracing import TRACE as JAX_TRACE
    from cruise_control_tpu_torch.common.sensors import SENSORS
    from cruise_control_tpu_torch.common.timeseries import TELEMETRY
    from cruise_control_tpu_torch.common.tracing import TRACE
    assert SENSORS is not JAX_SENSORS
    assert TRACE is not JAX_TRACE
    assert TELEMETRY is not JAX_TELEMETRY
    assert type(SENSORS) is not type(JAX_SENSORS)
    SENSORS.counter("PortOnly.registry-probe").inc(1)
    assert "PortOnly.registry-probe" in SENSORS.snapshot()
    assert "PortOnly.registry-probe" not in JAX_SENSORS.snapshot()
    TRACE.record("port.registry-probe", 0.0)
    assert any(s["name"] == "port.registry-probe" for s in TRACE.recent(5))
    assert not any(s["name"] == "port.registry-probe" for s in JAX_TRACE.recent(50))


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO))
                                        for p in (PORT / "api").rglob("*.py")))
def test_service_front_imports_no_app_module(path):
    """The port's service front stands without an ``app`` module: the realm
    file is read by its own ``api.security.load_credentials``."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] + [f"{node.module or ''}.{a.name}" for a in node.names]
        for n in names:
            assert n.split(".")[-1] != "app", f"{path}:{node.lineno} imports {n}"


def test_new_wrappers_raise_on_a_non_cpu_device_and_check_shapes():
    """K8's flight row and the band accepts never take the plain path off
    the CPU, and refuse inputs of the wrong type or shape."""
    from cruise_control_tpu_torch.analyzer.goals.kernels import band_accepts
    from cruise_control_tpu_torch.analyzer.optimizer import flight_row
    from cruise_control_tpu_torch.analyzer.state import CTR_WIDTH, FLIGHT_WIDTH

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    i32, b8 = torch.int32, torch.bool
    with pytest.raises(ValueError, match="unsupported device"):
        flight_row(meta(CTR_WIDTH, dtype=i32), meta(4, dtype=b8), (0, 4), (0,), meta(4),
                   meta(4, dtype=b8), None, meta(dtype=i32), meta(dtype=i32), 2,
                   meta(3, FLIGHT_WIDTH, dtype=i32))
    with pytest.raises(ValueError, match="unsupported device"):
        band_accepts(meta(2, 3), meta(2, 3), meta(2, 3), meta(2, 4), meta(2, 4),
                     meta(2, dtype=b8), meta(3, dtype=b8), meta(4, dtype=i32),
                     meta(4, dtype=i32))
    with pytest.raises(ValueError):
        flight_row(torch.zeros(CTR_WIDTH, dtype=i32), torch.zeros(4, dtype=b8), (0, 3), (0,),
                   torch.zeros(4), torch.zeros(4, dtype=b8), None,
                   torch.zeros((), dtype=i32), torch.zeros((), dtype=i32), 2,
                   torch.zeros(3, FLIGHT_WIDTH, dtype=i32))
    with pytest.raises(TypeError):
        band_accepts(torch.zeros(2, 3, dtype=torch.float64), torch.zeros(2, 3),
                     torch.zeros(2, 3), torch.zeros(2, 4), torch.zeros(2, 4),
                     torch.zeros(2, dtype=b8), torch.zeros(3, dtype=b8),
                     torch.zeros(4, dtype=i32), torch.zeros(4, dtype=i32))
