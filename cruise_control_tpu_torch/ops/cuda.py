"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source exposes a plain C entry point and is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
under ``build/cuda/`` at the root of the checkout, named by a hash of the
source and the flags, and loaded with ``ctypes``.  ``build_all`` starts one
``nvcc`` per source at once.  Nothing here runs at import time: the CPU
tests import every module of the package on a machine without ``nvcc``.

The C entries take device pointers as ``void*``, sizes as ``int64_t`` and
PyTorch's current stream last, and return ``cudaGetLastError()``;
``check_rc`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
SOURCES = ("broker_aggregates", "best_per_segment", "prefix_cut",
           "apply_actions")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each source's last build.
BUILD_LOG: Dict[str, str] = {}

# Argument layout of every C entry: "p" = device pointer, "i" = int64.
# The stream pointer is appended to each.
_SIGNATURES = {
    "cc_broker_aggregates": "pppppipppppi",
    "cc_best_per_segment": "pppiipp",
    "cc_prefix_cut": "ppppppppiii",
    "cc_apply_actions": "pppppppppiiippp",
}
_ENTRY_OF = {
    "broker_aggregates": "cc_broker_aggregates",
    "best_per_segment": "cc_best_per_segment",
    "prefix_cut": "cc_prefix_cut",
    "apply_actions": "cc_apply_actions",
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _so_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    so = _so_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    so = _so_path(name)
    os.replace(so.with_suffix(f".{os.getpid()}.tmp"), so)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every listed source that is not built yet, one ``nvcc`` per
    source, all started together; returns the wall seconds it took."""
    t0 = time.monotonic()
    with _LOCK:
        procs = {n: _start_build(n) for n in names}
        for n, p in procs.items():
            _finish_build(n, p)
    return time.monotonic() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_so_path(name)))
            entry = _ENTRY_OF[name]
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int64
                           for c in _SIGNATURES[entry]] + [ctypes.c_void_p]
            _LIBS[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call the C entry of kernel ``name`` with ``args`` (tensors become
    device pointers, ints stay ints) on PyTorch's current stream, and raise
    on a non-zero ``cudaGetLastError``."""
    fn = getattr(library(name), _ENTRY_OF[name])
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
            for a in args]
    rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def check(t: torch.Tensor, what: str, dtype: torch.dtype,
          shape: Sequence[int], device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, shape and device a kernel takes and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def on_cpu(t: torch.Tensor) -> bool:
    """True for the plain path; False for CUDA (the kernel path).  Any other
    device raises: there is no third route."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


# ---------------------------------------------------------------------------
# First-call capture: a run can record each kernel's inputs at their first
# launch (the shapes the main path gives it) so a harness can later hold the
# kernel against its plain version on exactly those tensors.
# ---------------------------------------------------------------------------

CAPTURE: Optional[Dict[str, tuple]] = None


def record(name: str, args: tuple) -> None:
    if CAPTURE is not None and name not in CAPTURE:
        CAPTURE[name] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args)
