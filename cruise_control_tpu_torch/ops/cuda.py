"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source exposes a plain C entry point and is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
under ``build/cuda/`` at the root of the checkout, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, and loaded with
``ctypes``.  ``build_all`` starts one ``nvcc`` per source at once.  Nothing
here runs at import time: the CPU tests import every module of the package
on a machine without ``nvcc``.

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
           "apply_actions", "goal_masks", "transport_match", "cluster_stats",
           "stack_sweep", "frontier_active", "chunk_gate", "ordered", "placement_score",
           "detector_scores", "flight_row", "band_accepts", "shard_combine")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each source's last build.
BUILD_LOG: Dict[str, str] = {}

# Every C entry: kernel name -> (source, entry symbol, argument layout),
# "p" = device pointer, "i" = int64, "f" = float.  The stream pointer is
# appended to each.
_ENTRIES = {
    "broker_aggregates": ("broker_aggregates", "cc_broker_aggregates", "pppppipppppi"),
    "segment_sum": ("broker_aggregates", "cc_segment_sum", "pppiiip"),
    "best_per_segment": ("best_per_segment", "cc_best_per_segment", "pppiipp"),
    "prefix_cut": ("prefix_cut", "cc_prefix_cut", "ppppppppiii"),
    "ordered_sum": ("ordered", "cc_ordered_sum", "ppii"),
    "ordered_cumsum": ("ordered", "cc_ordered_cumsum", "ppii"),
    "apply_actions": ("apply_actions", "cc_apply_actions", "pppppppppiiippp"),
    "goal_masks": ("goal_masks", "cc_goal_masks", "i" * 7 + "f" + "p" * 46),
    "transport_rank": ("transport_match", "cc_transport_rank", "ppip"),
    "transport_lookup": ("transport_match", "cc_transport_lookup", "ppppiippp"),
    "cluster_stats": ("cluster_stats", "cc_cluster_stats", "ppiip"),
    "structural_accepts": ("goal_masks", "cc_structural_accepts", "i" * 11 + "p" * 26),
    "stack_sweep": ("stack_sweep", "cc_stack_sweep", "i" * 6 + "p" * 25 + "ii" + "p" * 4),
    "frontier_active": ("frontier_active", "cc_frontier_active", "if" + "p" * 8),
    "frontier_active_batch": ("frontier_active", "cc_frontier_active_batch",
                              "ii" + "p" * 10),
    "chunk_gate": ("chunk_gate", "cc_chunk_gate", "p" * 9 + "iiii"),
    "cross_gate": ("chunk_gate", "cc_cross_gate", "p" * 5 + "i"),
    "chunk_touched": ("chunk_gate", "cc_chunk_touched", "ii" + "p" * 8),
    "blend_aggregates": ("placement_score", "cc_blend_aggregates", "i" * 5 + "p" * 17),
    "blend_disk_load": ("placement_score", "cc_blend_disk_load", "i" * 6 + "p" * 12),
    "stack_sweep_batch": ("placement_score", "cc_stack_sweep_batch",
                          "i" * 8 + "p" * 31 + "ii" + "p" * 4),
    "detector_peer": ("detector_scores", "cc_detector_peer", "ppiifp"),
    "detector_rows": ("detector_scores", "cc_detector_rows", "pppp" + "ii" + "f" * 7 + "ppp"),
    "flight_row": ("flight_row", "cc_flight_row", "ppippipppippipi"),
    "band_accepts": ("band_accepts", "cc_band_accepts", "iii" + "p" * 10),
    "shard_combine": ("shard_combine", "cc_shard_combine", "ppiiipp"),
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int64, "f": ctypes.c_float}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _so_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    headers of ``csrc`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
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


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, building it on first use."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    build_all((source,))
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_so_path(source)))
            for src, entry, sig in _ENTRIES.values():
                if src == source:
                    fn = getattr(lib, entry)
                    fn.restype = ctypes.c_int
                    fn.argtypes = [_CTYPE[c] for c in sig] + [ctypes.c_void_p]
            _LIBS[source] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call the C entry of kernel ``name`` with ``args`` (tensors become
    device pointers, ints and floats stay numbers; ``None`` is a null
    pointer) on PyTorch's current stream, and raise on a non-zero
    ``cudaGetLastError``."""
    source, entry, sig = _ENTRIES[name]
    fn = getattr(library(source), entry)
    if len(args) != len(sig):
        raise TypeError(f"{name}: {len(args)} arguments for layout {sig!r}")
    conv = []
    for a, c in zip(args, sig):
        if c == "p":
            conv.append(None if a is None else a.data_ptr())
        elif c == "f":
            conv.append(float(a))
        else:
            conv.append(int(a))
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
    """Keep clones of ``args`` as kernel ``name``'s first inputs while a
    capture dict is set.  Never during a CUDA-graph capture: cloning there
    would record copies into the graph instead of taking them."""
    if (CAPTURE is not None and name not in CAPTURE
            and not (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())):
        CAPTURE[name] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args)


# ---------------------------------------------------------------------------
# Launch counters: every kernel wrapper carries a plain integer ``launches``
# that it raises by one where it launches its kernel.  A CUDA-graph capture
# runs the wrappers once without launching anything, so the graph cache
# (``analyzer/graphs.py``) takes each capture's increments back off and
# credits them once per replay instead.
# ---------------------------------------------------------------------------

COUNTED: Dict[str, object] = {}


def counted(name: str):
    """Register the decorated wrapper under ``name`` with ``launches = 0``."""
    def wrap(fn):
        fn.launches = 0
        COUNTED[name] = fn
        return fn
    return wrap


class ModeCounter:
    """The launches of one mode of a kernel (one goal kind of K5, K5b, K9 or
    K10), counted beside its wrapper's own count."""

    def __init__(self):
        self.launches = 0


def mode_counters(kernel: str, modes: Sequence[str]) -> Dict[str, ModeCounter]:
    """Register a counter ``<kernel>[<mode>]`` for each of ``modes``; the
    wrapper adds one to a mode's counter where a launch computes that
    mode."""
    out = {}
    for m in modes:
        out[m] = COUNTED[f"{kernel}[{m}]"] = ModeCounter()
    return out


def launch_counts() -> Dict[str, int]:
    return {n: fn.launches for n, fn in COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def add_launches(delta: Dict[str, int], times: int = 1) -> None:
    for n, d in delta.items():
        COUNTED[n].launches += d * times
