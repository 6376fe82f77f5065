"""Build and load the port's CUDA kernels, and count their launches.

The sources in ``src/repro_torch/csrc/*.cu`` have a plain C interface. On
first use :func:`load` compiles each of them with ``nvcc`` for ``sm_90a``
(all at once, one process each), links them into one shared library under
``build/repro_torch/`` at the root of the checkout, and loads it with
``ctypes``. The library's name carries a hash of the sources and flags, so
an edited source is rebuilt and a built one is reused. Nothing here runs
when the module is imported: the CPU tests import it on hosts with no
``nvcc``.

A failed build raises; there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("tiered_cost.cu", "fsm_scan.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# -fmad=false: no multiply is contracted into an add, on top of the explicit
# __dadd_rn/__dmul_rn intrinsics, so float64 results keep the plain
# versions' rounding.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: Launch counts, one per kernel. Each wrapper adds one where it launches
#: its kernel and nowhere else; a caller zeroes them to see which kernels a
#: run went through.
LAUNCHES: Dict[str, int] = {"tiered_cost_batched": 0, "fsm_scan": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Seconds the last :func:`load` spent compiling (0.0 when it reused a build).
build_seconds = 0.0
#: The compiler's output of the last build (``-Xptxas -v`` register counts).
build_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objs.append(str(obj))
        logs, failed = [], []
        for cmd, p in procs:
            out, _ = p.communicate()
            logs.append(out)
            if p.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / target.name
        link = [nvcc, "-shared", *objs, "-o", str(so)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(so, target)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("tiered_cost_batched_f64", "tiered_cost_batched_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, p, p]
        fn.restype = i
    lib.fsm_scan_f64.argtypes = [p] * 9 + [i, i, i] + [p] * 4
    lib.fsm_scan_f64.restype = i


def load() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if need be."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
            if target.exists():
                build_seconds = 0.0
            else:
                _build(target)
            lib = ctypes.CDLL(str(target))
            _declare(lib)
            _lib = lib
        return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed with cudaError {status}")
