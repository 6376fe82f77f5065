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
SOURCES = ("tiered_cost.cu", "tiered_cost_scan.cu", "fsm_scan.cu", "stream_chunk.cu",
           "stream_chunk_routed.cu", "leg_segment_sum.cu", "rmsnorm.cu", "flash_attention.cu",
           "int8_quant.cu", "oracle_dp.cu")
#: The float64 sources, held bit for bit against their plain versions.
EXACT_SOURCES = ("tiered_cost.cu", "tiered_cost_scan.cu", "fsm_scan.cu", "stream_chunk.cu",
                 "stream_chunk_routed.cu", "leg_segment_sum.cu", "oracle_dp.cu")
#: Headers the sources include; part of the build hash.
HEADERS = ("tier_fold.cuh", "fsm_step.cuh", "occupancy.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# For EXACT_SOURCES only: no multiply is contracted into an add, on top of
# the explicit __dadd_rn/__dmul_rn intrinsics, so float64 results keep the
# plain versions' rounding. The float32/bfloat16 LM kernels are held to
# tolerances and keep the fused multiply-adds.
EXACT_FLAGS = ("-fmad=false",)

#: Launch counts, one per kernel. Each wrapper adds one where it launches
#: its kernel and nowhere else; a caller zeroes them to see which kernels a
#: run went through. ``flash_attention`` counts every flash launch and
#: ``flash_attention_sm90`` those of its Hopper entry.
LAUNCHES: Dict[str, int] = {
    "tiered_cost_batched": 0, "fsm_scan": 0, "tiered_cost_scan": 0, "fsm_chunk": 0,
    "stream_chunk": 0, "stream_chunk_routed": 0, "flash_attention": 0,
    "flash_attention_sm90": 0, "rmsnorm": 0, "int8_quantize": 0, "int8_dequantize": 0,
    "tiered_cost": 0, "leg_segment_sum": 0, "oracle_dp": 0,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Seconds the last :func:`load` spent compiling (0.0 when it reused a build).
build_seconds = 0.0
#: The compiler's output of the loaded library's build (``-Xptxas -v``
#: register counts), kept beside it so a reused build has it too.
build_log = ""


#: Tiers of the static table the ``tiered_cost`` kernel takes by value.
MAX_TIERS = 8


class TierTable(ctypes.Structure):
    """``struct TierTable`` of ``csrc/tiered_cost.cu``, passed by value."""

    _fields_ = [("K", ctypes.c_int), ("bounds", ctypes.c_float * MAX_TIERS),
                ("rates", ctypes.c_float * MAX_TIERS)]


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + EXACT_FLAGS + EXACT_SOURCES).encode())
    for name in SOURCES + HEADERS:
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
            extra = EXACT_FLAGS if name in EXACT_SOURCES else ()
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
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
        build_log = "".join(logs)
        log = Path(tmp) / "build.log"
        log.write_text(build_log)
        os.replace(log, target.with_suffix(".log"))   # before the library: a reuse finds both
        os.replace(so, target)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("tiered_cost_batched_f64", "tiered_cost_batched_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, p, p]
        fn.restype = i
    lib.fsm_scan_f64.argtypes = [p] * 9 + [i, i, i] + [p] * 4
    lib.fsm_scan_f64.restype = i
    # cum0, demand, bounds, rates, reset, N, K, Kt, slots, plan, costs, cum_out, stream
    for name in ("tiered_cost_scan_f64", "tiered_cost_scan_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 5 + [i] * 4 + [p] * 4
        fn.restype = i
    lib.tiered_cost_calendar_f64.argtypes = [p] * 4 + [i] * 5 + [p] * 3
    lib.tiered_cost_calendar_f64.restype = i
    lib.fsm_chunk_f64.argtypes = [p] * 11 + [i] * 4 + [p] * 11
    lib.fsm_chunk_f64.restype = i
    lib.stream_chunk_f64.argtypes = [p] * 20 + [i] * 7 + [p] * 3   # ..., Kt, form, out, ...
    lib.stream_chunk_f64.restype = i
    lib.stream_chunk_routed_f64.argtypes = [p] * 27 + [i] * 8 + [p] * 3
    lib.stream_chunk_routed_f64.restype = i
    # src0, src1, w0, w1, n_planes, leg_pair, order, start, T, M, out0, out1, stream
    lib.leg_segment_sum_f64.argtypes = [p] * 4 + [i] + [p] * 3 + [i, i] + [p] * 3
    lib.leg_segment_sum_f64.restype = i
    # vpn, cci, D, T_cci, order, regs, N, T, n_large, S_max, warps,
    # allow_head_start, total, start_on, stream
    lib.oracle_dp_f64.argtypes = [p] * 6 + [i] * 6 + [p] * 3
    lib.oracle_dp_f64.restype = i
    for name in ("rmsnorm_f32", "rmsnorm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, ctypes.c_longlong, i, ctypes.c_float, p, p]
        fn.restype = i
    for name in ("flash_attention_f32", "flash_attention_bf16", "flash_attention_sm90_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 6 + [ctypes.c_float, p]
        fn.restype = i
    ll = ctypes.c_longlong
    for name in ("int8_quantize_f32", "int8_quantize_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, ll, i, i, p, p, p]        # x, rows, d, guard, q, scale, stream
        fn.restype = i
    for name in ("int8_dequantize_f32", "int8_dequantize_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, ll, i, p, p]           # q, scale, rows, d, out, stream
        fn.restype = i
    lib.tiered_cost_static_f32.argtypes = [p, p, ctypes.c_longlong, TierTable, p, p]
    lib.tiered_cost_static_f32.restype = i


def load() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if need be."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
            if target.exists():
                build_seconds = 0.0
                log = target.with_suffix(".log")
                build_log = log.read_text() if log.exists() else ""
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
