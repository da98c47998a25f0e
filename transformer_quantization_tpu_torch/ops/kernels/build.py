"""Build and load the engine's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
with ``nvcc`` into a shared library, which :func:`load` opens with
``ctypes``. All sources compile in parallel, once per content hash (of
the source, the shared ``csrc/*.cuh`` headers and the flags), into
``_build/`` beside this file (listed in ``.gitignore``). Nothing happens
at import time: the first kernel launch builds.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o <name>-<hash>.so csrc/<name>.cu

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions round them; there is no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("int8_matmul", "int8_attention", "add_ln_payload",
           "float_edge_matmul", "flex_add_ln", "int8_matmul_norm",
           "int8_mb_layer", "fused_int8_linear", "float_int8_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each library's entry point (all return cudaError_t)
_SIGNATURES = {
    "int8_matmul": ("tq_int8_matmul",
                    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                     _P)),
    "int8_matmul_w4": ("tq_int8_matmul_w4",
                       (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                        _P)),
    "int8_attention": ("tq_int8_attention",
                       (_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                        _F, _F, _I, _P)),
    "int8_attention_blocks": ("tq_int8_attention_blocks", (_I, _I)),
    "int8_attention_flex": ("tq_int8_attention_flex",
                            (_P, _I, _P, _P, _P) + (_I,) * 7
                            + (_F, _F, _I, _P)),
    "int8_attention_flex_blocks": ("tq_int8_attention_flex_blocks",
                                   (_I, _I, _I)),
    "float_int8_matmul": ("tq_float_int8_matmul",
                          (_P,) * 4 + (_I,) * 5 + (_F, _F, _F, _P)),
    "int8_matmul_norm": ("tq_int8_matmul_norm",
                         (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P)),
    "int8_matmul_norm_w4": ("tq_int8_matmul_norm_w4",
                            (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P)),
    "int8_mb_layer": ("tq_int8_mb_layer",
                      (_P, _P, _P, _P, _I, _P) + (_I,) * 13
                      + (_F, _F, _F, _P)),
    "int8_mb_layer_w4": ("tq_int8_mb_layer_w4",
                         (_P, _P, _P, _P, _I, _P) + (_I,) * 14
                         + (_F, _F, _F, _P)),
    "add_ln_payload": ("tq_add_ln_payload",
                       (_P, _P, _P, _P, _P, _I, _I, _F, _I, _P)),
    "float_edge_levels": ("tq_float_edge_levels",
                          (_P,) * 5 + (_I,) * 4 + (_F, _P)),
    "float_edge_gemm": ("tq_float_edge_gemm",
                        (_P,) * 7 + (_I,) * 7 + (_F, _F, _F, _P)),
    "flex_add_ln": ("tq_flex_add_ln",
                    (_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _I, _F, _F,
                     _F, _F, _P)),
    "fused_add_ln_bf16": ("tq_fused_add_ln_bf16",
                          (_P,) * 6 + (_I, _I, _F, _I, _F, _F, _F, _F, _P)),
    "fused_int8_linear": ("tq_fused_int8_linear",
                          (_P, _I) + (_P,) * 7 + (_I,) * 8 + (_F, _P)),
    "fused_int8_linear_w4": ("tq_fused_int8_linear_w4",
                             (_P, _I) + (_P,) * 7 + (_I,) * 8 + (_F, _P)),
    "fused_quantize": ("tq_fused_quantize",
                       (_P, _P, _P, _I, _I, _I, _P)),
    "fused_rcp_check": ("tq_fused_rcp_check", (_P, _P)),
    "ln_div_check": ("tq_ln_div_check", (_P, _I, _P, _P)),
}
# entry points that live in another source's library
_LIBRARY = {"int8_matmul_w4": "int8_matmul",
            "int8_matmul_norm_w4": "int8_matmul_norm",
            "int8_mb_layer_w4": "int8_mb_layer",
            "fused_int8_linear_w4": "fused_int8_linear",
            "int8_attention_blocks": "int8_attention",
            "int8_attention_flex": "int8_attention",
            "int8_attention_flex_blocks": "int8_attention",
            "float_int8_matmul": "float_int8_gemm",
            "fused_quantize": "fused_int8_linear",
            "fused_rcp_check": "fused_int8_linear",
            "ln_div_check": "add_ln_payload",
            "fused_add_ln_bf16": "flex_add_ln",
            "float_edge_levels": "float_edge_matmul",
            "float_edge_gemm": "float_edge_matmul"}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every missing library (one ``nvcc`` per source, all started
    together); returns the wall seconds spent. Raises with the compiler's
    output if a build fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".tmp{os.getpid()}")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        BUILD_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (exit {p.returncode}) ---\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes._CFuncPtr:
    """Entry point ``name`` (a source's own, or one of ``_LIBRARY``'s),
    building its library if needed."""
    src = _LIBRARY.get(name, name)
    lib = _LIBS.get(src)
    if lib is None:
        build((src,))
        lib = ctypes.CDLL(str(_target(src)))
        _LIBS[src] = lib
    sym, argtypes = _SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
