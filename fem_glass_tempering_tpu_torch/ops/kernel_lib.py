"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, `libfgt_torch_kernels.so`, loaded with
ctypes. The build happens on first use, never at import, into
`build/torch_kernels/` at the root of the checkout: one `nvcc -c` per
source, all started together, then one link. A stamp holding the hash of
the sources and flags lets a later process reuse the library.
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

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("material_tspace.cu", "stencil_matvec.cu", "dg_cell_residual.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libfgt_torch_kernels.so"
# -fmad=false: no multiply-add contraction, so each kernel rounds exactly
# as its plain PyTorch twin does (see the notes in the sources)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_D = ctypes.c_double
_SIGNATURES = {
    "fgt_material_tspace": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _I64,
                            _D, _D, _D, _D, ctypes.POINTER(_D),
                            ctypes.POINTER(_D), _P],
    "fgt_stencil_matvec": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _I64,
                           _I64, _I64, _P],
    "fgt_dg_cell_residual": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _I64,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, _D, _D, _D, _D, _P],
}


class KernelLibrary:
    """The loaded library, with what its build printed and took."""

    def __init__(self, path: Path, build_log: str, build_seconds: float):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self.cdll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def _build(digest: str) -> tuple[str, float]:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, p in procs:
            out, _ = p.communicate()
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if p.returncode != 0:
                failed.append(cmd[-3])
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [nvcc, "-shared", "-o", str(tmp_lib),
               *(str(obj) for _, obj, _ in procs)]
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        log.append(f"$ {' '.join(cmd)}\n{p.stdout}")
        if p.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + "\n".join(log))
        os.replace(tmp_lib, BUILD_DIR / LIB_NAME)
    (BUILD_DIR / "stamp").write_text(digest)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    return "\n".join(log), time.perf_counter() - t0


def library() -> KernelLibrary:
    """The kernel library, built from the sources on first use."""
    global _loaded
    with _lock:
        if _loaded is None:
            digest = _digest()
            stamp = BUILD_DIR / "stamp"
            lib = BUILD_DIR / LIB_NAME
            if (lib.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                log = (BUILD_DIR / "build.log").read_text() if (
                    BUILD_DIR / "build.log").exists() else ""
                _loaded = KernelLibrary(lib, log, 0.0)
            else:
                log, seconds = _build(digest)
                _loaded = KernelLibrary(lib, log, seconds)
        return _loaded


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or float64, not {dtype}")
