"""Build and load the hand-written CUDA kernels (csrc/*.cu) and the host
runtime (csrc/runtime.cpp).

The CUDA sources compile with `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, `libfgt_torch_kernels.so`, loaded with
ctypes. The build happens on first use, never at import, into
`build/torch_kernels/` at the root of the checkout: one `nvcc -c` per
source, all started together, then one link. A stamp holding the hash of
the sources and flags lets a later process reuse the library.

The host runtime (facet enumeration, the gmsh parser, BFS partitioning;
utils/native.py binds it) compiles with the host C++ compiler into
`build/torch_native/libfgt_torch_runtime.so`, on first use, with the same
stamp. Each build writes into a private temporary directory and moves the
finished library into place, so processes that build at once never load
a half-written file.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per source. -fmad=false: no multiply-add contraction, so the kernel
# rounds every operation as its plain PyTorch twin does (K2 is held to its
# twin bit for bit, K1 to the rounding of exp). The cell residual is built
# with contraction: with uniform tables it is bound by FP64 throughput, a fused
# multiply-add halves its instructions, and the default run keeps the CPU's
# Newton and CG counts to the iteration either way (see its source's note).
SOURCE_FLAGS = {"material_tspace.cu": ("-fmad=false",),
                "stencil_matvec.cu": ("-fmad=false",),
                "dg_cell_residual.cu": ()}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_D = ctypes.c_double
_SIGNATURES = {
    "fgt_material_tspace": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _I64,
                            _D, _D, _D, _D, ctypes.POINTER(_D),
                            ctypes.POINTER(_D), _P],
    "fgt_stencil_matvec": [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                           _P, _P, _I64, _I64, _I64, _I64, _P],
    "fgt_stencil_matvec_halo": [ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                _I64, _I64, _I64, _P],
    "fgt_dg_cell_residual": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _I64,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, _D, _D, _D, _D, _P],
    "fgt_dg_cell_residual_param": [ctypes.c_int, _P, _P, _P, _P, _P, _I64,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   _D, _D, _D, _D, _P],
    "fgt_dg_cell_param_table_bytes": [],
    "fgt_dg_cell_element": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I64, ctypes.c_int, ctypes.c_int, _D, _D, _D, _D,
                            _P],
}


HOST_SOURCES = ("runtime.cpp",)
HOST_BUILD_DIR = _PKG.parent / "build" / "torch_native"
HOST_LIB_NAME = "libfgt_torch_runtime.so"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


class KernelLibrary:
    """The loaded library, with what its build printed and took; the
    functions of `signatures` return int and take those ctypes."""

    def __init__(self, path: Path, build_log: str, build_seconds: float,
                 signatures: dict | None = None):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self.cdll = ctypes.CDLL(str(path))
        for name, argtypes in (signatures or {}).items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_lock = threading.Lock()
_loaded: KernelLibrary | None = None
_host_loaded: KernelLibrary | None = None


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
        h.update(" ".join((src, *SOURCE_FLAGS[src])).encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def _cached(build_dir: Path, lib_name: str, digest: str, build,
            signatures=None) -> KernelLibrary:
    """The library of `digest` from `build_dir`, built by `build(digest)`
    unless the stamp there says the library on disk is that build."""
    stamp = build_dir / "stamp"
    lib = build_dir / lib_name
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        log_path = build_dir / "build.log"
        log = log_path.read_text() if log_path.exists() else ""
        return KernelLibrary(lib, log, 0.0, signatures)
    log, seconds = build(digest)
    return KernelLibrary(lib, log, seconds, signatures)


def _build(digest: str) -> tuple[str, float]:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS[src], "-c",
                   str(CSRC / src), "-o", str(obj)]
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
            _loaded = _cached(BUILD_DIR, LIB_NAME, _digest(), _build,
                              _SIGNATURES)
        return _loaded


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found: the native runtime "
                       "cannot be built (set CXX or put g++ on PATH)")


def _host_digest() -> str:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in HOST_SOURCES:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def _build_host(digest: str) -> tuple[str, float]:
    cmd0 = [_cxx(), *HOST_FLAGS]
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HOST_BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / HOST_LIB_NAME
        cmd = [*cmd0, "-o", str(tmp_lib),
               *(str(CSRC / s) for s in HOST_SOURCES)]
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, timeout=300)
        log = f"$ {' '.join(cmd)}\n{p.stdout}"
        if p.returncode != 0:
            raise RuntimeError("the native runtime's build failed\n" + log)
        os.replace(tmp_lib, HOST_BUILD_DIR / HOST_LIB_NAME)
    (HOST_BUILD_DIR / "stamp").write_text(digest)
    (HOST_BUILD_DIR / "build.log").write_text(log)
    return log, time.perf_counter() - t0


def host_library() -> KernelLibrary:
    """The host runtime library, built from its source on first use; the
    caller binds its functions (utils/native.py)."""
    global _host_loaded
    with _lock:
        if _host_loaded is None:
            _host_loaded = _cached(HOST_BUILD_DIR, HOST_LIB_NAME,
                                   _host_digest(), _build_host)
        return _host_loaded


def current_stream(index: int) -> int:
    """Handle of the current stream of device `index`. The raw getter skips
    the Stream object that `torch.cuda.current_stream()` builds on every
    call (microseconds of a launch path that has few to spend)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch_on(device: torch.device, launch) -> int:
    """Run `launch(stream)` with `device` current; enters the device
    context only when another device is current."""
    if torch.cuda.current_device() == device.index:
        return launch(current_stream(device.index))
    with torch.cuda.device(device):
        return launch(current_stream(device.index))


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
