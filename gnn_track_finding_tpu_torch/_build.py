"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by nvcc into ONE shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: the build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/gnn_kernels/libgnn_kernels_<hash>.so

`-fmad=false` keeps each kernel on the same sequence of individually
rounded operations as its plain PyTorch version (no fused multiply-add
contraction); fast-math is never used.  The library is named by a hash of
the sources and flags, built at first use into `build/` (git-ignored) and
reused while the sources are unchanged.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "gnn_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C signatures of the entry points, one per dtype suffix
_SIGNATURES = {
    # x, ok, node_x, out, n, k, stream
    "distinct_counts": [_P, _P, _P, _P, _I, _I, _P],
    # pk, nodex, gate, klthr, valid, rows, kc, chi2_thr, endcap, s_rz,
    # s_rz2, bug_compat, found, pm, pc, mprior, deact, stream
    "gmr_cluster": [_P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _D, _I,
                    _P, _P, _P, _P, _P, _P],
}


class KernelLibrary:
    """The loaded shared library plus how it was built."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(self.lib, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int

    def fn(self, name: str, dtype) -> ctypes._CFuncPtr:
        import torch
        if dtype == torch.float64:
            return getattr(self.lib, f"{name}_f64")
        if dtype == torch.float32:
            return getattr(self.lib, f"{name}_f32")
        raise TypeError(f"{name}: no kernel for dtype {dtype}")


_LIBRARY: KernelLibrary | None = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(verbose: bool = False) -> KernelLibrary:
    """Compile (if needed) and load the kernel library.  verbose adds
    ptxas resource usage (registers, shared memory, spills) to the log."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"libgnn_kernels_{h.hexdigest()[:16]}.so"
    log = ""
    t0 = time.perf_counter()
    if verbose or not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ([_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
               + ["-o", tmp] + [str(s) for s in sources()])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    return KernelLibrary(path, time.perf_counter() - t0, log)


def library(rebuild: bool = False) -> KernelLibrary:
    """The kernel library, built at first use in this process; rebuild
    compiles it again from the sources, with ptxas resource usage."""
    global _LIBRARY
    if _LIBRARY is None or rebuild:
        _LIBRARY = build(verbose=rebuild)
    return _LIBRARY


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
