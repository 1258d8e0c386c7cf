"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own nvcc process, all started
together, and the objects are linked into ONE shared library with a plain
C interface, loaded with ctypes (no PyTorch headers: the build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -fmad=false -c csrc/<name>.cu   (one per source)
    nvcc -shared -o build/gnn_kernels/libgnn_kernels_<hash>.so <objects>

`-fmad=false` keeps each kernel on the same sequence of individually
rounded operations as its plain PyTorch version (no fused multiply-add
contraction); fast-math is never used.  csrc/kf_fit.cu builds with
`-fmad=true` instead (`FMAD`), as torch's own kernels are built, so that
the math library's float64 pow rounds as in torch's pow kernel; its
arithmetic rounds op by op all the same, through the `_rn` intrinsics,
which nvcc never contracts (see its note).  The library is named by a
hash of the sources and flags, built at first use into `build/`
(git-ignored) and reused while the sources are unchanged.

Each kernel's C entry point launches on the stream it is given and
returns `cudaGetLastError()`; `check()` turns a nonzero code into an
exception.  One entry point is host code alone: `graph_node_count`
(csrc/graph_nodes.cu) counts a captured CUDA graph's nodes
(`graph_nodes`).
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
              "-Xcompiler", "-fPIC"]
# nvcc's contraction flag by source; every other source -fmad=false
FMAD = {"kf_fit.cu": "-fmad=true"}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points, one per dtype suffix
_SIGNATURES = {
    # x, ok, node_x, out, n, k, stream
    "distinct_counts": [_P, _P, _P, _P, _I, _I, _P],
    # const ClusterArgs* (cluster_kernel._Args), stream
    "gmr_cluster": [_P, _P],
    # kc, int[4] out: blocks per SM, threads per block, smem bytes, lanes
    # per row
    "gmr_cluster_occupancy": [_I, _P],
    # int[3] out: blocks per SM, threads per block, smem bytes
    "distinct_counts_occupancy": [_P],
    # const FitArgs* (fit_kernel._Args), stream
    "kf_fit": [_P, _P],
    # int[3] out: blocks per SM, threads per block, smem bytes
    "kf_fit_occupancy": [_P],
}
# C signatures of the entry points without a dtype
_PLAIN_SIGNATURES = {
    # cudaGraph_t, int64 out: its nodes
    "graph_node_count": [_P, _P],
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
        for name, argtypes in _PLAIN_SIGNATURES.items():
            fn = getattr(self.lib, name)
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


def source_flags(src: Path) -> list:
    return NVCC_FLAGS + [FMAD.get(src.name, "-fmad=false")]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run_all(cmds) -> str:
    """Run the commands side by side; raise if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}")
    return log


def build(verbose: bool = False) -> KernelLibrary:
    """Compile (if needed) and load the kernel library.  verbose adds
    ptxas resource usage (registers, shared memory, spills) to the log."""
    srcs = sources()
    h = hashlib.sha256()
    for src in srcs:
        h.update(" ".join(source_flags(src)).encode())
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"libgnn_kernels_{h.hexdigest()[:16]}.so"
    log = ""
    t0 = time.perf_counter()
    if verbose or not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
            ptxas = ["-Xptxas", "-v"] if verbose else []
            log = _run_all(
                [[_nvcc()] + source_flags(src) + ptxas
                 + ["-c", "-o", str(obj), str(src)]
                 for src, obj in zip(srcs, objs)])
            lib = Path(tmp) / path.name
            log += _run_all([[_nvcc(), "-shared", "-o", str(lib)]
                             + [str(o) for o in objs]])
            os.replace(lib, path)
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


def graph_nodes(graph: int) -> int:
    """The nodes of a captured CUDA graph (a cudaGraph_t, as
    torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph() gives it)."""
    out = ctypes.c_int64()
    rc = library().lib.graph_node_count(graph, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"graph_node_count failed: cudaError {rc}")
    return out.value


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
