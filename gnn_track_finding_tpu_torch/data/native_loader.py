"""ctypes binding of the C++ event loader (native/loader.cc).

Counterpart of `gnn_track_finding_tpu.data.native_loader`: one pass of CSV
parsing into packed arrays, pair dedupe in first-occurrence order,
union-find components, and the node -> hits truth lists; plus `gnn_cca`,
the union-find labelling of a masked edge list that the host driver uses
for the extraction CCA.

The library is built from `native/loader.cc` at first use with

    g++ -O3 -fPIC -std=c++17 -shared -o build/native/libgnn_loader_<hash>.so

named by a hash of the source and flags, and reused while both are
unchanged.  A failed build raises: there is no fallback reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "loader.cc"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# name -> (argtypes, restype), the C ABI of native/loader.cc
_SIGNATURES = {
    "gnn_load_event": ([ctypes.c_char_p] * 3 + [ctypes.c_int] * 2, _P),
    "gnn_error": ([_P], ctypes.c_char_p),
    "gnn_num_nodes": ([_P], _I64),
    "gnn_num_pairs": ([_P], _I64),
    "gnn_num_hits": ([_P], _I64),
    "gnn_num_modules": ([_P], _I64),
    "gnn_get_nodes": ([_P] * 6, None),
    "gnn_get_pairs": ([_P] * 2, None),
    "gnn_get_truth": ([_P] * 6, None),
    "gnn_free": ([_P], None),
    "gnn_cca": ([_I64, _I64] + [_P] * 4, None),
}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgnn_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/loader.cc unless a library of the same source and
    flags exists; raises when g++ fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++"] + CXX_FLAGS + ["-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built at first use in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
    return _LIB


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def load_event_arrays_native(nodes_csv: str, edges_csv: str, truth_csv: str,
                             min_volume: int, max_volume: int):
    """-> (xyzr, vivl, truth_particle, pairs, extra) of one event's CSVs
    (the contract of the JAX `trackml.load_event_arrays`).  pairs are
    already deduplicated.  extra holds `node_ids`, the union-find
    `components`, and the truth lists as flat arrays with offsets in the
    event cache's layout: `hit_flat`/`pid_flat` (hit and particle id per
    hit) over `hit_off`, `mod_flat` (unique module ids) over `mod_off`."""
    lib = library()
    h = lib.gnn_load_event(os.fsencode(nodes_csv), os.fsencode(edges_csv),
                           os.fsencode(truth_csv), min_volume, max_volume)
    if not h:
        raise MemoryError("native loader returned no event")
    try:
        err = lib.gnn_error(h)
        if err:
            raise RuntimeError(f"native loader: {err.decode()}")
        n = lib.gnn_num_nodes(h)
        m = lib.gnn_num_pairs(h)
        n_hits = lib.gnn_num_hits(h)
        n_mods = lib.gnn_num_modules(h)
        xyzr = np.empty((n, 4), np.float64)
        vivl = np.empty((n, 2), np.int32)
        node_ids = np.empty(n, np.int64)
        comp = np.empty(n, np.int32)
        truth_pid = np.empty(n, np.int64)
        pairs = np.empty((m, 2), np.int32)
        hit_off = np.empty(n + 1, np.int64)
        hit_flat = np.empty(n_hits, np.int64)
        pid_flat = np.empty(n_hits, np.int64)
        mod_off = np.empty(n + 1, np.int64)
        mod_flat = np.empty(n_mods, np.int64)
        lib.gnn_get_nodes(h, _ptr(xyzr), _ptr(vivl), _ptr(node_ids),
                          _ptr(comp), _ptr(truth_pid))
        lib.gnn_get_pairs(h, _ptr(pairs))
        lib.gnn_get_truth(h, _ptr(hit_off), _ptr(hit_flat), _ptr(pid_flat),
                          _ptr(mod_off), _ptr(mod_flat))
    finally:
        lib.gnn_free(h)
    extra = {"node_ids": node_ids, "components": comp,
             "hit_flat": hit_flat, "hit_off": hit_off, "pid_flat": pid_flat,
             "mod_flat": mod_flat, "mod_off": mod_off}
    return xyzr, vivl, truth_pid, pairs.astype(np.int64), extra


def connected_components_native(src: np.ndarray, dst: np.ndarray,
                                ok: np.ndarray, n: int) -> np.ndarray:
    """Union-find labels over the directed edges with ok set: (n,) int32,
    the minimum node index of each weak component."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    ok = np.ascontiguousarray(ok, np.bool_).view(np.uint8)
    if not (src.shape == dst.shape == ok.shape and src.ndim == 1):
        raise ValueError("src, dst and ok must be equal-length vectors")
    if src.size and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n):
        raise ValueError("edge endpoints must lie in [0, n)")
    labels = np.empty(n, np.int32)
    library().gnn_cca(n, src.shape[0], _ptr(src), _ptr(dst), _ptr(ok),
                      _ptr(labels))
    return labels
