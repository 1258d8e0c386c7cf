"""Binary event cache: one parsed, order-resolved event in an .npz.

Counterpart of `gnn_track_finding_tpu.data.event_cache` (event_cache.py:
50-123), in the same file layout, so each package reads the caches the
other writes.  The file holds the raw event arrays, the truth lists as
flat arrays with offsets, and the two products of the reference's
NetworkX-order emulation — the set()-order `mirror` table and the
component labels — so ingest needs neither NetworkX nor a dataframe
library.  A cache is keyed by the source CSV files' identity (path, size,
mtime) and the volume window; `load_npz` reads one by path, without the
CSVs.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

CACHE_VERSION = 2
# truth lists as flat arrays with offsets (data/native_loader.py's extra)
TRUTH_KEYS = ("hit_flat", "hit_off", "pid_flat", "mod_flat", "mod_off")


def cache_key(nodes_csv: str, edges_csv: str, truth_csv: str,
              min_volume: int, max_volume: int) -> str:
    """The JAX package's key of one event's CSVs and volume window."""
    h = hashlib.sha1()
    h.update(f"v{CACHE_VERSION}|{min_volume}|{max_volume}".encode())
    for p in (nodes_csv, edges_csv, truth_csv):
        st = os.stat(p)
        h.update(f"|{p}|{st.st_size}|{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def cache_path(cache_dir: str | os.PathLike, key: str) -> str:
    return os.path.join(cache_dir, f"event_{key}.npz")


def save(cache_dir: str | os.PathLike, key: str, xyzr, vivl, truth_particle,
         pairs, extra: dict, mirror: np.ndarray, component: np.ndarray
         ) -> str:
    """Write one event in the JAX layout (event_cache.py:78-102; its
    optional slot tables are left out) and return its path.  pairs must be
    the deduplicated pairs the mirror indexes; `extra` holds `node_ids` and
    the TRUTH_KEYS arrays."""
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(cache_dir, key)
    arrays = dict(xyzr=xyzr, vivl=vivl, truth_particle=truth_particle,
                  pairs=pairs, node_ids=np.asarray(extra["node_ids"]),
                  mirror=np.asarray(mirror, np.int32),
                  component=np.asarray(component, np.int32),
                  **{k: np.asarray(extra[k]) for k in TRUTH_KEYS})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_npz(path: str | os.PathLike) -> tuple:
    """-> (xyzr, vivl, truth_particle, pairs, extra, precomputed), the tuple
    of the JAX `event_cache.load`.  `extra` carries the original node ids,
    the component labels and the flat truth lists; `precomputed` the mirror
    and the component labels."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    extra = {"node_ids": arrays["node_ids"],
             "components": arrays["component"],
             **{k: arrays[k] for k in TRUTH_KEYS}}
    # a cache's slot tables (if any) are not read: the port's ingest
    # rebuilds them from the pairs, which re-deduplicating leaves unchanged
    precomputed = {"mirror": arrays["mirror"],
                   "component": arrays["component"]}
    return (arrays["xyzr"], arrays["vivl"], arrays["truth_particle"],
            arrays["pairs"], extra, precomputed)


def hit_particle_ids(extra: dict) -> list:
    """The particle ids of each node's hits, one array per node, from the
    flat truth lists (`pid_flat` over `hit_off`)."""
    return np.split(np.asarray(extra["pid_flat"]),
                    np.asarray(extra["hit_off"])[1:-1])


def load(cache_dir: str | os.PathLike, key: str) -> tuple | None:
    """load_npz of the cache of `key`, or None when there is none."""
    path = cache_path(cache_dir, key)
    return load_npz(path) if os.path.exists(path) else None
