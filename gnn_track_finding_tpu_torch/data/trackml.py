"""TrackML event ingest from the CSV files, through the C++ loader.

Counterpart of `gnn_track_finding_tpu.data.trackml.load_event`
(trackml.py:87-150) without a dataframe library: the files are parsed by
the C++ loader (data/native_loader.py), whose arrays equal those of the
JAX package's dataframe reader, then built by graph/build.py.  The three files (trackml.py:6-13):

  * nodes CSV ``node_idx,layer_id,x,y,z``, filtered to the volume window,
    r = hypot(x, y), volume_id = layer_id // 1000,
    in_volume_layer_id = layer_id % 100;
  * edges CSV whose first line is a ``<nodes> <edges>`` count header,
    followed by the real ``node2,node1,weight`` header;
  * the aggregated truth mapping ``node_idx,hit_id,particle_id,volume_id,
    layer_id,module_id,nhits``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import event_cache, native_loader
from gnn_track_finding_tpu_torch.graph.build import build_event


@dataclasses.dataclass
class TrackMLPaths:
    nodes_csv: str
    edges_csv: str
    truth_csv: str           # aggregated full-mapping CSV
    particles_csv: Optional[str] = None


def load_event(paths: TrackMLPaths, cfg: PipelineConfig, *,
               device: torch.device | str,
               dtype: torch.dtype = torch.float64,
               cache_dir: str | os.PathLike | None = None,
               with_tracker: bool = True):
    """-> (GraphState, HostEvent) for one event.

    cache_dir: binary event cache (data/event_cache.py, the JAX layout and
    key).  A hit skips the parse and the mirror computation; a miss writes
    the cache after ingest, unless the mirror was never computed (clean
    mode without a tracker: a later bug_compat load would read a wrong
    mirror).  with_tracker=False leaves HostEvent.tracker None: only
    run_pipeline's extraction-leak replay needs the tracker."""
    key = hit = None
    if cache_dir is not None:
        key = event_cache.cache_key(paths.nodes_csv, paths.edges_csv,
                                    paths.truth_csv, cfg.min_volume,
                                    cfg.max_volume)
        hit = event_cache.load(cache_dir, key)
    if hit is not None:
        xyzr, vivl, tp, pairs, extra, pre = hit
        mirror, component = pre["mirror"], pre["component"]
    else:
        xyzr, vivl, tp, pairs, extra = native_loader.load_event_arrays_native(
            paths.nodes_csv, paths.edges_csv, paths.truth_csv,
            cfg.min_volume, cfg.max_volume)
        mirror, component = None, extra["components"]
    g, host = build_event(xyzr, vivl, tp, pairs, cfg, device=device,
                          dtype=dtype, mirror=mirror, component=component,
                          node_ids=extra["node_ids"],
                          with_tracker=with_tracker,
                          hit_particle_ids=event_cache.hit_particle_ids(extra))
    if hit is None and key is not None and (cfg.bug_compat or with_tracker):
        # the loader's pairs are already deduplicated, so they are the
        # pairs the mirror indexes (2i = u->v of pair i)
        event_cache.save(cache_dir, key, xyzr, vivl, tp, pairs, extra,
                         host.mirror, component)
    return g, host


def write_csvs(directory: str | os.PathLike, xyzr, vivl, pairs,
               extra: dict) -> TrackMLPaths:
    """Write one event's arrays (e.g. an event cache's, load_npz) as the
    three CSV files load_event reads, and return their paths.

    Node and hit ids are `extra`'s (`node_ids`, TRUTH_KEYS of
    data/event_cache.py); layer_id = volume * 1000 + layer.  Floats are
    written in shortest round-trip form, so the loader reads x, y and z
    back bit for bit (r it recomputes).  Pair (u, v) is written as
    node1 = u, node2 = v.  The truth file has one row per hit; the i-th
    hit of a node carries the node's i-th unique module (the last one for
    any hits beyond), so the loader's unique modules are the node's."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    ids = np.asarray(extra["node_ids"]).tolist()
    paths = TrackMLPaths(str(d / "nodes.csv"), str(d / "edges.csv"),
                         str(d / "truth.csv"))
    with open(paths.nodes_csv, "w") as f:
        f.write("node_idx,layer_id,x,y,z\n")
        for i, (v0, v1), (x, y, z, _) in zip(ids, np.asarray(vivl).tolist(),
                                             np.asarray(xyzr).tolist()):
            f.write(f"{i},{v0 * 1000 + v1},{x!r},{y!r},{z!r}\n")
    pairs = np.asarray(pairs).tolist()
    with open(paths.edges_csv, "w") as f:
        f.write(f"{len(ids)} {len(pairs)}\nnode2,node1,weight\n")
        for u, v in pairs:
            f.write(f"{ids[v]},{ids[u]},1.0\n")
    hit_off, mod_off = extra["hit_off"], extra["mod_off"]
    hits, pids = extra["hit_flat"].tolist(), extra["pid_flat"].tolist()
    mod_flat = extra["mod_flat"].tolist()
    with open(paths.truth_csv, "w") as f:
        f.write("node_idx,hit_id,particle_id,volume_id,layer_id,module_id,"
                "nhits\n")
        for i, nid in enumerate(ids):
            mods = mod_flat[mod_off[i]:mod_off[i + 1]]
            lo, hi = int(hit_off[i]), int(hit_off[i + 1])
            if hi > lo and not mods:
                raise ValueError(f"node {nid} has hits but no module")
            for j in range(lo, hi):
                f.write(f"{nid},{hits[j]},{pids[j]},{vivl[i][0]},"
                        f"{vivl[i][1]},{mods[min(j - lo, len(mods) - 1)]},"
                        f"{hi - lo}\n")
    return paths


# The JAX package's default event, in the reference project's checkout
# beside this repository.
REFERENCE_DIR = Path(__file__).resolve().parents[3] / "reference"
_TRACKML = REFERENCE_DIR / "src" / "trackml_mod"
DEFAULT_EVENT = TrackMLPaths(
    nodes_csv=str(_TRACKML / "event_network" / "minCurv_0.3_134"
                  / "event_1_filtered_graph_nodes.csv"),
    edges_csv=str(_TRACKML / "event_network" / "minCurv_0.3_134"
                  / "event_1_filtered_graph_edges.csv"),
    truth_csv=str(_TRACKML / "event_truth"
                  / "event000001000-full-mapping-minCurv-0.3-800.csv"),
    particles_csv=str(_TRACKML / "event_truth"
                      / "event000001000-particles.csv"),
)
