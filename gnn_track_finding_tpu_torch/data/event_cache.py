"""Binary event cache reader: one parsed, order-resolved event in an .npz.

Counterpart of `gnn_track_finding_tpu.data.event_cache.load`, keyed by
path instead of by the source CSV files' identity (the CSVs need not be
present to read a committed cache).  The file holds the raw event arrays
plus the two products of the reference's NetworkX-order emulation — the
set()-order `mirror` table and the component labels — so ingest needs
neither NetworkX nor pandas.
"""

from __future__ import annotations

import os

import numpy as np


def load_npz(path: str | os.PathLike) -> tuple:
    """-> (xyzr, vivl, truth_particle, pairs, extra, precomputed), the tuple
    of the JAX `event_cache.load`.  `extra` carries the original node ids
    and the component labels; the per-node hit/module lists stay behind
    (nothing on the port's path reads them)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    extra = {"node_ids": arrays["node_ids"],
             "components": arrays["component"]}
    # a cache's slot tables (if any) are not read: the port's ingest
    # rebuilds them from the pairs, which re-deduplicating leaves unchanged
    precomputed = {"mirror": arrays["mirror"],
                   "component": arrays["component"]}
    return (arrays["xyzr"], arrays["vivl"], arrays["truth_particle"],
            arrays["pairs"], extra, precomputed)
