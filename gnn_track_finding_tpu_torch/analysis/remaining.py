"""Post-hoc audit of the remaining (unextracted) network.

Port of `gnn_track_finding_tpu.analysis.remaining` (remaining.py:1-153),
the same host code over host copies of the state's tensors.

Re-design of analyse_remaining_networks.py:75-110: classify the leftover
components — counting candidates where every layer holds exactly two hits
("track splitting" candidates), fragments, and mixed blobs — plus the
clustering_updated_states_test.py:367-382 statistic (fraction of nodes
that received updated states).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np

from gnn_track_finding_tpu_torch.graph.state import GraphState, as_numpy


def analyse_remaining(g: GraphState) -> Dict[str, int]:
    alive = as_numpy(g.node_mask)
    comp = as_numpy(g.component)
    vivl = as_numpy(g.vivl)

    by_comp: Dict[int, list] = {}
    for n in np.flatnonzero(alive):
        by_comp.setdefault(int(comp[n]), []).append(int(n))

    stats = Counter()
    for nodes in by_comp.values():
        stats["remaining_components"] += 1
        stats["remaining_nodes"] += len(nodes)
        layer_counts = Counter((int(vivl[n, 0]), int(vivl[n, 1]))
                               for n in nodes)
        counts = list(layer_counts.values())
        if all(c == 2 for c in counts) and len(counts) >= 2:
            # 2 hits on every layer -> merged pair of tracks, splittable
            # (analyse_remaining_networks.py:75-110 "track splitting")
            stats["track_splitting_candidates"] += 1
        elif all(c == 1 for c in counts):
            stats["clean_chains"] += 1
        else:
            stats["mixed_blobs"] += 1
    return dict(stats)


def updated_state_coverage(g: GraphState) -> Dict[str, float]:
    """Fraction of alive nodes holding updated states
    (clustering_updated_states_test.py:367-382)."""
    alive = as_numpy(g.node_mask)
    has_upd = np.zeros(g.num_padded_nodes, bool)
    dst = as_numpy(g.dst)
    upd = as_numpy(g.has_updated & g.edge_mask)
    np.maximum.at(has_upd, dst[upd], True)
    n_alive = int(alive.sum())
    n_upd = int((has_upd & alive).sum())
    return {"nodes": n_alive, "nodes_with_updated_states": n_upd,
            "fraction": n_upd / max(n_alive, 1)}


def close_proximity_separations(g: GraphState,
                                percentile: float = 95.0) -> Dict:
    """The close-proximity module-hit study
    (r&d/remaining/close_proximity_module_hits.py:54-122): over remaining
    components with >4 nodes, find those where 1-2 layers hold exactly
    two hits, require the pair to share a common neighbour (an edge to
    the same third node, either direction — the reference intersects
    both nodes' edge endpoints, :80-92), and collect the pair's 3D
    separation.  Returns the separations, the count, and the chosen
    percentile cut (the reference prints the 95th percentile as the
    recommended node_merge_distance, :118-119)."""
    alive = as_numpy(g.node_mask)
    comp = as_numpy(g.component)
    vivl = as_numpy(g.vivl)
    xyzr = as_numpy(g.xyzr)
    src = as_numpy(g.src)
    dst = as_numpy(g.dst)
    emask = as_numpy(g.edge_mask)

    nbrs: Dict[int, set] = {}
    for e in np.flatnonzero(emask):
        nbrs.setdefault(int(src[e]), set()).add(int(dst[e]))
        nbrs.setdefault(int(dst[e]), set()).add(int(src[e]))

    by_comp: Dict[int, list] = {}
    for n in np.flatnonzero(alive):
        by_comp.setdefault(int(comp[n]), []).append(int(n))

    separations = []
    extractable = 0
    for nodes in by_comp.values():
        if len(nodes) <= 4:          # don't process track fragments (:60)
            continue
        layer_nodes: Dict[tuple, list] = {}
        for n in nodes:
            layer_nodes.setdefault((int(vivl[n, 0]), int(vivl[n, 1])),
                                   []).append(n)
        doubled = {k: v for k, v in layer_nodes.items() if len(v) == 2}
        if not 1 <= len(doubled) <= 2:       # (:69-70)
            continue
        comp_seps = []
        ok = True
        for pair in doubled.values():
            n1, n2 = pair
            common = (nbrs.get(n1, set()) - {n2}) & (
                nbrs.get(n2, set()) - {n1})
            if not common:                    # (:92-94)
                ok = False
                break
            d = np.sqrt(np.sum((xyzr[n1, :3] - xyzr[n2, :3]) ** 2))
            comp_seps.append(float(d))
        if ok and comp_seps:
            extractable += 1
            separations.extend(comp_seps)

    seps = np.asarray(separations)
    cut = float(np.percentile(seps, percentile)) if seps.size else float("nan")
    return {"separations": seps, "extractable_components": extractable,
            "percentile": percentile, "separation_cut": cut}


def node_weight_distributions(g: GraphState, candidates) -> Dict[int, Dict]:
    """Per-candidate per-node active inward-edge mixture weights
    (r&d/node_weight_dist/test_weight_dist.py:24-52): for each extracted
    candidate, for each of its nodes, the mixture weights of its ACTIVE
    in-edges — the data behind the reference's per-node weight histograms.

    candidates: iterables of node ids (pipeline.Candidate or raw sets).
    Weights read from the current edge state: updated weights where
    updated states exist, else seed weights (the reference reads the live
    'mixture_weight' attribute, which the extrapolation stage overwrote).
    """
    src = as_numpy(g.src)
    dst = as_numpy(g.dst)
    emask = as_numpy(g.edge_mask)
    act = as_numpy(g.active)
    has_upd = as_numpy(g.has_updated)
    w = np.where(has_upd, as_numpy(g.upd_weight), as_numpy(g.seed_weight))

    in_edges: Dict[int, list] = {}
    for e in np.flatnonzero(emask & act):
        in_edges.setdefault(int(dst[e]), []).append(e)

    out: Dict[int, Dict] = {}
    for i, cand in enumerate(candidates):
        nodes = getattr(cand, "nodes", cand)
        per_node = {}
        for n in nodes:
            n = int(n)
            per_node[n] = np.asarray(
                [w[e] for e in in_edges.get(n, [])], dtype=float)
        out[i] = per_node
    return out
