"""Post-hoc audit of extracted track candidates.

Port of `gnn_track_finding_tpu.analysis.quality_check` (quality_check.py:
1-108), the same host code; the edge arrays may be tensors on any device.

Re-design of the reference's one-off sanity script
(r&d/quality_check/quality_check_extracted_candidates.py:47-129): re-check
every extracted candidate against four structural invariants —

  test 1  at least n hits (":47-60");
  test 2  hits sorted by descending r are pairwise connected (":66-80");
  test 3  hits sorted by descending z are pairwise connected (":83-97");
  test 4  layer ids, sorted, step by at most one detector layer
          (increment 2 in the reference's vivl numbering — "holes in the
          track!") and are connected in that order (":103-126").

The reference prints ERROR lines and matplotlib-plots the offenders; here
the audit returns a per-candidate record array so tests and studies can
assert on it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from gnn_track_finding_tpu_torch.graph.state import as_numpy


@dataclasses.dataclass
class CandidateAudit:
    nodes: np.ndarray
    min_hits_ok: bool          # test 1
    r_order_connected: bool    # test 2
    z_order_connected: bool    # test 3
    no_layer_holes: bool       # test 4a
    layer_order_connected: bool  # test 4b

    @property
    def all_ok(self) -> bool:
        return (self.min_hits_ok and self.r_order_connected
                and self.z_order_connected and self.no_layer_holes
                and self.layer_order_connected)


def _edge_set(src: np.ndarray, dst: np.ndarray,
              mask: np.ndarray) -> Set[Tuple[int, int]]:
    es = set()
    for s, d in zip(src[mask].tolist(), dst[mask].tolist()):
        es.add((s, d))
        es.add((d, s))        # reference checks both directions (":78-79")
    return es


def _chain_connected(order: Sequence[int],
                     edges: Set[Tuple[int, int]]) -> bool:
    return all((order[j], order[j + 1]) in edges
               for j in range(len(order) - 1))


def quality_check_candidates(
    candidate_nodes: Sequence[np.ndarray],
    xyzr: np.ndarray,
    vivl: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    edge_mask: np.ndarray,
    min_track_hits: int = 4,
    layer_increment: float = 2.0,
) -> List[CandidateAudit]:
    """Audit candidates (lists of node ids) against the ORIGINAL event
    edges (the candidate subgraphs the reference reads keep their edges;
    here connectivity is checked against the event's edge list)."""
    edges = _edge_set(as_numpy(src), as_numpy(dst),
                      as_numpy(edge_mask).astype(bool))
    xyzr = as_numpy(xyzr)
    vivl = as_numpy(vivl)
    audits = []
    for nodes in candidate_nodes:
        nodes = as_numpy(nodes)
        nodes = nodes[nodes >= 0]
        by_r = nodes[np.argsort(-xyzr[nodes, 3], kind="stable")]
        by_z = nodes[np.argsort(-xyzr[nodes, 2], kind="stable")]
        # sort by (volume, layer) pairs like the reference's sorted(vivl_ids)
        lex = np.lexsort((vivl[nodes, 1], vivl[nodes, 0]))
        by_layer = nodes[lex]
        layer_ids = vivl[by_layer, 1].astype(float)
        holes = bool((np.diff(layer_ids) > layer_increment).any())
        audits.append(CandidateAudit(
            nodes=nodes,
            min_hits_ok=len(nodes) >= min_track_hits,
            r_order_connected=_chain_connected(by_r.tolist(), edges),
            z_order_connected=_chain_connected(by_z.tolist(), edges),
            no_layer_holes=not holes,
            layer_order_connected=_chain_connected(by_layer.tolist(), edges),
        ))
    return audits


def summarize(audits: List[CandidateAudit]) -> Dict[str, int]:
    """Counts per failed invariant (the reference's printed ERROR tally)."""
    return {
        "n_candidates": len(audits),
        "fragments": sum(not a.min_hits_ok for a in audits),
        "r_order_breaks": sum(not a.r_order_connected for a in audits),
        "z_order_breaks": sum(not a.z_order_connected for a in audits),
        "layer_holes": sum(not a.no_layer_holes for a in audits),
        "layer_order_breaks": sum(not a.layer_order_connected
                                  for a in audits),
        "clean": sum(a.all_ok for a in audits),
    }
