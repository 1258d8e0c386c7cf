"""Truth-instrumented online metrics (confusion counters).

Port of `gnn_track_finding_tpu.ops.metrics` (metrics.py:1-94).  The
reference scores every pruning decision against MC truth and prints a
precision/recall/confusion matrix per stage — clustering
(clustering.py:317-369), reweight (helper.py:182-225), the extrapolation
chi2 gate (extrapolate_merged_states.py:367-373,396-402,496-518).  Here the
same counters are reductions over the edge tensors on the graph's device,
computed from a before/after pair of graph states, so any stage can be
scored with

    before = g
    g = stage(g, cfg)
    cm = metrics.edge_decision_confusion(before, g)

Each function stacks its counts on the device and reads them with one
host copy.  Counting fix vs the reference (documented in ops/priors.py):
the reference's active-edge counters use ``=`` where ``+=`` was meant
(helper.py:199-200, extrapolate_merged_states.py:372-373), so its printed
TN/FN are 0/1-valued; here they accumulate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from gnn_track_finding_tpu_torch.graph.state import GraphState


@dataclasses.dataclass
class ConfusionMatrix:
    tp: int   # deactivated edges whose endpoints disagree in truth
    fp: int   # deactivated edges whose endpoints agree (wrongly cut)
    tn: int   # kept edges whose endpoints agree
    fn: int   # kept edges whose endpoints disagree (missed outliers)

    @property
    def precision(self) -> float:
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self) -> float:
        return self.tp / max(self.tp + self.fn, 1)

    def rates(self) -> Dict[str, float]:
        return {
            "tpr": self.recall,
            "fnr": self.fn / max(self.tp + self.fn, 1),
            "fpr": self.fp / max(self.tn + self.fp, 1),
            "tnr": self.tn / max(self.tn + self.fp, 1),
            "precision": self.precision,
            "recall": self.recall,
        }


def _counts(*masks: torch.Tensor) -> list:
    """Number of set entries of each mask, in one host read."""
    return torch.stack([m.sum() for m in masks]).tolist()


def edge_decision_confusion(before: GraphState, after: GraphState
                            ) -> ConfusionMatrix:
    """Score a stage's edge (de)activations against truth labels.

    'Positive' = the stage deactivated the edge; 'correct positive' = the
    edge crossed truth particles (an outlier, clustering.py:317-321).
    """
    considered = before.edge_mask & before.active & after.edge_mask
    deact = considered & ~after.active
    kept = considered & after.active
    same = before.truth[before.src] == before.truth[before.dst]
    tp, fp, tn, fn = _counts(deact & ~same, deact & same, kept & same,
                             kept & ~same)
    return ConfusionMatrix(tp=tp, fp=fp, tn=tn, fn=fn)


def graph_summary(g: GraphState) -> Dict[str, int]:
    """Per-stage counts the reference prints (clustering.py:342-346)."""
    keys = ("nodes", "edges", "active_edges", "merged_nodes", "updated_edges")
    return dict(zip(keys, _counts(g.node_mask, g.edge_mask,
                                  g.edge_mask & g.active,
                                  g.has_merged & g.node_mask,
                                  g.has_updated & g.edge_mask)))


def chi2_truth_dump(g: GraphState, chi2, mask) -> "tuple":
    """Optional debug stream analog of the reference's side-channel CSV
    appends (extrapolate_merged_states.py:284-295): rows (truth, chi2) for
    threshold-tuning studies, collected OFF the critical path.  -> numpy
    (truth as 0/1 ints, chi2) of the masked edges."""
    m = torch.as_tensor(mask, device=g.device)
    same = (g.truth[g.src] == g.truth[g.dst])[m]
    vals = torch.as_tensor(chi2, device=g.device)[m]
    return same.cpu().numpy().astype(int), vals.cpu().numpy()
