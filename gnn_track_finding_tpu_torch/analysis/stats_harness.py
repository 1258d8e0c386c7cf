"""Statistical repetition harness.

Port of `gnn_track_finding_tpu.analysis.stats_harness` (stats_harness.py:
1-124): the same studies through the port's drivers, each event built on
`device` at float64.

Re-design of the reference's bash repetition loops
(r&d/chi2_studies/chi2_uniform_distribution/check_uniform_dist.sh:3-9 —
100 pipeline reruns accumulating the p-value distribution;
r&d/node_weight_dist/tune_reweight_threshold/run_tune_reweight_threshold.sh:6-18):
rerun the pipeline over independently seeded toy events in one process,
accumulating p-values, purities, and the chi2-vs-truth debug stream, plus
the uniformity check of check_uniform_dist.py:1-30 (a correct fit's
p-values are uniform on [0, 1]).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import as_numpy
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import extract


def accumulate_pvals(num_runs: int = 50, seed: int = 0,
                     cfg: PipelineConfig | None = None,
                     num_tracks: int = 12, *,
                     device: torch.device | str = "cuda"
                     ) -> Dict[str, np.ndarray]:
    """p-values and purity of every accepted candidate over `num_runs`
    seeded toy events through the host driver `run_pipeline`."""
    cfg = cfg or PipelineConfig(node_bucket=256, edge_bucket=1024)
    pxy, pzr, purity = [], [], []
    for run in range(num_runs):
        ev = toymc.generate_event(num_tracks=num_tracks, seed=seed + run)
        g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                              device=device)
        out = pipeline.run_pipeline(g, cfg)
        for c in out.candidates:
            pxy.append(c.pval_xy)
            pzr.append(c.pval_zr)
            tids = [int(ev.truth[n]) for n in c.nodes]
            purity.append(max(np.bincount(tids).max() / len(tids), 0.0))
    return {"pvals_xy": np.asarray(pxy), "pvals_zr": np.asarray(pzr),
            "purity": np.asarray(purity)}


def reweight_threshold_sweep(num_runs: int = 50, seed: int = 0,
                             cfg: PipelineConfig | None = None,
                             num_tracks: int = 32,
                             thresholds: np.ndarray | None = None,
                             toy_kwargs: Dict | None = None, *,
                             device: torch.device | str = "cuda"
                             ) -> Dict[str, np.ndarray]:
    """The reference's reweight-threshold tuning study
    (r&d/node_weight_dist/tune_reweight_threshold/
    run_tune_reweight_threshold.sh:6-18): rerun iterations 1-2 over many
    seeded toy events, collect every remaining edge's post-iteration-2
    mixture weight with its truth label
    (extract_remaining_edge_reweights.py:26-40), and report, per candidate
    threshold, the fraction of true/false edges that survive — the data
    behind the hard-coded 0.1 at helper.py:145.

    Returns {"truth", "weight"} raw samples plus the sweep arrays
    {"thresholds", "signal_kept", "background_kept"}.

    toy_kwargs: extra generate_event parameters.  The default widens the
    edge gates (dphi 0.25, dtau 1.0) so cross-track confusion edges
    survive the iteration-1 clustering prune into the sweep — the study
    is signal-vs-background by construction (the reference's version runs
    on its 10-track/10-layer toy whose dense HitPairPredictor edges
    always carry background); with the framework's default windows the
    toy is so clean that zero false edges reach iteration 2 and the sweep
    would discriminate nothing.  Measured at the defaults (6 runs):
    signal kept 0.89 vs background kept 0.66 at the reference's 0.1
    operating point.  An empty class yields kept fraction 1.0 (vacuously
    nothing removed), not NaN.
    """
    cfg = cfg or PipelineConfig(node_bucket=256, edge_bucket=2048)
    if thresholds is None:
        thresholds = np.linspace(0.0, 0.5, 26)
    if toy_kwargs is None:
        toy_kwargs = {"edge_dphi_window": 0.25, "edge_dtau_window": 1.0}
    truths, weights = [], []
    for run in range(num_runs):
        ev = toymc.generate_event(num_tracks=num_tracks, seed=seed + run,
                                  **toy_kwargs)
        g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                              cfg, device=device)
        g = pipeline.prepare(g, cfg)
        g = pipeline.stage_step(g, cfg, 1)
        g = extract.apply_extraction(g, extract.extract_candidates(g, cfg),
                                     cfg)
        g = pipeline.stage_step(g, cfg, 2)   # extrapolation + reweight
        # The reference walks s.edges(data=True) over the remaining
        # networks (extract_remaining_edge_reweights.py:26-40): edge
        # DEACTIVATION does not remove an edge from the graph, so weights
        # below the operating threshold stay in the sample — that is the
        # whole point of the study (the distribution must not be truncated
        # at the 0.1 it is tuning).  Hence no g.active in this filter.
        member = as_numpy(g.has_updated & g.edge_mask)
        if not member.any():
            continue
        src = as_numpy(g.src)[member]
        dst = as_numpy(g.dst)[member]
        tr = as_numpy(g.truth)
        truths.append((tr[src] == tr[dst]).astype(np.int32))
        weights.append(as_numpy(g.upd_weight)[member])
    truth = np.concatenate(truths) if truths else np.zeros(0, np.int32)
    weight = np.concatenate(weights) if weights else np.zeros(0)
    sig = weight[truth == 1]
    bkg = weight[truth == 0]
    signal_kept = np.array([(sig >= t).mean() if sig.size else 1.0
                            for t in thresholds])
    background_kept = np.array([(bkg >= t).mean() if bkg.size else 1.0
                                for t in thresholds])
    return {"truth": truth, "weight": weight,
            "thresholds": np.asarray(thresholds),
            "signal_kept": signal_kept,
            "background_kept": background_kept}


def uniformity_check(pvals: np.ndarray, bins: int = 10) -> Dict[str, float]:
    """Chi-square test that accepted-candidate p-values are uniform
    (check_uniform_dist.py:1-30)."""
    from scipy.stats import chisquare
    if len(pvals) < bins:
        return {"statistic": float("nan"), "pvalue": float("nan"),
                "n": len(pvals)}
    hist, _ = np.histogram(pvals, bins=bins, range=(0.0, 1.0))
    stat, p = chisquare(hist)
    return {"statistic": float(stat), "pvalue": float(p), "n": len(pvals)}
