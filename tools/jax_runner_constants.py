"""The JAX package's answers on its runner's calibration and toy paths, at
float64 on the CPU, as the constants `chip_smoke.py` phase 8 holds the port
to (the card's machine has no JAX).

  * toy: `run.py --toy` (50 tracks, seed 1, node_bucket 256, edge_bucket
    1024, run_pipeline with the NetworkX-order tracker): accepted
    candidates per iteration, the toy efficiency report and the count of
    pure candidates;
  * calibration: `run.py --calibrate`'s training rows (20 toy events,
    seed 0) and its quantile LUT on emp_var (row count, lower / upper
    bins, bin widths);
  * calibrated: run_pipeline with that LUT's per-node thresholds and the
    tracker on each committed event cache (volume 7 and the full event):
    accepted candidates per iteration and the threshold levels;
  * clean_volume7: run_pipeline_fast in clean mode (bug_compat=False, the
    identity mirror) on the volume-7 cache: accepted candidates per
    iteration (chip_smoke phase 3 and tests/test_torch_modes.py).

Usage (about 3 minutes and 3.5 GB, most of it the full event's quadratic
leak replay in the JAX module):

    JAX_PLATFORMS=cpu python tools/jax_runner_constants.py
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gnn_track_finding_tpu.calib import lut, training_data  # noqa: E402
from gnn_track_finding_tpu.config import PipelineConfig  # noqa: E402
from gnn_track_finding_tpu.data import event_cache  # noqa: E402
from gnn_track_finding_tpu.evaluation import efficiency  # noqa: E402
from gnn_track_finding_tpu.graph.build import build_graph_state  # noqa: E402
from gnn_track_finding_tpu.models import pipeline, toymc  # noqa: E402

CACHE_KEYS = {"volume7": "fafb3309e4598e9b", "full": "7bba1cb4ae95bca1"}


def per_iteration(out, cfg):
    return [sum(1 for c in out.candidates if c.iteration == i)
            for i in range(1, cfg.num_iterations + 1)]


def main() -> None:
    out = {}
    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    ev = toymc.generate_event(num_tracks=50, seed=1)
    g, host = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg)
    res = pipeline.run_pipeline(g, cfg, tracker=host.tracker)
    rep = efficiency.evaluate_toy([c.nodes for c in res.candidates],
                                  ev.truth, ev.vivl, cfg)
    out["toy"] = {
        "per_iteration": per_iteration(res, cfg),
        "num_reference": rep.num_reference,
        "num_reconstructed": rep.num_reconstructed,
        "efficiency_pct": rep.efficiency_pct,
        "track_purities": rep.track_purities.tolist(),
        "particle_purities": rep.particle_purities.tolist(),
        # JAX run.py:149-153's count, kept here rather than taken from the
        # port's efficiency.pure_candidates: these constants are the JAX
        # package's answers, computed without the code they check
        "pure": sum(1 for c in res.candidates
                    if len({int(ev.truth[n]) for n in c.nodes}) == 1)}

    rows = training_data.generate_training_data(num_events=20, seed=0)
    table = lut.fit_lut_quantile(rows, feature="emp_var")
    out["calibration"] = {
        "rows": int(rows.shape[0]), "lower": table.lower.tolist(),
        "upper": table.upper.tolist(),
        "feature_bin_width": table.feature_bin_width,
        "kl_bin_width": table.kl_bin_width}

    out["calibrated"] = {}
    for name, key in CACHE_KEYS.items():
        xyzr, vivl, tp, pairs, extra, pre = event_cache.load(
            str(REPO / ".event_cache"), key)
        cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                             max_volume=int(vivl[:, 0].max()))
        g, host = build_graph_state(xyzr, vivl, tp, pairs, cfg,
                                    host_extra=extra, precomputed=pre,
                                    with_tracker=True)
        feat = np.asarray(pipeline._prepare_jit(g, cfg).grad_stats)[:, 1]
        with np.errstate(invalid="ignore"):
            thr = table.thresholds_for(feat)
        levels, counts = np.unique(thr[:g.n_nodes], return_counts=True)
        res = pipeline.run_pipeline(g, cfg,
                                    kl_thresholds=jnp.asarray(thr, g.dtype),
                                    tracker=host.tracker)
        out["calibrated"][name] = {
            "per_iteration": per_iteration(res, cfg),
            "nan_emp_var": int(np.isnan(feat[:g.n_nodes]).sum()),
            "threshold_levels": dict(zip(map(float, levels),
                                         map(int, counts)))}
        print(name, out["calibrated"][name], file=sys.stderr, flush=True)

    xyzr, vivl, tp, pairs, extra, pre = event_cache.load(
        str(REPO / ".event_cache"), CACHE_KEYS["volume7"])
    cfg = PipelineConfig(bug_compat=False)
    g, _ = build_graph_state(xyzr, vivl, tp, pairs, cfg, host_extra=extra,
                             precomputed={"component": pre["component"]},
                             with_tracker=False)
    out["clean_volume7"] = per_iteration(pipeline.run_pipeline_fast(g, cfg),
                                         cfg)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
