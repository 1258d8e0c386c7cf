"""Validate the PyTorch port's states against the reference pipeline's outputs.

The port's counterpart of tools/validate_vs_reference.py: the same
comparison (`compare`) against the committed digest of a reference run
(tests/data/ref_digest.npz, volume 7), with the framework side computed by
the port from the committed volume-7 event cache.  The cache's mirror and
component labels are not read: the port recomputes both from the node ids,
so a full match also proves the port's NetworkX-order ingest.

Imports torch and numpy only (no JAX), so it runs where the port runs.

Usage:
  python tools/validate_port_vs_reference.py [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gnn_track_finding_tpu_torch.config import PipelineConfig  # noqa: E402
from gnn_track_finding_tpu_torch.data.event_cache import load_npz  # noqa: E402
from gnn_track_finding_tpu_torch.graph.build import build_event  # noqa: E402
from gnn_track_finding_tpu_torch.models import pipeline  # noqa: E402
from tools.validate_vs_reference import compare, load_digest  # noqa: E402

VOL7_NPZ = os.path.join(REPO, ".event_cache", "event_fafb3309e4598e9b.npz")


def compute_port_states(device: torch.device | str = "cpu",
                        path: str = VOL7_NPZ) -> dict:
    """The port's schedule to the iteration-2 boundary at float64, with
    the extraction leak of iteration 1 applied: every array `compare`
    reads (validate_vs_reference.compute_framework_states, with port
    calls).  The iterations are those of the shipped host driver
    (pipeline.driver_steps: host union-find CCA, leak replay)."""
    xyzr, vivl, tp, pairs, extra, _ = load_npz(path)
    cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                         max_volume=int(vivl[:, 0].max()))
    g, host = build_event(xyzr, vivl, tp, pairs, cfg, device=device,
                          node_ids=extra["node_ids"])
    g = pipeline.prepare(g, cfg)
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    out = {"remap": {int(n): i for i, n in enumerate(host.node_ids)},
           "src": src, "dst": dst,
           "seed_sv": g.seed_sv.cpu().numpy(),
           "seed_cov": g.seed_cov.cpu().numpy(),
           "edge_index": {(int(src[e]), int(dst[e])): e
                          for e in range(g.n_edges)}}

    steps = pipeline.driver_steps(g, cfg, tracker=host.tracker)
    it1 = next(steps)                   # after extraction 1 and its leak
    out["muts"] = {n: c for n, c in it1.mutations}
    out["has_merged"] = it1.graph.has_merged.cpu().numpy()
    out["merged_state"] = it1.graph.merged_state.cpu().numpy()
    out["merged_cov"] = it1.graph.merged_cov.cpu().numpy()

    it2 = next(steps).staged            # stage 2, before extraction 2
    steps.close()
    out["has_updated"] = it2.has_updated.cpu().numpy()
    out["upd_sv"] = it2.upd_sv.cpu().numpy()
    out["upd_joint"] = it2.upd_joint.cpu().numpy()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    res = compare(load_digest(), compute_port_states(args.device))
    return 0 if all(v == 1.0 for k, v in res.items()
                    if not k.endswith("_cmp")) else 1


if __name__ == "__main__":
    sys.exit(main())
