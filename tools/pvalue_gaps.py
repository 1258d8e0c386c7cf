"""Per-candidate p-value gaps between the port and the JAX package, at
float64 on the CPU.

Runs each package's own `run_pipeline` on the same seeded toy events (and,
with --event, on an event cache) and prints, for each run, the largest
relative difference of `pval_xy` and of `pval_zr` and the candidate it
belongs to.  The candidates are compared in order; the run stops if the
two packages accept different node sets.

The gaps are the JAX side's compiled fit: XLA:CPU's LLVM backend contracts
the unrolled Kalman fit into fused multiply-adds, which the port's op by op
fit does not.  Run again with the JAX backend's optimisation off to see
them collapse:

    JAX_PLATFORMS=cpu python tools/pvalue_gaps.py
    XLA_FLAGS=--xla_backend_optimization_level=0 JAX_PLATFORMS=cpu \\
        python tools/pvalue_gaps.py --event .event_cache/event_fafb3309e4598e9b.npz
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build  # noqa: E402
from gnn_track_finding_tpu.models import pipeline as jax_pipeline  # noqa: E402
from gnn_track_finding_tpu.models import toymc as jax_toymc  # noqa: E402

from gnn_track_finding_tpu_torch.config import PipelineConfig  # noqa: E402
from gnn_track_finding_tpu_torch.data.event_cache import load_npz  # noqa: E402
from gnn_track_finding_tpu_torch.graph.build import build_graph_state  # noqa: E402
from gnn_track_finding_tpu_torch.models import pipeline  # noqa: E402


def gaps(label, build_args, cfg_kw, pre=None):
    """Print the largest relative p-value gap of one event's run."""
    jg, _ = jax_build(*build_args, JaxConfig(**cfg_kw),
                      precomputed=pre or {})
    ref = jax_pipeline.run_pipeline(jg, JaxConfig(**cfg_kw))
    kw = {} if pre is None else dict(mirror=pre["mirror"],
                                     component=pre["component"])
    g = build_graph_state(*build_args, PipelineConfig(**cfg_kw),
                          device="cpu", **kw)
    out = pipeline.run_pipeline(g, PipelineConfig(**cfg_kw))
    nodes = lambda r: [c.nodes.tolist() for c in r.candidates]
    if nodes(out) != nodes(ref):
        raise SystemExit(f"{label}: the packages accept different candidates")
    for name in ("pval_xy", "pval_zr"):
        a = np.array([getattr(c, name) for c in out.candidates])
        b = np.array([getattr(c, name) for c in ref.candidates])
        rel = np.abs(a - b) / np.abs(b)
        i = int(np.argmax(rel))
        print(f"{label} {name}: {len(a)} candidates, max relative gap "
              f"{rel[i]:.3e} at candidate {i} (iteration "
              f"{out.candidates[i].iteration}, {len(out.candidates[i].nodes)} "
              f"nodes): port {a[i]!r}, JAX {b[i]!r}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=list(range(8)))
    parser.add_argument("--tracks", type=int, nargs="+", default=[12, 20])
    parser.add_argument("--event", help="also an event cache (.npz)")
    args = parser.parse_args()
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    toy_cfg = dict(node_bucket=64, edge_bucket=256)
    for tracks in args.tracks:
        for seed in args.seeds:
            ev = jax_toymc.generate_event(num_tracks=tracks, seed=seed)
            gaps(f"toy {tracks} tracks seed {seed}",
                 (ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs), toy_cfg)
    if args.event:
        xyzr, vivl, tp, pairs, _, pre = load_npz(args.event)
        window = dict(min_volume=int(vivl[:, 0].min()),
                      max_volume=int(vivl[:, 0].max()))
        gaps(Path(args.event).name, (xyzr, vivl, tp, pairs), window, pre)


if __name__ == "__main__":
    main()
