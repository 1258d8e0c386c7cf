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

`--trace I` (with --event) follows candidate I of the event's run through
both packages' extraction stage by stage, from the port's staged state and
labels, and prints the first rotation intermediate that differs and the
port's fit on the JAX package's rotated coordinates:

    XLA_FLAGS=--xla_backend_optimization_level=0 python tools/pvalue_gaps.py \\
        --seeds --event .event_cache/event_fafb3309e4598e9b.npz --trace 1035
"""

from __future__ import annotations

import argparse
import math
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


def trace(build_args, cfg_kw, pre, target: int) -> None:
    """Candidate `target` of the port's run_pipeline through both packages'
    extraction intermediates, on the port's staged state and labels."""
    import jax.numpy as jnp
    import torch

    from gnn_track_finding_tpu.graph.state import GraphState as JaxState
    from gnn_track_finding_tpu.ops import extract as jax_extract
    from gnn_track_finding_tpu_torch.ops import extract

    cfg, jcfg = PipelineConfig(**cfg_kw), JaxConfig(**cfg_kw)
    g = pipeline.prepare(build_graph_state(
        *build_args, cfg, device="cpu", mirror=pre["mirror"],
        component=pre["component"]), cfg)
    seen = 0
    for step in pipeline.driver_steps(g, cfg):
        if seen + len(step.candidates) > target:
            break
        seen += len(step.candidates)
    else:
        raise SystemExit(f"the run accepts only {seen} candidates")
    s, res = step.staged, step.result
    row = int(torch.nonzero(res.accepted).squeeze(1)[target - seen])
    jg = JaxState(n_nodes=s.n_nodes, n_edges=s.n_edges,
                  max_degree=s.max_degree, n_layers=s.n_layers,
                  **{k: jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                    else a) for k, a in s.to_numpy().items()})
    h = cfg.max_track_hits
    mat, _, _ = extract._candidate_matrix(s, res.labels, h, cfg.min_track_hits)
    jmat, jsize, _ = jax_extract._candidate_matrix(
        jg, jnp.asarray(res.labels.numpy().astype(np.int32)), h,
        cfg.min_track_hits)
    coords, valid, _, _ = extract._proximity_merge(s, cfg, mat)
    jcoords, jvalid, _, _ = jax_extract._proximity_merge(jg, jcfg, jmat,
                                                         jsize)
    print(f"candidate {target}: iteration {step.iteration}, row {row}, "
          f"nodes {mat[row][mat[row] >= 0].tolist()}; candidate rows equal "
          f"{np.array_equal(np.asarray(jmat)[row], mat[row].numpy())}, "
          f"merged coordinates equal "
          f"{np.array_equal(np.asarray(jcoords)[row], coords[row].numpy())}")
    n = int(valid[row].sum())
    hits = coords[row][valid[row]]                  # radius order kept
    p1, p2a, p3 = hits[n - 1], hits[n - 2], hits[n - 3]
    dd = p1[:3] - p2a[:3]
    d = torch.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    p2 = p3 if d < cfg.separation_3d_threshold else p2a
    # each op as the port's fit runs it: over the whole (C,) column (the
    # SIMD kernels), then this row's entry; JAX on the same inputs
    col = lambda v: torch.full((mat.shape[0],), float(v), dtype=torch.float64)
    for plane, (yy, xx) in (("xy", (p2[1] - p1[1], p2[0] - p1[0])),
                            ("zr", (p2[2] - p1[2], p2[3] - p1[3]))):
        ang = float(torch.atan2(col(yy), col(xx))[0])
        jang = float(jnp.arctan2(jnp.float64(yy), jnp.float64(xx)))
        print(f"angle_{plane}: port {ang!r} (one element: "
              f"{float(torch.atan2(yy, xx))!r}), JAX {jang!r}, "
              f"libm {math.atan2(float(yy), float(xx))!r}")
    # the port's fit on the JAX package's rotated coordinates
    c, hh = jvalid.shape
    rank = jnp.cumsum(jvalid, axis=1) - 1
    perm = jvalid[:, :, None] & (rank[:, :, None] == jnp.arange(hh)[None, None])
    jc = jnp.einsum("cij,cik->cjk", perm.astype(jcoords.dtype), jcoords)
    jn = jnp.sum(jvalid, axis=1)
    jrot = jax_extract._rotate_tracks(jc, jnp.arange(hh)[None] < jn[:, None],
                                      jn, jcfg)
    one = torch.from_numpy(np.array(jrot[row:row + 1]))
    nh = torch.tensor([n])
    pv = [float(p[0]) for p in extract._kf_fit(one, nh, cfg)]
    print(f"port fit on the JAX rotation: pval_xy {pv[0]!r}, pval_zr "
          f"{pv[1]!r}; port run {step.candidates[target - seen].pval_zr!r}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="*",
                        default=list(range(8)))
    parser.add_argument("--tracks", type=int, nargs="+", default=[12, 20])
    parser.add_argument("--event", help="also an event cache (.npz)")
    parser.add_argument("--trace", type=int,
                        help="follow this candidate of --event's run")
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
        if args.trace is not None:
            trace((xyzr, vivl, tp, pairs), window, pre, args.trace)
        else:
            gaps(Path(args.event).name, (xyzr, vivl, tp, pairs), window, pre)


if __name__ == "__main__":
    main()
