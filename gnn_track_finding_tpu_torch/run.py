"""Command-line runner of the port on one CUDA device.

Runs the iterative schedule on one event and prints the accepted
candidates per iteration and the wall time.  The event comes from an
event cache (.npz, data/event_cache.py), from the three TrackML CSV
files (data/trackml.py, through the C++ loader), or, with --toy, from
the toy generator (50 tracks, seed 1; the toy efficiency and the count of
pure candidates follow).  By default it runs the parity host driver
`run_pipeline` (host union-find CCA, extraction-leak replay through the
NetworkX-order tracker), the JAX runner's default; --fast runs the
production driver `run_pipeline_fast`, which captures the schedule of the
event's pad bucket as one CUDA graph at its first call and replays it
(as does --stream).  --calibrate fits a KL-threshold LUT (quantile rule
on emp_var) on 20 toy events (seed 0) and hands the event's per-node
thresholds to `run_pipeline`.  --particles with --csv
adds the TrackML efficiency report.  --stream N streams N copies of the
event through the prefetch loader and `stream_pipeline` (ingest
included) and reports events/s.  --json prints one JSON summary line
last: nodes, edges, candidates and pipeline_seconds, with pure (--toy) or
the efficiency keys (--particles); with --stream, events, events_per_s
and candidates of the stream.

Usage:
  python -m gnn_track_finding_tpu_torch.run --event .event_cache/<key>.npz
  python -m gnn_track_finding_tpu_torch.run --toy
  python -m gnn_track_finding_tpu_torch.run --event <npz> --calibrate
  python -m gnn_track_finding_tpu_torch.run --csv NODES EDGES TRUTH --volumes 7 14
  python -m gnn_track_finding_tpu_torch.run --csv NODES EDGES TRUTH --particles PARTICLES
  python -m gnn_track_finding_tpu_torch.run --event <npz> --fast --f32
  python -m gnn_track_finding_tpu_torch.run --event <npz> --stream 10
  python -m gnn_track_finding_tpu_torch.run --toy --json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--event", help="event cache (.npz)")
    source.add_argument("--csv", nargs=3, metavar=("NODES", "EDGES", "TRUTH"),
                        help="TrackML nodes, edges and truth-mapping CSVs")
    source.add_argument("--toy", action="store_true",
                        help="a toy event (50 tracks, seed 1)")
    parser.add_argument("--particles", metavar="CSV",
                        help="TrackML particles CSV (with --csv): report "
                             "the reconstruction efficiency")
    parser.add_argument("--calibrate", action="store_true",
                        help="fit a KL-threshold LUT on 20 toy events and "
                             "use its per-node thresholds in clustering")
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--volumes", type=int, nargs=2, metavar=("MIN", "MAX"),
                        help="volume window: filters the CSVs (default 7 7); "
                             "a cache must have been built for it (default: "
                             "the cache's own)")
    parser.add_argument("--fast", action="store_true",
                        help="production driver run_pipeline_fast (the "
                             "schedule captured as one CUDA graph, device "
                             "FastSV, no leak replay, no tracker)")
    parser.add_argument("--f32", action="store_true",
                        help="float32 compute (default float64, the parity mode)")
    parser.add_argument("--stream", type=int, default=0, metavar="N",
                        help="stream N copies of the event and report events/s")
    parser.add_argument("--json", action="store_true",
                        help="print one JSON summary line last")
    args = parser.parse_args(argv)
    if args.particles and not args.csv:
        parser.error("--particles needs --csv")

    import torch
    if not torch.cuda.is_available():
        print("gnn_track_finding_tpu_torch.run needs a CUDA device",
              file=sys.stderr)
        return 2

    from gnn_track_finding_tpu_torch.calib import lut, training_data
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.data import event_cache, prefetch, trackml
    from gnn_track_finding_tpu_torch.evaluation import efficiency
    from gnn_track_finding_tpu_torch.graph.build import build_event
    from gnn_track_finding_tpu_torch.models import pipeline, toymc

    device = torch.device("cuda")
    dtype = torch.float32 if args.f32 else torch.float64
    with_tracker = not args.fast
    base = PipelineConfig(num_iterations=args.iterations)
    if args.toy:
        cfg = dataclasses.replace(base, node_bucket=256, edge_bucket=1024)
        ev = toymc.generate_event(num_tracks=50, seed=1)

        def build(tracker: bool):
            return build_event(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                               device=device, dtype=dtype,
                               with_tracker=tracker)
    elif args.event:
        xyzr, vivl, tp, pairs, extra, pre = event_cache.load_npz(args.event)
        window = (int(vivl[:, 0].min()), int(vivl[:, 0].max()))
        if args.volumes and tuple(args.volumes) != window:
            print(f"{args.event} holds volumes {window[0]}-{window[1]}, not "
                  f"{args.volumes[0]}-{args.volumes[1]}", file=sys.stderr)
            return 2
        cfg = dataclasses.replace(base, min_volume=window[0],
                                  max_volume=window[1])

        def build(tracker: bool):
            return build_event(xyzr, vivl, tp, pairs, cfg, device=device,
                               dtype=dtype, mirror=pre["mirror"],
                               component=pre["component"],
                               node_ids=extra["node_ids"],
                               with_tracker=tracker,
                               hit_particle_ids=event_cache.hit_particle_ids(
                                   extra))
    else:
        cfg = base
        if args.volumes:
            cfg = dataclasses.replace(cfg, min_volume=args.volumes[0],
                                      max_volume=args.volumes[1])
        paths = trackml.TrackMLPaths(*args.csv, particles_csv=args.particles)

        def build(tracker: bool):
            return trackml.load_event(paths, cfg, device=device, dtype=dtype,
                                      with_tracker=tracker)

    t0 = time.perf_counter()
    g, host = build(with_tracker)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"[load] {g.n_nodes} nodes, {g.n_edges} directed edges, "
          f"K={g.max_degree}, padded ({g.num_padded_nodes}, "
          f"{g.num_padded_edges}), {dtype} in {t_load:.2f}s"
          + (" (tracker built)" if with_tracker else ""))

    kl_thresholds = None
    if args.calibrate:
        t0 = time.perf_counter()
        rows = training_data.generate_training_data(num_events=20, seed=0,
                                                    device=device, dtype=dtype)
        table = lut.fit_lut_quantile(rows, feature="emp_var")
        kl_thresholds = lut.node_thresholds(table, g, cfg)
        print(f"[calib] quantile LUT fit on {rows.shape[0]} pairs in "
              f"{time.perf_counter() - t0:.2f}s; thresholds "
              f"[{float(kl_thresholds.min()):.3g}, "
              f"{float(kl_thresholds.max()):.3g}]")

    t0 = time.perf_counter()
    if args.fast and kl_thresholds is None:
        out = pipeline.run_pipeline_fast(g, cfg)
        driver = "run_pipeline_fast"
    else:
        out = pipeline.run_pipeline(g, cfg, kl_thresholds=kl_thresholds,
                                    tracker=host.tracker)
        driver = "run_pipeline"
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    per_it = [sum(1 for c in out.candidates if c.iteration == i)
              for i in range(1, cfg.num_iterations + 1)]
    print(f"[pipeline] {driver}: {len(out.candidates)} candidates {per_it} "
          f"in {t_pipe:.3f}s (first call, kernel build and any capture "
          f"included); FastSV "
          f"rounds {out.cca_rounds}")
    summary = {"nodes": g.n_nodes, "edges": g.n_edges,
               "candidates": len(out.candidates), "pipeline_seconds": t_pipe}

    if args.toy:
        lists = [c.nodes for c in out.candidates]
        rep = efficiency.evaluate_toy(lists, ev.truth, ev.vivl, cfg)
        pure = efficiency.pure_candidates(lists, ev.truth)
        print(f"[eval] reference tracks: {rep.num_reference}, reconstructed: "
              f"{rep.num_reconstructed}, efficiency: "
              f"{rep.efficiency_pct:.3f}%; pure candidates: "
              f"{pure}/{len(out.candidates)}")
        summary["pure"] = pure
    elif args.particles:
        rep = efficiency.evaluate([c.nodes for c in out.candidates], host,
                                  args.particles, args.csv[2], cfg)
        print(f"[eval] reference tracks: {rep.num_reference}, reconstructed: "
              f"{rep.num_reconstructed}, efficiency: "
              f"{rep.efficiency_pct:.3f}%")
        if len(rep.track_purities):
            print(f"[eval] mean track purity {rep.track_purities.mean():.3f}, "
                  f"mean particle purity {rep.particle_purities.mean():.3f}")
        summary.update(efficiency_pct=rep.efficiency_pct,
                       num_reference=rep.num_reference,
                       num_reconstructed=rep.num_reconstructed)

    if args.stream:
        loader = prefetch.prefetch(
            [lambda: build(False)[0] for _ in range(args.stream)])
        t0 = time.perf_counter()
        n_cand = sum(len(r.candidates)
                     for r in pipeline.stream_pipeline(loader, cfg))
        dt = time.perf_counter() - t0
        print(f"[stream] {args.stream} events in {dt:.2f}s = "
              f"{args.stream / dt:.2f} events/s ({n_cand} candidates)")
        summary = {"events": args.stream, "events_per_s": args.stream / dt,
                   "candidates": n_cand}
    if args.json:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
