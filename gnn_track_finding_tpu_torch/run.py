"""Command-line runner of the port on one CUDA device.

Runs the three-iteration schedule on one event and prints the accepted
candidates per iteration and the wall time.  The event comes from an
event cache (.npz, data/event_cache.py) or from the three TrackML CSV
files (data/trackml.py, through the C++ loader).  By default it runs the
parity host driver `run_pipeline` (host union-find CCA, extraction-leak
replay through the NetworkX-order tracker), the JAX runner's default;
--fast runs the production driver `run_pipeline_fast`.  --stream N
streams N copies of the event through the prefetch loader and
`stream_pipeline` (ingest included) and reports events/s.

Usage:
  python -m gnn_track_finding_tpu_torch.run --event .event_cache/<key>.npz
  python -m gnn_track_finding_tpu_torch.run --csv NODES EDGES TRUTH --volumes 7 14
  python -m gnn_track_finding_tpu_torch.run --event <npz> --fast --f32
  python -m gnn_track_finding_tpu_torch.run --event <npz> --stream 10
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--event", help="event cache (.npz)")
    source.add_argument("--csv", nargs=3, metavar=("NODES", "EDGES", "TRUTH"),
                        help="TrackML nodes, edges and truth-mapping CSVs")
    parser.add_argument("--volumes", type=int, nargs=2, metavar=("MIN", "MAX"),
                        help="volume window: filters the CSVs (default 7 7); "
                             "a cache must have been built for it (default: "
                             "the cache's own)")
    parser.add_argument("--fast", action="store_true",
                        help="production driver run_pipeline_fast (device "
                             "FastSV, no leak replay, no tracker)")
    parser.add_argument("--f32", action="store_true",
                        help="float32 compute (default float64, the parity mode)")
    parser.add_argument("--stream", type=int, default=0, metavar="N",
                        help="stream N copies of the event and report events/s")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("gnn_track_finding_tpu_torch.run needs a CUDA device",
              file=sys.stderr)
        return 2

    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.data import prefetch, trackml
    from gnn_track_finding_tpu_torch.data.event_cache import load_npz
    from gnn_track_finding_tpu_torch.graph.build import build_event
    from gnn_track_finding_tpu_torch.models import pipeline

    device = torch.device("cuda")
    dtype = torch.float32 if args.f32 else torch.float64
    with_tracker = not args.fast
    if args.event:
        xyzr, vivl, tp, pairs, extra, pre = load_npz(args.event)
        window = (int(vivl[:, 0].min()), int(vivl[:, 0].max()))
        if args.volumes and tuple(args.volumes) != window:
            print(f"{args.event} holds volumes {window[0]}-{window[1]}, not "
                  f"{args.volumes[0]}-{args.volumes[1]}", file=sys.stderr)
            return 2
        cfg = dataclasses.replace(PipelineConfig(), min_volume=window[0],
                                  max_volume=window[1])

        def build(tracker: bool):
            return build_event(xyzr, vivl, tp, pairs, cfg, device=device,
                               dtype=dtype, mirror=pre["mirror"],
                               component=pre["component"],
                               node_ids=extra["node_ids"],
                               with_tracker=tracker)
    else:
        cfg = PipelineConfig()
        if args.volumes:
            cfg = dataclasses.replace(cfg, min_volume=args.volumes[0],
                                      max_volume=args.volumes[1])
        paths = trackml.TrackMLPaths(*args.csv)

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

    t0 = time.perf_counter()
    if args.fast:
        out = pipeline.run_pipeline_fast(g, cfg)
    else:
        out = pipeline.run_pipeline(g, cfg, tracker=host.tracker)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    per_it = [sum(1 for c in out.candidates if c.iteration == i)
              for i in range(1, cfg.num_iterations + 1)]
    driver = "run_pipeline_fast" if args.fast else "run_pipeline"
    print(f"[pipeline] {driver}: {len(out.candidates)} candidates {per_it} "
          f"in {t_pipe:.3f}s (first call, kernel build included); FastSV "
          f"rounds {out.cca_rounds}")

    if args.stream:
        loader = prefetch.prefetch(
            [lambda: build(False)[0] for _ in range(args.stream)])
        t0 = time.perf_counter()
        n_cand = sum(len(r.candidates)
                     for r in pipeline.stream_pipeline(loader, cfg))
        dt = time.perf_counter() - t0
        print(f"[stream] {args.stream} events in {dt:.2f}s = "
              f"{args.stream / dt:.2f} events/s ({n_cand} candidates)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
