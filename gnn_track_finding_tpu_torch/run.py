"""Command-line runner of the port's production driver on one CUDA device.

Runs the three-iteration schedule on one event from an event cache
(.npz, data/event_cache.py) and prints the accepted candidates per
iteration, the FastSV round counts and the wall time; --stream N streams
N copies of the event (ingest included) and reports events/s.

Usage:
  python -m gnn_track_finding_tpu_torch.run --event .event_cache/<key>.npz
  python -m gnn_track_finding_tpu_torch.run --event <npz> --volumes 7 14 --f32
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
    parser.add_argument("--event", required=True, help="event cache (.npz)")
    parser.add_argument("--volumes", type=int, nargs=2, metavar=("MIN", "MAX"),
                        help="volume window the cache must have been built "
                             "for (default: the cache's own)")
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
    from gnn_track_finding_tpu_torch.data.event_cache import load_npz
    from gnn_track_finding_tpu_torch.graph.build import build_graph_state
    from gnn_track_finding_tpu_torch.models import pipeline

    device = torch.device("cuda")
    dtype = torch.float32 if args.f32 else torch.float64
    xyzr, vivl, tp, pairs, extra, pre = load_npz(args.event)
    window = (int(vivl[:, 0].min()), int(vivl[:, 0].max()))
    if args.volumes and tuple(args.volumes) != window:
        print(f"{args.event} holds volumes {window[0]}-{window[1]}, not "
              f"{args.volumes[0]}-{args.volumes[1]}", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(PipelineConfig(), min_volume=window[0],
                              max_volume=window[1])

    def build():
        return build_graph_state(xyzr, vivl, tp, pairs, cfg, device=device,
                                 dtype=dtype, mirror=pre["mirror"],
                                 component=pre["component"])

    t0 = time.perf_counter()
    g = build()
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"[load] {g.n_nodes} nodes, {g.n_edges} directed edges, "
          f"K={g.max_degree}, padded ({g.num_padded_nodes}, "
          f"{g.num_padded_edges}), {dtype} in {t_load:.2f}s")

    t0 = time.perf_counter()
    out = pipeline.run_pipeline_fast(g, cfg)
    t_pipe = time.perf_counter() - t0
    per_it = [sum(1 for c in out.candidates if c.iteration == i)
              for i in range(1, cfg.num_iterations + 1)]
    print(f"[pipeline] {len(out.candidates)} candidates {per_it} in "
          f"{t_pipe:.3f}s (first call, kernel build included); FastSV "
          f"rounds {out.cca_rounds}")

    if args.stream:
        t0 = time.perf_counter()
        n_cand = sum(len(r.candidates) for r in pipeline.stream_pipeline(
            (build() for _ in range(args.stream)), cfg))
        dt = time.perf_counter() - t0
        print(f"[stream] {args.stream} events in {dt:.2f}s = "
              f"{args.stream / dt:.2f} events/s ({n_cand} candidates)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
