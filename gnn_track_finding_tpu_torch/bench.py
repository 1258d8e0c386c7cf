"""Benchmark of the port on one CUDA device: the counterpart of the JAX
package's bench.py, on the full TrackML event.

Prints two JSON lines on stdout, {"metric", "value", "unit",
"vs_baseline"}, in bench.py's order:

  full_pipeline_seconds_full_event        seconds per whole three-iteration
      schedule: N_FULL back-to-back launches of the event's captured
      program (models/pipeline.CapturedSchedule, what run_pipeline_fast
      replays), the clock stopped when the last launch's packed readback
      has landed; no candidate is unpacked inside the clock, as JAX's loop
      reads back one scalar;
  message_passing_edges_per_s_full_event  directed edges over the time of
      one extrapolation iteration (message passing and the two-pass
      reweight), from N_REP replays of one captured extrapolation_stage
      that hands its state from replay to replay, as JAX's fori_loop does.

The event is .event_cache/event_7bba1cb4ae95bca1.npz (volumes 7-14:
55,701 nodes, 330,944 directed edges, padded to N = 57,344, E = 344,064,
K = 64), at float32 by default, as bench.py times it; --dtype float64 is
the parity mode, whose metric names end in _float64.  Each metric is
timed REPEATS times in one process and the median printed.  stderr gets
the card (nvidia-smi's name and power limit), the load, capture and
instantiate seconds, every repeat, run_pipeline_fast's wall (which also
unpacks the candidates in Python), the streamed events/s through
data/prefetch.prefetch (ingest included) and the peak device memory; its
last line is all of that as one JSON record.

Before any metric line, the kernel gate holds both CUDA kernels against
their plain versions on the event's own inputs and the accepted counts
against the reference's (float64) or the eager schedule's (float32).  A
failed gate, build, capture or stream raises: the process exits non-zero
and prints no metric line.  Without CUDA it exits 2.

    python -m gnn_track_finding_tpu_torch.bench [--dtype float64]

--pileup B is the counterpart of the JAX package's tools/bench_pileup.py:
after the kernel gate, B copies of the full event (copy b rotated about
the beam axis by b * 2 pi / B: the same graph, other floats) run N_FULL
times as B single-event replays in turn and as one replay of the
batch's program (graph/state.stack_events), each replay read back before
the next; stderr gets bench_pileup's three records
(sequential and batched s/event and events/s with their checksums, the
accepted candidates over all runs, and the speedup), then one JSON
record.  It prints no metric line.

    python -m gnn_track_finding_tpu_torch.bench --pileup 4 [--dtype float64]
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from gnn_track_finding_tpu_torch import _build
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import event_cache, prefetch
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import GraphState, tensor_fields
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             distinct_kernel, extrapolate,
                                             priors)

# The reference Python pipeline's wall clock on a CPU, one process, at
# volumes 7-14 (BASELINE.md, "Full event (volumes 7-14)" and round-3
# sections); neither is a number taken on an accelerator.  330,944
# directed edges / 119 s of its extrapolation stage:
REF_EDGES_PER_S = 2781.0
# its whole three-iteration schedule, start of clustering to the end of
# the last extraction:
REF_FULL_PIPELINE_S = 743.0

FULL_EVENT = (Path(__file__).resolve().parents[1] / ".event_cache"
              / "event_7bba1cb4ae95bca1.npz")
CFG = PipelineConfig(min_volume=7, max_volume=14)
EXPECTED_F64 = [1504, 436, 9]   # the reference's accepted counts per iteration
N_REP = 40          # extrapolation iterations per timing (bench.py's)
N_FULL = 3          # schedules per timing (bench.py's)
REPEATS = 5         # timings per metric; the median is printed
FLIP_SHARE = 0.06   # float32: found-flag flips allowed, as a share of rows


class GateError(RuntimeError):
    """A kernel disagrees with its plain version, or a count is off."""


def log(*args) -> None:
    print("[bench]", *args, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_event(path, cfg: PipelineConfig, *, device, dtype) -> GraphState:
    """The event's GraphState from its cache, with the cached set()-order
    mirror and components."""
    xyzr, vivl, tp, pairs, _, pre = event_cache.load_npz(path)
    return build_graph_state(xyzr, vivl, tp, pairs, cfg, device=device,
                             dtype=dtype, mirror=pre["mirror"],
                             component=pre["component"])


def load_rotated(path, cfg: PipelineConfig, copy: int, copies: int, *,
                 device, dtype) -> GraphState:
    """The event with every hit rotated about the beam axis by
    copy * 2 pi / copies in (x, y) (r as cached): the same graph, other
    floats, so that `copies` such events make a batch of distinct
    events of one pad bucket; copy 0 is the event itself."""
    xyzr, vivl, tp, pairs, _, pre = event_cache.load_npz(path)
    if copy:
        phi = 2.0 * math.pi * copy / copies
        c, s = math.cos(phi), math.sin(phi)
        xyzr = xyzr.astype(np.float64, copy=True)
        x, y = xyzr[:, 0].copy(), xyzr[:, 1].copy()
        xyzr[:, 0] = c * x - s * y
        xyzr[:, 1] = s * x + c * y
    return build_graph_state(xyzr, vivl, tp, pairs, cfg, device=device,
                             dtype=dtype, mirror=pre["mirror"],
                             component=pre["component"])


def per_iteration(out: pipeline.PipelineResult, cfg: PipelineConfig) -> list:
    return [sum(1 for c in out.candidates if c.iteration == i)
            for i in range(1, cfg.num_iterations + 1)]


# ------------------------------------------------------- message passing

class LoopResult(NamedTuple):
    seconds: float          # per iteration
    checksum: int           # final.active.sum(), bench.py's checksum
    final: GraphState


def clustered(g: GraphState, cfg: PipelineConfig) -> GraphState:
    """Iteration 1's clustering without its extraction: the state the
    message-passing loop starts from (bench.py:83-86)."""
    return pipeline.cluster_stage(pipeline.prepare(g, cfg), cfg, False)


class CapturedStage(pipeline.CapturedGraph):
    """One extrapolation_stage captured as a CUDA graph whose body ends by
    copying its output state into its own input tensors, so each replay
    advances the state by one iteration (the body of JAX's fori_loop).
    Built as CapturedSchedule is (the kernels first, then
    CapturedGraph._capture); `kernel_launches` holds the kernel launches
    captured, which every replay makes."""

    def __init__(self, g: GraphState, cfg: PipelineConfig):
        _build.library()                      # nvcc outside the capture
        self.inputs = {name: getattr(g, name).clone()
                       for name in tensor_fields()}
        static = g.replace(n_nodes=0, n_edges=0, **self.inputs)

        def body():
            # a stage returns new tensors for the fields it changes (a
            # GraphState is immutable by convention), so each copy reads
            # memory that no earlier copy wrote
            out = pipeline.extrapolation_stage(static, cfg)
            for name, t in self.inputs.items():
                new = getattr(out, name)
                if new is not t:
                    t.copy_(new)

        self._capture(body, g)

    def run(self, g: GraphState, n_rep: int) -> LoopResult:
        """g's state copied in, then n_rep replays on a host clock that
        ends in torch.cuda.synchronize()."""
        for name, t in self.inputs.items():
            t.copy_(getattr(g, name))
        torch.cuda.synchronize(g.device)
        t0 = time.perf_counter()
        for _ in range(n_rep):
            self.graph.replay()
        torch.cuda.synchronize(g.device)
        seconds = (time.perf_counter() - t0) / n_rep
        final = pipeline.clone_state(g.replace(**self.inputs))
        return LoopResult(seconds, int(final.active.sum()), final)


def message_passing_loop(g: GraphState, cfg: PipelineConfig,
                         n_rep: int = N_REP,
                         captured: CapturedStage | None = None) -> LoopResult:
    """n_rep extrapolation_stage calls threaded through one state, from the
    clustered state g (bench.py:62-97).  On a CUDA device the replays of a
    CapturedStage (`captured`, or one captured for this call); on CPU
    tensors the stage run eagerly."""
    if g.device.type == "cuda":
        return (captured or CapturedStage(g, cfg)).run(g, n_rep)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        g = pipeline.extrapolation_stage(g, cfg)
    return LoopResult((time.perf_counter() - t0) / n_rep,
                      int(g.active.sum()), g)


def program_record(prog: pipeline.CapturedGraph) -> dict:
    """A captured program's record: what its capture cost (its Capture)
    and the kernel launches each replay makes."""
    cap = prog.capture
    return {"warmup_s": cap.warmup_s, "record_s": cap.record_s,
            "instantiate_s": cap.instantiate_s,
            "pool_gib": cap.pool_bytes / 2**30,
            "graph_nodes": cap.graph_nodes,
            "launches_per_replay": prog.kernel_launches}


# ----------------------------------------------------------- full schedule

class FullResult(NamedTuple):
    seconds: float          # per schedule
    accepted: int           # accepted candidates over the n_full schedules
    counts: list            # per iteration, the last schedule's


def full_pipeline_seconds(g: GraphState, cfg: PipelineConfig,
                          n_full: int = N_FULL) -> FullResult:
    """n_full whole schedules back to back (bench.py:99-131).  On a CUDA
    device launches of the event's captured program, the clock stopped
    when the last launch's packed readback has landed (the candidates are
    unpacked after it); on CPU tensors run_pipeline_eager."""
    if g.device.type == "cuda":
        prog = pipeline.captured_program(g, cfg)
        torch.cuda.synchronize(g.device)
        t0 = time.perf_counter()
        pending = [prog.launch(g) for _ in range(n_full)]
        pending[-1].slot.copied.synchronize()
        seconds = time.perf_counter() - t0
        results = [p.result() for p in pending]
    else:
        t0 = time.perf_counter()
        results = [pipeline.run_pipeline_eager(g, cfg) for _ in range(n_full)]
        seconds = time.perf_counter() - t0
    return FullResult(seconds / n_full,
                      sum(len(r.candidates) for r in results),
                      per_iteration(results[-1], cfg))


# ----------------------------------------------------------------- pileup

def pileup(graphs: List[GraphState], cfg: PipelineConfig,
           n_rep: int = N_FULL) -> dict:
    """tools/bench_pileup.py's comparison on the graphs' device: the B
    events n_rep times as B single-event runs in turn
    (pipeline.run_pipeline_fast) and as one batched run
    (pipeline.run_pipeline_batched: the events stacked and dispatched as
    one program), each run read back before the next starts; both
    dispatch on the device (on a CUDA device replays of the captured
    programs, captured in one warm-up run of each before the clocks).
    Checksums: the accepted candidates over all runs, the same on both
    paths.  -> the record."""
    b = len(graphs)

    def seq():
        return [pipeline.run_pipeline_fast(g, cfg)
                for _ in range(n_rep) for g in graphs]

    def par():
        return [r for _ in range(n_rep)
                for r in pipeline.run_pipeline_batched(graphs, cfg)]

    def timed(run):
        t0 = time.perf_counter()
        out = run()
        return time.perf_counter() - t0, out

    pipeline.run_pipeline_fast(graphs[0], cfg)
    pipeline.run_pipeline_batched(graphs, cfg)
    t_seq, out_seq = timed(seq)
    t_par, out_par = timed(par)
    per_event = lambda outs: [len(r.candidates) for r in outs[:b]]
    rec = {"batch": b, "repeats": n_rep,
           "sequential_s_per_event": t_seq / (b * n_rep),
           "batched_s_per_event": t_par / (b * n_rep),
           "sequential_checksum": sum(len(r.candidates) for r in out_seq),
           "batched_checksum": sum(len(r.candidates) for r in out_par),
           "candidates_per_event": per_event(out_seq)}
    rec["sequential_events_per_s"] = 1.0 / rec["sequential_s_per_event"]
    rec["batched_events_per_s"] = 1.0 / rec["batched_s_per_event"]
    rec["speedup"] = t_seq / t_par
    if (rec["sequential_checksum"] != rec["batched_checksum"]
            or per_event(out_par) != rec["candidates_per_event"]):
        raise GateError(f"batched candidates {per_event(out_par)} differ "
                        f"from sequential {rec['candidates_per_event']}")
    return rec


def pileup_lines(rec: dict) -> List[str]:
    """bench_pileup's three records."""
    return [f"[pileup] sequential {rec['sequential_s_per_event']:.6f} s/event "
            f"({rec['sequential_events_per_s']:.4f} events/s, checksum "
            f"{rec['sequential_checksum']})",
            f"[pileup] batched(B={rec['batch']}) "
            f"{rec['batched_s_per_event']:.6f} s/event "
            f"({rec['batched_events_per_s']:.4f} events/s, checksum "
            f"{rec['batched_checksum']})",
            f"[pileup] batching speedup x{rec['speedup']:.4f}"]


# ------------------------------------------------------------ kernel gate

def _close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float,
           equal_nan: bool) -> bool:
    return bool(torch.isclose(a, b, rtol=rtol, atol=atol,
                              equal_nan=equal_nan).all())


def compare_cluster(inputs: tuple, *, chi2_thr: float, cfg: PipelineConfig,
                    kernel=cluster_kernel.cluster_core,
                    plain=cluster_kernel.cluster_core_plain,
                    require_merged: bool = True,
                    label: str = "gmr_cluster") -> dict:
    """`kernel` against `plain` on one round's compacted rows (inputs:
    states, tab, node_xyzr, klthr and optionally the live count; rows past
    it come out not found from both): bitwise at float64; at float32
    found-flag flips under FLIP_SHARE of the rows, and the merged values
    of the rows both find within rtol 1e-5 (NaN equal to NaN only at
    float64).  -> the agreement; raises
    GateError."""
    want = plain(*inputs, chi2_thr=chi2_thr, cfg=cfg)
    got = kernel(*inputs, chi2_thr=chi2_thr, cfg=cfg)
    rows = inputs[1].shape[0]
    both = got[0] & want[0]
    live = inputs[4] if len(inputs) > 4 and inputs[4] is not None else rows
    stats = {"rows": rows, "live": int(live), "found": int(got[0].sum()),
             "found_plain": int(want[0].sum()),
             "flips": int((got[0] != want[0]).sum()),
             "deact_diffs": int((got[4] != want[4]).sum()),
             "max_abs_diff": max(
                 float((a[both] - b[both]).abs().nan_to_num().max())
                 if both.any() else 0.0
                 for a, b in zip(got[1:4], want[1:4]))}
    if require_merged and not both.any():
        raise GateError(f"{label}: no row merged; {stats}")
    if inputs[2].dtype == torch.float64:
        ok = (stats["flips"] == 0 and stats["deact_diffs"] == 0
              and all(_close(a, b, 0.0, 0.0, True)
                      for a, b in zip(got[1:4], want[1:4])))
        bar = "bitwise at float64"
    else:
        ok = (stats["flips"] < FLIP_SHARE * max(rows, 1)
              and all(_close(a[both], b[both], 1e-5, 1e-7, False)
                      for a, b in zip(got[1:4], want[1:4])))
        bar = (f"float32: flips under {FLIP_SHARE:.0%} of the rows, merged "
               "values within rtol 1e-5")
    if not ok:
        raise GateError(f"{label} disagrees with its plain version ({bar}): "
                        f"{stats}")
    return stats


def _distinct_plain(ok: torch.Tensor, x: torch.Tensor,
                    node_x: torch.Tensor) -> torch.Tensor:
    return distinct_kernel.distinct_counts_plain(ok, x, x < node_x[:, None],
                                                 x.dtype)


def compare_distinct(ok: torch.Tensor, x: torch.Tensor, node_x: torch.Tensor,
                     *, kernel=distinct_kernel.distinct_counts,
                     plain=_distinct_plain) -> dict:
    """`kernel` against `plain` on one (N, K) reweight table: exact.
    -> the agreement; raises GateError."""
    got = kernel(ok, x, node_x)
    want = plain(ok, x, node_x)
    stats = {"rows": ok.shape[0], "ok_slots": int(ok.sum()),
             "count_sum": int(want.sum()),
             "diffs": int((got != want).sum())}
    if not torch.equal(got, want):
        raise GateError(f"distinct_counts disagrees with its plain version: "
                        f"{stats}")
    return stats


def kernel_gate(g: GraphState, cfg: PipelineConfig,
                expected: List[int] | None = None) -> dict:
    """Both kernels against their plain versions on g's own inputs
    (bench.py:133-160, which only logs): gmr_cluster on the seed round's
    rows of the prepared state, distinct_counts on iteration 2's first
    reweight table; then run_pipeline_fast's accepted counts per
    iteration against `expected`, or, when None, against
    run_pipeline_eager's.  -> the agreement; raises GateError."""
    prepared = pipeline.prepare(g, cfg)
    x = clustering.core_inputs(prepared, cfg, False)
    cluster = compare_cluster(
        (x.states, x.tab, x.node_xyzr, x.klthr, x.count), chi2_thr=x.chi2_thr,
        cfg=cfg, label="gmr_cluster, seed round")
    g2, _ = pipeline.iteration(prepared, cfg, 1)
    distinct = compare_distinct(
        *priors.distinct_inputs(extrapolate.message_passing(g2, cfg)))
    counts = per_iteration(pipeline.run_pipeline_fast(g, cfg), cfg)
    want = expected if expected is not None else per_iteration(
        pipeline.run_pipeline_eager(g, cfg), cfg)
    if counts != list(want):
        raise GateError(f"accepted counts {counts}, expected {list(want)}")
    return {"gmr_cluster": cluster, "distinct_counts": distinct,
            "accepted": counts}


# ----------------------------------------------------------------- stream

def stream_rate(path, cfg: PipelineConfig, *, device, dtype, n_ev: int = 10,
                depth: int = 2) -> dict:
    """n_ev copies of the event through stream_pipeline, each ingested
    (npz read, build_graph_state on the device) by data/prefetch.prefetch
    up to `depth` ahead (bench.py:162-188): events/s, ingest included."""
    device = torch.device(device)
    factories = [lambda: load_event(path, cfg, device=device, dtype=dtype)
                 ] * n_ev
    t0 = time.perf_counter()
    outs = list(pipeline.stream_pipeline(
        prefetch.prefetch(factories, depth=depth), cfg))
    _sync(device)
    seconds = time.perf_counter() - t0
    return {"events": n_ev, "seconds": seconds, "events_per_s": n_ev / seconds,
            "candidates": [len(o.candidates) for o in outs]}


# ------------------------------------------------------------------- main

def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _spread(values: list) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "all": values}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dtype", choices=("float32", "float64"),
                        default="float32",
                        help="working dtype (float64: the parity mode, the "
                             "counts pinned to the reference's)")
    parser.add_argument("--pileup", type=int, metavar="B",
                        help="after the gate, B rotated copies of the event "
                             "run in turn and as one batched program "
                             "(tools/bench_pileup.py); no metric line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnn_track_finding_tpu_torch.bench needs a CUDA device "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    f64 = dtype == torch.float64
    suffix = "_float64" if f64 else ""
    card = card_name()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"{args.dtype}")
    rec = {"card": card, "dtype": args.dtype}
    fallbacks = pipeline.fallbacks
    pipeline.reset_kernel_launches()

    t0 = time.perf_counter()
    _build.library()
    rec["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = load_event(FULL_EVENT, CFG, device=dev, dtype=dtype)
    _sync(dev)
    rec["load_s"] = time.perf_counter() - t0
    log(f"kernels built or found in {rec['build_s']:.3f} s; loaded "
        f"{g.n_nodes} nodes / {g.n_edges} directed edges (padded "
        f"{g.num_padded_nodes} / {g.num_padded_edges}, K {g.max_degree}) "
        f"in {rec['load_s']:.3f} s")

    rec["gate"] = kernel_gate(g, CFG, EXPECTED_F64 if f64 else None)
    log(f"kernel gate passed: {json.dumps(rec['gate'])}")
    if args.pileup:
        graphs = [g] + [load_rotated(FULL_EVENT, CFG, c, args.pileup,
                                     device=dev, dtype=dtype)
                        for c in range(1, args.pileup)]
        rec["pileup"] = pileup(graphs, CFG)
        for line in pileup_lines(rec["pileup"]):
            print(line, file=sys.stderr, flush=True)
        if pipeline.fallbacks != fallbacks:
            raise GateError("an event fell back to the host driver")
        rec["peak_allocated_gib"] = (torch.cuda.max_memory_allocated(dev)
                                     / 2**30)
        print(json.dumps({"bench": rec}), file=sys.stderr, flush=True)
        return 0
    prog = pipeline.captured_program(g, CFG)
    rec["schedule_program"] = program_record(prog)
    log(f"schedule program: {rec['schedule_program']}")

    per_event = sum(rec["gate"]["accepted"])
    full = [full_pipeline_seconds(g, CFG) for _ in range(REPEATS)]
    for r in full:
        if r.accepted != N_FULL * per_event:
            raise GateError(f"{N_FULL} schedules accepted {r.accepted}, "
                            f"expected {N_FULL} x {per_event}")
    rec["full_pipeline_s"] = _spread([r.seconds for r in full])
    log(f"full schedule, {N_FULL} launches per timing, s per schedule: "
        f"{rec['full_pipeline_s']}")

    walls = []
    for _ in range(REPEATS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        pipeline.run_pipeline_fast(g, CFG)
        walls.append(time.perf_counter() - t0)
    rec["run_pipeline_fast_s"] = _spread(walls)
    log(f"run_pipeline_fast wall (readback and Python unpack of "
        f"{per_event} candidates included), best of {REPEATS}: "
        f"{min(walls):.6f} s; {walls}")

    g1 = clustered(g, CFG)
    stage = CapturedStage(g1, CFG)
    rec["stage_program"] = program_record(stage)
    log(f"extrapolation stage program: {rec['stage_program']}")
    loops = [message_passing_loop(g1, CFG, N_REP, stage)
             for _ in range(REPEATS)]
    if len({r.checksum for r in loops}) != 1:
        raise GateError(f"message-passing checksums differ between "
                        f"repeats: {[r.checksum for r in loops]}")
    rec["iteration_s"] = _spread([r.seconds for r in loops])
    rec["checksum"] = loops[0].checksum
    log(f"extrapolation iteration, {N_REP} replays per timing, s: "
        f"{rec['iteration_s']}; checksum {rec['checksum']}")

    rec["stream"] = stream_rate(FULL_EVENT, CFG, device=dev, dtype=dtype)
    if rec["stream"]["candidates"] != [per_event] * rec["stream"]["events"]:
        raise GateError(f"streamed events' candidates "
                        f"{rec['stream']['candidates']}, expected "
                        f"{per_event} each")
    log(f"stream of {rec['stream']['events']} events (prefetch depth 2, "
        f"ingest included): {rec['stream']['events_per_s']:.4f} events/s")
    if pipeline.fallbacks != fallbacks:
        raise GateError("an event fell back to the host driver")

    rec["peak_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    rec["launches"] = pipeline.kernel_launches()
    log(f"peak device memory allocated {rec['peak_allocated_gib']:.3f} GiB; "
        f"kernel launches outside replays {rec['launches']}")
    print(json.dumps({"bench": rec}), file=sys.stderr, flush=True)

    dt_full = rec["full_pipeline_s"]["median"]
    edges_per_s = g.n_edges / rec["iteration_s"]["median"]
    print(json.dumps({"metric": f"full_pipeline_seconds_full_event{suffix}",
                      "value": dt_full, "unit": "s",
                      "vs_baseline": REF_FULL_PIPELINE_S / dt_full}))
    print(json.dumps({
        "metric": f"message_passing_edges_per_s_full_event{suffix}",
        "value": edges_per_s, "unit": "edges/s",
        "vs_baseline": edges_per_s / REF_EDGES_PER_S}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
