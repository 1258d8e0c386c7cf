"""Stage and part profile of the schedule on one CUDA device.

The port's counterpart of the JAX package's profilers, as one module:
tools/profile_stages.py (per-stage device ms), profile_extract_parts.py,
profile_extrap_parts.py, profile_reweight_parts.py and profile_hot_parts.py
(the parts of extraction, message passing, the reweight tail and the
clustering wrapper around its kernel), profile_cca_ops.py (one FastSV
round), roofline.py (bytes against the HBM floor) and capture_trace.py (a
trace of one fused schedule).

It runs full_pipeline_results (models/pipeline.py) eagerly, stage by stage
and part by part, each part fed the state the schedule hands it in that
iteration (so iteration 3's extraction sees fewer live edges than
iteration 1's), and for every stage and part, in schedule order:

  device ms    the part captured once as a CUDA graph over a clone of its
               inputs (the eager run below is its warm-up), replayed
               between CUDA events, best of 3, with the L2 flushed before
               each replay (a 128 MiB write) and warm; a spin kernel ahead
               of the start event keeps the host's submission of the
               replay out of the time;
  launches     the device events (kernels, copies, memsets) of one replay
               under torch.profiler (utils/timing.busy_share), and among
               them the gmr_cluster, distinct_counts, kf_fit and row_merge
               kernels;
  kernel ms    the summed durations of those events: the replay's device
               time without the gaps between graph nodes, which in some
               replays add ~0.34 us a node and in others vanish (PERF.md);
  byte floor   compulsory bytes over 3.35 TB/s (H100 SXM data sheet): the
               storages that existed before the part and that one of its
               ops reads (a tensor handed to a CUDA kernel counts as read),
               plus the storages it creates and returns, counted in the
               eager run by `ByteCount`; the floor is per storage, so a
               part that reads a slice pays for the whole storage;
  share        byte floor / device ms;
  launch floor launches x the device cost of one node of a captured graph,
               measured once per run (`launch_node_ms`: a graph of 1,000
               one-element add_'s);
  rest         a stage's device ms less the sum of its parts: what no part
               accounts for (e.g. extraction's `processed` and `accepted`
               masks between its parts);
  bitwise      the captured part's output against its eager output.

The whole schedule, `full_pipeline_packed` (what pipeline.CapturedSchedule
captures), is the last row: the sum the stage rows are held to.  Each
captured graph is freed once it is timed.  On CPU tensors, which only the
tests use, each part is timed eagerly with time.perf_counter (`host_ms`)
and no device field is filled.

    python -m gnn_track_finding_tpu_torch.profile_stages [--dtype float32|float64]
        [--event full|volume7] [--batch B] [--trace DIR]

prints the table on stdout; stderr ends with one JSON record (the card's
name and power limit, every row).  --batch B adds the same rows on B
copies of the event rotated about the beam axis (testing.load_event) and
stacked as their union (graph/state.stack_events), beside the single
event; --trace DIR writes a Chrome trace of one replay of the event's
captured schedule and its readback, the driver's spans among its ranges
(utils/timing.trace).  It needs a CUDA device: without
one it exits 2 and prints no table.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from gnn_track_finding_tpu_torch import _build, testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph.state import (GraphState,
                                                     stack_events,
                                                     tensor_fields)
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             extract, extrapolate, metadata,
                                             priors)
from gnn_track_finding_tpu_torch.utils import timing

# H100 SXM data sheet, the rate PERF.md's kernel bounds use
HBM_BYTES_PER_S = 3.35e12
# written before a flushed replay to empty the 50 MB L2
L2_FLUSH_BYTES = 128 * 2**20
# about 1 ms of a spin kernel, enqueued ahead of each timed replay
SPIN_CYCLES = 2_000_000
LAUNCH_NODES = 1000
KERNELS = ("gmr_cluster", "distinct_counts", "kf_fit", "row_merge")
CACHE = Path(__file__).resolve().parents[1] / ".event_cache"
EVENTS = {"full": CACHE / "event_7bba1cb4ae95bca1.npz",
          "volume7": CACHE / "event_fafb3309e4598e9b.npz"}
CFG = PipelineConfig(min_volume=7, max_volume=14)   # the full event's


# ------------------------------------------------------------ byte count

def _tensors(x) -> List[torch.Tensor]:
    """The tensors of a part's inputs or outputs: a tensor, a GraphState,
    or tuples, lists and dicts of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (int, float, bool, str)) or x is None:
        return []
    if isinstance(x, GraphState):
        return [getattr(x, name) for name in tensor_fields()]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return _tensors(list(x.values()))
    return []


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return (t.device, s.data_ptr()), s.nbytes()


class ByteCount(TorchDispatchMode):
    """Compulsory bytes of a block, per storage: every aten op's tensor
    inputs whose storage the block did not create count as read, once per
    storage (views of one storage count once; ops that only make a view
    read nothing), and so does every tensor whose data_ptr() is taken (a
    kernel wrapper handing it to native code).  `total(out)` adds the
    storages the block created and returns.  Use as `with counter.on():`."""

    def __init__(self):
        super().__init__()
        self.read: Dict[tuple, int] = {}
        self.created = set()

    def note_read(self, t: torch.Tensor) -> None:
        key, nbytes = _storage(t)
        if key not in self.created and key not in self.read:
            self.read[key] = nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:                # aliases an input, reads nothing
            return out
        with torch._C.DisableTorchFunction():
            for t in _tensors((args, kwargs)):
                self.note_read(t)
            for t in _tensors(out):
                key, _ = _storage(t)
                if key not in self.read:
                    self.created.add(key)
        return out

    @contextlib.contextmanager
    def on(self):
        with _NativeReads(self), self:
            yield

    @property
    def read_bytes(self) -> int:
        return sum(self.read.values())

    def written_bytes(self, out) -> int:
        """The storages of `out` that the block created, once each."""
        seen = {}
        for t in _tensors(out):
            key, nbytes = _storage(t)
            if key in self.created:
                seen[key] = nbytes
        return sum(seen.values())

    def total(self, out) -> int:
        return self.read_bytes + self.written_bytes(out)


class _NativeReads(TorchFunctionMode):
    """Counts a tensor whose data_ptr() is taken as read (ByteCount)."""

    def __init__(self, counter: ByteCount):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.data_ptr:
            self.counter.note_read(args[0])
        return func(*args, **(kwargs or {}))


# ----------------------------------------------------------------- rows

@dataclasses.dataclass
class Row:
    level: str              # "stage", "part", "round" (inside a part, not
                            # summed) or "whole"
    name: str
    iteration: int          # 0: prepare and the whole schedule
    stage: str              # a part's stage; a stage's own name
    bytes: int              # compulsory bytes, per storage
    device_ms: Optional[float] = None       # one replay, L2 flushed
    warm_ms: Optional[float] = None         # one replay, L2 warm
    launches: Optional[int] = None          # device events of one replay
    kernel_ms: Optional[float] = None       # their summed durations
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    bitwise: Optional[bool] = None          # captured output == eager
    launch_floor_ms: Optional[float] = None
    host_ms: Optional[float] = None         # CPU tensors: eager wall
    rest_ms: Optional[float] = None         # a stage less its parts
    leaf: bool = True       # a part, or a stage without parts

    @property
    def floor_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def share(self) -> Optional[float]:
        return self.floor_ms / self.device_ms if self.device_ms else None

    @property
    def ms(self) -> Optional[float]:
        """device ms on a CUDA device, host ms on CPU tensors."""
        return self.device_ms if self.device_ms is not None else self.host_ms


def _clone(x):
    """x with every tensor cloned (GraphStates, tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, GraphState):
        return pipeline.clone_state(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def same_bits(a, b) -> bool:
    """Every tensor of a equal to b's bit for bit (NaN and -0.0 count)."""
    ta, tb = _tensors(a), _tensors(b)
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype in bits:
            x, y = x.view(bits[x.dtype]), y.view(bits[y.dtype])
        if not torch.equal(x, y):
            return False
    return True


def launch_node_ms(device) -> float:
    """The device time of one node of a captured graph: a graph of
    LAUNCH_NODES one-element add_'s, replayed, per node."""
    x = torch.zeros(1, device=device)
    x.add_(1)                                   # the warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCH_NODES):
            x.add_(1)
    graph.replay()
    torch.cuda.synchronize(device)
    return timing.replay_ms(graph, before=_spin) / LAUNCH_NODES


def _spin() -> None:
    torch.cuda._sleep(SPIN_CYCLES)


class Profiler:
    """Runs parts eagerly, in order, and measures each (`run`); `rows`
    holds what it measured."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.rows: List[Row] = []
        self.node_ms = None
        if self.cuda:
            _build.library()                  # nvcc outside any capture
            self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                     device=device)
            self.node_ms = launch_node_ms(device)

    def _flushed(self) -> None:
        self.flush.zero_()
        _spin()

    def run(self, level: str, name: str, fn, *args, iteration: int,
            stage: str = ""):
        """fn(*args) run eagerly under ByteCount -> its output; the row
        appended (on a CUDA device also captured, timed, profiled and held
        to the eager output)."""
        counter = ByteCount()
        with counter.on():
            out = fn(*args)
        row = Row(level, name, iteration, stage or name, counter.total(out),
                  leaf=level == "part")
        if not self.cuda:
            t0 = time.perf_counter()
            fn(*args)
            row.host_ms = (time.perf_counter() - t0) * 1e3
        else:
            self._measure(row, fn, args, out)
        self.rows.append(row)
        return out

    def _measure(self, row: Row, fn, args, out) -> None:
        """Capture fn over a clone of args (the eager run was the
        warm-up), replay, time, profile; the graph is freed on return."""
        inputs = _clone(args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static = fn(*inputs)
        graph.replay()
        torch.cuda.synchronize(self.device)
        row.bitwise = same_bits(static, out)
        row.warm_ms = timing.replay_ms(graph, before=_spin)
        row.device_ms = timing.replay_ms(graph, before=self._flushed)
        busy = timing.busy_share(graph.replay)
        row.launches = busy.events
        row.kernel_ms = sum(ms for _, ms in busy.ms_by_name)
        row.kernels = {k: sum(c for n, c in busy.count_by_name.items()
                              if k in n) for k in KERNELS}
        row.launch_floor_ms = row.launches * self.node_ms

    def stage(self, name: str, fn, *args, iteration: int, parts=None):
        """A stage row of fn(g, *rest), then (when given) its parts in
        order, parts(g) -> the stage's output composed from them, which the
        schedule goes on with."""
        out = self.run("stage", name, fn, *args, iteration=iteration)
        if parts is None:
            self.rows[-1].leaf = True
            return out
        return parts(args[0])


# ---------------------------------------------------------- the schedule

def _cluster_parts(p: Profiler, cfg: PipelineConfig, use_updated: bool,
                   i: int, stage: str):
    run = functools.partial(p.run, "part", iteration=i, stage=stage)

    def parts(g):
        x = run("clustering.core_inputs", clustering.core_inputs, g, cfg,
                use_updated)
        core = run("cluster_core (gmr_cluster)", functools.partial(
            cluster_kernel.cluster_core, chi2_thr=x.chi2_thr, cfg=cfg),
            x.states, x.tab, x.node_xyzr, x.klthr, x.count)
        g = run("scatter back + _apply_cluster_results",
                clustering.apply_core, g, x, core)
        return run("degree, weight, prior refresh", pipeline.cluster_refresh,
                   g, use_updated)
    return parts


def _extrapolation_parts(p: Profiler, cfg: PipelineConfig, i: int,
                         stage: str):
    run = functools.partial(p.run, "part", iteration=i, stage=stage)

    def parts(g):
        g = run("extrapolate.message_passing", extrapolate.message_passing,
                g, cfg)
        return run("reweight_stage x2 (distinct_counts)",
                   priors.reweight_stage, g, cfg, 2)
    return parts


def _fastsv(g: GraphState):
    return cca.connected_components_fixed(g, g.edge_mask & g.active)


def _extraction_parts(p: Profiler, cfg: PipelineConfig, i: int, stage: str,
                      rounds: list):
    """extract_candidates (FastSV labels) + apply_extraction, part by part
    (ops/extract.py); -> parts(g) -> (g, result)."""
    run = functools.partial(p.run, "part", iteration=i, stage=stage)
    h, min_hits = cfg.max_track_hits, cfg.min_track_hits

    def parts(g):
        labels, n_rounds, converged = run(
            f"FastSV, {cca.R_CAP} fixed rounds", _fastsv, g)
        rounds.append(n_rounds.tolist())        # read once, outside capture
        a, b, ok = cca._pairs(g, g.edge_mask & g.active)
        n = g.num_padded_nodes
        f1 = cca._first_round(a, b, ok, torch.arange(n, device=g.device), n)
        p.run("round", "FastSV, one round (cca._round)", cca._round, f1, a, b,
              ok, n, iteration=i, stage=stage)
        mat, size, row_of_node = run("_candidate_matrix",
                                     extract._candidate_matrix, g, labels, h,
                                     min_hits)
        coords_c, valid_c, n_hits, can_process, n_pairs = run(
            "merge_rows (row_merge)", extract.merge_rows, g, cfg, mat)
        processed = (size >= min_hits) & can_process & (n_hits >= min_hits)
        pval_xy, pval_zr = run("track_fit (kf_fit)", extract.track_fit,
                               coords_c, valid_c, n_hits, cfg)
        accepted = (processed & (pval_xy >= cfg.track_acceptance_pval)
                    & (pval_zr >= cfg.track_acceptance_pval))
        acc_count, acc_nodes, acc_pvals = run(
            "_accepted_heads", extract._accepted_heads, mat, accepted,
            torch.stack([pval_xy, pval_zr], dim=1), g.event_shape,
            g.num_padded_nodes // g.batch, min_hits)
        res = extract.ExtractionResult(
            labels=labels, row_of_node=row_of_node, cand_nodes=mat,
            cand_size=size, processed=processed, accepted=accepted,
            merged_pair=n_pairs, pval_xy=pval_xy, pval_zr=pval_zr,
            acc_count=acc_count, acc_nodes=acc_nodes, acc_pvals=acc_pvals,
            cca_rounds=n_rounds, cca_converged=converged)
        return run("apply_extraction", extract.apply_extraction, g, res,
                   cfg), res
    return parts


@dataclasses.dataclass
class Profile:
    rows: List[Row]
    graph: GraphState           # the final state, composed from the parts
    accepted: list              # accepted rows per iteration (per event on
                                # a batch)
    rounds: list                # FastSV's rounds per extraction
    launch_node_ms: Optional[float]
    device: str

    def stage_sum_ms(self, field: str = "ms") -> float:
        return sum(getattr(r, field) for r in self.rows if r.level == "stage")

    def whole(self) -> Row:
        return next(r for r in self.rows if r.level == "whole")

    def leaf_kernels(self) -> Dict[str, int]:
        """Kernel launches over the leaf rows, which partition the
        schedule (its packing aside)."""
        return {k: sum(r.kernels.get(k, 0) for r in self.rows if r.leaf)
                for k in KERNELS}

    def record(self) -> dict:
        return {"device": self.device, "launch_node_ms": self.launch_node_ms,
                "fastsv_rounds": self.rounds, "accepted": self.accepted,
                "stage_sum_ms": self.stage_sum_ms(),
                "stage_sum_kernel_ms": (self.stage_sum_ms("kernel_ms")
                                        if self.launch_node_ms else None),
                "rows": [dict(dataclasses.asdict(r), floor_ms=r.floor_ms,
                              share=r.share) for r in self.rows]}


def profile(g: GraphState, cfg: PipelineConfig) -> Profile:
    """The schedule of full_pipeline_results on g's device, stage by stage
    and part by part, each measured on the state the schedule hands it
    (module doc), then the whole of full_pipeline_packed.  -> the rows in
    schedule order, the final state and accepted counts the parts
    composed (equal to full_pipeline_results'), and FastSV's rounds."""
    p = Profiler(g.device)
    g_in = g
    g = p.stage("pipeline.prepare", pipeline.prepare, g, cfg, iteration=0)
    rounds, accepted = [], []
    for i in range(1, cfg.num_iterations + 1):
        if i % 2 == 0:
            name = "extrapolation_stage"
            g = p.stage(name, pipeline.extrapolation_stage, g, cfg,
                        iteration=i,
                        parts=_extrapolation_parts(p, cfg, i, name))
        else:
            use_updated = i > 1
            name = f"cluster_stage ({'updated' if use_updated else 'seed'})"
            g = p.stage(name, pipeline.cluster_stage, g, cfg, use_updated,
                        iteration=i,
                        parts=_cluster_parts(p, cfg, use_updated, i, name))
        name = "extract_candidates + apply_extraction"
        g, res = p.stage(name, pipeline.extract_only, g, cfg, iteration=i,
                         parts=_extraction_parts(p, cfg, i, name, rounds))
        accepted.append(res.acc_count.tolist())
        if i % 2 == 0:
            g = p.stage("metadata.remove_state_metadata",
                        metadata.remove_state_metadata, g, cfg, iteration=i)
    p.run("whole", "full_pipeline_packed (CapturedSchedule's body)",
          pipeline.full_pipeline_packed, g_in, cfg, iteration=0)
    for r in p.rows:
        if r.level == "stage" and not r.leaf:
            inside = [q.ms for q in p.rows if q.level == "part"
                      and q.iteration == r.iteration and q.stage == r.stage]
            r.rest_ms = r.ms - sum(inside)
    return Profile(rows=p.rows, graph=g, accepted=accepted, rounds=rounds,
                   launch_node_ms=p.node_ms, device=str(g.device))


# ------------------------------------------------------------------ table

def _f(v, spec=".4f") -> str:
    return "-" if v is None else format(v, spec)


def table(prof: Profile, label: str) -> List[str]:
    """The rows as text, one line each, in schedule order."""
    head = ("device ms" if prof.launch_node_ms is not None
            else "host ms (CPU tensors)")
    lines = [f"--- {label}: {head} (L2 flushed / warm), kernel ms, launches "
             f"({', '.join(KERNELS)}), compulsory MB, byte floor "
             f"ms, its share of the {head}, launch floor ms, rest ms",
             f"{'it':>2} {'level':6} {'name':44} {'ms':>9} {'warm':>9} "
             f"{'kernel':>9} {'launch':>6} {'k':>7} {'MB':>9} {'floor':>7} "
             f"{'share':>7} {'lfloor':>8} {'rest':>8}"]
    for r in prof.rows:
        name = {"part": "  ", "round": "  ("}.get(r.level, "") + r.name
        k = (",".join(str(r.kernels.get(kernel, 0)) for kernel in KERNELS)
             if r.kernels else "-")
        lines.append(
            f"{r.iteration:>2} {r.level:6} {name[:44]:44} {_f(r.ms):>9} "
            f"{_f(r.warm_ms):>9} {_f(r.kernel_ms):>9} "
            f"{_f(r.launches, 'd'):>6} {k:>7} {r.bytes / 1e6:>9.3f} "
            f"{r.floor_ms:>7.4f} {_f(r.share, '.2%'):>7} "
            f"{_f(r.launch_floor_ms):>8} {_f(r.rest_ms):>8}")
    whole = prof.whole()
    kernel = (f" (kernel ms {prof.stage_sum_ms('kernel_ms'):.4f} against "
              f"{whole.kernel_ms:.4f})" if whole.kernel_ms else "")
    lines.append(f"stage rows sum {prof.stage_sum_ms():.4f} ms against one "
                 f"replay of the whole schedule {_f(whole.ms)} ms{kernel}; "
                 f"FastSV rounds needed per extraction {prof.rounds} of "
                 f"{cca.R_CAP}; accepted {prof.accepted}; one graph node "
                 f"{_f(prof.launch_node_ms, '.6f')} ms")
    return lines


# ------------------------------------------------------------------- main

def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dtype", choices=("float32", "float64"),
                        default="float32")
    parser.add_argument("--event", choices=sorted(EVENTS), default="full")
    parser.add_argument("--batch", type=int, metavar="B",
                        help="also profile B rotated copies stacked as one "
                             "program")
    parser.add_argument("--trace", metavar="DIR",
                        help="write a Chrome trace of one captured replay "
                             "and its readback")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnn_track_finding_tpu_torch.profile_stages needs a CUDA "
              "device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    card = card_name()
    path = EVENTS[args.event]
    cfg = CFG if args.event == "full" else PipelineConfig(
        min_volume=7, max_volume=7)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"{args.event} event, {args.dtype}", flush=True)
    g = testing.load_event(path, cfg, device=dev, dtype=dtype)
    rec = {"card": card, "dtype": args.dtype, "event": args.event}
    runs = {"single event": g}
    if args.batch:
        runs[f"{args.batch} rotated copies stacked"] = stack_events(
            [testing.load_event(path, cfg, device=dev, dtype=dtype, copy=c,
                                copies=args.batch)
             for c in range(args.batch)])
    for label, gg in runs.items():
        t0 = time.perf_counter()
        prof = profile(gg, cfg)
        print("\n".join(table(prof, f"{label}, {args.event} event, "
                                    f"{args.dtype}")), flush=True)
        rec[label] = dict(prof.record(), seconds=time.perf_counter() - t0)
    if args.trace:
        prog = pipeline.CapturedSchedule(g, cfg)
        torch.cuda.synchronize(dev)
        with timing.trace(args.trace):
            prog.launch(g).result()
        rec["trace"] = f"{args.trace}/trace.json"
        print(f"Chrome trace of one captured replay and its readback: "
              f"{rec['trace']}")
    print(json.dumps({"profile_stages": rec}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
