"""The full iterative track-finding schedule on one torch device.

Port of `gnn_track_finding_tpu.models.pipeline` (pipeline.py:34-506).
The schedule of the reference (run_gnn_trackml_mod.sh:71-148):

  prepare            : seed states, activation, priors, weights, degrees
  iteration 1        : clustering on seed states (chi2=1.0, KL=2.0)
  iteration 2        : extrapolation message passing + double reweight
  iteration 3        : clustering on updated states (chi2=1000, KL=100)
  after every iter   : candidate extraction (CCA + KF fit)
  after even iters   : state-metadata pruning

`group` / `routing` (JAX pipeline.py:34-149) run a stage, an iteration or
the whole schedule edge-partitioned: each rank of the group holds its
block of the edge arrays and calls the same function
(parallel/edge_shard.py).  With group=None every function is the
single-device one.  The edge-partitioned schedule is the same static
program: on an NCCL group with CUDA tensors each rank captures it, its
collectives inside, as one CUDA graph per (pad bucket, routing bucket,
group) (`CapturedSchedule` with a group, replayed by
edge_shard.run_sharded).

Two drivers run it.  `run_pipeline_fast` / `stream_pipeline` (production)
run `full_pipeline_packed`: every shape is static and nothing between
`prepare` and the return is read on the host (FastSV in cca.R_CAP fixed
rounds, the gated clustering rows and the accepted heads compacted into
static tables, the counts left on the device), and the results come back
as one flat buffer in JAX's layout.  On a CUDA device that program is
captured once per pad bucket as one CUDA graph (`CapturedSchedule`) and
replayed per event; on the CPU it runs eagerly.  An event whose accepted
count exceeds extract.ACC_PULL_CAP, or whose FastSV needed more than
R_CAP rounds, is rerun by the exact host driver, as JAX's falls back.
`run_pipeline` (parity) takes the extraction's CCA labels from the host
union-find and, given the event's NetworkX-order tracker, replays the
reference's extraction-time coordinate leak between an extraction and the
next stage.

The fast drivers' host work is marked by spans (utils/timing.span, which
record only while torch.profiler runs), each named `pipeline.<part>`:
`stack` (stack_events of a batch), `launch` (a replay enqueued: its
children `copy_in`, `replay`, `clone_out`, `unstack`), `wait` (the
readback's event) and `unpack` (unpack_packed; its child `fallback`, the
exact rerun of an overflowed event).  Each dispatch takes a number from
one counter: the `event` of its stack and launch spans; its wait and
unpack spans carry (dispatch, row).  Every capture appends what it cost
to `captures`.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Iterable, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gnn_track_finding_tpu_torch import _build
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import native_loader
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph.state import (
    GraphState, stack_events, tensor_fields, unstack_events)
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             distinct_kernel, extract,
                                             extrapolate, fit_kernel,
                                             merge_kernel, metadata, priors,
                                             seeding)
from gnn_track_finding_tpu_torch.utils.timing import span


def prepare(g: GraphState, cfg: PipelineConfig, group=None) -> GraphState:
    """Event-conversion tail (event_conversion.py:92-101)."""
    g = seeding.seed_track_states(g, cfg, group)
    g = priors.initialize_edge_activation(g)
    g = priors.compute_prior_probabilities(g, use_updated=False, group=group)
    g = priors.compute_mixture_weights(g, use_updated=False, group=group)
    return priors.update_degrees(g, group)


def cluster_stage(g: GraphState, cfg: PipelineConfig, use_updated: bool,
                  kl_thresholds: torch.Tensor | None = None,
                  group=None, routing=None) -> GraphState:
    """Clustering iteration incl. the weight/prior recompute and degree
    update (clustering.py:323-327,372-373)."""
    g = clustering.cluster(g, cfg, use_updated, kl_thresholds, group=group,
                           routing=routing)
    return cluster_refresh(g, use_updated, group)


def cluster_refresh(g: GraphState, use_updated: bool, group=None
                    ) -> GraphState:
    """The degree, weight and prior refresh that ends a clustering
    iteration (clustering.py:323-327,372-373)."""
    g = priors.update_degrees(g, group)
    g = priors.compute_mixture_weights(g, use_updated, group)
    return priors.compute_prior_probabilities(g, use_updated, group)


def extrapolation_stage(g: GraphState, cfg: PipelineConfig, group=None,
                        routing=None) -> GraphState:
    """Extrapolation iteration: message passing, then the double
    prior/reweight and degree refresh (extrapolate_merged_states.py:
    554-566): table-resident on one device, two prior_reweight passes
    under a group (JAX pipeline.py:68-86)."""
    g = extrapolate.message_passing(g, cfg, group)
    if group is None:
        return priors.reweight_stage(g, cfg, n_passes=2)
    g = priors.prior_reweight(g, cfg, group, routing)
    g = priors.prior_reweight(g, cfg, group, routing)
    return priors.update_degrees(g, group)


def stage_step(g: GraphState, cfg: PipelineConfig, i: int,
               kl_thresholds: torch.Tensor | None = None,
               group=None, routing=None) -> GraphState:
    """The pre-extraction stage of iteration i (schedule in module doc)."""
    if i % 2 == 0:
        return extrapolation_stage(g, cfg, group, routing)
    return cluster_stage(g, cfg, use_updated=i > 1,
                         kl_thresholds=kl_thresholds, group=group,
                         routing=routing)


def metadata_step(g: GraphState, cfg: PipelineConfig, group=None,
                  routing=None) -> GraphState:
    """State-metadata pruning (JAX pipeline.py:114-125): the table-resident
    pass on one device; under a group the same semantics through the
    collective-aware passes."""
    if group is None:
        return metadata.remove_state_metadata(g, cfg)
    g = g.replace(has_updated=g.has_updated & g.edge_mask)
    g = priors.compute_prior_probabilities(g, use_updated=False, group=group)
    g = priors.prior_reweight(g, cfg, group, routing)
    return priors.update_degrees(g, group)


def extract_only(g: GraphState, cfg: PipelineConfig,
                 labels: torch.Tensor | None = None, group=None
                 ) -> Tuple[GraphState, extract.ExtractionResult]:
    """Extraction + candidate-node removal, no metadata pruning (JAX
    pipeline.py:105-111)."""
    res = extract.extract_candidates(g, cfg, labels, group=group)
    return extract.apply_extraction(g, res, cfg), res


def extract_step(g: GraphState, cfg: PipelineConfig, i: int, group=None,
                 routing=None) -> Tuple[GraphState, extract.ExtractionResult]:
    """Extraction + node removal + (even iterations) metadata pruning."""
    g, res = extract_only(g, cfg, group=group)
    if i % 2 == 0:
        g = metadata_step(g, cfg, group, routing)
    return g, res


def iteration(g: GraphState, cfg: PipelineConfig, i: int,
              kl_thresholds: torch.Tensor | None = None,
              group=None, routing=None
              ) -> Tuple[GraphState, extract.ExtractionResult]:
    """One full iteration: stage, extraction + node removal, and (even
    iterations) metadata pruning."""
    g = stage_step(g, cfg, i, kl_thresholds, group, routing)
    return extract_step(g, cfg, i, group, routing)


def reset_reactivate(g: GraphState, cfg: PipelineConfig) -> GraphState:
    """Brute-force reset of a remaining network (clustering.py:126-146,
    the '-r' CLI flag; JAX pipeline.py:152-161): drop merged and updated
    states, reactivate every surviving edge, re-seed and recompute
    priors and weights."""
    g = g.replace(has_merged=torch.zeros_like(g.has_merged),
                  has_updated=torch.zeros_like(g.has_updated))
    return prepare(g, cfg)


class ScheduleResults(NamedTuple):
    """One event's results; on a stacked batch of B events every field but
    `graph` (the union's state) has a leading (B,) axis."""
    graph: GraphState
    acc_count: torch.Tensor     # (I,) accepted candidates per iteration
    acc_nodes: torch.Tensor     # (I, cap, H) accepted heads, -1 padded
    acc_pvals: torch.Tensor     # (I, cap, 2) their (pval_xy, pval_zr)
    cca_rounds: torch.Tensor    # (I,) FastSV rounds per extraction
    overflow: torch.Tensor      # (I,) bool: count over the cap, or FastSV
                                # still changing labels after R_CAP rounds
    path: str = "eager"         # how it ran: "eager", "captured" (a CUDA
                                # graph's replay) or "exact" (the fallback);
                                # one per event on a sharded stack (a tuple,
                                # edge_shard.run_sharded)


def full_pipeline_results(g: GraphState, cfg: PipelineConfig, group=None,
                          routing=None) -> ScheduleResults:
    """The whole schedule (JAX pipeline.py:288-312), every per-iteration
    result stacked and left on the device: nothing from `prepare` on is
    read on the host, so this is the program a CUDA graph captures (under
    a group: the results the same on every rank, the graph the rank's
    block).  On a stacked batch (g.batch = B > 1) the per-event results
    stack to (B, I, ...)."""
    g = prepare(g, cfg, group)
    res = []
    for i in range(1, cfg.num_iterations + 1):
        g, r = iteration(g, cfg, i, group=group, routing=routing)
        res.append(r)
    # iterations stack after the batch axis, if any
    axis = len(g.event_shape)
    stack = lambda name: torch.stack([getattr(r, name) for r in res], axis)
    counts = stack("acc_count")
    acc_nodes = stack("acc_nodes")
    return ScheduleResults(
        graph=g, acc_count=counts, acc_nodes=acc_nodes,
        acc_pvals=stack("acc_pvals"), cca_rounds=stack("cca_rounds"),
        overflow=(counts > acc_nodes.shape[-2]) | ~stack("cca_converged"))


def exact_results(out: "PipelineResult") -> ScheduleResults:
    """A host-driver run (run_pipeline with device FastSV) as
    ScheduleResults: every accepted row in the heads, whose cap rises to
    the largest count when that is over ACC_PULL_CAP; nothing overflows."""
    rows = [extract.accepted_rows(r) for r in out.per_iteration]
    first = out.per_iteration[0].cand_nodes
    cap = max([min(extract.ACC_PULL_CAP, first.shape[0])]
              + [n.shape[0] for n, _ in rows])
    n_it, dev = len(rows), first.device
    nodes = torch.full((n_it, cap, first.shape[1]), -1, dtype=first.dtype,
                       device=dev)
    pvals = torch.zeros((n_it, cap, 2), dtype=rows[0][1].dtype, device=dev)
    for it, (nd, pv) in enumerate(rows):
        nodes[it, :nd.shape[0]] = nd
        pvals[it, :pv.shape[0]] = pv
    return ScheduleResults(
        graph=out.graph,
        acc_count=torch.tensor([n.shape[0] for n, _ in rows], device=dev),
        acc_nodes=nodes, acc_pvals=pvals,
        cca_rounds=torch.tensor(out.cca_rounds, device=dev),
        overflow=torch.zeros(n_it, dtype=torch.bool, device=dev),
        path="exact")


def full_pipeline(g: GraphState, cfg: PipelineConfig):
    """The whole schedule -> (final graph, accepted (I, C), cand_nodes
    (I, C, H)), stacked on the device (JAX pipeline.py:491-506)."""
    g = prepare(g, cfg)
    accepted, cand_nodes = [], []
    for i in range(1, cfg.num_iterations + 1):
        g, res = iteration(g, cfg, i)
        accepted.append(res.accepted)
        cand_nodes.append(res.cand_nodes)
    return g, torch.stack(accepted), torch.stack(cand_nodes)


def _words(values, like: torch.Tensor) -> torch.Tensor:
    """A (len(values),) int32 tensor of python ints, written on the device
    (no host-to-device copy, so it can be captured)."""
    out = torch.empty(len(values), dtype=torch.int32, device=like.device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def pack_results(counts: torch.Tensor, nodes: torch.Tensor,
                 pvals: torch.Tensor, narrow: bool) -> torch.Tensor:
    """Pack (counts (I,), nodes (I, cap, L) -1 padded, pvals (I, cap, 2))
    into one flat int32 tensor whose bytes are JAX's uint32 words
    (pipeline.py:339-364): a [cap, track_len, narrow, pv_wide] header, the
    counts, the node ids (uint16 pairs when narrow, -1 -> sentinel 0xFFFF,
    an odd count padded with one sentinel; int32 otherwise) and the
    p-values' raw bits (float64 as two little-endian words each, anything
    else as float32).  unpack_results is its inverse.  With leading batch
    axes (counts (B, I), ...) each event packs to its own row of words,
    (B, words)."""
    *lead, n_it, cap, track_len = nodes.shape
    rows = int(np.prod(lead))
    flat = nodes.reshape(rows, -1).to(torch.int64)
    if narrow:
        # the low 16 bits as the int16 of the same bit pattern
        lo = ((flat & 0xFFFF) ^ 0x8000) - 0x8000
        nd = lo.to(torch.int16)
        if nd.shape[1] % 2:
            nd = torch.cat([nd, torch.full((rows, 1), -1, dtype=torch.int16,
                                           device=nd.device)], dim=1)
        nd32 = nd.view(torch.int32)
    else:
        nd32 = flat.to(torch.int32)
    pv_wide = pvals.dtype == torch.float64
    pv = pvals.reshape(rows, -1)
    pv32 = pv.view(torch.int32) if pv_wide else \
        pv.to(torch.float32).view(torch.int32)
    header = _words([cap, track_len, int(narrow), int(pv_wide)], nodes)
    return torch.cat([header.expand(rows, 4),
                      counts.reshape(rows, n_it).to(torch.int32), nd32, pv32],
                     dim=1).reshape(*lead, -1)


def unpack_results(buf: np.ndarray, n_it: int):
    """Host-side inverse of pack_results (JAX pipeline.py:367-390) over the
    buffer's words (uint32 or int32) -> (counts (I,), nodes (I, cap, L)
    int32, pvals (I, cap, 2), sentinel): node entries equal to `sentinel`
    are padding."""
    buf = np.ascontiguousarray(buf).view(np.uint32)
    cap, track_len, narrow, pv_wide = (int(buf[0]), int(buf[1]),
                                       bool(buf[2]), bool(buf[3]))
    counts = buf[4:4 + n_it].astype(np.int64)
    n_nd = n_it * cap * track_len
    off = 4 + n_it
    if narrow:
        nd32 = buf[off:off + (n_nd + 1) // 2]
        nodes = nd32.view(np.uint16)[:n_nd].astype(np.int32)
        sentinel = 0xFFFF
        off += (n_nd + 1) // 2
    else:
        nodes = np.ascontiguousarray(buf[off:off + n_nd]).view(np.int32)
        sentinel = -1
        off += n_nd
    nodes = nodes.reshape(n_it, cap, track_len)
    pv_dtype = np.float64 if pv_wide else np.float32
    pvals = np.ascontiguousarray(buf[off:]).view(pv_dtype) \
        .reshape(n_it, cap, 2)
    return counts, nodes, pvals, sentinel


def packed_words(res: ScheduleResults) -> torch.Tensor:
    """The whole host readback of full_pipeline_results in one flat int32
    tensor (JAX pipeline.py:322-336): pack_results' layout, then the
    FastSV rounds (I,) and the overflow flags (I,), one word each; on a
    stacked batch one such row per event, (B, words), each in the layout
    of the event's own run (narrow ids when one event's nodes fit)."""
    g = res.graph
    narrow = g.num_padded_nodes // g.batch <= 0xFFFF   # ids < sentinel
    return torch.cat([
        pack_results(res.acc_count, res.acc_nodes, res.acc_pvals, narrow),
        res.cca_rounds.to(torch.int32), res.overflow.to(torch.int32)], dim=-1)


def full_pipeline_packed(g: GraphState, cfg: PipelineConfig
                         ) -> Tuple[GraphState, torch.Tensor]:
    """full_pipeline_results with its readback packed (packed_words) ->
    (final graph, packed); the graph stays on the device."""
    res = full_pipeline_results(g, cfg)
    return res.graph, packed_words(res)


@dataclasses.dataclass
class Candidate:
    nodes: np.ndarray      # graph node indices
    iteration: int
    pval_xy: float
    pval_zr: float


@dataclasses.dataclass
class PipelineResult:
    graph: GraphState
    candidates: List[Candidate]
    per_iteration: list
    cca_rounds: List[int] = dataclasses.field(default_factory=list)
    # run_pipeline with a tracker: the leak replay's mutations per extraction
    mutations: list = dataclasses.field(default_factory=list)


# Events the fast drivers reran through the exact host driver (an accepted
# count over the cap, or FastSV unconverged after R_CAP rounds)
fallbacks = 0

# the fast drivers' dispatch numbers (the `event` of their spans)
_DISPATCHES = itertools.count()


def unpack_packed(g_in: GraphState, g_out: GraphState, buf: np.ndarray,
                  cfg: PipelineConfig, event=None) -> PipelineResult:
    """Candidates from full_pipeline_packed's buffer read back to the host
    (JAX pipeline.py:393-414).  An event that overflowed is rerun by
    run_pipeline with device FastSV (its adaptive loop and exact pulls),
    on g_in's device, and counted in `fallbacks`.  event: the (dispatch,
    row) its spans serve."""
    global fallbacks
    with span("pipeline.unpack", event):
        n_it = cfg.num_iterations
        words = np.ascontiguousarray(buf).view(np.uint32)
        rounds = words[-2 * n_it:-n_it].astype(np.int64)
        overflow = words[-n_it:] != 0
        counts, nodes, pvals, sentinel = unpack_results(words[:-2 * n_it],
                                                        n_it)
        if overflow.any():              # a count over the cap, or FastSV
            fallbacks += 1
            with span("pipeline.fallback", event):
                return run_pipeline(g_in, cfg, host_cca=False)
        # One gather of the live ids per iteration, cut at the rows'
        # cumulative lengths: each candidate's nodes are a view of it (the
        # views do not overlap; nothing writes to them).  Positional
        # arguments: with keywords the dataclass's __init__ costs 1.4-1.9
        # times as much a call (CPython 3.12).
        candidates: List[Candidate] = []
        for it, k in enumerate(counts.tolist(), start=1):
            block = nodes[it - 1, :k]
            live = block != sentinel
            flat = block[live].astype(np.int64)
            ends = np.cumsum(live.sum(axis=1)).tolist()
            candidates += [Candidate(flat[a:b], it, xy, zr)
                           for a, b, (xy, zr) in zip(
                               [0] + ends, ends, pvals[it - 1, :k].tolist())]
        return PipelineResult(graph=g_out, candidates=candidates,
                              per_iteration=[], cca_rounds=rounds.tolist())


def run_pipeline_eager(g: GraphState, cfg: PipelineConfig) -> PipelineResult:
    """full_pipeline_packed run op by op on g's device, then the readback:
    the fast drivers' path on the CPU, and what the captured program is
    held to on the card."""
    dispatch = next(_DISPATCHES)
    g_out, packed = full_pipeline_packed(g, cfg)
    g_out = g_out.replace(n_nodes=g.n_nodes, n_edges=g.n_edges)
    return unpack_packed(g, g_out, packed.cpu().numpy(), cfg, (dispatch, 0))


# ---------------------------------------------------------------- capture

def program_key(g: GraphState, cfg: PipelineConfig, group=None,
                routing=None) -> tuple:
    """What a captured program depends on: the device, dtype and pad
    bucket (padded N and E, K, layers), the events stacked in it and the
    config, never the events' true sizes (the counterpart of JAX's
    _normalize_static, pipeline.py:438-449), plus the head cap and the
    FastSV rounds; under
    an edge partition also the group, its size, this rank, the backend
    and the routing's bucket (its all_to_all split)."""
    key = (g.device, g.dtype, g.num_padded_nodes, g.num_padded_edges,
           g.max_degree, g.n_layers, g.batch, cfg, extract.ACC_PULL_CAP,
           cca.R_CAP)
    if group is None:
        return key
    return key + (group, dist.get_world_size(group), dist.get_rank(group),
                  dist.get_backend(group), routing.bucket)


def _routing_tensors(routing) -> dict:
    """The tensors of an OwnerRouting (parallel/edge_shard.py) by field."""
    return {f.name: getattr(routing, f.name)
            for f in dataclasses.fields(routing)
            if isinstance(getattr(routing, f.name), torch.Tensor)}


class _Slot:
    """A pinned host buffer for one replay's packed readback (one row per
    event of a batch), the CUDA event recorded after its copy, and the
    events whose results have not been read from it yet."""

    def __init__(self, like: torch.Tensor):
        self.buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        self.copied = torch.cuda.Event()
        self.unread = 0


def kernel_launches() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    return {"gmr_cluster": cluster_kernel.cluster_core.launches,
            "distinct_counts": distinct_kernel.distinct_counts.launches,
            "kf_fit": fit_kernel.chi2_sums.launches,
            "row_merge": merge_kernel.merge_rows.launches}


def reset_kernel_launches() -> None:
    """Every kernel wrapper's launch counter set to 0."""
    cluster_kernel.cluster_core.launches = 0
    distinct_kernel.distinct_counts.launches = 0
    fit_kernel.chi2_sums.launches = 0
    merge_kernel.merge_rows.launches = 0


class Capture(NamedTuple):
    """What one capture (CapturedSchedule._capture) cost."""
    bucket: tuple           # the inputs' (padded N, padded E, K, B)
    warmup_s: float         # the eager warm-up, to its end on the device
    record_s: float         # torch.cuda.graph's block: the device
                            # synchronised, the body recorded, the
                            # capture ended
    instantiate_s: float    # the graph's nodes counted, the graph
                            # instantiated
    pool_bytes: int         # the device memory the capture reserved
    graph_nodes: int        # the graph's nodes, which every replay runs
    kernel_launches: dict   # the hand-written kernels' launches among
                            # them, by kernel


# every capture of this process, in order (clear_programs keeps them)
captures: List[Capture] = []


class CapturedSchedule:
    """full_pipeline_results of one pad bucket and its packed readback
    (packed_words), captured once as one CUDA graph and replayed per
    event (`launch` for the packed readback, `replay` for the results on
    the device); under an edge partition (`group`, `routing`: an NCCL
    group on the card) the rank's full_pipeline_results, its collectives
    inside the graph, with the routing's tensors among the inputs
    (`replay`).  Every rank of the group captures in lockstep: the same
    ops and collectives in the same order, since each runs the same
    program.  A stacked batch of B events (graph/state.stack_events) is
    one program of its own (program_key holds B): one replay runs all B
    events and one readback brings back their B rows.  Under an edge
    partition a stack is this rank's block of the union, its routing
    built over the union (parallel/edge_shard.py; the key holds the
    routing's bucket, which grows with B): `replay` clones the (B, I, ...)
    results out as they are, and every rank captures the same chunks in
    the same order.

    The capture (`_capture`) sets `graph`, `capture` (what the capture
    cost, a Capture) and `kernel_launches` (the hand-written kernels'
    launches captured, by kernel, which every replay makes: the kernels'
    own counters count the warm-up and the capture, never a replay; the
    graph's nodes, every op of the body, are `capture.graph_nodes`).  A
    prefetch thread may go on building the next event on the device while
    it runs.  The program's memory (every intermediate of one event, in
    the graph's private pool, and a copy of one event's state as its
    inputs) stays reserved while it is cached.  Each event: its state
    tensors are copied into the program's inputs (device to device), the
    graph is replayed, the final state is cloned out of the program's
    outputs (a fresh GraphState, as JAX returns a fresh g_out) and the
    packed buffer is copied, non-blocking, into a pinned host slot;
    nothing of that waits for the device."""

    def __init__(self, g: GraphState, cfg: PipelineConfig, group=None,
                 routing=None):
        self.cfg = cfg
        _build.library()                      # nvcc outside the capture
        self.inputs = {name: getattr(g, name).clone()
                       for name in tensor_fields()}
        static = g.replace(n_nodes=0, n_edges=0, event_nodes=(),
                           event_edges=(), **self.inputs)
        self.routing_inputs = {}
        if group is None:
            def body():
                res = full_pipeline_results(static, cfg)
                return res, packed_words(res)
            self.results, self.packed = self._capture(body, g)
            self.out = self.results.graph
        else:
            self.routing_inputs = {name: t.clone() for name, t in
                                   _routing_tensors(routing).items()}
            static_routing = dataclasses.replace(routing,
                                                 **self.routing_inputs)
            self.results = self._capture(
                lambda: full_pipeline_results(static, cfg, group,
                                              static_routing), g)
        self._free: List[_Slot] = []

    def _capture(self, body, g: GraphState):
        """body() once on a side stream (the warm-up), then captured in
        capture_error_mode "thread_local", so another thread (a prefetch
        thread) may go on using the device meanwhile, then its nodes
        counted and instantiated -> body()'s output, in the graph's
        memory.  The kernel library must be built before: nvcc cannot run
        inside a capture."""
        dev = g.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        side.synchronize()
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = kernel_launches()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved(dev)
            out = body()
        t2 = time.perf_counter()
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        nodes = _build.graph_nodes(self.graph.raw_cuda_graph())
        self.graph.instantiate()
        self.kernel_launches = {k: v - before[k]
                                for k, v in kernel_launches().items()}
        self.capture = Capture(
            bucket=(g.num_padded_nodes, g.num_padded_edges, g.max_degree,
                    g.batch),
            warmup_s=t1 - t0, record_s=t2 - t1,
            instantiate_s=time.perf_counter() - t2,
            pool_bytes=pool_bytes, graph_nodes=nodes,
            kernel_launches=self.kernel_launches)
        captures.append(self.capture)
        return out

    def launch(self, g: GraphState) -> "_Pending":
        """Enqueue one event on the current stream; nothing waits."""
        if g.batch != 1:
            raise ValueError("launch takes one event; launch_batch a batch")
        return self.launch_batch(g)[0]

    def launch_batch(self, g: GraphState,
                     events: List[GraphState] | None = None,
                     dispatch: int | None = None) -> List["_Pending"]:
        """Enqueue one replay of a stacked batch (or of one event) on the
        current stream; nothing waits.  -> one _Pending per event, all
        sharing the replay and the one readback.  `events`: the batch's
        own states, which an overflowed event reruns from (default:
        unstacked from g); `dispatch`: its number (default: the next)."""
        if dispatch is None:
            dispatch = next(_DISPATCHES)
        with span("pipeline.launch", dispatch):
            with span("pipeline.copy_in", dispatch):
                for name, t in self.inputs.items():
                    t.copy_(getattr(g, name))
            with span("pipeline.replay", dispatch):
                self.graph.replay()
            with span("pipeline.clone_out", dispatch):
                g_out = _sized_like(clone_state(self.out), g)
                slot = self._free.pop() if self._free else _Slot(self.packed)
                slot.buf.copy_(self.packed, non_blocking=True)
                slot.copied.record()
                slot.unread = g.batch
            with span("pipeline.unstack", dispatch):
                return [_Pending(self, g_in, g_b, slot, dispatch, b)
                        for b, (g_in, g_b) in enumerate(zip(
                            events or unstack_events(g),
                            unstack_events(g_out)))]

    def replay(self, g: GraphState, routing=None) -> ScheduleResults:
        """One replay with every result cloned out, on the current
        stream; nothing is read on the host.  Under an edge partition g
        and routing are this rank's block and routing."""
        for name, t in self.inputs.items():
            t.copy_(getattr(g, name))
        if routing is not None:
            for name, t in _routing_tensors(routing).items():
                self.routing_inputs[name].copy_(t)
        self.graph.replay()
        r = self.results
        return ScheduleResults(
            graph=_sized_like(clone_state(r.graph), g),
            **{k: getattr(r, k).clone() for k in ScheduleResults._fields
               if k not in ("graph", "path")}, path="captured")


def _sized_like(g_out: GraphState, g: GraphState) -> GraphState:
    """g_out with g's true sizes (a captured program holds none)."""
    return g_out.replace(n_nodes=g.n_nodes, n_edges=g.n_edges,
                         event_nodes=g.event_nodes, event_edges=g.event_edges)


def clone_state(g: GraphState) -> GraphState:
    """Every tensor of g in fresh memory."""
    return g.replace(**{name: getattr(g, name).clone()
                        for name in tensor_fields()})


class _Pending:
    """An event in flight: its result once the readback has landed (row
    `row` of the readback: the event's place in its batch; `dispatch`: the
    replay's number)."""

    def __init__(self, program: CapturedSchedule, g_in, g_out, slot: _Slot,
                 dispatch: int, row: int):
        self.program, self.g_in, self.g_out, self.slot = (program, g_in,
                                                          g_out, slot)
        self.dispatch, self.row = dispatch, row

    def result(self) -> PipelineResult:
        event = (self.dispatch, self.row)
        with span("pipeline.wait", event):
            self.slot.copied.synchronize()
        buf = self.slot.buf.numpy()
        out = unpack_packed(self.g_in, self.g_out,
                            buf.reshape(-1, buf.shape[-1])[self.row],
                            self.program.cfg, event)
        self.slot.unread -= 1
        if not self.slot.unread:
            self.program._free.append(self.slot)
        return out


# the captured programs by program_key, least recently used first
_PROGRAMS: "collections.OrderedDict[tuple, CapturedSchedule]" = \
    collections.OrderedDict()
MAX_PROGRAMS = 4


def captured_program(g: GraphState, cfg: PipelineConfig, group=None,
                     routing=None) -> CapturedSchedule:
    """The cached program of g's pad bucket (under a group: of this rank,
    the group and the routing's bucket), captured on first use; the least
    recently used of MAX_PROGRAMS is dropped for a new one."""
    key = program_key(g, cfg, group, routing)
    prog = _PROGRAMS.get(key)
    if prog is None:
        while len(_PROGRAMS) >= MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)
        prog = _PROGRAMS[key] = CapturedSchedule(g, cfg, group, routing)
    _PROGRAMS.move_to_end(key)
    return prog


def clear_programs() -> None:
    """Drop every captured program (their memory returns to the allocator;
    `captures` keeps what each capture cost)."""
    _PROGRAMS.clear()


class _Done(NamedTuple):
    """An event run eagerly (CPU tensors)."""
    out: PipelineResult

    def result(self) -> PipelineResult:
        return self.out


def _dispatch(g: GraphState, cfg: PipelineConfig):
    """-> an object whose result() is the event's PipelineResult."""
    if g.device.type == "cuda":
        return captured_program(g, cfg).launch(g)
    return _Done(run_pipeline_eager(g, cfg))


def _mask_to_host(mask: torch.Tensor, buf: torch.Tensor | None) -> np.ndarray:
    """Host copy of a device mask, through the pinned buffer when given."""
    if buf is None:
        return mask.cpu().numpy()
    buf.copy_(mask, non_blocking=True)
    torch.cuda.current_stream(mask.device).synchronize()
    return buf.numpy()


def _apply_gnn_mutations(g: GraphState, mutations, in_tab: np.ndarray,
                         slot_out: np.ndarray, src: np.ndarray) -> GraphState:
    """Apply extraction-leak coordinate mutations (graph/nxorder.py) to the
    live GNN coordinates and the out-table head-coordinate cache (JAX
    pipeline.py:202-227).  Coordinates are float64 midpoints, cast to the
    state's dtype."""
    last = {}
    for node, coords in mutations:      # later mutations win (in-place ref)
        last[node] = coords
    nodes = np.fromiter(last.keys(), np.int64, len(last))
    coords = np.array(list(last.values()), np.float64)
    # out_head_xyzr[src[e], slot_out[e]] holds gnn_xyzr[dst[e]]: refresh the
    # cells of every in-edge of each mutated node
    in_e = in_tab[nodes]
    has = in_e >= 0
    edges = in_e[has]
    vals = np.repeat(coords, has.sum(axis=1), axis=0)
    dev = g.device
    put = lambda a: torch.from_numpy(a).to(dev)
    # gnn_xyzr may alias xyzr (build time): write into a copy
    gnn = g.gnn_xyzr.clone()
    gnn[put(nodes)] = put(coords).to(g.dtype)
    out_head = g.out_head_xyzr.clone()
    out_head[put(src[edges]), put(slot_out[edges])] = put(vals).to(g.dtype)
    return g.replace(gnn_xyzr=gnn, out_head_xyzr=out_head)


class DriverStep(NamedTuple):
    """One iteration of the host driver, as `driver_steps` yields it."""
    iteration: int
    staged: GraphState                  # after the stage, before extraction
    result: extract.ExtractionResult
    candidates: List[Candidate]
    mutations: list                     # leak replay [(node, xyzr)], in order
    graph: GraphState                   # after extraction, leak and metadata
    cca_rounds: int = 0                 # FastSV rounds (0: host CCA)


def driver_steps(g: GraphState, cfg: PipelineConfig,
                 kl_thresholds: torch.Tensor | None = None,
                 host_cca: bool = True, tracker=None, group=None,
                 routing=None) -> Iterator[DriverStep]:
    """The host driver's iterations one at a time, from a prepared
    GraphState (run_pipeline's loop; its arguments are run_pipeline's)."""
    if group is not None and (host_cca or tracker is not None):
        raise ValueError("an edge-partitioned host driver takes its labels "
                         "from device FastSV, without a tracker")
    emulate_leak = tracker is not None and cfg.bug_compat
    read_mask = host_cca or emulate_leak
    buf = None
    if read_mask:
        src_np = g.src.cpu().numpy()
        dst_np = g.dst.cpu().numpy()
        if g.device.type == "cuda":
            buf = torch.empty(g.num_padded_edges, dtype=torch.bool,
                              pin_memory=True)
    if emulate_leak:
        vivl_np = g.vivl.cpu().numpy()
        xyzr_np = g.xyzr.cpu().numpy().astype(np.float64)
        in_tab_np = g.in_edges.cpu().numpy()
        slot_out_np = g.slot_out.cpu().numpy()
    for i in range(1, cfg.num_iterations + 1):
        staged = stage_step(g, cfg, i, kl_thresholds, group, routing)
        active_in = None
        if read_mask:
            active_in = _mask_to_host(staged.edge_mask & staged.active, buf)
        if host_cca:
            rounds = 0
            labels = torch.from_numpy(
                native_loader.connected_components_native(
                    src_np, dst_np, active_in, g.num_padded_nodes)
                .astype(np.int64)).to(g.device)
        else:
            # the adaptive loop: exact whatever the rounds
            labels, rounds = cca.connected_components_fastsv(
                staged, staged.edge_mask & staged.active, group)
        res = extract.extract_candidates(staged, cfg, labels)
        g = extract.apply_extraction(staged, res, cfg)
        nodes, pvals = (t.cpu().numpy() for t in extract.accepted_rows(res))
        candidates: List[Candidate] = []
        acc_sets = []
        for row, pv in zip(nodes, pvals):
            nn = row[row >= 0]
            acc_sets.append(set(nn.tolist()))
            candidates.append(Candidate(nodes=nn, iteration=i,
                                        pval_xy=float(pv[0]),
                                        pval_zr=float(pv[1])))
        muts = []
        if emulate_leak:
            muts = tracker.extraction_merges(
                active_in, vivl_np, xyzr_np, acc_sets, cfg.min_track_hits,
                cfg.node_merge_distance)
            if muts:
                g = _apply_gnn_mutations(g, muts, in_tab_np, slot_out_np,
                                         src_np)
        if i % 2 == 0:
            g = metadata_step(g, cfg, group, routing)
        yield DriverStep(iteration=i, staged=staged, result=res,
                         candidates=candidates, mutations=muts, graph=g,
                         cca_rounds=rounds)


def run_pipeline(g: GraphState, cfg: PipelineConfig,
                 kl_thresholds: torch.Tensor | None = None,
                 host_cca: bool = True, tracker=None, group=None,
                 routing=None) -> PipelineResult:
    """Host driver of the schedule (JAX pipeline.py:187-285): stage by
    stage, with every accepted candidate pulled after each extraction.

    host_cca: the extraction's CCA labels come from the union-find of
    data/native_loader.py over edge_mask & active, copied to the host once
    per extraction (src/dst once per event); False runs FastSV on the
    device in its adaptive loop (one host read per round).
    tracker: the event's graph/nxorder.RefOrderTracker (graph/build.py
    build_event).  Under bug_compat it replays each extraction's
    close-proximity merges and applies the reference's GNN-coordinate leak
    (extract_track_candidates.py:113-116) before the next stage; without
    it coordinates stay as ingested.  A tracker follows one run: it
    tracks the reference's orders through the extractions.
    group, routing: the edge partition (host_cca False, no tracker): the
    sharded schedule's exact fallback (parallel/edge_shard.py)."""
    g = prepare(g, cfg, group)
    out = PipelineResult(graph=g, candidates=[], per_iteration=[])
    for step in driver_steps(g, cfg, kl_thresholds, host_cca, tracker,
                             group, routing):
        out.graph = step.graph
        out.candidates += step.candidates
        out.per_iteration.append(step.result)
        out.cca_rounds.append(step.cca_rounds)
        out.mutations.append(step.mutations)
    return out


def run_pipeline_fast(g: GraphState, cfg: PipelineConfig) -> PipelineResult:
    """Production driver (JAX pipeline.py:452-459): one dispatch of the
    packed schedule — on a CUDA device a replay of the pad bucket's
    captured program — and one readback."""
    return _dispatch(g, cfg).result()


def stream_pipeline(graphs: Iterable[GraphState], cfg: PipelineConfig,
                    depth: int = 1) -> Iterator[PipelineResult]:
    """Multi-event streaming (JAX pipeline.py:462-488): event i+1 is
    dispatched before event i's readback is waited on and unpacked, with
    `depth` events held unread, so on the card one event's readback and
    unpack (and, fed by data/prefetch.py, the next events' ingest) run
    while the device works on the next.  Yields one PipelineResult per
    input graph, in order."""
    pending: collections.deque = collections.deque()
    for g in graphs:
        pending.append(_dispatch(g, cfg))
        if len(pending) > depth:
            yield pending.popleft().result()
    while pending:
        yield pending.popleft().result()


# ------------------------------------------------------------ event batch

def run_pipeline_batched(graphs: List[GraphState], cfg: PipelineConfig,
                         eager: bool = False) -> List[PipelineResult]:
    """B events of one pad bucket as one program (the production driver
    over JAX's vmapped batch, parallel/mesh.py:69-89): their disjoint
    union (stack_events) dispatched once — on a CUDA device one
    replay of the batch's captured program and one readback — then each
    event's row unpacked as run_pipeline_fast unpacks it.  An event that
    overflowed reruns alone through the exact driver from its own state
    and is counted in `fallbacks`; the others keep the batched result.
    eager: run the program op by op on any device (what the captured
    replay is held to).  -> one PipelineResult per event, in order."""
    dispatch = next(_DISPATCHES)
    with span("pipeline.stack", dispatch):
        g = stack_events(graphs)
    if g.device.type == "cuda" and not eager:
        return [p.result() for p in captured_program(g, cfg).launch_batch(
            g, list(graphs), dispatch)]
    g_out, packed = full_pipeline_packed(g, cfg)
    buf = packed.reshape(g.batch, -1).cpu().numpy()
    return [unpack_packed(g_in, g_b, row, cfg, (dispatch, b))
            for b, (g_in, g_b, row) in enumerate(
                zip(graphs, unstack_events(_sized_like(g_out, g)), buf))]


def split_events(res: ScheduleResults) -> List[ScheduleResults]:
    """A stacked run's results (res.graph the whole union) per event, in
    order: each event's fields (the leading (B,) axis taken apart; one
    event's fields as they are), its state unstacked, its path (res.path,
    or its own where res.path is a tuple)."""
    g = res.graph
    lead = len(g.event_shape)
    fields = [k for k in ScheduleResults._fields if k not in ("graph",
                                                              "path")]
    per = {k: getattr(res, k).reshape(g.batch, *getattr(res, k).shape[lead:])
           for k in fields}
    paths = res.path if isinstance(res.path, tuple) else (res.path,) * g.batch
    return [ScheduleResults(graph=g_b, **{k: v[b] for k, v in per.items()},
                            path=p)
            for b, (g_b, p) in enumerate(zip(unstack_events(g), paths))]


def run_schedule_batched(graphs: List[GraphState], cfg: PipelineConfig
                         ) -> List[ScheduleResults]:
    """B events of one pad bucket as one program, their results left on
    the device: full_pipeline_results of the union (on a CUDA device a
    replay of the batch's captured program, path "captured"; eagerly
    otherwise, path "eager"), split per event with each event's state
    unstacked (split_events); one host read of the overflow flags, and an
    overflowed event rerun alone by the exact driver (path "exact",
    counted in `fallbacks`)."""
    global fallbacks
    with span("pipeline.stack"):
        g = stack_events(graphs)
    if g.device.type == "cuda":
        res = captured_program(g, cfg).replay(g)
    else:
        res = full_pipeline_results(g, cfg)
    over = res.overflow.reshape(g.batch, -1).any(dim=1).tolist()
    fallbacks += sum(over)
    return [exact_results(run_pipeline(g_in, cfg, host_cca=False)) if o
            else r for g_in, r, o in zip(graphs, split_events(res), over)]
