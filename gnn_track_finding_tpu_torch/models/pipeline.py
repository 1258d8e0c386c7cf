"""The full iterative track-finding schedule on one torch device.

Port of `gnn_track_finding_tpu.models.pipeline` (pipeline.py:34-86,
138-285, 288-312, 452-488).  The schedule of the reference
(run_gnn_trackml_mod.sh:71-148):

  prepare            : seed states, activation, priors, weights, degrees
  iteration 1        : clustering on seed states (chi2=1.0, KL=2.0)
  iteration 2        : extrapolation message passing + double reweight
  iteration 3        : clustering on updated states (chi2=1000, KL=100)
  after every iter   : candidate extraction (CCA + KF fit)
  after even iters   : state-metadata pruning

Two drivers run it.  `run_pipeline_fast` / `stream_pipeline` (production)
run everything eagerly on the device that holds the GraphState; the host
syncs once per FastSV round and once per extraction (for the exact
accepted count), and reads the candidates back with one copy of three
small tensors at the end.  `run_pipeline` (parity) takes the extraction's
CCA labels from the host union-find and, given the event's NetworkX-order
tracker, replays the reference's extraction-time coordinate leak between
an extraction and the next stage.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import native_loader
from gnn_track_finding_tpu_torch.graph.state import GraphState
from gnn_track_finding_tpu_torch.ops import (clustering, extract, extrapolate,
                                             metadata, priors, seeding)


def prepare(g: GraphState, cfg: PipelineConfig) -> GraphState:
    """Event-conversion tail (event_conversion.py:92-101)."""
    g = seeding.seed_track_states(g, cfg)
    g = priors.initialize_edge_activation(g)
    g = priors.compute_prior_probabilities(g, use_updated=False)
    g = priors.compute_mixture_weights(g, use_updated=False)
    return priors.update_degrees(g)


def cluster_stage(g: GraphState, cfg: PipelineConfig, use_updated: bool,
                  kl_thresholds: torch.Tensor | None = None) -> GraphState:
    """Clustering iteration incl. the weight/prior recompute and degree
    update (clustering.py:323-327,372-373)."""
    g = clustering.cluster(g, cfg, use_updated, kl_thresholds)
    g = priors.update_degrees(g)
    g = priors.compute_mixture_weights(g, use_updated)
    return priors.compute_prior_probabilities(g, use_updated)


def extrapolation_stage(g: GraphState, cfg: PipelineConfig) -> GraphState:
    """Extrapolation iteration: message passing, then the table-resident
    double prior/reweight and degree refresh
    (extrapolate_merged_states.py:554-566)."""
    g = extrapolate.message_passing(g, cfg)
    return priors.reweight_stage(g, cfg, n_passes=2)


def stage_step(g: GraphState, cfg: PipelineConfig, i: int,
               kl_thresholds: torch.Tensor | None = None) -> GraphState:
    """The pre-extraction stage of iteration i (schedule in module doc)."""
    if i % 2 == 0:
        return extrapolation_stage(g, cfg)
    return cluster_stage(g, cfg, use_updated=i > 1,
                         kl_thresholds=kl_thresholds)


def iteration(g: GraphState, cfg: PipelineConfig, i: int,
              kl_thresholds: torch.Tensor | None = None
              ) -> Tuple[GraphState, extract.ExtractionResult]:
    """One full iteration: stage, extraction + node removal, and (even
    iterations) metadata pruning."""
    g = stage_step(g, cfg, i, kl_thresholds)
    res = extract.extract_candidates(g, cfg)
    g = extract.apply_extraction(g, res, cfg)
    if i % 2 == 0:
        g = metadata.remove_state_metadata(g, cfg)
    return g, res


def reset_reactivate(g: GraphState, cfg: PipelineConfig) -> GraphState:
    """Brute-force reset of a remaining network (clustering.py:126-146,
    the '-r' CLI flag; JAX pipeline.py:152-161): drop merged and updated
    states, reactivate every surviving edge, re-seed and recompute
    priors and weights."""
    g = g.replace(has_merged=torch.zeros_like(g.has_merged),
                  has_updated=torch.zeros_like(g.has_updated))
    return prepare(g, cfg)


class ScheduleResults(NamedTuple):
    graph: GraphState
    acc_count: torch.Tensor     # (I,) accepted candidates per iteration
    acc_nodes: torch.Tensor     # (sum of counts, H) node ids, -1 padded
    acc_pvals: torch.Tensor     # (sum of counts, 2) (pval_xy, pval_zr)
    cca_rounds: List[int]       # FastSV rounds per extraction


def full_pipeline_results(g: GraphState, cfg: PipelineConfig
                          ) -> ScheduleResults:
    """The whole schedule; accepted candidates of every iteration, in
    iteration then row order, left on the device."""
    g = prepare(g, cfg)
    counts, nodes, pvals, rounds = [], [], [], []
    for i in range(1, cfg.num_iterations + 1):
        g, res = iteration(g, cfg, i)
        counts.append(res.acc_nodes.shape[0])
        nodes.append(res.acc_nodes)
        pvals.append(res.acc_pvals)
        rounds.append(res.cca_rounds)
    return ScheduleResults(
        graph=g, acc_count=torch.tensor(counts, dtype=torch.int64),
        acc_nodes=torch.cat(nodes), acc_pvals=torch.cat(pvals),
        cca_rounds=rounds)


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


def _unpack(res: ScheduleResults) -> PipelineResult:
    """One device-to-host copy of the result tensors -> candidate records."""
    nodes = res.acc_nodes.cpu().numpy()
    pvals = res.acc_pvals.cpu().numpy()
    candidates: List[Candidate] = []
    row = 0
    for it, count in enumerate(res.acc_count.tolist()):
        for _ in range(count):
            nn = nodes[row]
            candidates.append(Candidate(nodes=nn[nn >= 0], iteration=it + 1,
                                        pval_xy=float(pvals[row, 0]),
                                        pval_zr=float(pvals[row, 1])))
            row += 1
    return PipelineResult(graph=res.graph, candidates=candidates,
                          per_iteration=[], cca_rounds=res.cca_rounds)


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


def driver_steps(g: GraphState, cfg: PipelineConfig,
                 kl_thresholds: torch.Tensor | None = None,
                 host_cca: bool = True, tracker=None) -> Iterator[DriverStep]:
    """The host driver's iterations one at a time, from a prepared
    GraphState (run_pipeline's loop; its arguments are run_pipeline's)."""
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
        staged = stage_step(g, cfg, i, kl_thresholds)
        labels = active_in = None
        if read_mask:
            active_in = _mask_to_host(staged.edge_mask & staged.active, buf)
        if host_cca:
            labels = torch.from_numpy(
                native_loader.connected_components_native(
                    src_np, dst_np, active_in, g.num_padded_nodes)
                .astype(np.int64)).to(g.device)
        res = extract.extract_candidates(staged, cfg, labels)
        g = extract.apply_extraction(staged, res, cfg)
        nodes = res.acc_nodes.cpu().numpy()
        pvals = res.acc_pvals.cpu().numpy()
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
            g = metadata.remove_state_metadata(g, cfg)
        yield DriverStep(iteration=i, staged=staged, result=res,
                         candidates=candidates, mutations=muts, graph=g)


def run_pipeline(g: GraphState, cfg: PipelineConfig,
                 kl_thresholds: torch.Tensor | None = None,
                 host_cca: bool = True, tracker=None) -> PipelineResult:
    """Host driver of the schedule (JAX pipeline.py:187-285): stage by
    stage, with the accepted candidates pulled after each extraction.

    host_cca: the extraction's CCA labels come from the union-find of
    data/native_loader.py over edge_mask & active, copied to the host once
    per extraction (src/dst once per event); False runs FastSV on the
    device.
    tracker: the event's graph/nxorder.RefOrderTracker (graph/build.py
    build_event).  Under bug_compat it replays each extraction's
    close-proximity merges and applies the reference's GNN-coordinate leak
    (extract_track_candidates.py:113-116) before the next stage; without
    it coordinates stay as ingested.  A tracker follows one run: it
    tracks the reference's orders through the extractions."""
    g = prepare(g, cfg)
    out = PipelineResult(graph=g, candidates=[], per_iteration=[])
    for step in driver_steps(g, cfg, kl_thresholds, host_cca, tracker):
        out.graph = step.graph
        out.candidates += step.candidates
        out.per_iteration.append(step.result)
        out.cca_rounds.append(step.result.cca_rounds)
        out.mutations.append(step.mutations)
    return out


def run_pipeline_fast(g: GraphState, cfg: PipelineConfig) -> PipelineResult:
    """Production driver: the whole schedule, then one readback."""
    return _unpack(full_pipeline_results(g, cfg))


def stream_pipeline(graphs: Iterable[GraphState], cfg: PipelineConfig,
                    depth: int = 1) -> Iterator[PipelineResult]:
    """Multi-event streaming: event i+1's schedule is issued before event
    i's results are read back, with `depth` events held unread.  Yields
    one PipelineResult per input graph, in order."""
    pending: collections.deque = collections.deque()
    for g in graphs:
        res = full_pipeline_results(g, cfg)
        if len(pending) >= depth:
            yield _unpack(pending.popleft())
        pending.append(res)
    while pending:
        yield _unpack(pending.popleft())
