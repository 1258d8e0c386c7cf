"""The full iterative track-finding schedule on one torch device.

Port of the production driver of `gnn_track_finding_tpu.models.pipeline`
(pipeline.py:34-86, 138-150, 288-312, 452-488).  The schedule of the
reference (run_gnn_trackml_mod.sh:71-148):

  prepare            : seed states, activation, priors, weights, degrees
  iteration 1        : clustering on seed states (chi2=1.0, KL=2.0)
  iteration 2        : extrapolation message passing + double reweight
  iteration 3        : clustering on updated states (chi2=1000, KL=100)
  after every iter   : candidate extraction (FastSV CCA + KF fit)
  after even iters   : state-metadata pruning

Everything runs eagerly on the device that holds the GraphState; the host
syncs once per FastSV round and once per extraction (for the exact
accepted count), and reads the candidates back with one copy of three
small tensors at the end.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
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


def iteration(g: GraphState, cfg: PipelineConfig, i: int,
              kl_thresholds: torch.Tensor | None = None
              ) -> Tuple[GraphState, extract.ExtractionResult]:
    """One full iteration: stage, extraction + node removal, and (even
    iterations) metadata pruning."""
    if i % 2 == 0:
        g = extrapolation_stage(g, cfg)
    else:
        g = cluster_stage(g, cfg, use_updated=i > 1,
                          kl_thresholds=kl_thresholds)
    res = extract.extract_candidates(g, cfg)
    g = extract.apply_extraction(g, res, cfg)
    if i % 2 == 0:
        g = metadata.remove_state_metadata(g, cfg)
    return g, res


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
