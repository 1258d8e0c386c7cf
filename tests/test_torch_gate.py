"""The kernel gate (gnn_track_finding_tpu_torch/testing.py) on CPU tensors:
plain against plain passes, a "kernel" that differs from the plain
version in one found flag or one distinct count fails the gate, as does a
wrong accepted count; and the event loader's rotated copies are the same
graph.  No JAX: the toy event comes from the port's own generator."""

from pathlib import Path

import pytest
import torch

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             extrapolate, priors)

REPO = Path(__file__).resolve().parents[1]
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


@pytest.fixture(scope="module")
def toy():
    """A toy event's state and both kernels' gate inputs, float64."""
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                          device="cpu")
    prepared = pipeline.prepare(g, CFG)
    x = clustering.core_inputs(prepared, CFG, False)
    g2, _ = pipeline.iteration(prepared, CFG, 1)
    table = priors.distinct_inputs(extrapolate.message_passing(g2, CFG))
    return g, x, table


def _cluster_inputs(x):
    return (x.states, x.tab, x.node_xyzr, x.klthr, x.count)


def _flip_one_found(*args, **kw):
    found, *rest = cluster_kernel.cluster_core_plain(*args, **kw)
    found = found.clone()
    found[int(torch.nonzero(found)[0])] = False
    return (found, *rest)


def _bump_one_count(ok, x, node_x):
    out = testing._distinct_plain(ok, x, node_x).clone()
    out[int(torch.nonzero(ok.any(1))[0]), 0] += 1
    return out


def test_gate_passes_plain_against_plain(toy):
    g, x, table = toy
    stats = testing.compare_cluster(_cluster_inputs(x), chi2_thr=x.chi2_thr,
                                    cfg=CFG,
                                    kernel=cluster_kernel.cluster_core_plain)
    assert stats["found"] == stats["found_plain"] > 0 and stats["flips"] == 0
    stats = testing.compare_distinct(*table, kernel=testing._distinct_plain)
    assert stats["diffs"] == 0 and stats["ok_slots"] > 0
    gate = testing.kernel_gate(g, CFG)
    assert sum(gate["accepted"]) > 0


@pytest.mark.parametrize("fault", ["found_flag", "distinct_count",
                                   "accepted_count"])
def test_gate_fails_on_a_disagreement(toy, fault):
    g, x, table = toy
    with pytest.raises(testing.GateError):
        if fault == "found_flag":
            testing.compare_cluster(_cluster_inputs(x), chi2_thr=x.chi2_thr,
                                    cfg=CFG, kernel=_flip_one_found)
        elif fault == "distinct_count":
            testing.compare_distinct(*table, kernel=_bump_one_count)
        else:
            want = testing.per_iteration(
                pipeline.run_pipeline_eager(g, CFG), CFG)
            want[0] += 1
            testing.kernel_gate(g, CFG, want)


def test_rotated_copy_is_the_same_graph():
    """A rotated copy keeps the graph and r and moves (x, y) by the angle;
    copy 0 is the event itself."""
    path = REPO / ".event_cache" / "event_fafb3309e4598e9b.npz"
    cfg = PipelineConfig()
    g0 = testing.load_event(path, cfg, device="cpu", dtype=torch.float64,
                            copy=0, copies=4)
    g1 = testing.load_event(path, cfg, device="cpu", dtype=torch.float64,
                            copy=1, copies=4)
    n = g0.n_nodes
    assert torch.equal(g0.xyzr, testing.load_event(
        path, cfg, device="cpu", dtype=torch.float64).xyzr)
    assert torch.equal(g0.src, g1.src) and torch.equal(g0.mirror, g1.mirror)
    assert torch.equal(g0.xyzr[:, 2:], g1.xyzr[:, 2:])
    torch.testing.assert_close(g1.xyzr[:n, 0], -g0.xyzr[:n, 1], rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(g1.xyzr[:n, 1], g0.xyzr[:n, 0], rtol=0,
                               atol=1e-12)
