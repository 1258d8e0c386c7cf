"""The port's utilities against the JAX package's, at float64 on the CPU:
state guards, tag propagation, the stage timer's artifacts, the profiler
trace, and checkpoints.

Every comparison here is exact: guard reports and tags are booleans and
integers; the timer's artifacts are text; a checkpoint round trip is bitwise
and a run resumed from one equals the uninterrupted run bit for bit (the
same operations on the same tensors)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.graph import tag_propagation as jax_tags
from gnn_track_finding_tpu.graph.state import GraphState as JaxState
from gnn_track_finding_tpu.utils import guards as jax_guards
from gnn_track_finding_tpu.utils import timing as jax_timing

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.graph import tag_propagation
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.utils import checkpoint, guards, timing

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def _toy_arrays(seed, **kw):
    ev = toymc.generate_event(seed=seed, **kw)
    return ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs


def _prepared(seed=11, **kw):
    """The prepared port state of one toy event."""
    return pipeline.prepare(build_graph_state(*_toy_arrays(seed, **kw), CFG,
                                              device="cpu"), CFG)


def _to_jax(g):
    """A JAX GraphState holding a port state's values (int64 as int32)."""
    arrays = {name: jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                else a)
              for name, a in g.to_numpy().items()}
    return JaxState(n_nodes=g.n_nodes, n_edges=g.n_edges,
                    max_degree=g.max_degree, n_layers=g.n_layers, **arrays)


@pytest.mark.parametrize("poison", [None, "seed_sv", "upd_sv", "merged_state",
                                    "seed_weight", "active", "node_mask"])
def test_check_state_matches_jax(poison):
    """A healthy staged state passes every check in both packages; each
    poisoned field fails the same checks, and strict raises."""
    g = _prepared(num_tracks=16, edge_dphi_window=0.12)
    g = pipeline.stage_step(pipeline.stage_step(g, CFG, 1), CFG, 2)
    e = int(torch.nonzero(g.has_updated & g.edge_mask)[0])
    if poison in ("seed_sv", "upd_sv", "seed_weight"):
        t = getattr(g, poison).clone()
        t[e] = float("nan")
        g = g.replace(**{poison: t})
    elif poison == "merged_state":
        n = int(torch.nonzero(g.has_merged)[0])
        t = g.merged_state.clone()
        t[n, 1] = float("inf")
        g = g.replace(merged_state=t)
    elif poison == "active":
        t = g.active.clone()
        t[g.n_edges:] = True
        g = g.replace(active=t)
    elif poison == "node_mask":
        t = g.node_mask.clone()
        t[int(g.dst[e])] = False
        g = g.replace(node_mask=t)
    got = guards.check_state(g)
    assert got == jax_guards.check_state(_to_jax(g))
    assert all(got.values()) == (poison is None)
    if poison is not None:
        with pytest.raises(FloatingPointError):
            guards.check_state(g, strict=True)


@pytest.mark.parametrize("minimize,flip_fraction,masked", [
    (True, 0.10, False), (True, 0.0001, False), (False, 0.10, False),
    (False, 0.0001, True), (True, 0.5, True)])
def test_propagate_tags_matches_jax(minimize, flip_fraction, masked):
    g = _prepared(seed=3, num_tracks=12)
    edge_ok = None
    if masked:                   # drop every third edge
        edge_ok = g.edge_mask & (torch.arange(g.num_padded_edges) % 3 != 0)
    got = tag_propagation.propagate_tags(g, edge_ok, minimize, flip_fraction)
    ref = jax_tags.propagate_tags(
        _to_jax(g), None if edge_ok is None else jnp.asarray(edge_ok.numpy()),
        minimize, flip_fraction)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[:g.n_nodes] != torch.arange(g.n_nodes)).any()


def test_stage_timer_artifacts_match_jax_format(tmp_path):
    g = _prepared(num_tracks=8)
    timer = timing.StageTimer()
    with timer.stage("stage_1", block_on=g):
        g = pipeline.stage_step(g, CFG, 1)
    with timer.stage("extraction_1", block_on=[g.active, {"x": g.xyzr}]):
        pass
    assert list(timer.durations()) == ["stage_1", "extraction_1"]
    ref = jax_timing.StageTimer()
    ref.stages, ref.times = list(timer.stages), [0.0, 12.7, 1234.5]
    timer.times = list(ref.times)
    timer.write_artifacts(str(tmp_path / "port"))
    ref.write_artifacts(str(tmp_path / "jax"))
    for name in ("execution_stages.txt", "execution_times.txt"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / "execution_times.txt").read_text() == \
        "0\n12\n1234\n"


def test_trace_writes_a_chrome_trace(tmp_path):
    g = _prepared(num_tracks=8)
    with timing.trace(None) as prof:
        assert prof is None
    with timing.trace(str(tmp_path)):
        pipeline.stage_step(g, CFG, 1)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("aten::" in ev.get("name", "")
               for ev in trace["traceEvents"])


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    g = _prepared(num_tracks=16, edge_dphi_window=0.12)
    step = next(pipeline.driver_steps(g, CFG))       # iteration 1
    g, candidates = step.graph, step.candidates
    assert candidates
    checkpoint.save(str(tmp_path), g, candidates, iteration=1)
    template = build_graph_state(*_toy_arrays(99, num_tracks=5), CFG,
                                 device="cpu")
    back, cands = checkpoint.restore(str(tmp_path), template, iteration=1)
    for name in tstate.STATIC_FIELDS:
        assert getattr(back, name) == getattr(g, name)
    for name in tstate.tensor_fields():
        a, b = getattr(back, name), getattr(g, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert [(c.iteration, c.nodes.tolist(), c.pval_xy, c.pval_zr)
            for c in cands] == \
        [(c.iteration, c.nodes.tolist(), c.pval_xy, c.pval_zr)
         for c in candidates]


def test_run_resumed_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    # a toy whose iteration 2 accepts a candidate
    g0 = pipeline.prepare(build_graph_state(*_toy_arrays(1, num_tracks=50),
                                            CFG, device="cpu"), CFG)
    g, results = g0, []
    for i in (1, 2, 3):
        g, res = pipeline.iteration(g, CFG, i)
        results.append(res)
    g_res, _ = pipeline.iteration(g0, CFG, 1)
    checkpoint.save(str(tmp_path), g_res, None, iteration=1)
    g_res, cands = checkpoint.restore(str(tmp_path), g0, iteration=1)
    assert cands == []
    for i in (2, 3):
        g_res, res = pipeline.iteration(g_res, CFG, i)
        ref = results[i - 1]
        assert torch.equal(res.acc_nodes, ref.acc_nodes)
        assert torch.equal(res.acc_pvals, ref.acc_pvals)
    assert sum(int(r.acc_count) for r in results[1:]) > 0
    for name in tstate.tensor_fields():
        assert torch.equal(getattr(g_res, name), getattr(g, name)), name
