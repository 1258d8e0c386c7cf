"""The port's one-program schedule (models/pipeline.py) against the JAX
package's, at float64 on the CPU: the static-shape full_pipeline_results
(counts and accepted node ids exact, pval_xy rtol 1e-9, pval_zr rtol
1e-8), pack_results byte for byte, the exact fallback, fixed-round FastSV
against the adaptive loop, and an audit that no operation of the schedule
reads the device on the host (what lets the card capture it as one CUDA
graph).  The JAX side runs only what tests/test_torch_pipeline.py already
compiles (the packed schedule at the 64/256 toy bucket) and unjitted
packing."""

import dataclasses
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import pipeline as jax_pipeline
from gnn_track_finding_tpu.models import toymc

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import cluster_kernel, clustering, extract

VOL7_NPZ = (Path(__file__).resolve().parents[1] / ".event_cache"
            / "event_fafb3309e4598e9b.npz")
JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def _toy(seed, num_tracks=20, with_jax=True):
    ev = toymc.generate_event(seed=seed, num_tracks=num_tracks,
                              edge_dphi_window=0.12)
    jg, host = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, JCFG)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                          device="cpu", mirror=host.mirror)
    return (jg, g) if with_jax else g


def _cands(out):
    return [(c.iteration, tuple(int(x) for x in c.nodes), c.pval_xy,
             c.pval_zr) for c in out.candidates]


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_full_pipeline_results_matches_jax(seed):
    """The port's static-shape schedule against JAX's one program (its
    packed form, the program run_pipeline_fast compiles): per-iteration
    counts, the accepted heads' node ids, and their p-values."""
    jg, g = _toy(seed)
    packed = jax_pipeline.full_pipeline_packed(
        jax_pipeline._normalize_static(jg), JCFG)[1]
    counts, nodes, pvals, sentinel = jax_pipeline.unpack_results(
        np.asarray(packed), JCFG.num_iterations)
    res = pipeline.full_pipeline_results(g, CFG)
    assert res.acc_count.tolist() == counts.tolist() and counts.sum() > 0
    assert not res.overflow.any()
    heads = res.acc_nodes.numpy()
    for it, n in enumerate(counts):
        want = np.where(nodes[it, :n] == sentinel, -1, nodes[it, :n])
        np.testing.assert_array_equal(heads[it, :n], want)
        assert (heads[it, n:] == -1).all()
        for col, rtol in ((0, 1e-9), (1, 1e-8)):
            np.testing.assert_allclose(res.acc_pvals[it, :n, col].numpy(),
                                       pvals[it, :n, col], rtol=rtol, atol=0)


def test_stacked_events_match_jax_per_event():
    """Three distinct toy events of one pad bucket (seeds 11, 23 and 3:
    N = 192, E = 512, the shapes seeds 11 and 23 compile above) stacked
    as one program (mesh.stack_events): each event against JAX's packed
    schedule of that event (its unpack_results), counts and heads (node
    ids local to the event) exact, pval_xy rtol 1e-9, pval_zr rtol 1e-8;
    JAX reports no FastSV rounds, so each event's rounds, overflow flags
    and final state are held to the port's single-event run, bitwise (JAX
    tests/test_parallel.py:14-49 pins its vmap to the single-device run
    the same way)."""
    pairs = [_toy(seed) for seed in (11, 23, 3)]
    graphs = [g for _, g in pairs]
    assert len({(g.n_nodes, g.n_edges) for g in graphs}) == 3
    batched = pipeline.run_schedule_batched(graphs, CFG)
    for (jg, g), res in zip(pairs, batched):
        packed = jax_pipeline.full_pipeline_packed(
            jax_pipeline._normalize_static(jg), JCFG)[1]
        counts, nodes, pvals, sentinel = jax_pipeline.unpack_results(
            np.asarray(packed), JCFG.num_iterations)
        assert res.acc_count.tolist() == counts.tolist() and counts.sum() > 0
        assert res.path == "eager" and not res.overflow.any()
        heads = res.acc_nodes.numpy()
        for it, n in enumerate(counts):
            want = np.where(nodes[it, :n] == sentinel, -1, nodes[it, :n])
            np.testing.assert_array_equal(heads[it, :n], want)
            assert (heads[it, n:] == -1).all()
            for col, rtol in ((0, 1e-9), (1, 1e-8)):
                np.testing.assert_allclose(res.acc_pvals[it, :n, col].numpy(),
                                           pvals[it, :n, col], rtol=rtol,
                                           atol=0)
        single = pipeline.full_pipeline_results(g, CFG)
        assert not testing.bitwise_fields(res, single)
        assert (res.graph.n_nodes, res.graph.n_edges) == (g.n_nodes,
                                                          g.n_edges)


def test_full_pipeline_stacks_every_extraction():
    """full_pipeline's stacked (accepted, cand_nodes) hold each
    extraction's accepted rows, whose node lists are the heads of
    full_pipeline_results, and both end in the same state."""
    g = _toy(23, with_jax=False)
    g_end, accepted, cand_nodes = pipeline.full_pipeline(g, CFG)
    res = pipeline.full_pipeline_results(g, CFG)
    assert accepted.shape == cand_nodes.shape[:2]
    assert accepted.sum(1).tolist() == res.acc_count.tolist()
    for it, n in enumerate(res.acc_count.tolist()):
        assert torch.equal(cand_nodes[it][accepted[it]], res.acc_nodes[it, :n])
    assert torch.equal(g_end.node_mask, res.graph.node_mask)
    assert torch.equal(g_end.active, res.graph.active)


@pytest.mark.parametrize("narrow,wide_pv,shape", list(itertools.product(
    (True, False), (True, False), ((5, 7), (4, 8)))))
def test_pack_results_bytes_equal_jax(narrow, wide_pv, shape):
    """narrow (uint16 pairs, sentinel 0xFFFF) / wide (int32) ids, float64 /
    float32 p-values, odd / even node-section lengths: the same bytes as
    JAX's pack_results, and unpack_results inverts it (JAX
    tests/test_pipeline.py:206)."""
    rng = np.random.default_rng(0)
    cap, length = shape
    n_it = 3
    nodes = rng.integers(0, 0xFFFF if narrow else 2**30,
                         size=(n_it, cap, length)).astype(np.int32)
    nodes[rng.random(nodes.shape) < 0.4] = -1
    counts = rng.integers(0, cap + 1, size=(n_it,)).astype(np.int32)
    pvals = rng.standard_normal((n_it, cap, 2)).astype(
        np.float64 if wide_pv else np.float32)
    want = np.asarray(jax_pipeline.pack_results(
        jnp.asarray(counts), jnp.asarray(nodes), jnp.asarray(pvals), narrow))
    got = pipeline.pack_results(torch.from_numpy(counts).long(),
                                torch.from_numpy(nodes).long(),
                                torch.from_numpy(pvals), narrow).numpy()
    assert got.tobytes() == want.tobytes()
    c2, n2, p2, sentinel = pipeline.unpack_results(got, n_it)
    np.testing.assert_array_equal(c2, counts)
    np.testing.assert_array_equal(p2, pvals)
    np.testing.assert_array_equal(n2, np.where(nodes == -1, sentinel, nodes))


@pytest.mark.parametrize("narrow,wide_pv,shape,overflow", [
    (True, True, (5, 7), False), (False, False, (4, 8), False),
    (True, False, (4, 8), False), (False, True, (5, 7), False),
    (True, True, (5, 7), True)],
    ids=["narrow-f64-odd", "wide-f32-even", "narrow-f32-even",
         "wide-f64-odd", "overflow-first"])
def test_unpack_packed_equals_jax_candidates(monkeypatch, narrow, wide_pv,
                                             shape, overflow):
    """The port's candidate build from a packed readback (pack_results,
    then the rounds and overflow words) against JAX's per-candidate loop
    (_unpack_packed over the same bytes): the same candidates in the same
    order, field by field, nodes int64 with every sentinel dropped, also
    mid-row; an iteration with no candidates and one at the cap.  An
    overflow word with valid counts returns run_pipeline's result and
    builds no candidate."""
    rng = np.random.default_rng(5)
    cap, length = shape
    n_it = CFG.num_iterations
    nodes = rng.integers(0, 0xFFFF if narrow else 2**30,
                         size=(n_it, cap, length)).astype(np.int32)
    nodes[rng.random(nodes.shape) < 0.4] = -1
    counts = np.array([cap, 0, cap // 2], np.int32)
    live = nodes[0, :cap] != -1
    assert (live[:, 1:] & ~live[:, :-1]).any()     # a sentinel mid-row
    pvals = rng.standard_normal((n_it, cap, 2)).astype(
        np.float64 if wide_pv else np.float32)
    packed = pipeline.pack_results(torch.from_numpy(counts).long(),
                                   torch.from_numpy(nodes).long(),
                                   torch.from_numpy(pvals), narrow).numpy()
    rounds = np.array([3, 2, 1], np.int32)
    flags = np.array([0, int(overflow), 0], np.int32)
    buf = np.concatenate([packed, rounds, flags])
    g_in, g_out = object(), object()
    if overflow:
        rerun = object()
        monkeypatch.setattr(pipeline, "run_pipeline",
                            lambda g, cfg, host_cca: (g, host_cca, rerun))
        monkeypatch.setattr(pipeline, "Candidate", None)   # never built
        before = pipeline.fallbacks
        out = pipeline.unpack_packed(g_in, g_out, buf, CFG)
        assert out == (g_in, False, rerun)
        assert pipeline.fallbacks == before + 1
        return
    want = jax_pipeline._unpack_packed(None, None, packed, JCFG).candidates
    out = pipeline.unpack_packed(g_in, g_out, buf, CFG)
    assert out.graph is g_out and out.per_iteration == []
    assert out.cca_rounds == rounds.tolist()
    assert [c.iteration for c in out.candidates] == [1] * cap + [3] * (cap // 2)
    assert len(out.candidates) == len(want)
    for got, ref in zip(out.candidates, want):
        assert got.nodes.dtype == np.int64
        np.testing.assert_array_equal(got.nodes, ref.nodes)
        assert (got.iteration, got.pval_xy, got.pval_zr) == \
            (ref.iteration, ref.pval_xy, ref.pval_zr)
        assert type(got.pval_xy) is float and type(got.pval_zr) is float


@pytest.mark.parametrize("limit", ["cap", "rounds"])
def test_overflow_takes_the_exact_fallback(monkeypatch, limit):
    """An accepted count over the head cap, or FastSV cut below the rounds
    it needs: the fast driver reruns the event through run_pipeline with
    device FastSV, whose candidates are the uncut schedule's, and counts
    the fallback (JAX tests/test_pipeline.py:237)."""
    g = _toy(11, with_jax=False)
    want = _cands(pipeline.run_pipeline_fast(g, CFG))
    res = pipeline.full_pipeline_results(g, CFG)
    assert not res.overflow.any()
    if limit == "cap":
        monkeypatch.setattr(extract, "ACC_PULL_CAP",
                            int(res.acc_count.max()) - 1)
    else:
        monkeypatch.setattr(cca, "R_CAP", int(res.cca_rounds.max()) - 1)
    cut = pipeline.full_pipeline_results(g, CFG)
    assert cut.overflow.any()
    before = pipeline.fallbacks
    out = pipeline.run_pipeline_fast(g, CFG)
    assert pipeline.fallbacks == before + 1
    assert _cands(out) == want
    streamed = list(pipeline.stream_pipeline([g, g], CFG))
    assert pipeline.fallbacks == before + 3
    assert all(_cands(r) == want for r in streamed)


def _staged_states(g, cfg):
    """The state each extraction of the schedule sees."""
    g = pipeline.prepare(g, cfg)
    out = []
    for i in range(1, cfg.num_iterations + 1):
        g = pipeline.stage_step(g, cfg, i)
        out.append(g)
        g, _ = pipeline.extract_step(g, cfg, i)
    return out


def _volume7_staged():
    xyzr, vivl, tp, pairs, _, pre = load_npz(VOL7_NPZ)
    cfg = PipelineConfig()
    g = build_graph_state(xyzr, vivl, tp, pairs, cfg, device="cpu",
                          mirror=pre["mirror"], component=pre["component"])
    return pipeline.stage_step(pipeline.prepare(g, cfg), cfg, 1)


@pytest.mark.parametrize("event", ["toys", "volume7"])
def test_fixed_round_fastsv_equals_the_adaptive_loop(event):
    """Labels and rounds of the fixed-round FastSV equal the adaptive
    loop's on every extraction's input; one round short it reports no
    convergence."""
    if event == "toys":
        states = [s for seed in (7, 11, 23)
                  for s in _staged_states(_toy(seed, with_jax=False), CFG)]
    else:
        states = [_volume7_staged()]
    for s in states:
        ok = s.edge_mask & s.active
        labels, rounds = cca.connected_components_fastsv(s, ok)
        fixed, f_rounds, converged = cca.connected_components_fixed(s, ok)
        assert torch.equal(fixed, labels)
        assert int(f_rounds) == rounds and bool(converged)
        assert 2 <= rounds <= cca.R_CAP
        _, short_rounds, short = cca.connected_components_fixed(
            s, ok, max_rounds=rounds - 1)
        assert not bool(short) and int(short_rounds) == rounds - 1


def test_schedule_reads_nothing_on_the_host():
    """full_pipeline_packed (prepare, three iterations, the packing) on a
    toy: no aten op that reads device values on the host or sizes its
    output by them (.item / bool(), nonzero, boolean-mask indexing,
    masked_select, unique, bincount, repeat_interleave with tensor
    repeats)."""
    g = _toy(7, with_jax=False)
    mode = testing.HostReads()
    with mode:
        pipeline.full_pipeline_packed(g, CFG)
    assert not mode.reads, sorted(set(mode.reads))
    # the audit sees the schedule's ops, the kernels' plain versions too
    assert {"aten.scatter_reduce.two", "aten.cumsum.default"} <= mode.ops
    # ... and catches what the host driver does
    mode = testing.HostReads()
    with mode:
        extract.accepted_rows(extract.extract_candidates(
            pipeline.prepare(g, CFG), CFG))
    assert "aten.nonzero.default" in mode.reads


def test_distinct_true_sizes_share_one_program_key():
    """Two toy events of different true sizes in one pad bucket key one
    captured program (JAX tests/test_pipeline.py:177); the drivers hand
    each event's true sizes back."""
    graphs = [_toy(s, num_tracks=t, with_jax=False)
              for s, t in ((3, 12), (5, 14))]
    assert (graphs[0].n_nodes, graphs[0].n_edges) != \
        (graphs[1].n_nodes, graphs[1].n_edges)
    assert pipeline.program_key(graphs[0], CFG) == \
        pipeline.program_key(graphs[1], CFG)
    other = dataclasses.replace(CFG, bug_compat=False)
    assert pipeline.program_key(graphs[0], other) != \
        pipeline.program_key(graphs[0], CFG)
    for g, out in zip(graphs, pipeline.stream_pipeline(graphs, CFG)):
        assert (out.graph.n_nodes, out.graph.n_edges) == (g.n_nodes,
                                                          g.n_edges)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_equals_solo_runs_across_buckets(depth):
    """Events of two pad buckets interleaved: each streamed result equals
    its solo run (candidates, FastSV rounds and the final state)."""
    ev = toymc.generate_event(seed=1, num_tracks=50)
    big = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                            dataclasses.replace(CFG, node_bucket=256,
                                                edge_bucket=1024),
                            device="cpu")
    graphs = [_toy(7, with_jax=False), big, _toy(11, with_jax=False)]
    assert pipeline.program_key(graphs[0], CFG) != \
        pipeline.program_key(big, CFG)
    solo = [pipeline.run_pipeline_fast(g, CFG) for g in graphs]
    streamed = list(pipeline.stream_pipeline(iter(graphs), CFG, depth=depth))
    assert len(streamed) == len(graphs)
    for a, b in zip(solo, streamed):
        assert _cands(a) == _cands(b) and a.cca_rounds == b.cca_rounds
        for name in ("node_mask", "edge_mask", "active", "merged_state"):
            assert torch.equal(getattr(a.graph, name),
                               getattr(b.graph, name)), name
    assert all(_cands(r) for r in solo)


def test_cluster_core_plain_rows_past_the_count_are_not_found():
    """Rows at or past the live count come out not found, with zero
    outputs, whatever their entries; the live rows are the uncounted
    call's."""
    inputs = testing.cluster_rows(5, 33, 16)
    full = cluster_kernel.cluster_core_plain(*inputs, chi2_thr=1.0, cfg=CFG)
    count = torch.tensor(20)
    cut = cluster_kernel.cluster_core(*inputs, count, chi2_thr=1.0, cfg=CFG)
    assert full[0][20:].any()
    for a, b in zip(full, cut):
        assert torch.equal(a[:20], b[:20])
        assert not b[20:].any()


def test_core_inputs_rows_are_the_gated_nodes_in_order():
    """The static compaction: the gated nodes first, in node order, then
    rows with no member; the count on the device."""
    g = pipeline.prepare(_toy(7, with_jax=False), CFG)
    x = clustering.core_inputs(g, CFG, False)
    n = g.num_padded_nodes
    assert x.tab.shape == (n, clustering.KC) and x.ids.shape == (n,)
    members = (x.tab >= 0).sum(1)
    count = int(x.count)
    assert count > 0 and (x.ids[count:] == n).all()
    assert torch.equal(x.ids[:count], torch.sort(x.ids[:count]).values)
    assert ((members[:count] >= 3) & (members[:count] <= 15)).all()
    assert (members[count:] == 0).all()
