"""The one-device event batch (graph/state.stack_events, mesh.run_batched,
pipeline.run_schedule_batched / run_pipeline_batched) against the port's
own single-event runs, at float64 on the CPU; no JAX here
(tests/test_torch_schedule.py holds the batch to the JAX package).

The events are distinct toys of one pad bucket (seeds 11, 23 and 3: 140
nodes each, 288 / 294 / 312 directed edges, padded to N = 192, E = 512),
so an event that read another's rows would give another answer.  Every
equality is bitwise: counts, heads, p-values, FastSV rounds, overflow
flags and every field of each event's final state."""

import dataclasses

import pytest
import torch

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import tensor_fields
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import extract
from gnn_track_finding_tpu_torch.parallel import mesh

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)
SEEDS = (11, 23, 3)


def _toy(seed, dtype=torch.float64):
    ev = toymc.generate_event(seed=seed, num_tracks=20,
                              edge_dphi_window=0.12)
    return build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                             device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def toys():
    graphs = [_toy(s) for s in SEEDS]
    singles = [pipeline.full_pipeline_results(g, CFG) for g in graphs]
    return graphs, singles


def _cands(out):
    return [(c.iteration, c.nodes.tolist(), c.pval_xy, c.pval_zr)
            for c in out.candidates]


def _fields_differ(a, b) -> list:
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    bad = []
    for name in tensor_fields():
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype in bits:
            x, y = x.view(bits[x.dtype]), y.view(bits[y.dtype])
        if not torch.equal(x, y):
            bad.append(name)
    return bad


def test_unstack_inverts_stack_bitwise(toys):
    """unstack_events(stack_events(gs)) gives back each input, every
    field bit for bit and its true sizes; the union offsets each event's
    node and edge indices and keeps the reverse edge at e ^ 1."""
    graphs, _ = toys
    st = mesh.stack_events(graphs)
    n, e = graphs[0].num_padded_nodes, graphs[0].num_padded_edges
    assert (st.batch, st.num_padded_nodes, st.num_padded_edges) == (
        3, 3 * n, 3 * e)
    assert st.event_nodes == tuple(g.n_nodes for g in graphs)
    assert st.event_edges == tuple(g.n_edges for g in graphs)
    assert torch.equal(st.src[e:2 * e], graphs[1].src + n)
    assert torch.equal(st.src[1::2], st.dst[0::2])
    tab = st.in_edges[n:2 * n]
    assert torch.equal(tab, torch.where(graphs[1].in_edges >= 0,
                                        graphs[1].in_edges + e, -1))
    for g, back in zip(graphs, mesh.unstack_events(st)):
        assert not _fields_differ(g, back)
        assert (back.n_nodes, back.n_edges, back.batch) == (g.n_nodes,
                                                            g.n_edges, 1)


def test_one_event_batch_is_the_unbatched_run(toys):
    """B = 1: stack_events returns the event itself, and the batched
    drivers equal the unbatched ones bitwise."""
    graphs, singles = toys
    g = graphs[0]
    assert mesh.stack_events([g]) is g
    (res,) = pipeline.run_schedule_batched([g], CFG)
    assert not testing.bitwise_fields(res, singles[0])
    (out,) = pipeline.run_pipeline_batched([g], CFG)
    solo = pipeline.run_pipeline_fast(g, CFG)
    assert _cands(out) == _cands(solo) and out.cca_rounds == solo.cca_rounds
    assert not _fields_differ(out.graph, solo.graph)


def test_each_event_is_its_single_run(toys):
    """Three distinct events as one program: each event's results and
    final state are its own single run's, bitwise, through both batched
    drivers, and each packed row is the event's own packed buffer."""
    graphs, singles = toys
    for res, single, g in zip(pipeline.run_schedule_batched(graphs, CFG),
                              singles, graphs):
        assert not testing.bitwise_fields(res, single)
        assert res.path == "eager" and res.graph.n_edges == g.n_edges
    assert len({tuple(s.acc_count.tolist()) for s in singles}) == 3
    for out, g in zip(pipeline.run_pipeline_batched(graphs, CFG), graphs):
        solo = pipeline.run_pipeline_fast(g, CFG)
        assert _cands(out) == _cands(solo) and out.candidates
        assert out.cca_rounds == solo.cca_rounds
        assert not _fields_differ(out.graph, solo.graph)
    _, packed = pipeline.full_pipeline_packed(mesh.stack_events(graphs), CFG)
    for row, g in zip(packed, graphs):
        assert torch.equal(row, pipeline.full_pipeline_packed(g, CFG)[1])


def test_fixed_round_fastsv_is_per_event(toys):
    """On a stacked extraction input FastSV's rounds and convergence are
    each event's own: cut one round short of the most any event needs,
    only the events that need it are unconverged."""
    graphs, _ = toys
    staged = [pipeline.stage_step(pipeline.extract_step(
        pipeline.stage_step(pipeline.prepare(g, CFG), CFG, 1), CFG, 1)[0],
        CFG, 2) for g in graphs]
    st = mesh.stack_events(staged)
    ok = st.edge_mask & st.active
    labels, rounds, converged = cca.connected_components_fixed(st, ok)
    own = [cca.connected_components_fixed(s, s.edge_mask & s.active)
           for s in staged]
    assert rounds.tolist() == [int(r) for _, r, _ in own]
    assert converged.all()
    n = graphs[0].num_padded_nodes
    for b, (lab, _, _) in enumerate(own):
        assert torch.equal(labels[b * n:(b + 1) * n] - b * n, lab)
    most = int(rounds.max())
    assert int(rounds.min()) < most
    _, cut_rounds, cut = cca.connected_components_fixed(st, ok, most - 1)
    assert cut.tolist() == [int(r) < most for r in rounds]
    assert cut_rounds.tolist() == [min(int(r), most - 1) for r in rounds]


def test_cut_cap_overflows_one_event_only(toys, monkeypatch):
    """A head cap under one event's count overflows that event alone: it
    alone reruns through the exact driver (path "exact", one fallback),
    its candidates those of the uncut run; the others keep their batched
    results."""
    graphs, singles = toys
    counts = [int(s.acc_count.max()) for s in singles]
    big = counts.index(max(counts))
    assert sorted(counts)[-2] < max(counts)
    want = [_cands(pipeline.run_pipeline_fast(g, CFG)) for g in graphs]
    monkeypatch.setattr(extract, "ACC_PULL_CAP", max(counts) - 1)
    before = pipeline.fallbacks
    res = pipeline.run_schedule_batched(graphs, CFG)
    assert pipeline.fallbacks == before + 1
    assert [r.path for r in res] == ["exact" if b == big else "eager"
                                     for b in range(len(graphs))]
    for b, (r, g) in enumerate(zip(res, graphs)):
        if b != big:           # its single run under the same cut cap
            assert not testing.bitwise_fields(
                r, pipeline.full_pipeline_results(g, CFG))
    assert res[big].acc_count.tolist() == singles[big].acc_count.tolist()
    out = pipeline.run_pipeline_batched(graphs, CFG)
    assert pipeline.fallbacks == before + 2
    assert [_cands(o) for o in out] == want


def test_mixed_pad_buckets_raise():
    """Events of different pad buckets, dtypes or an already stacked
    state do not stack (run_batched groups them instead: the next
    test)."""
    g = _toy(11)
    small = _toy(7)                           # E pads to 256, not 512
    assert small.num_padded_edges != g.num_padded_edges
    for bad in ([g, small], [g, _toy(23, torch.float32)],
                [mesh.stack_events([g, g]), g]):
        with pytest.raises(ValueError):
            mesh.stack_events(bad)


def test_run_batched_groups_buckets_in_bounded_chunks(toys, monkeypatch):
    """On a (1, 1) mesh (no collective, so no process group needed) a
    slice that mixes pad buckets runs one program per bucket, a bucket
    over MAX_BATCH_NODES in chunks of at most that many padded nodes;
    the results come back in event order, each its single run's."""
    graphs, singles = toys
    small = _toy(7)
    batch = [graphs[0], small, graphs[1], graphs[2]]
    monkeypatch.setattr(mesh, "MAX_BATCH_NODES",
                        2 * graphs[0].num_padded_nodes)
    assert mesh.batch_chunks(batch) == [[0, 2], [3], [1]]
    calls = []
    real = pipeline.full_pipeline_results

    def counted(g, cfg, *args, **kw):
        calls.append(g.batch)
        return real(g, cfg, *args, **kw)

    monkeypatch.setattr(pipeline, "full_pipeline_results", counted)
    one = mesh.Mesh(shape=(1, 1), data_index=0, edge_index=0,
                    data_group=None, edge_group=None)
    out = mesh.run_batched(batch, CFG, one)
    assert calls == [2, 1, 1]
    assert [i for i, _ in out] == [0, 1, 2, 3]
    want = [singles[0], real(small, CFG), singles[1], singles[2]]
    for (_, res), single in zip(out, want):
        assert not testing.bitwise_fields(res, single)


def test_run_batched_without_a_process_group_runs_one_program(toys,
                                                              monkeypatch):
    """run_batched(graphs, cfg) with no process group: one schedule
    program over the whole batch (JAX's one-device call), each event's
    results its single run's."""
    graphs, singles = toys
    calls = []
    real = pipeline.full_pipeline_results

    def counted(g, cfg, *args, **kw):
        calls.append(g.batch)
        return real(g, cfg, *args, **kw)

    monkeypatch.setattr(pipeline, "full_pipeline_results", counted)
    out = mesh.run_batched(graphs, CFG)
    assert calls == [len(graphs)]
    assert [i for i, _ in out] == list(range(len(graphs)))
    for (_, res), single in zip(out, singles):
        assert not testing.bitwise_fields(res, single)


def test_batched_program_reads_nothing_on_the_host(toys):
    """The stacked program (prepare, three iterations, the per-event
    packing) has no op that reads the device on the host, so the card
    captures it as one CUDA graph."""
    graphs, _ = toys
    st = mesh.stack_events(graphs)
    mode = testing.HostReads()
    with mode:
        pipeline.full_pipeline_packed(st, CFG)
    assert not mode.reads, sorted(set(mode.reads))
    assert "aten.scatter_reduce.two" in mode.ops


def test_program_key_holds_the_batch(toys):
    """A batch keys its own program, whatever its events' true sizes."""
    graphs, _ = toys
    two = mesh.stack_events(graphs[:2])
    assert pipeline.program_key(two, CFG) != \
        pipeline.program_key(graphs[0], CFG)
    assert pipeline.program_key(two, CFG) == \
        pipeline.program_key(mesh.stack_events(graphs[1:]), CFG)
    other = dataclasses.replace(CFG, bug_compat=False)
    assert pipeline.program_key(two, other) != pipeline.program_key(two, CFG)
