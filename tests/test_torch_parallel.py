"""The port's edge-partitioned schedule over torch.distributed vs the JAX
package's shard_map functions (gnn_track_finding_tpu.parallel.edge_shard)
on as many virtual CPU devices, at float64.

The port's ranks are processes started with spawn over gloo (file
rendezvous under the test's tmp dir, a 60 s collective timeout, a join
timeout that fails the test); their workers live in
gnn_track_finding_tpu_torch/testing.py, which imports no JAX.  Each world
is started once per module and runs its jobs in turn while this process
computes the JAX references.  The schedule's static program (FastSV in
fixed rounds, the static owner table, no host read) is held here against
JAX's schedule_sharded, the single-device port, the exact fallback's
adaptive loop and compaction, and the host-read audit; no test here
compiles another JAX program, and every rank job rides in those worlds.

Bars: masks, integers, labels and accepted candidates are exact.  Against
the port's single-device run the sharded states are bitwise, except the
variance columns of grad_stats, held to 1e-12 of their second moment
(testing.states_differ: the edge partition reassociates seeding's per-node
sums).  Against the JAX package, floats agree to rtol 1e-12 / atol 1e-14,
and the per-node float sums that the two packages take in other orders
(SUM_ORDER_FIELDS of tests/test_torch_stages.py) and the p-values of the
compiled JAX fit to rtol 1e-9, the single-device bars of
tests/test_torch_stages.py and tests/test_torch_pipeline.py."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import pipeline as jax_pipeline
from gnn_track_finding_tpu.models import toymc
from gnn_track_finding_tpu.parallel import edge_shard as jax_edge_shard
from gnn_track_finding_tpu.parallel import mesh as jax_mesh

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import clustering
from gnn_track_finding_tpu_torch.parallel import edge_shard, mesh, multihost

CFG_KW = dict(node_bucket=64, edge_bucket=256)
JCFG = JaxConfig(**CFG_KW)
CFG = PipelineConfig(**CFG_KW)
SCHEDULE_TOY = (20, 5)            # tracks, seed: test_edge_shard.py:202
VOL7_NPZ = (Path(__file__).resolve().parents[1] / ".event_cache"
            / "event_fafb3309e4598e9b.npz")
BATCH = [(8, seed) for seed in range(4)]          # test_parallel.py:17
# a toy whose clustering rounds gate owner rows in both rounds (112 and 3)
DENSE = {"toy": (50, 2), "cfg": CFG_KW, "gen": {"edge_dphi_window": 0.2}}
# per-node float sums taken in another order than XLA's, and the JAX fit's
# p-values (tests/test_torch_stages.py, tests/test_torch_pipeline.py)
LOOSER = {"grad_stats": 1e-9, "upd_weight": 1e-9, "merged_cov": 1e-9}
JOIN_TIMEOUT = 240.0


def _jax_graph(tracks, seed):
    ev = toymc.generate_event(num_tracks=tracks, seed=seed)
    g, _ = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, JCFG,
                     dtype=jnp.float64)
    return g


def _arrays(jg):
    return {name: np.asarray(getattr(jg, name))
            for name in tstate.tensor_fields()}


def _meta(jg):
    return dict(n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                max_degree=jg.max_degree, n_layers=jg.n_layers)


def _port_graph(tracks, seed):
    ev = toymc.generate_event(num_tracks=tracks, seed=seed)
    return build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                             device="cpu")


def _toy(tracks, seed):
    return {"toy": (tracks, seed), "cfg": CFG_KW}


def _assert_matches_jax(jg, got):
    bad = testing.states_differ(_arrays(jg), got, rtol=1e-12, atol=1e-14,
                                looser=LOOSER)
    assert not bad, bad


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank world of the module, started together; the JAX
    references are computed while they run."""
    root = tmp_path_factory.mktemp("ranks")
    # test_edge_shard.py:30-36 and :151-155: toy 20 tracks, seed 3
    jg = _jax_graph(20, 3)
    prepared = jax_pipeline._prepare_jit(jg, JCFG)
    staged = jax_pipeline._stage_jit(prepared, JCFG, 1, None)
    vol7 = str(VOL7_NPZ)
    batch = [_toy(*e) for e in BATCH]
    handles = {
        1: testing.spawn_ranks("collect", 1, root / "w1",
                               timeout=JOIN_TIMEOUT),
        2: testing.spawn_ranks("sequence", 2, root / "w2",
                               timeout=JOIN_TIMEOUT, jobs=[
            ("collect", {}),
            ("stages", dict(staged=_arrays(staged),
                            prepared=_arrays(prepared), meta=_meta(jg),
                            cfg=CFG_KW)),
            ("schedule", dict(event=_toy(*SCHEDULE_TOY), exact=True)),
            ("schedule", dict(event={"npz": vol7})),
            ("static_parts", dict(event=DENSE)),
            ("audit", dict(event=DENSE)),
            ("fallback", dict(event=_toy(*SCHEDULE_TOY), limit="cap")),
            ("fallback", dict(event=_toy(*SCHEDULE_TOY), limit="rounds")),
            ("batched", dict(events=batch, shape=(1, 2))),
            ("batched", dict(events=[{"npz": vol7}] * 2, shape=(1, 2))),
            ("audit", dict(event={"stack": batch})),
            ("fallback", dict(event={"stack": batch}, limit="cap"))]),
        4: testing.spawn_ranks("sequence", 4, root / "w4",
                               timeout=JOIN_TIMEOUT, jobs=[
            ("schedule", dict(event=_toy(*SCHEDULE_TOY), exact=True)),
            ("batched", dict(events=batch, shape=(2, 2))),
            ("multihost", dict(events=batch, num_events=10)),
            ("static_parts", dict(event=DENSE)),
            ("audit", dict(event=DENSE)),
            ("batched", dict(events=batch, shape=(1, 4))),
            ("multihost", dict(events=batch[:2], num_events=2))])}
    ref = {"prepared": prepared, "staged": staged}
    m2 = jax_edge_shard.edge_mesh(2)
    r2 = jax_edge_shard.build_owner_routing(jg, 2)
    gs = jax_edge_shard.shard_graph(staged, m2)
    ref["stage_dense"] = jax_edge_shard.extrapolation_stage_sharded(
        JCFG, m2)(gs)
    ref["stage_routed"] = jax_edge_shard.extrapolation_stage_sharded(
        JCFG, m2, routing=r2)(gs)
    gs = jax_edge_shard.shard_graph(prepared, m2)
    for i in (1, 2, 3):
        gs, res = jax_edge_shard.iteration_sharded(JCFG, m2, i, r2)(gs)
        ref[f"iteration{i}"], ref[f"result{i}"] = gs, res
    sg = _jax_graph(*SCHEDULE_TOY)
    for d in (2, 4):
        m = jax_edge_shard.edge_mesh(d)
        ref[f"schedule{d}"] = jax_edge_shard.schedule_sharded(
            JCFG, m, jax_edge_shard.build_owner_routing(sg, d))(
            jax_edge_shard.shard_graph(sg, m))
    # JAX's batch over a (2, 2) mesh of the virtual devices (mesh.py:69-89),
    # and the same program with the accepted heads and p-values
    # (full_pipeline_results in place of full_pipeline), the earlier
    # programs released first
    jax.clear_caches()
    jgraphs = [_jax_graph(*e) for e in BATCH]
    jmesh = jax_mesh.make_mesh((2, 2))
    final, accepted, cand_nodes = jax_mesh.run_batched(jgraphs, JCFG, jmesh)
    stacked = jax_mesh.shard_batched_graph(jax_mesh.stack_events(jgraphs),
                                           jmesh)
    heads = jax.jit(jax.vmap(
        lambda g: jax_pipeline.full_pipeline_results(g, JCFG)[1:]),
        in_shardings=(jax_mesh.batched_graph_sharding(stacked, jmesh),))(
        stacked)
    ref["run_batched"] = {
        "accepted": np.asarray(accepted), "cand_nodes": np.asarray(cand_nodes),
        "final": _arrays(final),
        **dict(zip(("acc_count", "acc_nodes", "acc_pvals"),
                   (np.asarray(h) for h in heads)))}
    out = {d: h.join() for d, h in handles.items()}
    w2, w4 = out[2], out[4]
    return {"ref": ref, "collect1": out[1],
            "collect2": [r[0] for r in w2], "stages": w2[0][1],
            "schedule2": w2[0][2], "vol7": w2[0][3],
            "schedule4": w4[0][0],
            "batched": {k: v for r in w4 for k, v in r[1]["events"].items()},
            "batched_ranks": [r[1] for r in w4],
            "edge_batched2": [r[8] for r in w2],
            "edge_batched4": [r[5] for r in w4],
            "vol7_batched": [r[9] for r in w2],
            "audit_stack2": [r[10] for r in w2],
            "fallback_stack": [r[11] for r in w2],
            "multihost": [r[2] for r in w4],
            "multihost_short": [r[6] for r in w4],
            "exact_differs2": [r[2]["exact_differs"] for r in w2],
            "exact_differs4": [r[0]["exact_differs"] for r in w4],
            "static2": [r[4] for r in w2], "static4": [r[3] for r in w4],
            "audit2": [r[5] for r in w2], "audit4": [r[4] for r in w4],
            "fallback_cap": [r[6] for r in w2],
            "fallback_rounds": [r[7] for r in w2]}


@pytest.mark.parametrize("d", [2, 4, 8])
def test_owner_routing_matches_jax(d):
    """build_owner_routing's arrays equal the JAX function's element for
    element (bucket rounded up to 128 included); routing_shard takes the
    rank's block."""
    jr = jax_edge_shard.build_owner_routing(_jax_graph(20, 3), d)
    r = edge_shard.build_owner_routing(_port_graph(20, 3), d)
    assert (r.n_shards, r.bucket) == (jr.n_shards, jr.bucket)
    for name in ("owner", "pos", "own_idx", "recv_row", "recv_slot"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    e_loc = r.owner.shape[0] // d
    s = edge_shard.routing_shard(r, d - 1)
    np.testing.assert_array_equal(s.pos.numpy(), r.pos[-e_loc:].numpy())
    assert s.recv_row is r.recv_row
    with pytest.raises(ValueError):
        edge_shard.build_owner_routing(_port_graph(20, 3), 3)


def _collect_expected(world):
    """Each collect op's definition, from every rank's inputs."""
    a = [testing.collect_inputs(r, world) for r in range(world)]
    x = np.stack([v["x"] for v in a])
    rows = x.shape[1] // world
    exp = []
    for r in range(world):
        recv = []
        for s in range(world):                 # what rank s sends to r
            v = a[s]
            ok = (v["owner"] == r) & (v["pos"] < v["bucket"]) & (v["pos"] >= 0)
            blk = np.zeros((v["bucket"], 3))
            blk[v["pos"][ok]] = v["values"][ok]
            recv.append(blk)
        exp.append({
            "allsum": x.sum(0),
            "allor": np.any([v["flags"] for v in a], axis=0),
            "allmin": np.min([v["ints"] for v in a], axis=0),
            "ownsum": x.sum(0)[r * rows:(r + 1) * rows],
            "ownor": np.any([v["flags"] for v in a], axis=0)[
                r * rows:(r + 1) * rows],
            "gather_rows": np.concatenate([v["rows"] for v in a]),
            "owner_block": a[r]["x"][r * rows:(r + 1) * rows],
            "owner_block_interleaved": a[r]["x"][r::world],
            "route_to_owners": np.concatenate(recv)})
    return exp


@pytest.mark.parametrize("world", [1, 2])
def test_collect_ops_match_their_definitions(worlds, world):
    got = worlds[f"collect{world}"]
    for r, (g, e) in enumerate(zip(got, _collect_expected(world))):
        for name, want in e.items():
            if want.dtype.kind == "f" and name in ("allsum", "ownsum"):
                np.testing.assert_allclose(g[name], want, rtol=1e-15,
                                           err_msg=f"rank {r} {name}")
            else:
                np.testing.assert_array_equal(g[name], want,
                                              err_msg=f"rank {r} {name}")
        assert g["owner_shards"] == [6 % world == 0, 7 % world == 0,
                                     8 % world == 0]
        assert g["identity"]
        assert [c["op"] for c in g["census"]] == [
            "all_reduce_sum", "all_reduce_or", "all_reduce_min",
            "reduce_scatter_sum", "reduce_scatter_or", "all_gather",
            "all_to_all"]
        assert {c["device"] for c in g["census"]} == {"cpu"}


@pytest.mark.parametrize("name", ["stage_dense", "stage_routed"])
def test_extrapolation_stage_sharded_matches_jax(worlds, name):
    """Without routing (the dense reduce-scatter combine) and with it (the
    owner all_to_all), from the JAX-staged state (test_edge_shard.py:
    39-61, 97-128)."""
    _assert_matches_jax(worlds["ref"][name], worlds["stages"][name])


@pytest.mark.parametrize("i", [1, 2, 3])
def test_iteration_sharded_matches_jax(worlds, i):
    """Each iteration of the schedule in turn at D = 2, the state and the
    extraction (test_edge_shard.py:171-197)."""
    ref = worlds["ref"]
    _assert_matches_jax(ref[f"iteration{i}"], worlds["stages"][f"iteration{i}"])
    jr, res = ref[f"result{i}"], worlds["stages"][f"result{i}"]
    for name in ("labels", "row_of_node", "cand_nodes", "cand_size",
                 "processed", "accepted", "merged_pair"):
        np.testing.assert_array_equal(res[name], np.asarray(getattr(jr, name)),
                                      err_msg=name)
    for name in ("pval_xy", "pval_zr"):
        np.testing.assert_allclose(res[name], np.asarray(getattr(jr, name)),
                                   rtol=1e-9, atol=1e-300, err_msg=name)
    n_acc = int(jr.acc_count)
    assert int(res["acc_count"]) == n_acc
    np.testing.assert_array_equal(res["acc_nodes"][:n_acc],
                                  np.asarray(jr.acc_nodes)[:n_acc])


@pytest.mark.parametrize("d", [2, 4])
def test_schedule_sharded_matches_jax(worlds, d):
    """The whole schedule (test_edge_shard.py:200-212): accepted counts per
    iteration exact, the final state within the bars."""
    jstate, accepted = worlds["ref"][f"schedule{d}"]
    out = worlds[f"schedule{d}"]
    assert out["acc_count"] == np.asarray(accepted).sum(axis=1).tolist()
    _assert_matches_jax(jstate, out["graph"])


@pytest.mark.parametrize("d", [2, 4])
def test_schedule_sharded_equals_the_single_device_port(worlds, d):
    """The same toy event through the port's single-device schedule: the
    candidates and every field bitwise, but grad_stats' variances (their
    second moment's bar)."""
    ref = pipeline.full_pipeline_results(_port_graph(*SCHEDULE_TOY), CFG)
    out = worlds[f"schedule{d}"]
    assert out["acc_count"] == ref.acc_count.tolist()
    np.testing.assert_array_equal(out["acc_nodes"], ref.acc_nodes.numpy())
    np.testing.assert_array_equal(out["acc_pvals"], ref.acc_pvals.numpy())
    assert out["cca_rounds"] == ref.cca_rounds.tolist()
    bad = testing.states_differ(ref.graph.to_numpy(), out["graph"], rtol=0.0)
    assert not bad, bad
    assert out["launches"] == {"gmr_cluster": 0, "distinct_counts": 0,
                               "kf_fit": 0}


def _pins(census, n, k, e):
    """The census pins of test_edge_shard.py:64-80,132-148,216-238."""
    ops = [c["op"] for c in census]
    assert "all_to_all" in ops
    for c in census:
        float_ = c["dtype"].startswith("float")
        # an all_gather materialising an edge-sized array: the partition
        # would have degenerated to replication
        assert not (c["op"] == "all_gather" and float_
                    and c["shape"][0] * 2 == e), c
        # the (N, K) float tables never ride an all-reduce
        assert not (c["op"].startswith("all_reduce") and float_
                    and c["shape"][:2] == (n, k)), c


@pytest.mark.parametrize("name", ["census_stage_routed", "census_iteration1",
                                  "census_iteration2"])
def test_census_shows_the_designed_exchange(worlds, name):
    st = worlds["ref"]["staged"]
    census = worlds["stages"][name]
    _pins(census, st.num_padded_nodes, st.in_edges.shape[1],
          st.num_padded_edges)
    if name != "census_iteration1":
        # the prior/reweight owner exchange: payloads all_to_all to their
        # owners, the (N / D, L + 4) results gathered back
        assert any(c["caller"] == "owner_tables" and c["op"] == "all_to_all"
                   for c in census)
        assert any(c["caller"] == "prior_reweight" and c["op"] == "all_gather"
                   and c["shape"] == (st.num_padded_nodes // 2,
                                      st.n_layers + 4) for c in census)


def test_dense_stage_census_has_no_all_to_all(worlds):
    ops = {c["op"] for c in worlds["stages"]["census_stage_dense"]}
    assert "all_to_all" not in ops
    assert {"reduce_scatter_sum", "reduce_scatter_or", "all_gather"} <= ops


def _program_collectives(census):
    """The collectives of a census that the schedule's program issued (not
    gather_graph's, which brings the final state back whole)."""
    return [c for c in census if c["caller"] != "gather_graph"]


def test_run_batched_matches_single_device(worlds):
    """Four toy events on a (2, 2) mesh: each event's candidates and final
    state equal the single-device run's (test_parallel.py:15-49); each data
    rank's two events run as one edge-partitioned program per rank, so the
    census shows one program's 64 collectives, not one per event."""
    got = worlds["batched"]
    assert sorted(got) == list(range(len(BATCH)))
    for i, ev in enumerate(BATCH):
        ref = pipeline.full_pipeline_results(_port_graph(*ev), CFG)
        out = got[i]
        assert out["acc_count"] == ref.acc_count.tolist()
        np.testing.assert_array_equal(out["acc_nodes"], ref.acc_nodes.numpy())
        np.testing.assert_array_equal(out["acc_pvals"], ref.acc_pvals.numpy())
        bad = testing.states_differ(ref.graph.to_numpy(), out["graph"],
                                    rtol=0.0)
        assert not bad, (i, bad)
    for rank, r in enumerate(worlds["batched_ranks"]):
        assert len(_program_collectives(r["census"])) == 64, rank
        assert {o["path"] for o in r["events"].values()} == {"eager"}


# the sharded bars: bitwise, but grad_stats' variance columns, held to
# 1e-12 of their second moment (testing.states_differ)
SHARDED_BARS = dict(rtol=0.0, looser={"grad_stats": 1e-12})


@pytest.mark.parametrize("d", [2, 4])
def test_run_batched_on_an_edge_group_runs_one_program(worlds, d):
    """BATCH on a (1, d) mesh: the four events' union edge-partitioned over
    d ranks as one program per rank (64 collectives, the kernels' plain
    versions launched once per clustering round and reweight table, not
    per event); each event's candidates equal its single-device run's
    exactly, its state within the sharded bars; every rank's live edges
    add up to the union's."""
    ranks = worlds[f"edge_batched{d}"]
    singles = [_port_graph(*ev) for ev in BATCH]
    live = sum(int(g.edge_mask.sum()) for g in singles)
    assert sum(r["live_edges"][0] for r in ranks) == live
    for rank, r in enumerate(ranks):
        assert len(_program_collectives(r["census"])) == 64, rank
        assert r["launches"] == {"gmr_cluster": 0, "distinct_counts": 0,
                                 "kf_fit": 0}
        assert sorted(r["events"]) == list(range(len(BATCH)))
        for i, g in enumerate(singles):
            ref = pipeline.full_pipeline_results(g, CFG)
            out = r["events"][i]
            assert out["path"] == "eager"
            assert out["acc_count"] == ref.acc_count.tolist()
            assert out["cca_rounds"] == ref.cca_rounds.tolist()
            np.testing.assert_array_equal(out["acc_nodes"],
                                          ref.acc_nodes.numpy())
            np.testing.assert_array_equal(out["acc_pvals"],
                                          ref.acc_pvals.numpy())
            bad = testing.states_differ(ref.graph.to_numpy(), out["graph"],
                                        **SHARDED_BARS)
            assert not bad, (rank, i, bad)


def test_run_batched_matches_jax_per_event(worlds):
    """The (2, 2) mesh's events against JAX's run_batched on a (2, 2) mesh
    of virtual devices: accepted candidates and the final `active` mask
    exact, every field of the final state within the JAX bars, and the
    accepted p-values of the same program's heads at pval_xy rtol 1e-9 /
    pval_zr rtol 1e-8."""
    jr = worlds["ref"]["run_batched"]
    got = worlds["batched"]
    for b in range(len(BATCH)):
        out = got[b]
        want = [jr["cand_nodes"][b, i][jr["accepted"][b, i]]
                for i in range(CFG.num_iterations)]
        assert out["acc_count"] == [len(w) for w in want]
        assert out["acc_count"] == np.asarray(jr["acc_count"][b]).tolist()
        for i, w in enumerate(want):
            np.testing.assert_array_equal(out["acc_nodes"][i, :len(w)], w)
            for col, rtol in enumerate((1e-9, 1e-8)):
                np.testing.assert_allclose(
                    out["acc_pvals"][i, :len(w), col],
                    jr["acc_pvals"][b, i, :len(w), col], rtol=rtol,
                    atol=1e-300, err_msg=f"event {b}")
        final = {k: v[b] for k, v in jr["final"].items()}
        np.testing.assert_array_equal(out["graph"]["active"], final["active"])
        bad = testing.states_differ(final, out["graph"], rtol=1e-12,
                                    atol=1e-14, looser=LOOSER)
        assert not bad, (b, bad)


def test_stacked_schedule_sharded_reads_nothing_on_the_host(worlds):
    """BATCH stacked and edge-partitioned at D = 2: the whole stacked
    schedule_sharded under testing.HostReads reads nothing on the host on
    either rank."""
    for rank, a in enumerate(worlds["audit_stack2"]):
        assert a["reads"] == [], (rank, a["reads"])
        assert {"c10d.allreduce_.default", "c10d.alltoall_base_.default",
                "c10d._allgather_base_.default"} <= set(a["ops"]), rank


def test_stacked_overflow_reruns_only_that_event(worlds):
    """BATCH stacked at D = 2 with the head cap cut one below the largest
    count (event 1's 5): only event 1 overflows, with the same flags on
    both ranks; it alone reruns through the exact fallback on every rank,
    counted once; every event equals the uncut run."""
    ranks = worlds["fallback_stack"]
    flags = [o["overflow"] for o in ranks]
    assert flags == [flags[0]] * len(ranks)
    assert [any(f) for f in flags[0]] == [False, True, False, False]
    for rank, o in enumerate(ranks):
        assert o["fallbacks"] == 1
        assert [e["path"] for e in o["full"]] == ["eager"] * len(BATCH)
        assert [e["path"] for e in o["fallback"]] == [
            "eager", "exact", "eager", "eager"]
        for b, (fell, full) in enumerate(zip(o["fallback"], o["full"])):
            assert not any(fell["overflow"]), (rank, b)
            assert fell["acc_count"] == full["acc_count"]
            assert fell["cca_rounds"] == full["cca_rounds"]
            for it, k in enumerate(full["acc_count"]):
                np.testing.assert_array_equal(fell["acc_nodes"][it, :k],
                                              full["acc_nodes"][it, :k])
                np.testing.assert_array_equal(fell["acc_pvals"][it, :k],
                                              full["acc_pvals"][it, :k])
            bad = testing.states_differ(full["graph"], fell["graph"],
                                        **SHARDED_BARS)
            assert not bad, (rank, b, bad)


def test_stacked_volume7_sharded_counts(worlds):
    """Two volume-7 copies stacked on a (1, 2) mesh: each gives the
    single-device port's counts [1055, 110, 2], in one program per rank."""
    for rank, r in enumerate(worlds["vol7_batched"]):
        assert [r["events"][i]["acc_count"] for i in (0, 1)] == [
            [1055, 110, 2]] * 2, rank
        assert len(_program_collectives(r["census"])) == 64, rank


@pytest.fixture(scope="module")
def vol7_graph():
    return testing._graph(testing.RankContext(0, 1, torch.device("cpu")),
                          {"npz": str(VOL7_NPZ)})[0]


@pytest.mark.parametrize("d", [2, 4])
def test_union_routing_keeps_each_events_owners(vol7_graph, d):
    """The routing of a union (stack-then-shard): every edge of event b
    keeps the owner rank of its single event's routing (N % D == 0), the
    bucket, part of the program key, grows with B (volume 7 stacked 1, 2
    and 4 times), and the union refuses a D that does not divide its
    B*N nodes and B*E edges, as one event does."""
    singles = [_port_graph(*ev) for ev in BATCH]
    e = singles[0].num_padded_edges
    union = tstate.stack_events(singles)
    r = edge_shard.build_owner_routing(union, d)
    with pytest.raises(ValueError):
        edge_shard.build_owner_routing(union, 3)
    for k, g in enumerate(singles):
        np.testing.assert_array_equal(
            r.owner[k * e:(k + 1) * e].numpy(),
            edge_shard.build_owner_routing(g, d).owner.numpy())
    buckets = [edge_shard.build_owner_routing(
        tstate.stack_events([vol7_graph] * b), d).bucket for b in (1, 2, 4)]
    assert buckets[0] < buckets[1] < buckets[2], buckets


def test_local_event_slice_and_scaling_report(worlds):
    """Each of 4 ranks takes its slice of 10 events; the scaling report's
    checksums agree (no wall-clock bar on the CPU)."""
    out = worlds["multihost"]
    assert [tuple(o["slice"]) for o in out] == [(0, 3), (3, 6), (6, 9),
                                                (9, 10)]
    assert multihost.local_event_slice(10) == (0, 10)
    # one host (LOCAL_WORLD_SIZE = 4): one data rank by default, rank r at
    # edge index r; with two data ranks, row-major
    assert [o["meshes"] for o in out] == [
        [((1, 4), 0, r), ((2, 2), r // 2, r % 2)] for r in range(4)]
    rep = out[0]["report"]
    assert rep["events"] == 4 and rep["devices"] == 4
    assert rep["parallel_checksum"] == rep["sequential_checksum"] > 0
    ref = sum(int(pipeline.full_pipeline_results(_port_graph(*ev), CFG)
                  .acc_count.sum()) for ev in BATCH)
    assert rep["sequential_checksum"] == ref


def test_scaling_report_counts_the_data_ranks_it_uses(worlds):
    """2 events on 4 ranks: ranks 2 and 3 get empty slices, so the report
    counts and divides by the 2 data ranks that run events, as JAX's
    min(len(graphs), len(jax.devices())) mesh does (multihost.py:80-92);
    every rank's checksums equal the single-device port's sum."""
    out = worlds["multihost_short"]
    assert [max(hi - lo, 0) for lo, hi in (o["slice"] for o in out)] == [
        1, 1, 0, 0]
    ref = sum(int(pipeline.full_pipeline_results(_port_graph(*ev), CFG)
                  .acc_count.sum()) for ev in BATCH[:2])
    assert ref > 0
    for rep in (o["report"] for o in out):
        assert rep["events"] == 2 and rep["devices"] == 2
        assert rep["scaling_efficiency"] == pytest.approx(
            rep["sequential_s"] / (rep["parallel_s"] * 2), rel=1e-12)
        assert rep["parallel_checksum"] == rep["sequential_checksum"] == ref


def test_volume7_sharded_counts(worlds):
    """Volume 7 at D = 2: the single-device port's counts [1055, 110, 2]."""
    assert worlds["vol7"]["acc_count"] == [1055, 110, 2]


def test_mesh_event_slices_and_single_process_initialize():
    assert [mesh.event_slice(5, i, 2) for i in range(2)] == [(0, 3), (3, 5)]
    assert mesh.event_slice(4, 3, 4) == (3, 4)
    multihost.initialize()               # one process: a no-op
    assert not torch.distributed.is_initialized()


def _single_device_results(out, ref):
    """A rank's results (numpy) equal the port's single-device
    ScheduleResults: candidates, FastSV rounds, the gathered state bitwise
    but grad_stats' variances."""
    n = ref.acc_count.tolist()
    assert out["acc_count"] == n
    assert out["cca_rounds"] == ref.cca_rounds.tolist()
    for it, k in enumerate(n):
        np.testing.assert_array_equal(out["acc_nodes"][it, :k],
                                      ref.acc_nodes[it, :k].numpy())
        np.testing.assert_array_equal(out["acc_pvals"][it, :k],
                                      ref.acc_pvals[it, :k].numpy())
    bad = testing.states_differ(ref.graph.to_numpy(), out["graph"], rtol=0.0)
    assert not bad, bad


@pytest.mark.parametrize("d", [2, 4])
def test_schedule_sharded_reads_nothing_on_the_host(worlds, d):
    """The whole of schedule_sharded (prepare, three iterations) on every
    rank under testing.HostReads: no op reads the device on the host,
    and the audit saw the collectives, the scatters and the cumsums."""
    for rank, a in enumerate(worlds[f"audit{d}"]):
        assert a["reads"] == [], (rank, a["reads"])
        assert {"c10d.allreduce_.default", "c10d.alltoall_base_.default",
                "c10d._allgather_base_.default", "aten.scatter_reduce.two",
                "aten.cumsum.default"} <= set(a["ops"]), rank


@pytest.mark.parametrize("d", [2, 4])
def test_schedule_sharded_equals_the_exact_adaptive_run(worlds, d):
    """The static program against the exact fallback's eager run (FastSV's
    adaptive loop, every accepted row pulled): bit for bit on every rank,
    its results and its block of the final state."""
    assert worlds[f"exact_differs{d}"] == [[]] * d
    out = worlds[f"schedule{d}"]
    ex = out["exact"]
    assert ex["path"] == "exact" and not any(ex["overflow"])
    assert ex["acc_count"] == out["acc_count"]
    assert ex["cca_rounds"] == out["cca_rounds"]
    np.testing.assert_array_equal(ex["acc_nodes"], out["acc_nodes"])
    np.testing.assert_array_equal(ex["acc_pvals"], out["acc_pvals"])
    bad = testing.states_differ(out["graph"], ex["graph"], rtol=0.0)
    assert not bad, bad


@pytest.mark.parametrize("d", [2, 4])
def test_fixed_round_fastsv_over_the_group_equals_the_adaptive_loop(
        worlds, d):
    """At each extraction of the sharded schedule, on every rank: the
    fixed-round FastSV's labels and rounds are the adaptive loop's, and it
    reports convergence."""
    for rank, parts in enumerate(worlds[f"static{d}"]):
        for it, f in enumerate(parts["fastsv"]):
            assert f["labels"] and f["converged"], (rank, it, f)
            assert f["fixed_rounds"] == f["rounds"], (rank, it, f)
            assert 2 <= f["rounds"] <= cca.R_CAP


@pytest.mark.parametrize("d", [2, 4])
def test_static_owner_table_equals_the_exact_compaction(worlds, d):
    """Both clustering rounds on every rank: the static (N / D)-row owner
    table's live rows are the exact compaction's (nonzero) in order, the
    dump row past the count, the device count the exact row count, and
    the plain core on the static table equals the plain core on the exact
    rows (rows past the count not found).  Over the ranks the live rows
    add up to the single-device gate's."""
    parts = worlds[f"static{d}"]
    for rank, p in enumerate(parts):
        for rnd, o in enumerate(p["owner"]):
            assert o["count"] == o["exact_rows"], (rank, rnd, o)
            assert all(o[k] for k in ("ids", "tab", "node_xyzr", "klthr",
                                      "core", "core_dead_rows")), (rank, o)
    g = pipeline.prepare(testing._graph(testing.RankContext(
        0, 1, torch.device("cpu")), DENSE)[0], CFG)
    seed = int(clustering.core_inputs(g, CFG, False).count)
    for i in (1, 2):
        g, _ = pipeline.iteration(g, CFG, i)
    updated = int(clustering.core_inputs(g, CFG, True).count)
    assert seed > 0 and updated > 0
    assert [sum(p["owner"][rnd]["count"] for p in parts)
            for rnd in (0, 1)] == [seed, updated]
    assert sum(p["owner"][0]["found"] for p in parts) > 0


@pytest.mark.parametrize("limit", ["cap", "rounds"])
def test_sharded_overflow_takes_the_exact_fallback(worlds, limit):
    """The head cap or FastSV's rounds cut one below what the toy needs, at
    D = 2: the overflow flags are set, the same on every rank; run_sharded
    counts one fallback and returns the exact run's results, which are the
    uncut run's candidates.  Over gloo run_sharded does not capture (its
    path is eager) and the program key holds the group's size, the rank,
    the backend and the routing bucket."""
    ranks = worlds[f"fallback_{limit}"]
    flags = [o["overflow"] for o in ranks]
    assert any(flags[0]) and flags == [flags[0]] * len(ranks)
    ref = pipeline.full_pipeline_results(_port_graph(*SCHEDULE_TOY), CFG)
    for rank, o in enumerate(ranks):
        assert o["fallbacks"] == 1
        assert o["full"]["path"] == "eager" and not o["captures"]
        assert o["key"] == [2, rank, "gloo", worlds["schedule2"]["bucket"]]
        fell, ex = o["fallback"], o["exact"]
        assert fell["path"] == ex["path"] == "exact"
        _single_device_results(fell, ref)
        _single_device_results(o["full"], ref)
        assert fell["cca_rounds"] == ex["cca_rounds"]
        assert not testing.states_differ(ex["graph"], fell["graph"], rtol=0.0)
