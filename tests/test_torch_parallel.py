"""The port's edge-partitioned schedule over torch.distributed vs the JAX
package's shard_map functions (gnn_track_finding_tpu.parallel.edge_shard)
on as many virtual CPU devices, at float64.

The port's ranks are processes started with spawn over gloo (file
rendezvous under the test's tmp dir, a 60 s collective timeout, a join
timeout that fails the test); their workers live in
gnn_track_finding_tpu_torch/testing.py, which imports no JAX.  Each world
is started once per module and runs its jobs in turn while this process
computes the JAX references.

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
import jax.numpy as jnp
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import pipeline as jax_pipeline
from gnn_track_finding_tpu.models import toymc
from gnn_track_finding_tpu.parallel import edge_shard as jax_edge_shard

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.parallel import edge_shard, mesh, multihost

CFG_KW = dict(node_bucket=64, edge_bucket=256)
JCFG = JaxConfig(**CFG_KW)
CFG = PipelineConfig(**CFG_KW)
SCHEDULE_TOY = (20, 5)            # tracks, seed: test_edge_shard.py:202
VOL7_NPZ = (Path(__file__).resolve().parents[1] / ".event_cache"
            / "event_fafb3309e4598e9b.npz")
BATCH = [(8, seed) for seed in range(4)]          # test_parallel.py:17
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
    handles = {
        1: testing.spawn_ranks("collect", 1, root / "w1",
                               timeout=JOIN_TIMEOUT),
        2: testing.spawn_ranks("sequence", 2, root / "w2",
                               timeout=JOIN_TIMEOUT, jobs=[
            ("collect", {}),
            ("stages", dict(staged=_arrays(staged),
                            prepared=_arrays(prepared), meta=_meta(jg),
                            cfg=CFG_KW)),
            ("schedule", dict(event=_toy(*SCHEDULE_TOY))),
            ("schedule", dict(event={"npz": vol7}))]),
        4: testing.spawn_ranks("sequence", 4, root / "w4",
                               timeout=JOIN_TIMEOUT, jobs=[
            ("schedule", dict(event=_toy(*SCHEDULE_TOY))),
            ("batched", dict(events=[_toy(*e) for e in BATCH],
                             shape=(2, 2))),
            ("multihost", dict(events=[_toy(*e) for e in BATCH],
                               num_events=10))])}
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
    out = {d: h.join() for d, h in handles.items()}
    w2 = out[2]
    return {"ref": ref, "collect1": out[1],
            "collect2": [r[0] for r in w2], "stages": w2[0][1],
            "schedule2": w2[0][2], "vol7": w2[0][3],
            "schedule4": out[4][0][0],
            "batched": {k: v for r in out[4] for k, v in r[1].items()},
            "multihost": [r[2] for r in out[4]]}


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
    np.testing.assert_array_equal(res["acc_nodes"],
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
    assert out["cca_rounds"] == ref.cca_rounds
    bad = testing.states_differ(ref.graph.to_numpy(), out["graph"], rtol=0.0)
    assert not bad, bad
    assert out["launches"] == {"gmr_cluster": 0, "distinct_counts": 0}


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


def test_run_batched_matches_single_device(worlds):
    """Four toy events on a (2, 2) mesh: each event's candidates and final
    state equal the single-device run's (test_parallel.py:15-49)."""
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


def test_volume7_sharded_counts(worlds):
    """Volume 7 at D = 2: the single-device port's counts [1055, 110, 2]."""
    assert worlds["vol7"]["acc_count"] == [1055, 110, 2]


def test_mesh_event_slices_and_single_process_initialize():
    assert [mesh.event_slice(5, i, 2) for i in range(2)] == [(0, 3), (3, 5)]
    assert mesh.event_slice(4, 3, 4) == (3, 4)
    multihost.initialize()               # one process: a no-op
    assert not torch.distributed.is_initialized()
