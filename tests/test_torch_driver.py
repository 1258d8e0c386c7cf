"""The port's host driver `run_pipeline` at float64 on the CPU, against the
port's fast driver and the JAX host driver, on toy events.

Tolerances: candidate node lists, masks and labels are exact.  Between the
port's two drivers p-values agree to rtol 1e-12 (same library, same
operations).  Against the JAX package they agree to rtol 1e-9, the bar of
tests/test_torch_pipeline.py (atan2/cos/sin and the incomplete gamma
function differ between the libraries in the last ulps); state arrays after
the leak replay agree to rtol 1e-12.

The toy generator gives every track one hit per layer, so its candidates
never hold the same-layer pairs that the reference's close-proximity merge
acts on, and the extraction leak never fires.  The leak cases therefore
add, for every other track, a second hit on one layer, about 0.9 mm from the
first and wired to the same neighbours."""

import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import pipeline as jax_pipeline
from gnn_track_finding_tpu.models import toymc

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.graph.build import build_event, build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline

JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)
SEEDS = [7, 11, 23]
LEAK_FIELDS = ("gnn_xyzr", "out_head_xyzr", "upd_sv", "upd_cov")
# per-node float sums the port takes in another order than XLA's
# (tests/test_torch_stages.py): rtol 1e-9 there, 1e-12 elsewhere
SUM_ORDER_FIELDS = {"grad_stats", "upd_weight", "merged_cov"}


def _toy(seed, duplicates=False):
    ev = toymc.generate_event(seed=seed, num_tracks=20, edge_dphi_window=0.12)
    xyzr, vivl, truth, pairs = ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs
    if not duplicates:
        return xyzr, vivl, truth, pairs
    n = xyzr.shape[0]
    add_x, add_v, add_t, add_p = [], [], [], []
    for t in range(0, int(truth.max()) + 1, 2):
        hits = np.flatnonzero(truth == t)
        h = hits[np.argsort(vivl[hits, 1])[len(hits) // 2]]
        x = xyzr[h, :3] + np.array([0.6, -0.4, 0.5])
        new = n + len(add_x)
        add_x.append([x[0], x[1], x[2], np.hypot(x[0], x[1])])
        add_v.append(vivl[h])
        add_t.append(truth[h])
        add_p += [(new, b) for a, b in pairs if a == h]
        add_p += [(a, new) for a, b in pairs if b == h]
    return (np.concatenate([xyzr, add_x]), np.concatenate([vivl, add_v]),
            np.concatenate([truth, add_t]), np.concatenate([pairs, add_p]))


def _by_iteration(cands):
    return [(c.iteration, tuple(int(x) for x in c.nodes)) for c in cands]


def _pvals(cands):
    return np.array([(c.pval_xy, c.pval_zr) for c in cands])


@pytest.mark.parametrize("seed", SEEDS)
def test_host_driver_matches_fast_driver_and_jax(seed):
    arrays = _toy(seed)
    jg, _ = jax_build(*arrays, JCFG)
    g = build_graph_state(*arrays, CFG, device="cpu")
    host = pipeline.run_pipeline(g, CFG)
    fast = pipeline.run_pipeline_fast(g, CFG)
    ref = jax_pipeline.run_pipeline(jg, JCFG)
    assert len(host.candidates) > 0
    assert host.cca_rounds == [0, 0, 0]
    assert _by_iteration(host.candidates) == _by_iteration(fast.candidates)
    np.testing.assert_allclose(_pvals(host.candidates),
                               _pvals(fast.candidates), rtol=1e-12)
    assert _by_iteration(host.candidates) == _by_iteration(ref.candidates)
    np.testing.assert_allclose(_pvals(host.candidates),
                               _pvals(ref.candidates), rtol=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_cca_labels_equal_fastsv_labels(seed):
    g = build_graph_state(*_toy(seed), CFG, device="cpu")
    host = pipeline.run_pipeline(g, CFG, host_cca=True)
    device = pipeline.run_pipeline(g, CFG, host_cca=False)
    assert min(device.cca_rounds) >= 2
    for a, b in zip(host.per_iteration, device.per_iteration):
        assert torch.equal(a.labels, b.labels)
        assert torch.equal(a.accepted, b.accepted)


@pytest.mark.parametrize("seed", SEEDS)
def test_leak_replay_matches_jax(seed):
    arrays = _toy(seed, duplicates=True)
    jg, jhost = jax_build(*arrays, JCFG)
    g, host = build_event(*arrays, CFG, device="cpu")
    np.testing.assert_array_equal(host.mirror, jhost.mirror)
    out = pipeline.run_pipeline(g, CFG, tracker=host.tracker)
    ref = jax_pipeline.run_pipeline(jg, JCFG, tracker=jhost.tracker)
    assert len(out.mutations) == 3 and len(out.mutations[0]) > 0
    assert _by_iteration(out.candidates) == _by_iteration(ref.candidates)
    np.testing.assert_allclose(_pvals(out.candidates), _pvals(ref.candidates),
                               rtol=1e-9)
    port = out.graph.to_numpy()
    for name in LEAK_FIELDS:
        np.testing.assert_allclose(port[name], np.asarray(getattr(ref.graph,
                                                                  name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    # the leak reached the states: without the tracker they differ
    plain = pipeline.run_pipeline(g, CFG).graph
    assert not torch.equal(plain.gnn_xyzr, out.graph.gnn_xyzr)
    assert not torch.equal(plain.upd_sv, out.graph.upd_sv)
    # and the ingested coordinates stay as they were
    assert torch.equal(g.xyzr, out.graph.xyzr)
    assert torch.equal(g.gnn_xyzr, g.xyzr)


def test_reset_reactivate_matches_jax():
    arrays = _toy(11)
    jg, _ = jax_build(*arrays, JCFG)
    jg = jax_pipeline.run_pipeline(jg, JCFG).graph
    g = tstate.from_numpy({name: np.asarray(getattr(jg, name))
                           for name in tstate.tensor_fields()},
                          n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                          max_degree=jg.max_degree, n_layers=jg.n_layers,
                          device="cpu", dtype=torch.float64)
    assert np.asarray(jg.has_updated).any() or np.asarray(jg.has_merged).any()
    ref = jax_pipeline.reset_reactivate(jg, JCFG)
    got = pipeline.reset_reactivate(g, CFG).to_numpy()
    for name in tstate.tensor_fields():
        want = np.asarray(getattr(ref, name))
        if np.issubdtype(want.dtype, np.floating):
            rtol = 1e-9 if name in SUM_ORDER_FIELDS else 1e-12
            np.testing.assert_allclose(got[name], want, rtol=rtol, atol=1e-14,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
