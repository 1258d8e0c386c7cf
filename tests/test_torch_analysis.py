"""The port's post-hoc audits and statistics against the JAX package's, at
float64 on the CPU.

The audits (quality_check, remaining, pulls, state_distances) are host
numpy code over a graph state: each is fed the port's states of one toy
run and the JAX package's function the same states (as JAX arrays), so
their outputs must be identical.  The statistics harness runs each
package's own pipeline over seeded toy events: truth labels, purities and
the sweep's kept fractions are exact; the sweep's updated weights agree to
rtol 1e-9 (the port sums them in another order than XLA,
tests/test_torch_driver.py).  The accumulated pval_xy agree to rtol 1e-9,
pval_zr to rtol 1e-8.  Over toy seeds 0-7 (12 and 20 tracks,
tools/pvalue_gaps.py) pval_xy differ by at most 2.1e-10 relative and
pval_zr by up to 1.55e-9 (20 tracks, seed 6, candidate 0; here seed 4,
candidate 1: 1.14e-9).  The pval_zr gaps are the JAX package's compiled
fit: XLA:CPU's LLVM backend contracts it into fused multiply-adds, and
with XLA_FLAGS=--xla_backend_optimization_level=0 every toy pval_zr gap
falls below 2e-15."""

import jax.numpy as jnp
import numpy as np
import pytest

from gnn_track_finding_tpu.analysis import pulls as jax_pulls
from gnn_track_finding_tpu.analysis import quality_check as jax_qc
from gnn_track_finding_tpu.analysis import remaining as jax_remaining
from gnn_track_finding_tpu.analysis import state_distances as jax_sd
from gnn_track_finding_tpu.analysis import stats_harness as jax_stats
from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.state import GraphState as JaxState

from gnn_track_finding_tpu_torch.analysis import (pulls, quality_check,
                                                  remaining, state_distances,
                                                  stats_harness)
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc

JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def _to_jax(g):
    """A JAX GraphState holding a port state's values (int64 as int32)."""
    arrays = {name: jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                else a)
              for name, a in g.to_numpy().items()}
    return JaxState(n_nodes=g.n_nodes, n_edges=g.n_edges,
                    max_degree=g.max_degree, n_layers=g.n_layers, **arrays)


@pytest.fixture(scope="module")
def runs():
    """One toy run's states (prepared, staged for iteration 1, after
    iterations 1 and 2, final), each with its JAX twin, and candidates."""
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                          device="cpu")
    prep = pipeline.prepare(g, CFG)
    it2 = prep
    for i in (1, 2):
        it2, _ = pipeline.iteration(it2, CFG, i)
    result = pipeline.run_pipeline(g, CFG)
    assert result.candidates
    states = {"prep": prep, "staged": pipeline.stage_step(prep, CFG, 1),
              "it2": it2, "final": result.graph}
    out = {name: (s, _to_jax(s)) for name, s in states.items()}
    out.update(ev=ev, candidates=result.candidates)
    return out


def _assert_dicts_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_quality_check_matches_jax(runs):
    ev = runs["ev"]
    g = runs["prep"][0]
    cands = [c.nodes for c in runs["candidates"]]
    iso = np.array([0, g.n_nodes - 1])                  # planted fragment
    args = (ev.xyzr, ev.vivl)
    fields = lambda audits: [
        (a.nodes.tolist(), a.min_hits_ok, a.r_order_connected,
         a.z_order_connected, a.no_layer_holes, a.layer_order_connected)
        for a in audits]
    for lists, mask in ((cands + [iso], g.edge_mask),
                        ([iso] + cands[:2], g.edge_mask & False)):
        got = quality_check.quality_check_candidates(
            lists, *args, g.src, g.dst, mask, min_track_hits=CFG.min_track_hits)
        ref = jax_qc.quality_check_candidates(
            lists, *args, g.src.numpy(), g.dst.numpy(), mask.numpy(),
            min_track_hits=CFG.min_track_hits)
        assert fields(got) == fields(ref)
        assert quality_check.summarize(got) == jax_qc.summarize(ref)
    assert quality_check.summarize(got)["clean"] < len(got)


def test_remaining_audits_match_jax(runs):
    final, jfinal = runs["final"]
    assert remaining.analyse_remaining(final) == \
        jax_remaining.analyse_remaining(jfinal)
    for g, jg in (runs["it2"], runs["final"]):
        assert remaining.updated_state_coverage(g) == \
            jax_remaining.updated_state_coverage(jg)
    assert remaining.updated_state_coverage(runs["it2"][0])["fraction"] > 0
    _assert_dicts_equal(remaining.close_proximity_separations(final),
                        jax_remaining.close_proximity_separations(jfinal))
    staged, jstaged = runs["staged"]
    got = remaining.node_weight_distributions(staged, runs["candidates"])
    ref = jax_remaining.node_weight_distributions(jstaged, runs["candidates"])
    assert list(got) == list(ref)
    for i in ref:
        _assert_dicts_equal(got[i], ref[i])
    assert sum(w.size for per in got.values() for w in per.values()) > 0


def test_close_proximity_separations_match_jax_on_a_doubled_layer():
    """Two tracks merged at one layer: layer 2 holds two hits that both
    connect to the layer-1 hit (the JAX package's own test case)."""
    n = 8
    xyzr = np.zeros((n, 4))
    xyzr[:, 0] = [1, 2, 2, 3, 4, 5, 6, 7]
    xyzr[:, 1] = [0, 0.5, -0.5, 0, 0, 0, 0, 0]
    xyzr[:, 3] = np.hypot(xyzr[:, 0], xyzr[:, 1])
    vivl = np.stack([np.full(n, 7), [1, 2, 2, 3, 4, 5, 6, 7]], axis=1)
    pairs = np.array([(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (4, 5),
                      (5, 6), (6, 7)])
    g = build_graph_state(xyzr, vivl, np.arange(n), pairs, CFG, device="cpu")
    got = remaining.close_proximity_separations(g)
    assert got["extractable_components"] == 1
    _assert_dicts_equal(got,
                        jax_remaining.close_proximity_separations(_to_jax(g)))


def test_pull_residuals_match_jax(runs):
    g, jg = runs["prep"]
    got = pulls.pull_residuals(g, CFG)
    ref = jax_pulls.pull_residuals(jg, JCFG)
    assert ref["pull_a"].size > 0
    _assert_dicts_equal(got, ref)
    true_b = got["pull_b"][got["truth"] == 1]
    assert pulls.fwhm(true_b) == jax_pulls.fwhm(true_b)


def test_updated_state_distances_match_jax(runs):
    g, jg = runs["it2"]
    got = state_distances.updated_state_distances(g, CFG)
    ref = jax_sd.updated_state_distances(jg, JCFG)
    assert ref["kl"].size > 0
    _assert_dicts_equal(got, ref)


def test_accumulate_pvals_and_uniformity_match_jax():
    kw = dict(num_runs=2, seed=3, num_tracks=12)
    got = stats_harness.accumulate_pvals(cfg=CFG, device="cpu", **kw)
    ref = jax_stats.accumulate_pvals(cfg=JCFG, **kw)
    assert ref["pvals_xy"].size > 0
    np.testing.assert_array_equal(got["purity"], ref["purity"])
    for k, rtol in (("pvals_xy", 1e-9), ("pvals_zr", 1e-8)):
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=0,
                                   err_msg=k)
    for bins in (4, 10):
        got_u = stats_harness.uniformity_check(ref["pvals_xy"], bins=bins)
        assert got_u == jax_stats.uniformity_check(ref["pvals_xy"], bins=bins)


def test_reweight_threshold_sweep_matches_jax():
    kw = dict(num_runs=1, seed=0, num_tracks=24)
    got = stats_harness.reweight_threshold_sweep(cfg=CFG, device="cpu", **kw)
    ref = jax_stats.reweight_threshold_sweep(cfg=JCFG, **kw)
    assert (ref["truth"] == 0).any() and (ref["truth"] == 1).any()
    for k in ("truth", "thresholds", "signal_kept", "background_kept"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["weight"], ref["weight"], rtol=1e-9,
                               atol=0)
