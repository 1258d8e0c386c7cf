"""The port's analysis and calibration studies against the JAX package's, at
float64 on the CPU: shared-hit dendrograms, Leiden / Louvain community
extraction, the p-value and purity artifacts and plots, and the
calibration plots and studies.

The host functions over a state (linkage maxima, communities, plots) are
fed the port's own states and the JAX function the same states as JAX
arrays (`_to_jax`), so their outputs must be identical: the same maxima
bit for bit, the same communities in the same order, the same modularity,
the same file bytes and file names.  The studies that drive a pipeline
(dendrogram statistics, parabolic vs linear, the LUT effect) run each
package's own stages over the same seeded toy events: their counts and
confusion rates are exact, their float values agree to rtol 1e-9 (the
port sums some per-node reductions in another order than XLA,
tests/test_torch_driver.py)."""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from gnn_track_finding_tpu.analysis import community as jax_community
from gnn_track_finding_tpu.analysis import distributions as jax_dist
from gnn_track_finding_tpu.analysis import leiden as jax_leiden
from gnn_track_finding_tpu.analysis import shared_hits as jax_shared
from gnn_track_finding_tpu.calib import plots as jax_plots
from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.state import GraphState as JaxState

from gnn_track_finding_tpu_torch.analysis import (community, distributions,
                                                  leiden, shared_hits)
from gnn_track_finding_tpu_torch.calib import plots, training_data
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.evaluation import efficiency
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc

VOL7_NPZ = (Path(__file__).resolve().parents[1] / ".event_cache"
            / "event_fafb3309e4598e9b.npz")
JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)
# wide edge gates: cross-track edges survive into iteration 2, so the toys
# have updated states with truth edges (the default toy extracts nearly
# every track in iteration 1)
WIDE = dict(edge_dphi_window=0.25, edge_dtau_window=1.0)


def _to_jax(g):
    """A JAX GraphState holding a port state's values (int64 as int32)."""
    arrays = {name: jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                else a)
              for name, a in g.to_numpy().items()}
    return JaxState(n_nodes=g.n_nodes, n_edges=g.n_edges,
                    max_degree=g.max_degree, n_layers=g.n_layers, **arrays)


@pytest.fixture(scope="module")
def toy():
    """One toy run on the port: the states after iteration 1's clustering
    and iteration 2's extrapolation, the final state and its candidates."""
    ev = toymc.generate_event(seed=11, num_tracks=24, **WIDE)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                          device="cpu")
    staged = pipeline.stage_step(pipeline.prepare(g, CFG), CFG, 1)
    updated = pipeline.stage_step(pipeline.extract_step(staged, CFG, 1)[0],
                                  CFG, 2)
    out = pipeline.run_pipeline(g, CFG)
    assert out.candidates
    return dict(ev=ev, staged=staged, updated=updated, final=out.graph,
                candidates=out.candidates)


@pytest.fixture(scope="module")
def volume7():
    """Volume 7's states on the port: after iteration 1's clustering and
    after iteration 2's extrapolation."""
    xyzr, vivl, tp, pairs, extra, pre = load_npz(VOL7_NPZ)
    cfg = PipelineConfig()
    g = build_graph_state(xyzr, vivl, tp, pairs, cfg, device="cpu",
                          mirror=pre["mirror"], component=pre["component"])
    staged = pipeline.stage_step(pipeline.prepare(g, cfg), cfg, 1)
    updated = pipeline.stage_step(pipeline.extract_step(staged, cfg, 1)[0],
                                  cfg, 2)
    return dict(staged=staged, updated=updated)


@pytest.mark.parametrize("m", [2, 3, 5, 9, 16])
def test_average_linkage_matches_jax_and_scipy(m):
    import scipy.cluster.hierarchy as sch
    rng = np.random.default_rng(m)
    feats = rng.normal(size=(m, 2))
    got = shared_hits.average_linkage_max_distance(feats)
    assert got == jax_shared.average_linkage_max_distance(feats)
    z = sch.linkage(feats, method="average")
    np.testing.assert_allclose(got, float(np.amax(z[:, 2])), rtol=1e-10)
    # tied distances: the first index of the flattened matrix wins in both
    ties = np.round(feats, 0)
    assert shared_hits.average_linkage_max_distance(ties) == \
        jax_shared.average_linkage_max_distance(ties)


@pytest.mark.parametrize("use_updated", [False, True])
@pytest.mark.parametrize("source", ["toy", "volume7"])
def test_node_dendrogram_maxima_match_jax(source, use_updated, request):
    """Volume 7's node truth labels agree across only 17 of its 7,383 hit
    pairs, so there every node gets the same label: the maxima of every
    node's active in-edges."""
    states = request.getfixturevalue(source)
    g = states["updated" if use_updated else "staged"]
    truth = (states["ev"].truth if source == "toy"
             else np.zeros(g.num_padded_nodes, np.int64))
    got = shared_hits.node_dendrogram_maxima(g, truth, use_updated)
    ref = jax_shared.node_dendrogram_maxima(_to_jax(g), truth, use_updated)
    assert ref.size > 0
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_dendrogram_statistics_match_jax():
    # the study's own buckets (256 / 1024), as the LUT study's: one padded
    # shape for every toy, so the JAX stages compile once
    kw = dict(num_runs=2, seed=11, num_tracks=24, toy_kwargs=WIDE)
    got = shared_hits.dendrogram_statistics(device="cpu", **kw)
    ref = jax_shared.dendrogram_statistics(**kw)
    for key in ("iteration1", "iteration2"):
        assert ref[key].size > 0, key
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-9, atol=0,
                                   err_msg=key)


def _planted(seed):
    """The JAX package's planted two-block graph (tests/test_analysis.py),
    or for seed >= 0 a noisy graph of three planted blocks."""
    rng = np.random.default_rng(3 if seed < 0 else seed)
    if seed < 0:
        n, blocks, p_in, noise = 24, [range(12), range(12, 24)], 0.6, 0
    else:
        n = int(rng.integers(24, 48))
        blocks, p_in, noise = np.array_split(np.arange(n), 3), 0.7, 2 * n
    edges = []
    for blk in blocks:
        for i in blk:
            for j in blk:
                if i < j and rng.random() < p_in:
                    edges.append((int(i), int(j), 1.0))
    if seed < 0:
        edges.append((3, 15, 1.0))                 # one weak bridge
    for u, v in rng.integers(0, n, (noise, 2)):
        if u != v:
            edges.append((int(u), int(v), float(rng.uniform(0.5, 2.0))))
    return n, edges


@pytest.mark.parametrize("graph_seed", [-1, 0, 1, 2, 3, 4])
def test_leiden_matches_jax(graph_seed):
    n, edges = _planted(graph_seed)
    for seed in (0, 1):
        got = leiden.leiden_communities(n, edges, seed=seed)
        assert got == jax_leiden.leiden_communities(n, edges, seed=seed)
        memb = {u: i for i, c in enumerate(got) for u in c}
        q = leiden.modularity(n, edges, memb)
        assert q == jax_leiden.modularity(n, edges, memb)
    if graph_seed < 0:
        assert sorted(map(sorted, (c for c in got if len(c) > 1))) == \
            [list(range(12)), list(range(12, 24))]


@pytest.mark.parametrize("source,method", [("toy", "leiden"),
                                           ("toy", "louvain"),
                                           ("volume7", "leiden")])
def test_detect_communities_match_jax(source, method, request):
    """On the state after iteration 1's clustering (volume 7's final state
    leaves no community that passes the filters)."""
    g = request.getfixturevalue(source)["staged"]
    cfg = CFG if source == "toy" else PipelineConfig()
    jcfg = JCFG if source == "toy" else JaxConfig()
    got = community.detect_communities(g, cfg, method=method)
    ref = jax_community.detect_communities(_to_jax(g), jcfg, method=method)
    assert ref, "vacuous: no community survives the filters"
    assert got == ref
    assert community.COMMUNITY_DETECTION is jax_community.COMMUNITY_DETECTION


@pytest.mark.parametrize("case", ["run", "edge_values", "empty"])
def test_save_pvals_csv_bytes_match_jax(case, toy, tmp_path):
    cands = toy["candidates"]
    if case == "edge_values":
        vals = [0.0, 1.0, float("nan"), 1e-300, 0.1, 5e-324, 0.30000000000000004]
        cands = [pipeline.Candidate(nodes=np.arange(3), iteration=1,
                                    pval_xy=a, pval_zr=b)
                 for a, b in zip(vals, vals[::-1])]
    elif case == "empty":
        cands = []
    distributions.save_pvals_csv(cands, str(tmp_path / "port.csv"))
    jax_dist.save_pvals_csv(cands, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_purity_csvs_and_plots_match_jax(toy, tmp_path):
    ev, cands = toy["ev"], toy["candidates"]
    rep = efficiency.evaluate_toy([c.nodes for c in cands], ev.truth, ev.vivl,
                                  CFG)
    assert len(rep.track_purities) > 0
    port, ref = tmp_path / "port", tmp_path / "jax"
    for mod, d, g in ((distributions, port, toy["final"]),
                      (jax_dist, ref, _to_jax(toy["final"]))):
        mod.save_purity_csvs(rep, str(d))
        mod.plot_purity_distribution(rep, str(d / "purity_distribution.png"))
        mod.plot_pval_distributions(cands, str(d))
        mod.plot_candidates_xy_zr(g, cands, str(d))
    for name in ("extracted_track_purities.csv",
                 "extracted_particle_purities.csv"):
        assert (port / name).read_bytes() == (ref / name).read_bytes()
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    n_port = distributions.plot_remaining_subgraphs(
        toy["final"], str(port / "remaining"), max_plots=3)
    n_ref = jax_dist.plot_remaining_subgraphs(
        _to_jax(toy["final"]), str(ref / "remaining"), max_plots=3)
    assert n_port == n_ref >= 1
    assert sorted(os.listdir(port / "remaining")) == \
        sorted(os.listdir(ref / "remaining"))


@pytest.fixture(scope="module")
def rows():
    return training_data.generate_training_data(num_events=4, seed=3,
                                                cfg=CFG, num_tracks=12,
                                                device="cpu")


@pytest.mark.parametrize("max_size,balance,seed", [(200, True, 0),
                                                   (200, False, 1),
                                                   (10**6, True, 2)])
def test_downsample_matches_jax(rows, max_size, balance, seed):
    got = plots.downsample(rows, max_size, seed=seed, balance=balance)
    np.testing.assert_array_equal(
        got, jax_plots.downsample(rows, max_size, seed=seed, balance=balance))


def test_calibration_plots_match_jax(rows, tmp_path):
    got = plots.plot_decision_boundary(rows, str(tmp_path / "port.png"))
    ref = jax_plots.plot_decision_boundary(rows, str(tmp_path / "jax.png"))
    assert got == ref
    assert 0.0 < got["recall"] <= 1.0
    plots.plot_training_scatter(rows, str(tmp_path / "scatter.png"),
                                feature="degree")
    assert sorted(os.listdir(tmp_path)) == ["jax.png", "port.png",
                                            "scatter.png"]


def test_parabolic_vs_linear_matches_jax():
    got = plots.parabolic_vs_linear(num_events=6, seed=0, device="cpu")
    ref = jax_plots.parabolic_vs_linear(num_events=6, seed=0)
    assert got["parabolic"]["separation"] > got["linear"]["separation"]
    for model in ("parabolic", "linear"):
        assert got[model]["n"] == ref[model]["n"]
        for key in ("true_kl_median", "false_kl_median", "separation"):
            np.testing.assert_allclose(got[model][key], ref[model][key],
                                       rtol=1e-9, atol=0,
                                       err_msg=f"{model} {key}")


def test_lut_effect_study_matches_jax():
    kw = dict(num_events=2, seed=50, train_events=5)
    got = plots.lut_effect_study(device="cpu", **kw)
    assert got == jax_plots.lut_effect_study(**kw)
    assert set(got) == {"fixed", "lut"}
    assert all(0.0 <= r["precision"] <= 1.0 for r in got.values())
