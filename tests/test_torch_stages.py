"""Each stage of the port vs its JAX counterpart, from the same JAX-staged
state (handed across with GraphState.from_numpy) at float64.

Tolerances: masks, integers and labels are exact; floats agree to
rtol 1e-12 / atol 1e-14 where both packages take the same order of
operations.  Fields listed in SUM_ORDER_FIELDS come from a per-node float
sum that the port takes as a row sum over the (N, K) in-edge table (or a
cumsum over the out-edge table) where the JAX package reduces in XLA's
order; those agree to rtol 1e-9.

One float32 case checks the Kalman fit against the JAX fit evaluated op
by op (see its docstring for why not against the compiled one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph import cca as jax_cca
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import pipeline as jax_pipeline
from gnn_track_finding_tpu.models import toymc
from gnn_track_finding_tpu.ops import clustering as jax_clustering
from gnn_track_finding_tpu.ops import extract as jax_extract

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import clustering, extract, metadata

JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)

# per-node float sums taken in another order than XLA's (see module doc)
SUM_ORDER_FIELDS = {"grad_stats", "upd_weight", "merged_cov"}


def to_port(jg):
    arrays = {name: np.asarray(getattr(jg, name))
              for name in tstate.tensor_fields()}
    return tstate.from_numpy(arrays, n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                             max_degree=jg.max_degree, n_layers=jg.n_layers,
                             device="cpu", dtype=torch.float64)


def assert_state_close(jg, g):
    port = g.to_numpy()
    for name in tstate.tensor_fields():
        ref = np.asarray(getattr(jg, name))
        got = port[name]
        if np.issubdtype(ref.dtype, np.floating):
            rtol = 1e-9 if name in SUM_ORDER_FIELDS else 1e-12
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-14,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.fixture(scope="module")
def staged():
    """The JAX schedule on a toy event, stage by stage."""
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g0, _ = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, JCFG)
    s = {"built": g0}
    s["prepared"] = jax_pipeline._prepare_jit(g0, JCFG)
    s["stage1"] = jax_pipeline._stage_jit(s["prepared"], JCFG, 1, None)
    s["extract1"], s["res1"] = jax_pipeline._extract_only_jit(
        s["stage1"], JCFG, None)
    s["stage2"] = jax_pipeline._stage_jit(s["extract1"], JCFG, 2, None)
    s["extract2"], s["res2"] = jax_pipeline._extract_only_jit(
        s["stage2"], JCFG, None)
    s["meta2"] = jax_pipeline._metadata_jit(s["extract2"], JCFG)
    s["stage3"] = jax_pipeline._stage_jit(s["meta2"], JCFG, 3, None)
    assert np.asarray(s["stage2"].has_updated).any()
    return s


def test_prepare(staged):
    assert_state_close(staged["prepared"],
                       pipeline.prepare(to_port(staged["built"]), CFG))


@pytest.mark.parametrize("rnd", ["seed_round", "updated_round"])
def test_cluster_stage(staged, rnd):
    before, after, upd = (("prepared", "stage1", False) if rnd == "seed_round"
                          else ("meta2", "stage3", True))
    g = pipeline.cluster_stage(to_port(staged[before]), CFG, use_updated=upd)
    assert_state_close(staged[after], g)
    assert g.has_merged.any()


@pytest.mark.parametrize("kc", [4, 16])
def test_cluster_per_node_lut_thresholds(staged, kc):
    """Per-node KL thresholds (the calibration LUT path) through the gated
    compaction, against the JAX uncompacted XLA path."""
    jg = staged["prepared"]
    n = jg.num_padded_nodes
    thr = 2.0 + np.arange(n) % 7
    ref = jax_clustering.cluster(jg, JCFG, False, kl_thresholds=thr,
                                 backend="xla", kc=kc)
    g = clustering.cluster(to_port(jg), CFG, False,
                           kl_thresholds=torch.from_numpy(thr), kc=kc)
    assert_state_close(ref, g)


@pytest.mark.parametrize("after", ["stage1", "stage2"])
def test_fastsv_labels(staged, after):
    jg = staged[after]
    ref = jax_cca.connected_components_fastsv(jg, jg.edge_mask & jg.active)
    g = to_port(jg)
    labels, rounds = cca.connected_components_fastsv(g, g.edge_mask & g.active)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref))
    assert rounds >= 2


@pytest.mark.parametrize("it", [1, 2])
def test_extraction(staged, it):
    before, after, jres = (("stage1", "extract1", "res1") if it == 1
                           else ("stage2", "extract2", "res2"))
    g = to_port(staged[before])
    res = extract.extract_candidates(g, CFG)
    g2 = extract.apply_extraction(g, res, CFG)
    ref = staged[jres]
    for name in ("labels", "row_of_node", "cand_nodes", "cand_size",
                 "processed", "accepted", "merged_pair"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    fitted = np.asarray(ref.processed)
    assert fitted.sum() > 0
    # p-values pass through atan2/cos/sin and the incomplete gamma
    # function, whose implementations differ between the two libraries
    # in the last ulps (relatively more in the far tail: atol 1e-15 is
    # twelve decades below the 0.01 acceptance gate)
    for name in ("pval_xy", "pval_zr"):
        np.testing.assert_allclose(getattr(res, name).numpy()[fitted],
                                   np.asarray(getattr(ref, name))[fitted],
                                   rtol=1e-9, atol=1e-15, err_msg=name)
    n_acc = int(ref.acc_count)
    assert int(res.acc_count) == n_acc
    np.testing.assert_array_equal(res.acc_nodes.numpy()[:n_acc],
                                  np.asarray(ref.acc_nodes)[:n_acc])
    assert_state_close(staged[after], g2)


def test_extrapolation_stage(staged):
    g = pipeline.extrapolation_stage(to_port(staged["extract1"]), CFG)
    assert_state_close(staged["stage2"], g)


def test_extrapolation_stage_repeated(staged):
    """extrapolation_stage applied 3 times in a row to the clustered state
    against JAX's stage 2 applied as many times, the program the fixture
    already compiled; the active-edge count exact."""
    n_rep = 3
    ref = staged["stage1"]
    for _ in range(n_rep):
        ref = jax_pipeline._stage_jit(ref, JCFG, 2, None)
    g = to_port(staged["stage1"])
    for _ in range(n_rep):
        g = pipeline.extrapolation_stage(g, CFG)
    assert_state_close(ref, g)
    assert int(g.active.sum()) == int(np.asarray(ref.active).sum()) > 0


def test_metadata(staged):
    g = metadata.remove_state_metadata(to_port(staged["extract2"]), CFG)
    assert_state_close(staged["meta2"], g)


def test_kf_fit_float32_follows_jax_op_order():
    """At float32 the port's two-plane fit equals the JAX fit evaluated op
    by op.  The compiled JAX fit is no reference at float32: XLA:CPU's LLVM
    backend contracts the 31 unrolled steps into FMAs, and the fit is
    ill-conditioned enough there (P_rz starts at 1000; the Joseph update
    cancels) that this alone flips acceptance gates and turns p-values into
    NaN.  p-values agree to atol 1e-3: exp, pow and the incomplete gamma
    function differ between the two libraries in the last ulps, and the
    float32 fit amplifies that; the 0.01 acceptance gates are exact."""
    rng = np.random.default_rng(5)
    c, h = 256, JCFG.max_track_hits
    n_hits = rng.integers(3, h + 1, c)
    x = np.cumsum(rng.uniform(20, 120, (c, h)), axis=1)
    y = (rng.normal(0, 2e-4, (c, 1)) * x * x + rng.normal(0, 0.05, (c, 1)) * x
         + rng.normal(0, 0.05, (c, h)) * rng.uniform(0.2, 3, (c, 1)))
    r = x * rng.uniform(0.9, 1.1, (c, 1)) + rng.normal(0, 0.1, (c, h))
    z = x * rng.normal(0, 1.5, (c, 1)) + rng.normal(0, 0.5, (c, h))
    valid = np.arange(h)[None] < n_hits[:, None]
    coords = np.where(valid[..., None], np.stack([x, y, z, r], -1),
                      0.0).astype(np.float32)
    with jax.disable_jit():
        ref = jax_extract._kf_fit(jnp.asarray(coords), jnp.asarray(valid),
                                  jnp.asarray(n_hits), JCFG)
    got = extract._kf_fit(torch.from_numpy(coords), torch.from_numpy(n_hits),
                          CFG)
    for name, g, jr in zip(("pval_xy", "pval_zr"), got, ref):
        g, jr = g.numpy(), np.asarray(jr)
        assert g.dtype == jr.dtype == np.float32
        np.testing.assert_allclose(g, jr, rtol=0, atol=1e-3, err_msg=name)
        np.testing.assert_array_equal(g >= CFG.track_acceptance_pval,
                                      jr >= CFG.track_acceptance_pval, name)
