"""The port's kernel modules: each plain PyTorch version against the JAX
package's XLA function and its Pallas kernel (run in interpret mode, as
the JAX package's own tests run it on the CPU).  The CUDA kernels are
checked against these plain versions on the card by test_torch_gpu.py.

Tolerances at float64: flags, deactivation masks and counts are exact;
merged values agree to rtol 1e-12 / atol 1e-14 (same order of
operations as the XLA function)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import pipeline as jax_pipeline
from gnn_track_finding_tpu.models import toymc
from gnn_track_finding_tpu.ops import clustering as jax_clustering
from gnn_track_finding_tpu.ops import pallas_cluster, pallas_distinct
from gnn_track_finding_tpu.ops import priors as jax_priors

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             distinct_kernel, priors)

JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def _to_port(jg):
    arrays = {name: np.asarray(getattr(jg, name))
              for name in tstate.tensor_fields()}
    return tstate.from_numpy(arrays, n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                             max_degree=jg.max_degree, n_layers=jg.n_layers,
                             device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def staged():
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g0, _ = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, JCFG)
    prepared = jax_pipeline._prepare_jit(g0, JCFG)
    stage2 = jax_pipeline._stage_jit(
        jax_pipeline._stage_jit(prepared, JCFG, 1, None), JCFG, 2, None)
    return {"prepared": prepared, "stage2": stage2}


def _core_inputs(jg, kc, per_node_thr, use_updated=False, klthr=None):
    thr = None
    if per_node_thr:
        thr = torch.from_numpy(2.0 + np.arange(jg.num_padded_nodes) % 7)
    elif klthr is not None:
        thr = torch.full((jg.num_padded_nodes,), klthr, dtype=torch.float64)
    return clustering.core_inputs(_to_port(jg), CFG, use_updated, thr, kc=kc)


def _assert_core_matches_jax(states, tab, node_xyzr, klthr, chi2_thr, kc,
                             pallas=True):
    """The port's core (plain on CPU tensors) against the JAX XLA core and,
    with pallas, the interpret-mode Pallas kernel, on the same packed rows:
    flags and deactivations exact, merged values to rtol 1e-12."""
    rows = tab.shape[0]
    found, pm, pc, mprior, deact = cluster_kernel.cluster_core(
        states, tab, node_xyzr, klthr, chi2_thr=chi2_thr, cfg=CFG)
    assert found.any()

    pk_t, valid_t = cluster_kernel.pack_rows(states, tab)
    pk = jnp.asarray(pk_t.numpy())
    node = jnp.asarray(node_xyzr.numpy())
    gate = jnp.ones((rows,), bool)
    valid = jnp.asarray(valid_t.numpy())
    kl = jnp.asarray(klthr.numpy())
    xla = jax_clustering._cluster_core_xla(JCFG, chi2_thr, kl, node, gate,
                                           valid, pk, kc)
    refs = [(np.asarray(xla[0]), np.asarray(xla[1]),
             np.asarray(xla[2]).reshape(rows, 9), np.asarray(xla[3]),
             np.asarray(xla[4]))]
    if pallas:
        t = lambda a, r: jnp.moveaxis(a, 0, -1).reshape(r, rows)
        out = pallas_cluster.cluster_tile(
            JCFG, float(chi2_thr),
            t(pk[..., 12:15], 3 * kc), t(pk[..., 15:24], 9 * kc),
            t(pk[..., 0:3], 3 * kc), t(pk[..., 3:12], 9 * kc),
            t(pk[..., 24][..., None], kc),
            t(valid[..., None].astype(jnp.int32), kc),
            t(pk[..., 25:29], 4 * kc), node.T,
            gate.astype(jnp.int32)[None, :], kl[None, :], interpret=True)
        refs.append((np.asarray(out[0][0]) > 0, np.asarray(out[1]).T,
                     np.asarray(out[2]).T, np.asarray(out[3][0]),
                     np.asarray(out[4]).T > 0))
    f = found.numpy()
    for ref in refs:
        np.testing.assert_array_equal(f, ref[0])
        np.testing.assert_array_equal(deact.numpy(), ref[4])
        for got, want in ((pm, ref[1]), (pc, ref[2]), (mprior, ref[3])):
            np.testing.assert_allclose(got.numpy()[f], want[f], rtol=1e-12,
                                       atol=1e-14)
    return found, deact


@pytest.mark.parametrize("per_node_thr", [False, True])
def test_plain_cluster_core_matches_xla_and_pallas(staged, per_node_thr):
    kc = 4
    x = _core_inputs(staged["prepared"], kc, per_node_thr)
    assert x.tab.shape[0] > 0
    _assert_core_matches_jax(x.states, x.tab, x.node_xyzr, x.klthr,
                             x.chi2_thr, kc)


@pytest.fixture(scope="module")
def updated_round():
    """The port's graph after iterations 1-2 of a toy event dense enough to
    hold updated-round rows (14 rows, 11 of them found)."""
    ev = toymc.generate_event(seed=3, num_tracks=60, edge_dphi_window=0.5)
    g = pipeline.prepare(build_graph_state(
        ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG, device="cpu"), CFG)
    for i in (1, 2):
        g, _ = pipeline.iteration(g, CFG, i)
    return g


@pytest.mark.parametrize("kc", [4, 8])
def test_plain_cluster_core_updated_round_matches_xla_and_pallas(
        updated_round, kc):
    """The updated-state round, after iterations 1-2."""
    x = clustering.core_inputs(updated_round, CFG, True, kc=kc)
    assert x.tab.shape[0] >= 10
    _assert_core_matches_jax(x.states, x.tab, x.node_xyzr, x.klthr,
                             x.chi2_thr, kc)


def test_plain_cluster_core_full_absorption_matches_xla_and_pallas(staged):
    """klthr 1e30: every found row runs all its greedy steps."""
    kc = 8
    x = _core_inputs(staged["prepared"], kc, False, klthr=1e30)
    found, deact = _assert_core_matches_jax(
        x.states, x.tab, x.node_xyzr, x.klthr, x.chi2_thr, kc)
    assert not deact[found].any()


@pytest.mark.parametrize("kc", [4, 16, 32])
def test_plain_cluster_core_matches_xla_on_synthetic_rows(kc):
    """The edge cases of testing.cluster_rows (NaN chi2, NaN KL, exact
    chi2 ties, chi2 = 0 duplicates, full absorption, counts above kc)
    against the JAX XLA core."""
    counts = np.arange(3, 3 + 2 * kc) % 30 + 3
    states, tab, node, klthr = testing.cluster_rows(kc, len(counts), kc,
                                                    counts)
    found, deact = _assert_core_matches_jax(states, tab, node, klthr, 1.0, kc,
                                            pallas=False)
    assert not found.all()


def _duplicate_rich_tables(n=64, k=16, seed=0):
    rng = np.random.default_rng(seed)
    x_vals = rng.choice([1.5, 2.5, 3.5, -1.0, 0.0], size=(n, k))
    ok = rng.uniform(size=(n, k)) < 0.6
    return ok, np.where(ok, x_vals, 0.0), rng.normal(size=(n,)) * 2.0


def test_plain_distinct_counts_match_xla_and_pallas(staged):
    ok, x, node_x = _duplicate_rich_tables()
    got = distinct_kernel.distinct_counts(
        torch.from_numpy(ok), torch.from_numpy(x), torch.from_numpy(node_x))
    jx, jok, jnx = jnp.asarray(x), jnp.asarray(ok), jnp.asarray(node_x)
    xla = jax_priors._distinct_counts(jok, jx, jx < jnx[:, None], jx.dtype)
    pallas = pallas_distinct.distinct_counts_tile(jok, jx, jnx,
                                                  interpret=True, tile=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))

    # the real reweight tables of an extrapolated toy graph
    ok_t, x_t, nx_t = priors.distinct_inputs(_to_port(staged["stage2"]))
    assert ok_t.any()
    got = distinct_kernel.distinct_counts(ok_t, x_t, nx_t)
    jx = jnp.asarray(x_t.numpy())
    jnx = jnp.asarray(nx_t.numpy())
    xla = jax_priors._distinct_counts(jnp.asarray(ok_t.numpy()), jx,
                                      jx < jnx[:, None], jx.dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        distinct_kernel.distinct_counts(
            torch.zeros((2, 4), dtype=torch.bool, device=meta),
            torch.zeros((2, 4), device=meta), torch.zeros(2, device=meta))
    states = cluster_kernel.SlotStates(*(
        torch.zeros(shape, device=meta)
        for shape in ((8, 3), (8, 3, 3), (8, 3), (8, 3, 3), (8,), (8, 4))))
    with pytest.raises(ValueError, match="unsupported device"):
        cluster_kernel.cluster_core(
            states, torch.zeros((2, 4), dtype=torch.int64, device=meta),
            torch.zeros((2, 4), device=meta), torch.zeros(2, device=meta),
            chi2_thr=1.0, cfg=CFG)
