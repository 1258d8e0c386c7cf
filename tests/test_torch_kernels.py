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

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import state as tstate
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


def _core_inputs(jg, kc, per_node_thr):
    thr = None
    if per_node_thr:
        thr = torch.from_numpy(2.0 + np.arange(jg.num_padded_nodes) % 7)
    return clustering.core_inputs(_to_port(jg), CFG, False, thr, kc=kc)


@pytest.mark.parametrize("per_node_thr", [False, True])
def test_plain_cluster_core_matches_xla_and_pallas(staged, per_node_thr):
    kc = 4
    x = _core_inputs(staged["prepared"], kc, per_node_thr)
    rows = x.pk.shape[0]
    found, pm, pc, mprior, deact = cluster_kernel.cluster_core(
        x.pk, x.node_xyzr, x.gate, x.klthr, x.valid, chi2_thr=x.chi2_thr,
        cfg=CFG)
    assert found.any()

    pk = jnp.asarray(x.pk.numpy())
    node = jnp.asarray(x.node_xyzr.numpy())
    gate = jnp.asarray(x.gate.numpy())
    valid = jnp.asarray(x.valid.numpy())
    klthr = jnp.asarray(x.klthr.numpy())
    xla = jax_clustering._cluster_core_xla(JCFG, x.chi2_thr, klthr, node,
                                           gate, valid, pk, kc)
    t = lambda a, r: jnp.moveaxis(a, 0, -1).reshape(r, rows)
    pallas = pallas_cluster.cluster_tile(
        JCFG, float(x.chi2_thr),
        t(pk[..., 12:15], 3 * kc), t(pk[..., 15:24], 9 * kc),
        t(pk[..., 0:3], 3 * kc), t(pk[..., 3:12], 9 * kc),
        t(pk[..., 24][..., None], kc),
        t(valid[..., None].astype(jnp.int32), kc),
        t(pk[..., 25:29], 4 * kc), node.T,
        gate.astype(jnp.int32)[None, :], klthr[None, :], interpret=True)
    pallas = (np.asarray(pallas[0][0]) > 0, np.asarray(pallas[1]).T,
              np.asarray(pallas[2]).T, np.asarray(pallas[3][0]),
              np.asarray(pallas[4]).T > 0)
    xla = (np.asarray(xla[0]), np.asarray(xla[1]),
           np.asarray(xla[2]).reshape(rows, 9), np.asarray(xla[3]),
           np.asarray(xla[4]))
    f = found.numpy()
    for ref in (xla, pallas):
        np.testing.assert_array_equal(f, ref[0])
        np.testing.assert_array_equal(deact.numpy(), ref[4])
        for got, want in ((pm, ref[1]), (pc, ref[2]), (mprior, ref[3])):
            np.testing.assert_allclose(got.numpy()[f], want[f], rtol=1e-12,
                                       atol=1e-14)


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
    with pytest.raises(ValueError, match="unsupported device"):
        cluster_kernel.cluster_core(
            torch.zeros((2, 4, 29), device=meta), None, None, None, None,
            chi2_thr=1.0, cfg=CFG)
