"""The stage and part profiler (gnn_track_finding_tpu_torch/profile_stages.py)
on CPU tensors at float64.

* The parts, run in the profiler's order, compose to the schedule: the
  final state, the accepted counts and FastSV's rounds of
  full_pipeline_results, bitwise, on one toy event and on two toys
  stacked as one program.
* The extraction parts it times against the JAX package's, on the same
  staged state (a toy and volume 7), the JAX functions evaluated op by op
  (jax.disable_jit, as tests/test_torch_stages.py's float32 fit case):
  masks and integers exact, floats within rtol 1e-12, p-values within
  pval_xy rtol 1e-9 and pval_zr rtol 1e-8; FastSV's adaptive round count
  equal to that of JAX's connected_components_fastsv (its while_loop's
  body calls counted, plus the specialised first round).
* The byte counter on known tensors; the CLI refuses to run without CUDA.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph import cca as jax_cca
from gnn_track_finding_tpu.graph.state import GraphState as JaxState
from gnn_track_finding_tpu.ops import extract as jax_extract

from gnn_track_finding_tpu_torch import profile_stages, testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import stack_events
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import extract

REPO = Path(__file__).resolve().parents[1]
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)
JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
VOL7_CFG = PipelineConfig(min_volume=7, max_volume=7)
JVOL7_CFG = JaxConfig(min_volume=7, max_volume=7)


def _toy(seed):
    ev = toymc.generate_event(seed=seed, num_tracks=20,
                              edge_dphi_window=0.12)
    return build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                             device="cpu")


@pytest.mark.parametrize("events", ["one toy", "two toys stacked"])
def test_parts_compose_to_the_schedule(events):
    """Seeds 11 and 23 share one pad bucket (N = 192, E = 512)."""
    g = _toy(11) if events == "one toy" else stack_events([_toy(11),
                                                           _toy(23)])
    prof = profile_stages.profile(g, CFG)
    ref = pipeline.full_pipeline_results(g, CFG)
    assert profile_stages.same_bits(prof.graph, ref.graph)
    # per iteration first (then per event on a stack)
    assert prof.accepted == ref.acc_count.movedim(-1, 0).tolist()
    assert prof.rounds == ref.cca_rounds.movedim(-1, 0).tolist()
    assert sum(map(np.sum, prof.accepted)) > 0

    rows = prof.rows
    stages = [(r.iteration, r.name) for r in rows if r.level == "stage"]
    assert stages == [
        (0, "pipeline.prepare"), (1, "cluster_stage (seed)"),
        (1, "extract_candidates + apply_extraction"),
        (2, "extrapolation_stage"),
        (2, "extract_candidates + apply_extraction"),
        (2, "metadata.remove_state_metadata"),
        (3, "cluster_stage (updated)"),
        (3, "extract_candidates + apply_extraction")]
    assert rows[-1].level == "whole" and rows[-1] is prof.whole()
    for r in rows:
        assert r.host_ms > 0 and r.bytes > 0
        assert r.device_ms is None and r.launches is None
        if r.level == "stage" and not r.leaf:
            parts = [q.host_ms for q in rows if q.level == "part"
                     and (q.iteration, q.stage) == (r.iteration, r.name)]
            assert len(parts) in (2, 4, 6)
            assert r.rest_ms == pytest.approx(r.host_ms - sum(parts))
    # the leaves (parts, and stages without parts) partition the schedule
    leaves = [r.name for r in rows if r.leaf]
    assert leaves.count("cluster_core (gmr_cluster)") == 2
    assert leaves.count("reweight_stage x2 (distinct_counts)") == 1
    assert leaves.count("metadata.remove_state_metadata") == 1
    assert "extract_candidates + apply_extraction" not in leaves
    text = "\n".join(profile_stages.table(prof, events))
    assert "host ms (CPU tensors)" in text and "track_fit (kf_fit)" in text


def _to_jax(g):
    """A JAX GraphState holding a port state's values (int64 as int32)."""
    arrays = {name: jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                else a)
              for name, a in g.to_numpy().items()}
    return JaxState(n_nodes=g.n_nodes, n_edges=g.n_edges,
                    max_degree=g.max_degree, n_layers=g.n_layers, **arrays)


@pytest.fixture(scope="module", params=["toy", "volume 7"])
def staged(request):
    """Iteration 1's clustered state (the input of its extraction), with
    the port's and the config of both packages."""
    if request.param == "toy":
        g, cfg, jcfg = _toy(11), CFG, JCFG
    else:
        path = REPO / ".event_cache" / "event_fafb3309e4598e9b.npz"
        g, cfg, jcfg = (testing.load_event(path, VOL7_CFG, device="cpu",
                                           dtype=torch.float64), VOL7_CFG,
                        JVOL7_CFG)
    g = pipeline.cluster_stage(pipeline.prepare(g, cfg), cfg, False)
    return g, cfg, jcfg


def _exact(got, ref, name):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), name)


def test_fastsv_rounds_equal_jax(staged, monkeypatch):
    g, cfg, _ = staged
    ok = g.edge_mask & g.active
    labels, rounds = cca.connected_components_fastsv(g, ok)
    fixed, f_rounds, converged = cca.connected_components_fixed(g, ok)
    body_calls = []

    def counted_while_loop(cond, body, state):
        calls = 0
        while bool(cond(state)):
            state = body(state)
            calls += 1
        body_calls.append(calls)
        return state

    monkeypatch.setattr(jax.lax, "while_loop", counted_while_loop)
    with jax.disable_jit():
        ref = jax_cca.connected_components_fastsv(
            _to_jax(g), jnp.asarray(ok.numpy()))
    # JAX's first (specialised) round, then one body call per round
    assert rounds == 1 + body_calls[0] == int(f_rounds) >= 2
    assert bool(converged)
    _exact(labels, ref, "labels")
    _exact(fixed, ref, "fixed-round labels")


def test_extraction_parts_equal_jax(staged):
    g, cfg, jcfg = staged
    jg = _to_jax(g)
    h, min_hits = cfg.max_track_hits, cfg.min_track_hits
    labels, _, _ = cca.connected_components_fixed(g, g.edge_mask & g.active)
    with jax.disable_jit():
        mat, size, row_of_node = extract._candidate_matrix(g, labels, h,
                                                           min_hits)
        ref = jax_extract._candidate_matrix(
            jg, jnp.asarray(labels.numpy().astype(np.int32)), h, min_hits)
        for name, got, r in zip(("mat", "size", "row_of_node"),
                                (mat, size, row_of_node), ref):
            _exact(got, r, name)
        assert int((size > 0).sum()) > 0

        merged = extract._proximity_merge(g, cfg, mat)
        ref = jax_extract._proximity_merge(jg, jcfg, ref[0], ref[1])
        np.testing.assert_allclose(merged[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-12, atol=0, err_msg="coords")
        for name, got, r in zip(("valid", "can_process", "n_pairs"),
                                merged[1:], ref[1:]):
            _exact(got, r, name)

        coords, valid, n_hits = extract._compact_rows(merged[0], merged[1])
        rotated = extract._rotate_tracks(coords, valid, n_hits, cfg)
        args = (jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
                jnp.asarray(n_hits.numpy()))
        ref_rot = jax_extract._rotate_tracks(*args, jcfg)
        # atol: the rotated coordinates that cancel to ~0 (the innermost
        # hit's y) carry the inputs' rounding, |coords| up to ~1e3
        np.testing.assert_allclose(rotated.numpy(), np.asarray(ref_rot),
                                   rtol=1e-12, atol=1e-12, err_msg="rotated")
        pvals = extract.track_fit(coords, valid, n_hits, cfg)
        ref_p = jax_extract._kf_fit(ref_rot, args[1], args[2], jcfg)
    # the rows the extraction fits (extract_candidates' `processed`)
    fitted = ((size >= min_hits) & merged[2] & (n_hits >= min_hits)).numpy()
    assert fitted.sum() > 0
    for name, got, r, rtol in zip(("pval_xy", "pval_zr"), pvals, ref_p,
                                  (1e-9, 1e-8)):
        np.testing.assert_allclose(got.numpy()[fitted],
                                   np.asarray(r)[fitted], rtol=rtol,
                                   atol=1e-15, err_msg=name)


@pytest.mark.parametrize("case", ["a + b", "a view once", "a kernel's read"])
def test_byte_count(case):
    a = torch.arange(10, dtype=torch.float64)
    b = torch.ones(10, dtype=torch.float64)
    counter = profile_stages.ByteCount()
    with counter.on():
        if case == "a + b":
            out = a + b
            want = a.nbytes + b.nbytes + out.nbytes
        elif case == "a view once":
            out = a[:5] + a[5:] * 2.0
            want = a.nbytes + out.nbytes
        else:
            # a wrapper hands its inputs to native code by pointer
            out = torch.empty(3)
            a[2:].data_ptr()
            want = a.nbytes + out.nbytes
    assert counter.total(out) == want
    assert counter.total(None) == want - out.nbytes


def test_profile_stages_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_track_finding_tpu_torch.profile_stages"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "CUDA" in proc.stderr
    assert proc.stdout == ""
