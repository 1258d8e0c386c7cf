"""Extraction's proximity merge and row compaction entry (extract.merge_rows)
on CPU tensors: it is the plain version, extract._proximity_merge then
extract._compact_rows, bit for bit, and launches nothing; it refuses any
device but the CPU and CUDA; extraction merges only through it and fits
what it gives; the synthetic rows that tests/test_torch_gpu.py holds the
row_merge kernel to reach every verdict of the merge; and on those rows,
which hold same-layer pairs (the toy generator makes none), the plain
merge and the compaction after it are the JAX package's (evaluated op by
op, jax.disable_jit): masks and integers exact, coordinates within rtol
1e-12."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.ops import extract as jax_extract

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import extract, merge_kernel

CFG = PipelineConfig()
BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype in BITS:
        a, b = a.view(BITS[a.dtype]), b.view(BITS[b.dtype])
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("h", [8, 32, 40])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_merge_rows_on_cpu_is_the_plain_version(dtype, h):
    state, mat = testing.merge_cases(5, 60, h, dtype=dtype)
    before = merge_kernel.merge_rows.launches
    got = extract.merge_rows(state, CFG, mat)
    assert merge_kernel.merge_rows.launches == before
    coords, valid_m, can_process, n_pairs = extract._proximity_merge(
        state, CFG, mat)
    want = (*extract._compact_rows(coords, valid_m), can_process, n_pairs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert _same_bits(g, w)


def test_merge_rows_refuses_other_devices():
    meta = torch.device("meta")
    state = testing.MergeState(torch.zeros((4, 4), device=meta),
                               torch.zeros((4, 2), dtype=torch.int64,
                                           device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        extract.merge_rows(state, CFG,
                           torch.zeros((2, 8), dtype=torch.int64, device=meta))


def test_extraction_merges_through_the_entry_point(monkeypatch):
    """extract_candidates hands its candidate matrix to extract.merge_rows
    once, fits exactly the rows it returns, and keeps its n_pairs."""
    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    ev = toymc.generate_event(num_tracks=30, seed=2)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                          device=torch.device("cpu"))
    g = pipeline.cluster_stage(pipeline.prepare(g, cfg), cfg, False)
    merges, fits = [], []
    merge_entry, fit_entry = extract.merge_rows, extract.track_fit

    def merged(*args):
        out = merge_entry(*args)
        merges.append((args, out))
        return out

    def fitted(*args):
        fits.append(args)
        return fit_entry(*args)

    monkeypatch.setattr(extract, "merge_rows", merged)
    monkeypatch.setattr(extract, "track_fit", fitted)
    res = extract.extract_candidates(g, cfg)
    assert len(merges) == 1 and len(fits) == 1
    (_, _, mat), out = merges[0]
    assert torch.equal(mat, res.cand_nodes)
    for a, b in zip(fits[0][:3], out[:3]):
        assert a is b
    assert torch.equal(res.merged_pair, out[4])
    assert int(res.acc_count) > 0


def test_merge_cases_reach_every_verdict():
    """Per kind of testing.merge_cases, what the plain merge makes of it:
    whether the row can be processed, its merged pairs and the slots the
    merge removes."""
    h = 32
    state, mat = testing.merge_cases(7, 3 * len(testing.MERGE_KINDS), h)
    coords, valid, n_hits, can, pairs = extract.merge_rows_plain(state, CFG,
                                                                 mat)
    live = (mat >= 0).sum(1)
    expect = {  # kind: (can_process, n_pairs, slots removed)
        "empty": (True, 0, 0), "full": (True, 0, 0), "short": (True, 0, 0),
        "near_pair": (True, 1, 1), "far_pair": (False, 0, 0),
        "edge_pair": (True, 1, 1), "first_pair": (True, 1, 1),
        "last_pair": (True, 1, 1), "apart_pair": (True, 1, 1),
        "two_pairs": (True, 2, 2), "full_pairs": (True, 2, 2),
        "three_pairs": (False, 0, 0), "triple": (False, 0, 0),
        "near_and_far": (False, 0, 0), "gap": (True, 1, 1)}
    for row in range(mat.shape[0]):
        kind = testing.MERGE_KINDS[row % len(testing.MERGE_KINDS)]
        got = (bool(can[row]), int(pairs[row]), int(live[row] - n_hits[row]))
        assert got == expect[kind], (row, kind, got)
        assert bool(valid[row, :n_hits[row]].all())
        assert not bool(valid[row, n_hits[row]:].any())
        assert not bool(coords[row, n_hits[row]:].any())
    kinds = [testing.MERGE_KINDS[r % len(testing.MERGE_KINDS)]
             for r in range(mat.shape[0])]
    at = lambda kind: [r for r, k in enumerate(kinds) if k == kind]
    assert all(int(live[r]) == h for r in at("full") + at("last_pair")
               + at("full_pairs"))
    # the last pair's partner at slot h - 1, the first pair's lead at 0
    key = state.vivl[mat.clamp(min=0)] @ torch.tensor([1000, 1])
    assert all(int(key[r, h - 1]) == int(key[r, h - 2])
               for r in at("last_pair"))
    assert all(int(key[r, 0]) == int(key[r, 1]) for r in at("first_pair"))
    # a gap row has an empty slot before a live one
    assert all(bool(((mat[r, :-1] < 0) & (mat[r, 1:] >= 0)).any())
               for r in at("gap"))


def _jax_compact(coords, valid_m):
    """The JAX package's row compaction as extract_candidates writes it
    inline (gnn_track_finding_tpu/ops/extract.py:368-383): n_hits, the
    rank of each valid slot, the one-hot (H, H) plane and its einsum."""
    n_hits = jnp.sum(valid_m, axis=1)
    h = valid_m.shape[1]
    rank = jnp.cumsum(valid_m, axis=1) - 1
    slots = jnp.arange(h, dtype=rank.dtype)[None, None, :]
    perm = valid_m[:, :, None] & (rank[:, :, None] == slots)
    coords_c = jnp.einsum("cij,cik->cjk", perm.astype(coords.dtype), coords)
    valid_c = jnp.arange(h, dtype=jnp.int32)[None, :] < n_hits[:, None]
    return coords_c, valid_c, n_hits


@pytest.mark.parametrize("h", [8, 32])
def test_plain_merge_matches_jax_on_same_layer_pairs(h):
    state, mat = testing.merge_cases(13, 2 * len(testing.MERGE_KINDS), h)
    got = extract._proximity_merge(state, CFG, mat)
    jg = types.SimpleNamespace(xyzr=jnp.asarray(state.xyzr.numpy()),
                               vivl=jnp.asarray(state.vivl.numpy()))
    jmat = jnp.asarray(mat.numpy().astype(np.int32))
    with jax.disable_jit():
        ref = jax_extract._proximity_merge(jg, JaxConfig(), jmat,
                                           jnp.sum(jmat >= 0, axis=1))
    assert int(got[3].sum()) > 0 and not bool(got[2].all())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-12, atol=0, err_msg="coords")
    for name, a, b in zip(("valid", "can_process", "n_pairs"), got[1:],
                          ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    # the compaction, on rows where the merge removed a slot before others
    coords_c, valid_c, n_hits = extract._compact_rows(got[0], got[1])
    with jax.disable_jit():
        ref_c = _jax_compact(ref[0], ref[1])
    moved = (~got[1][:, :-1] & got[1][:, 1:]).any(1)
    assert int(((mat >= 0).sum(1) > n_hits)[moved].sum()) > 0
    np.testing.assert_allclose(coords_c.numpy(), np.asarray(ref_c[0]),
                               rtol=1e-12, atol=0, err_msg="coords_c")
    np.testing.assert_array_equal(valid_c.numpy(), np.asarray(ref_c[1]),
                                  err_msg="valid_c")
    np.testing.assert_array_equal(n_hits.numpy(), np.asarray(ref_c[2]),
                                  err_msg="n_hits")
