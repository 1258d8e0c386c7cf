"""The track fit's entry point (extract.track_fit) on CPU tensors: it is
the plain version, extract.track_fit_plain, bit for bit, and launches
nothing; it refuses any device but the CPU and
CUDA; extraction reaches the fit only through it; and the synthetic rows
that tests/test_torch_gpu.py holds the kernel to on the card reach every
guard of the plain version.  No JAX: the plain version's agreement with
the JAX package is tests/test_torch_stages.py's and
tests/test_torch_profile_stages.py's."""

import pytest
import torch

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import extract, fit_kernel

CFG = PipelineConfig()
BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(BITS[a.dtype]),
                                              b.view(BITS[b.dtype]))


@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_track_fit_on_cpu_is_the_plain_version(dtype, bug_compat):
    cfg = PipelineConfig(bug_compat=bug_compat)
    rows = testing.fit_rows(5, 90, dtype=dtype)
    before = fit_kernel.chi2_sums.launches
    got = extract.track_fit(*rows, cfg)
    want = extract.track_fit_plain(*rows, cfg)
    assert fit_kernel.chi2_sums.launches == before
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    assert (want[0] > 0).any() and (want[0] < 1).any()


def test_track_fit_refuses_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        extract.track_fit(
            torch.zeros((2, 4, 4), device=meta),
            torch.zeros((2, 4), dtype=torch.bool, device=meta),
            torch.zeros(2, dtype=torch.int64, device=meta), CFG)


def test_extraction_fits_through_the_entry_point(monkeypatch):
    """extract_candidates hands its compacted rows to extract.track_fit
    once, and its p-values are the plain version's on those rows."""
    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    ev = toymc.generate_event(num_tracks=30, seed=2)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                          device=torch.device("cpu"))
    g = pipeline.cluster_stage(pipeline.prepare(g, cfg), cfg, False)
    calls = []
    entry = extract.track_fit

    def recorded(*args):
        calls.append(args)
        return entry(*args)

    monkeypatch.setattr(extract, "track_fit", recorded)
    res = extract.extract_candidates(g, cfg)
    assert len(calls) == 1
    coords, valid, n_hits, _ = calls[0]
    want = extract.track_fit_plain(coords, valid, n_hits, cfg)
    assert _same_bits(res.pval_xy, want[0]) and _same_bits(res.pval_zr,
                                                           want[1])
    assert int(res.acc_count) > 0


def test_fit_rows_reach_every_guard():
    """On the rows the kernel is held to: steps with denom == 0, hyp == 0,
    dz == 0 (and dz == 0 beside dr != 0 in the endcap), endcap and barrel
    steps, and rows whose innermost pair falls under the separation
    threshold; n_hits 0..3 and H among the rows."""
    coords, valid, n_hits = testing.fit_rows(5, 90)
    h = coords.shape[1]
    rot = extract._rotate_tracks(coords, valid, n_hits, CFG)
    ok = torch.arange(1, h)[None, :] < n_hits[:, None]       # step i: i, i+1
    x2, x3 = rot[:, :-1, 0], rot[:, 1:, 0]
    dr = rot[:, 1:, 3] - rot[:, :-1, 3]
    dz = rot[:, 1:, 2] - rot[:, :-1, 2]
    endcap = rot[:, 1:, 2].abs() >= CFG.endcap_boundary
    denom = (0.0 - x2) * (0.0 - x3) * (x2 - x3)
    counts = {
        "denom == 0": denom == 0.0,
        "hyp == 0": torch.sqrt(dr * dr + dz * dz) == 0.0,
        "dz == 0, dr != 0, endcap": (dz == 0) & (dr != 0) & endcap,
        "endcap": endcap,
        "barrel": ~endcap,
    }
    for name, hit in counts.items():
        assert int((hit & ok).sum()) > 0, name
    take = lambda k: coords[torch.arange(coords.shape[0]),
                            torch.clamp(n_hits - k, min=0)]
    d = torch.linalg.vector_norm((take(1) - take(2))[:, :3], dim=1)
    assert bool(((d < CFG.separation_3d_threshold) & (n_hits >= 3)).any())
    assert set(range(4)) | {h} <= set(n_hits.tolist())
