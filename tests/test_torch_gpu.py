"""Each CUDA kernel of the port against its plain PyTorch version on the
card, the schedule's float64 counts through the kernels, the schedule
captured as one CUDA graph per pad bucket against the same program run
eagerly, and the host
driver on the card (leak replay against the same driver on the CPU, host
CCA labels, the reference digest), and the calibrated path (the clustering
kernel under the runner's LUT thresholds, a calibrated toy run against the
same run on the CPU), and the edge-partitioned schedule on the card (2
gloo ranks on one card, 1 NCCL rank, the clustering kernel on routed
owner rows, the NCCL rank's schedule captured as one CUDA graph and
replayed by run_sharded and run_batched), and the kernel gate
(testing.kernel_gate) on volume 7, B events of one pad bucket as one
captured program (parallel/mesh.stack_events), and the stage and part
profiler on volume 7 (profile_stages.profile).
These tests need a CUDA device and skip without one; they import no JAX,
so they run on a machine that has only torch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: at float64 the kernels repeat their plain versions' order of
operations with no contraction (nvcc -fmad=false; the track fit's
kernel through the _rn intrinsics), so flags, masks,
counts and values are bitwise equal; the track fit's and the row merge's
kernels at float32 too; the clustering
kernel at float32 within the band of tests/test_pallas_cluster.py (under
6% flag flips, rtol 1e-5 where both merge)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_track_finding_tpu_torch import testing
from gnn_track_finding_tpu_torch.calib import lut, training_data
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph.build import build_event, build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             distinct_kernel, extract,
                                             fit_kernel, merge_kernel)
from gnn_track_finding_tpu_torch.utils import timing

VOL7_NPZ = (Path(__file__).resolve().parents[1] / ".event_cache"
            / "event_fafb3309e4598e9b.npz")
FULL_NPZ = VOL7_NPZ.parent / "event_7bba1cb4ae95bca1.npz"
CFG = PipelineConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _volume7(device, dtype):
    xyzr, vivl, tp, pairs, _, pre = load_npz(VOL7_NPZ)
    g = build_graph_state(xyzr, vivl, tp, pairs, CFG, device=device,
                          dtype=dtype, mirror=pre["mirror"],
                          component=pre["component"])
    return g


def _assert_core_equal(got, want, dtype):
    """float64: bitwise (flags, masks, values; NaN where the plain version
    has NaN); float32: the flag band, values where both merge."""
    f = want[0]
    if dtype == torch.float64:
        assert torch.equal(got[0], f) and torch.equal(got[4], want[4])
        for a, b in zip(got[1:4], want[1:4]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    else:
        assert (got[0] != f).sum() <= 0.06 * f.numel()
        both = got[0] & f
        for a, b in zip(got[1:4], want[1:4]):
            torch.testing.assert_close(a[both], b[both], rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("kc", [4, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cluster_kernel_matches_plain(cuda, kc, dtype):
    g = pipeline.prepare(_volume7(cuda, dtype), CFG)
    thr = 2.0 + torch.arange(g.num_padded_nodes, device=cuda) % 7
    x = clustering.core_inputs(g, CFG, False, thr, kc=kc)
    inputs = (x.states, x.tab, x.node_xyzr, x.klthr)
    want = cluster_kernel.cluster_core_plain(*inputs, chi2_thr=x.chi2_thr,
                                             cfg=CFG)
    assert want[0].any()
    before = cluster_kernel.cluster_core.launches
    got = cluster_kernel.cluster_core(*inputs, chi2_thr=x.chi2_thr, cfg=CFG)
    assert cluster_kernel.cluster_core.launches == before + 1
    torch.cuda.synchronize()
    _assert_core_equal(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [0, 1, 3, 33])
@pytest.mark.parametrize("kc", [4, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cluster_kernel_matches_plain_on_synthetic_rows(cuda, rows, kc, dtype):
    """Member counts 3..15 (3..32 at kc 32) mixed inside each warp, NaN
    chi2 and NaN KL slots, exact chi2 ties, duplicated states (chi2 = 0),
    klthr 1e30 (full absorption), row counts that are no multiple of the
    rows per warp (testing.cluster_rows)."""
    hi = 33 if kc == 32 else 16
    counts = 3 + (np.arange(rows) * 7) % (hi - 3)
    inputs = testing.cluster_rows(rows + kc, rows, kc, counts, dtype=dtype,
                                  device=cuda)
    want = cluster_kernel.cluster_core_plain(*inputs, chi2_thr=1.0, cfg=CFG)
    got = cluster_kernel.cluster_core(*inputs, chi2_thr=1.0, cfg=CFG)
    torch.cuda.synchronize()
    _assert_core_equal(got, want, dtype)
    if rows == 33:
        assert want[0].any() and not want[0].all()


@pytest.mark.gpu
def test_cluster_stage_on_the_card_reads_the_edge_tensors(cuda, monkeypatch):
    """On the card the clustering round builds no packed (E, 29) table and
    no (rows, kc, 29) gather: only the plain version calls pack_rows."""
    g = pipeline.prepare(_volume7(cuda, torch.float64), CFG)

    def refuse(*args):
        raise AssertionError("pack_rows called on the card path")

    monkeypatch.setattr(cluster_kernel, "pack_rows", refuse)
    before = cluster_kernel.cluster_core.launches
    got = clustering.cluster(g, CFG, False)
    assert cluster_kernel.cluster_core.launches == before + 1
    assert got.has_merged.any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_occupancy(cuda, dtype):
    for kc in (4, 16, 32):
        occ = cluster_kernel.occupancy(dtype, kc)
        assert occ["blocks_per_sm"] >= 1, occ
    assert distinct_kernel.occupancy(dtype)["blocks_per_sm"] >= 1
    assert fit_kernel.occupancy(dtype)["blocks_per_sm"] >= 1
    assert merge_kernel.occupancy(dtype)["blocks_per_sm"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_distinct_kernel_matches_plain(cuda, k, dtype):
    rng = np.random.default_rng(k)
    ok = torch.from_numpy(rng.uniform(size=(1000, k)) < 0.6).to(cuda)
    x = torch.from_numpy(rng.choice([1.5, 2.5, 3.5, -1.0, 0.0],
                                    size=(1000, k))).to(cuda, dtype)
    node_x = torch.from_numpy(rng.normal(size=1000) * 2.0).to(cuda, dtype)
    got = distinct_kernel.distinct_counts(ok, x, node_x)
    want = distinct_kernel.distinct_counts_plain(ok, x, x < node_x[:, None],
                                                 dtype)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [32, 64, 128, 40])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_distinct_kernel_matches_plain_on_edge_cases(cuda, k, dtype):
    """Empty rows, all-ok rows with duplicates, x equal to node_x, NaN,
    -0.0 beside 0.0 (testing.distinct_tables); K = 40 takes the byte path
    (rows not 16-byte aligned)."""
    ok, x, node_x = testing.distinct_tables(k, 997, k, dtype=dtype,
                                            device=cuda)
    before = distinct_kernel.distinct_counts.launches
    got = distinct_kernel.distinct_counts(ok, x, node_x)
    assert distinct_kernel.distinct_counts.launches == before + 1
    want = distinct_kernel.distinct_counts_plain(ok, x, x < node_x[:, None],
                                                 dtype)
    assert torch.equal(got, want)
    assert torch.equal(got[::6], torch.zeros_like(got[::6]))   # empty rows


BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _fit_differs(rows, cfg):
    """The fit kernel against its plain version on the card, on the same
    rows: the chi2 sums and the p-values bit for bit.  -> the outputs
    that differ (NaN included: it must be the same NaN)."""
    coords, valid, n_hits = rows
    plain_chi = extract._kf_chi2(
        extract._rotate_tracks(coords, valid, n_hits, cfg), n_hits, cfg)
    before = fit_kernel.chi2_sums.launches
    got_p = extract.track_fit(coords, valid, n_hits, cfg)
    got_chi = fit_kernel.chi2_sums(coords, valid, n_hits, cfg)
    assert fit_kernel.chi2_sums.launches == before + 2
    want_p = extract.track_fit_plain(coords, valid, n_hits, cfg)
    torch.cuda.synchronize()
    names = ("chi_xy", "chi_rz", "pval_xy", "pval_zr")
    bits = BITS[coords.dtype]
    return [name for name, a, b in zip(names, got_chi + got_p,
                                       plain_chi + want_p)
            if not torch.equal(a.view(bits), b.view(bits))]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [0, 1, 9, 1000])
@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fit_kernel_matches_plain_on_synthetic_rows(cuda, dtype, bug_compat,
                                                    rows):
    """testing.fit_rows: n_hits 0 to 3 and H, denom == 0, hyp == 0,
    dz == 0 (beside dr != 0 in the endcap), hits at the origin, endcap
    hits, the innermost pair under the separation threshold, a repeated
    hit mid-track; row counts that are no multiple of a block."""
    cfg = PipelineConfig(bug_compat=bug_compat)
    assert not _fit_differs(testing.fit_rows(rows, rows, dtype=dtype,
                                             device=cuda), cfg)


@pytest.fixture(scope="module")
def extraction_rows():
    """The compacted rows each of the three extractions hands the fit, at
    float64, for the full event, volume 7 and volume 7 in 32 rotated
    copies stacked (testing.extraction_rows: recorded at
    extract.track_fit in an eager run of the schedule).  The stack holds
    an endcap row whose dz == 0 steps make var_ms ~ |dr| / 1e-300: there
    one ulp of float64 pow moved a chi2 sum by 1.4e-4 relative when the
    kernel was built with -fmad=false (csrc/kf_fit.cu)."""
    from gnn_track_finding_tpu_torch.parallel import mesh
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda = torch.device("cuda")
    rows = {}
    cfgs = {"full": PipelineConfig(min_volume=7, max_volume=14), "vol7": CFG,
            "vol7x32": CFG}
    for name, path in (("full", FULL_NPZ), ("vol7", VOL7_NPZ),
                       ("vol7x32", None)):
        if path is None:
            g = mesh.stack_events([
                testing.load_event(VOL7_NPZ, CFG, device=cuda,
                                   dtype=torch.float64, copy=b, copies=32)
                for b in range(32)])
        else:
            xyzr, vivl, tp, pairs, _, pre = load_npz(path)
            g = build_graph_state(xyzr, vivl, tp, pairs, cfgs[name],
                                  device=cuda, mirror=pre["mirror"],
                                  component=pre["component"])
        rows[name] = testing.extraction_rows(g, cfgs[name])
    return rows, cfgs


@pytest.mark.gpu
@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("event", ["full", "vol7", "vol7x32"])
def test_fit_kernel_matches_plain_on_extraction_rows(extraction_rows, event,
                                                     dtype, bug_compat):
    """The rows of the event's three extractions (float32: the same rows
    rounded), both bug_compat modes: the kernel bitwise its plain version
    on the card, chi2 sums and p-values."""
    rows, cfgs = extraction_rows
    assert len(rows[event]) == 3
    cfg = dataclasses.replace(cfgs[event], bug_compat=bug_compat)
    for it, (coords, valid, n_hits) in enumerate(rows[event]):
        assert int((n_hits >= cfg.min_track_hits).sum()) > 0
        assert not _fit_differs((coords.to(dtype), valid, n_hits), cfg), it


@pytest.mark.gpu
def test_fit_kernel_refuses_what_it_cannot_take(cuda):
    coords, valid, n_hits = testing.fit_rows(0, 8, device=cuda)
    bad = {"coords": (coords.transpose(1, 2), valid, n_hits),
           "dtype": (coords.half(), valid, n_hits),
           "valid": (coords, valid[:, :-1], n_hits),
           "n_hits": (coords, valid, n_hits.int()),
           "device": (coords, valid, n_hits.cpu())}
    for name, args in bad.items():
        with pytest.raises(ValueError, match="kf_fit"):
            fit_kernel.chi2_sums(*args, CFG)


@pytest.mark.gpu
def test_fit_kernel_takes_the_place_of_the_fit_nodes(cuda):
    """The full event's captured program holds at most 3,000 graph nodes
    (the torch fit alone was 36,099), and kf_fit launches 3 times a
    replay in it and in the program of 32 volume-7 events stacked."""
    from gnn_track_finding_tpu_torch.parallel import mesh
    pipeline.clear_programs()
    cfg = PipelineConfig(min_volume=7, max_volume=14)
    xyzr, vivl, tp, pairs, _, pre = load_npz(FULL_NPZ)
    g = build_graph_state(xyzr, vivl, tp, pairs, cfg, device=cuda,
                          mirror=pre["mirror"], component=pre["component"])
    prog = pipeline.captured_program(g, cfg)
    assert prog.kernel_launches == {"gmr_cluster": 2, "distinct_counts": 3,
                                    "kf_fit": 3, "row_merge": 3}
    assert prog.capture.graph_nodes <= 3000, prog.capture.graph_nodes
    pipeline.clear_programs()
    stack = mesh.stack_events([
        testing.load_event(VOL7_NPZ, CFG, device=cuda, dtype=torch.float64,
                           copy=b, copies=32) for b in range(32)])
    prog = pipeline.captured_program(stack, CFG)
    assert prog.kernel_launches == {"gmr_cluster": 2, "distinct_counts": 3,
                                    "kf_fit": 3, "row_merge": 3}
    pipeline.clear_programs()


def _merge_differs(state, mat, cfg):
    """The row_merge kernel against its plain version (_proximity_merge
    then _compact_rows) on the card, on the same rows: every output bit
    for bit.  -> the outputs that differ."""
    before = merge_kernel.merge_rows.launches
    got = extract.merge_rows(state, cfg, mat)
    assert merge_kernel.merge_rows.launches == before + 1
    assert got[0].is_contiguous()
    want = extract.merge_rows_plain(state, cfg, mat)
    torch.cuda.synchronize()
    names = ("coords", "valid", "n_hits", "can_process", "n_pairs")
    differ = []
    for name, a, b in zip(names, got, want):
        if a.dtype in BITS:
            a, b = a.view(BITS[a.dtype]), b.view(BITS[b.dtype])
        if a.dtype != b.dtype or not torch.equal(a, b):
            differ.append(name)
    return differ


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [0, 1, 37, 1000])
@pytest.mark.parametrize("h", [8, 32, 40, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_merge_kernel_matches_plain_on_synthetic_rows(cuda, dtype, h, rows):
    """testing.merge_cases: empty rows, full rows, pairs within, beyond
    and at exactly node_merge_distance, one, two and three layers with
    pairs, a layer with three hits, a pair at slots 0 and 1 and at
    H - 2 and H - 1, a pair 3 slots apart, an empty slot inside a row;
    H below, at and above 32 (the shared-memory path), row counts that
    are no multiple of a block."""
    state, mat = testing.merge_cases(rows + h, rows, h, dtype=dtype,
                                     device=cuda)
    assert not _merge_differs(state, mat, CFG)


@pytest.fixture(scope="module")
def merge_inputs():
    """What each of the three extractions hands extract.merge_rows at
    float64 (testing.merge_inputs: recorded in an eager run of the
    schedule), for the full event and volume 7 in 32 rotated copies
    stacked."""
    from gnn_track_finding_tpu_torch.parallel import mesh
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda = torch.device("cuda")
    full_cfg = PipelineConfig(min_volume=7, max_volume=14)
    xyzr, vivl, tp, pairs, _, pre = load_npz(FULL_NPZ)
    full = build_graph_state(xyzr, vivl, tp, pairs, full_cfg, device=cuda,
                             mirror=pre["mirror"], component=pre["component"])
    stack = mesh.stack_events([
        testing.load_event(VOL7_NPZ, CFG, device=cuda, dtype=torch.float64,
                           copy=b, copies=32) for b in range(32)])
    return {"full": (testing.merge_inputs(full, full_cfg), full_cfg),
            "vol7x32": (testing.merge_inputs(stack, CFG), CFG)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("event", ["full", "vol7x32"])
def test_merge_kernel_matches_plain_on_extraction_rows(merge_inputs, event,
                                                       dtype):
    """The candidate rows of the event's three extractions (float32: the
    same coordinates rounded): the kernel bitwise its plain version on
    the card, every output; the rows hold merged pairs and rows that
    cannot be processed."""
    calls, cfg = merge_inputs[event]
    assert len(calls) == 3
    for it, (state, mat) in enumerate(calls):
        state = state._replace(xyzr=state.xyzr.to(dtype))
        assert not _merge_differs(state, mat, cfg), it
    pairs = [int(extract.merge_rows(s, cfg, m)[4].sum()) for s, m in calls]
    assert pairs[0] > 0, pairs


@pytest.mark.gpu
def test_merge_kernel_refuses_what_it_cannot_take(cuda):
    state, mat = testing.merge_cases(0, 4, 8, device=cuda)
    x, v = state.xyzr, state.vivl
    wide = torch.full((4, merge_kernel.MAX_H + 1), -1, dtype=torch.int64,
                      device=cuda)
    bad = {"mat dtype": (mat.int(), x, v), "mat strides": (mat.t(), x, v),
           "mat width": (wide, x, v), "xyzr dtype": (mat, x.half(), v),
           "xyzr width": (mat, x[:, :3], v), "vivl dtype": (mat, x, v.int()),
           "vivl rows": (mat, x, v[:-1]), "device": (mat, x, v.cpu()),
           "host mat": (mat.cpu(), x, v)}
    for name, args in bad.items():
        with pytest.raises(ValueError, match="row_merge"):
            merge_kernel.merge_rows(*args, CFG.node_merge_distance)


@pytest.mark.gpu
def test_merge_kernel_launches_three_times_an_event(cuda):
    """Volume 7: one launch per extraction eagerly and per replay of the
    captured program, and the captured counts are the reference's."""
    g = _volume7(cuda, torch.float64)
    pipeline.reset_kernel_launches()
    pipeline.run_pipeline_eager(g, CFG)
    assert merge_kernel.merge_rows.launches == 3
    pipeline.clear_programs()
    prog = pipeline.captured_program(g, CFG)
    assert prog.kernel_launches["row_merge"] == 3
    out = pipeline.run_pipeline_fast(g, CFG)
    assert [sum(1 for c in out.candidates if c.iteration == i)
            for i in (1, 2, 3)] == [1055, 110, 2]
    pipeline.clear_programs()


@pytest.mark.gpu
def test_volume7_counts_through_the_kernels(cuda):
    pipeline.reset_kernel_launches()
    out = pipeline.run_pipeline_fast(_volume7(cuda, torch.float64), CFG)
    per_it = [sum(1 for c in out.candidates if c.iteration == i)
              for i in (1, 2, 3)]
    assert per_it == [1055, 110, 2]
    assert cluster_kernel.cluster_core.launches > 0
    assert distinct_kernel.distinct_counts.launches > 0


def _volume7_with_tracker(device):
    """Volume 7 ingested with the mirror and components the port computes
    itself, and the NetworkX-order tracker."""
    xyzr, vivl, tp, pairs, extra, pre = load_npz(VOL7_NPZ)
    g, host = build_event(xyzr, vivl, tp, pairs, CFG, device=device,
                          node_ids=extra["node_ids"])
    assert (host.mirror == pre["mirror"]).all()
    return g, host


@pytest.mark.gpu
def test_host_driver_with_leak_replay_through_the_kernels(cuda):
    g, host = _volume7_with_tracker(cuda)
    pipeline.reset_kernel_launches()
    out = pipeline.run_pipeline(g, CFG, tracker=host.tracker)
    per_it = [sum(1 for c in out.candidates if c.iteration == i)
              for i in (1, 2, 3)]
    assert per_it == [1055, 110, 2]
    assert len(out.mutations[0]) > 0 and out.cca_rounds == [0, 0, 0]
    assert cluster_kernel.cluster_core.launches > 0
    assert distinct_kernel.distinct_counts.launches > 0
    assert out.graph.gnn_xyzr.is_cuda and out.per_iteration[0].labels.is_cuda


@pytest.mark.gpu
def test_host_driver_states_on_the_card_match_the_cpu_driver(cuda):
    """The leak path on the card (pinned mask copy, host CCA labels, replay,
    mutation scatter) against the same driver on CPU tensors, which
    tests/test_torch_driver.py holds to the JAX driver: the same mutations
    per extraction, the same candidate nodes, states to rtol 1e-12, and
    p-values to rtol 1e-6: the card's atan2/sin/cos differ from the CPU's
    in the last ulp, and one ulp on each rotated coordinate moves the
    ill-conditioned track fit's p-values by up to 1.5e-8 relative."""
    runs = [pipeline.run_pipeline(g, CFG, tracker=host.tracker)
            for g, host in (_volume7_with_tracker(d)
                            for d in (cuda, torch.device("cpu")))]
    card, cpu = runs
    assert card.mutations == cpu.mutations and len(cpu.mutations[0]) > 0
    assert [(c.iteration, c.nodes.tolist()) for c in card.candidates] == \
        [(c.iteration, c.nodes.tolist()) for c in cpu.candidates]
    pv = lambda r: [(c.pval_xy, c.pval_zr) for c in r.candidates]
    np.testing.assert_allclose(pv(card), pv(cpu), rtol=1e-6, atol=0)
    for name in ("gnn_xyzr", "out_head_xyzr", "upd_sv", "upd_cov"):
        torch.testing.assert_close(getattr(card.graph, name).cpu(),
                                   getattr(cpu.graph, name), rtol=1e-12,
                                   atol=1e-14, msg=name)


@pytest.mark.gpu
def test_host_cca_labels_equal_fastsv_labels_on_the_card(cuda):
    g, _ = _volume7_with_tracker(cuda)
    host = pipeline.run_pipeline(g, CFG, host_cca=True)
    device = pipeline.run_pipeline(g, CFG, host_cca=False)
    fast = pipeline.run_pipeline_fast(g, CFG)
    for a, b in zip(host.per_iteration, device.per_iteration):
        assert torch.equal(a.labels, b.labels)
    cands = lambda r: [(c.iteration, c.nodes.tolist()) for c in r.candidates]
    assert cands(host) == cands(device) == cands(fast)


@pytest.mark.gpu
def test_reference_digest_on_the_card(cuda):
    import sys
    sys.path.insert(0, str(VOL7_NPZ.parents[1]))
    from tools import validate_port_vs_reference as vpr
    res = vpr.compare(vpr.load_digest(), vpr.compute_port_states(cuda),
                      log=lambda *a: None)
    assert (res["seed_cmp"], res["clus_cmp"], res["upd_cmp"]) == (14766, 8748,
                                                                  434)
    assert all(v == 1.0 for k, v in res.items() if not k.endswith("_cmp"))


def _runner_lut(device):
    """The LUT of the runner's calibration (20 toy events, seed 0, quantile
    rule on emp_var)."""
    rows = training_data.generate_training_data(num_events=20, seed=0,
                                                device=device)
    return lut.fit_lut_quantile(rows, feature="emp_var")


@pytest.mark.gpu
@pytest.mark.parametrize("use_updated", [False, True], ids=["seed", "updated"])
def test_cluster_kernel_matches_plain_under_lut_thresholds(cuda, use_updated):
    """The full event's compacted rows under the runner's per-node LUT
    thresholds (0 to 4.1e8, mixed inside each warp): the seed round after
    prepare, the updated round after iterations 1 and 2 under the same
    thresholds; bitwise at float64."""
    xyzr, vivl, tp, pairs, _, pre = load_npz(FULL_NPZ)
    cfg = PipelineConfig(min_volume=7, max_volume=14)
    g = build_graph_state(xyzr, vivl, tp, pairs, cfg, device=cuda,
                          mirror=pre["mirror"], component=pre["component"])
    thr = lut.node_thresholds(_runner_lut(cuda), g, cfg)
    g = pipeline.prepare(g, cfg)
    if use_updated:
        for i in (1, 2):
            g, _ = pipeline.iteration(g, cfg, i, thr)
    x = clustering.core_inputs(g, cfg, use_updated, thr)
    assert torch.unique(x.klthr).numel() > 2
    inputs = (x.states, x.tab, x.node_xyzr, x.klthr)
    want = cluster_kernel.cluster_core_plain(*inputs, chi2_thr=x.chi2_thr,
                                             cfg=cfg)
    got = cluster_kernel.cluster_core(*inputs, chi2_thr=x.chi2_thr, cfg=cfg)
    torch.cuda.synchronize()
    assert want[0].any()
    _assert_core_equal(got, want, torch.float64)


@pytest.mark.gpu
def test_calibrated_toy_run_on_the_card_matches_the_cpu(cuda):
    """The runner's --toy --calibrate path (run_pipeline with the LUT
    thresholds and the tracker) on the card and on CPU tensors: the same
    thresholds, mutations and candidate nodes; p-values to rtol 1e-6 (see
    test_host_driver_states_on_the_card_match_the_cpu_driver)."""
    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    table = _runner_lut(cuda)
    ev = toymc.generate_event(num_tracks=50, seed=1)
    runs, thresholds = [], []
    for device in (cuda, torch.device("cpu")):
        g, host = build_event(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                              device=device)
        thr = lut.node_thresholds(table, g, cfg)
        thresholds.append(thr.cpu())
        runs.append(pipeline.run_pipeline(g, cfg, kl_thresholds=thr,
                                          tracker=host.tracker))
    card, cpu = runs
    assert torch.equal(*thresholds) and thresholds[0].unique().numel() > 1
    assert card.mutations == cpu.mutations
    cands = lambda r: [(c.iteration, c.nodes.tolist()) for c in r.candidates]
    assert cands(card) == cands(cpu) and card.candidates
    pv = lambda r: [(c.pval_xy, c.pval_zr) for c in r.candidates]
    np.testing.assert_allclose(pv(card), pv(cpu), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def sharded_volume7(tmp_path_factory):
    """schedule_sharded on volume 7 at float64 over 2 gloo ranks on
    cuda:0 and over 1 NCCL rank (spawned processes; the kernels are built
    here first, so the ranks load them), and the single-device run.  The
    NCCL rank also runs the captured program (runs["nccl_captured"]),
    run_batched on a (1, 1) mesh over volume 7 twice
    (runs["nccl_batched"]) and run_sharded on two volume-7 copies stacked
    (runs["nccl_stacked"])."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gnn_track_finding_tpu_torch import _build
    _build.library()
    root = tmp_path_factory.mktemp("sharded")
    event = {"npz": str(VOL7_NPZ)}
    schedule = dict(event=event, check_kernels=True)
    gloo = testing.spawn_ranks("schedule", 2, root / "gloo", backend="gloo",
                               device="cuda:0", **schedule)
    nccl = testing.spawn_ranks(
        "sequence", 1, root / "nccl", backend="nccl", device="cuda:0",
        jobs=[("schedule", schedule), ("captured", dict(event=event, reps=1)),
              ("batched", dict(events=[event] * 2, shape=(1, 1))),
              ("captured", dict(event={"stack": [event] * 2}, reps=1))])
    runs = {"gloo": gloo.join()}
    (seq,) = nccl.join()
    runs.update(nccl=[seq[0]], nccl_captured=seq[1],
                nccl_batched=seq[2]["events"], nccl_stacked=seq[3])
    ref = pipeline.full_pipeline_results(
        _volume7(torch.device("cuda"), torch.float64), CFG)
    return runs, ref


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_sharded_volume7_on_the_card_matches_the_single_device_port(
        sharded_volume7, backend):
    """2 gloo ranks / 1 NCCL rank on the card: the counts [1055, 110, 2],
    the single-device candidates (p-values bitwise) and the gathered state
    (masks and integers exact, floats rtol 1e-12, grad_stats' variances to
    1e-12 of their second moment); every rank launched both kernels."""
    runs, ref = sharded_volume7
    ranks = runs[backend]
    out = ranks[0]
    assert out["acc_count"] == ref.acc_count.tolist() == [1055, 110, 2]
    np.testing.assert_array_equal(out["acc_nodes"], ref.acc_nodes.cpu().numpy())
    np.testing.assert_array_equal(out["acc_pvals"], ref.acc_pvals.cpu().numpy())
    bad = testing.states_differ(ref.graph.to_numpy(), out["graph"], rtol=1e-12)
    assert not bad, bad
    # the backend was handed every collective's CUDA tensor: nothing staged
    assert {c["device"] for c in out["census"]} == {"cuda"}
    for o in ranks:
        assert all(n > 0 for n in o["launches"].values()), o["launches"]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_kernels_on_routed_owner_rows_match_plain(sharded_volume7, backend):
    """On every rank, the clustering kernel on the owner rows the
    all_to_all routed to it (seed round; volume 7 gates no row in the
    updated round) and the distinct counts of the first reweight pass,
    bitwise against their plain versions."""
    runs, _ = sharded_volume7
    for o in runs[backend]:
        checks = o["kernel_checks"]
        assert checks["cluster_seed"]["found"] > 0
        assert all(c["bitwise"] for c in checks.values()), checks


@pytest.mark.gpu
def test_nccl_rank_replays_the_captured_sharded_schedule(sharded_volume7):
    """The NCCL rank's run_sharded captures its schedule as one CUDA graph
    (collectives and both kernels inside): its first call, a replay and a
    replay under sync debug mode "error" are bitwise the eager body's run,
    and the results the single-device run's ([1055, 110, 2]); no
    fallback."""
    runs, ref = sharded_volume7
    cap = runs["nccl_captured"]
    assert cap["path"] == "captured" and cap["programs"] == 1
    assert cap["differs"] == {"first": [], "replay": [], "sync_debug": []}
    out = cap["result"]
    assert out["acc_count"] == ref.acc_count.tolist() == [1055, 110, 2]
    np.testing.assert_array_equal(out["acc_nodes"], ref.acc_nodes.cpu().numpy())
    np.testing.assert_array_equal(out["acc_pvals"], ref.acc_pvals.cpu().numpy())
    assert not testing.states_differ(ref.graph.to_numpy(), out["graph"],
                                     rtol=0.0)
    assert all(n > 0 for n in cap["launches"].values()), cap["launches"]
    assert cap["first_call_collectives"] == 2 * len(cap["census"])
    assert cap["fallbacks"] == 0


@pytest.mark.gpu
def test_run_batched_replays_one_program_per_nccl_rank(sharded_volume7):
    """run_batched on a (1, 1) NCCL mesh, volume 7 twice: the two events
    as one batched program (an edge group of one rank needs no
    collective), one program captured, each event of its replay bitwise
    the single-device run."""
    runs, ref = sharded_volume7
    got = runs["nccl_batched"]
    assert sorted(got) == [0, 1]
    for o in got.values():
        assert o["path"] == "captured" and o["programs"] == 1
        assert o["acc_count"] == ref.acc_count.tolist()
        np.testing.assert_array_equal(o["acc_nodes"],
                                      ref.acc_nodes.cpu().numpy())
        assert not testing.states_differ(ref.graph.to_numpy(), o["graph"],
                                         rtol=0.0)


@pytest.mark.gpu
def test_nccl_rank_replays_a_stacked_sharded_batch(sharded_volume7):
    """Two volume-7 copies stacked and run through run_sharded on the NCCL
    rank of one: one captured program, its first call, a replay and a
    replay under sync debug mode "error" bitwise the eager body's run,
    each event bitwise its single-device batched replay and at the
    single-device counts, 2 / 3 / 3 / 3 kernel launches per replay, no
    fallback."""
    runs, ref = sharded_volume7
    cap = runs["nccl_stacked"]
    assert cap["path"] == "captured" and cap["paths"] == ["captured"] * 2
    assert cap["differs"] == {"first": [], "replay": [], "sync_debug": []}
    assert cap["single_differs"] == [[], []]
    assert cap["launches"] == {"gmr_cluster": 2, "distinct_counts": 3,
                               "kf_fit": 3, "row_merge": 3}
    for out in cap["result"]:
        assert out["acc_count"] == ref.acc_count.tolist() == [1055, 110, 2]
    assert cap["fallbacks"] == 0


def _bitwise_diff(a, b):
    """Fields of two PipelineResults that differ bit for bit: candidates
    (nodes, p-values), FastSV rounds, the final state's tensors."""
    from gnn_track_finding_tpu_torch.graph.state import tensor_fields
    bad = []
    key = lambda r: [(c.iteration, c.nodes.tolist(),
                      np.float64(c.pval_xy).tobytes(),
                      np.float64(c.pval_zr).tobytes()) for c in r.candidates]
    if key(a) != key(b):
        bad.append("candidates")
    if a.cca_rounds != b.cca_rounds:
        bad.append("cca_rounds")
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    for name in tensor_fields():
        x, y = getattr(a.graph, name), getattr(b.graph, name)
        if x.dtype in bits:
            x, y = x.view(bits[x.dtype]), y.view(bits[y.dtype])
        if not torch.equal(x, y):
            bad.append(name)
    return bad


def _toy_graph(device, seed=1, num_tracks=50, dtype=torch.float64):
    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    ev = toymc.generate_event(num_tracks=num_tracks, seed=seed)
    return build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                             device=device, dtype=dtype), cfg


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("event", ["toy", "volume7"])
def test_captured_schedule_equals_eager(cuda, event, dtype):
    """run_pipeline_fast replays the pad bucket's CUDA graph: its first
    call (the capture) and a replay are bitwise the eager program's run
    (candidates, p-values, FastSV rounds, every field of the final state),
    with both kernels in the graph and no fallback."""
    pipeline.clear_programs()
    if event == "toy":
        g, cfg = _toy_graph(cuda, dtype=dtype)
    else:
        g, cfg = _volume7(cuda, dtype), CFG
    before = pipeline.fallbacks
    first = pipeline.run_pipeline_fast(g, cfg)
    prog = pipeline.captured_program(g, cfg)
    assert all(n > 0 for n in prog.kernel_launches.values()), \
        prog.kernel_launches
    # the graph was kept (keep_graph=True) to count its nodes
    assert pipeline.captures[-1] is prog.capture
    assert prog.capture.graph_nodes > 0
    n_launches = (cluster_kernel.cluster_core.launches,
                  distinct_kernel.distinct_counts.launches)
    replayed = pipeline.run_pipeline_fast(g, cfg)
    assert n_launches == (cluster_kernel.cluster_core.launches,
                          distinct_kernel.distinct_counts.launches)
    eager = pipeline.run_pipeline_eager(g, cfg)
    assert not _bitwise_diff(first, eager) and not _bitwise_diff(replayed,
                                                                 eager)
    assert pipeline.fallbacks == before and first.candidates
    if event == "volume7" and dtype == torch.float64:
        per_it = [sum(1 for c in first.candidates if c.iteration == i)
                  for i in (1, 2, 3)]
        assert per_it == [1055, 110, 2]
    pipeline.clear_programs()


@pytest.mark.gpu
def test_two_events_of_one_bucket_share_one_program(cuda):
    """Two toy events of different true sizes in one pad bucket go through
    one captured program, streamed and solo, each bitwise its eager run."""
    pipeline.clear_programs()
    graphs = [_toy_graph(cuda, seed=s, num_tracks=t)[0]
              for s, t in ((3, 40), (5, 45))]
    cfg = _toy_graph(cuda)[1]
    assert graphs[0].n_nodes != graphs[1].n_nodes
    streamed = list(pipeline.stream_pipeline(iter(graphs * 2), cfg, depth=2))
    assert pipeline.captured_program(graphs[0], cfg) is \
        pipeline.captured_program(graphs[1], cfg)
    for g, out in zip(graphs * 2, streamed):
        assert not _bitwise_diff(out, pipeline.run_pipeline_eager(g, cfg))
        assert (out.graph.n_nodes, out.graph.n_edges) == (g.n_nodes,
                                                          g.n_edges)
    pipeline.clear_programs()


@pytest.mark.gpu
@pytest.mark.parametrize("event", ["toys", "volume7"])
def test_batched_replay_equals_eager_and_single_replays(cuda, event):
    """B events of one pad bucket as one captured program (distinct toys,
    or volume 7 in 4 copies rotated about the beam axis): the first call
    (the capture) and a replay are, event by event, bitwise the batched
    eager run and the event's own single-event replay (candidates,
    p-values, FastSV rounds, every field of the final state), with both
    kernels in the batched graph and no fallback."""
    from gnn_track_finding_tpu_torch.parallel import mesh
    pipeline.clear_programs()
    if event == "toys":
        cfg = _toy_graph(cuda)[1]
        graphs = [_toy_graph(cuda, seed=s, num_tracks=t)[0]
                  for s, t in ((3, 40), (5, 45), (7, 42))]
    else:
        cfg = CFG
        graphs = [testing.load_event(VOL7_NPZ, cfg, device=cuda,
                                     dtype=torch.float64, copy=b, copies=4)
                  for b in range(4)]
    before = pipeline.fallbacks
    singles = [pipeline.run_pipeline_fast(g, cfg) for g in graphs]
    first = pipeline.run_pipeline_batched(graphs, cfg)
    prog = pipeline.captured_program(mesh.stack_events(graphs), cfg)
    assert prog.kernel_launches == {"gmr_cluster": 2, "distinct_counts": 3,
                                    "kf_fit": 3, "row_merge": 3}
    replayed = pipeline.run_pipeline_batched(graphs, cfg)
    eager = pipeline.run_pipeline_batched(graphs, cfg, eager=True)
    for b, single in enumerate(singles):
        assert single.candidates
        for got in (first[b], replayed[b]):
            assert not _bitwise_diff(got, eager[b]), b
            assert not _bitwise_diff(got, single), b
    assert pipeline.fallbacks == before
    if event == "volume7":
        per_it = [sum(1 for c in first[0].candidates if c.iteration == i)
                  for i in (1, 2, 3)]
        assert per_it == [1055, 110, 2]
    pipeline.clear_programs()


@pytest.mark.gpu
def test_replay_makes_no_synchronising_call(cuda):
    """Copying an event in, the replay, the state clone and the readback
    copy run under torch.cuda.set_sync_debug_mode("error")."""
    g = _volume7(cuda, torch.float64)
    prog = pipeline.captured_program(g, CFG)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = prog.launch(g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not _bitwise_diff(pending.result(),
                             pipeline.run_pipeline_eager(g, CFG))
    pipeline.clear_programs()


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["volume7", "synthetic"])
def test_cluster_kernel_reads_the_row_count_on_the_device(cuda, source):
    """The kernel with a device row count over a static row table: bitwise
    its plain version with the same count on every row (the live rows as
    without a count, the rest not found with zero outputs)."""
    if source == "volume7":
        g = pipeline.prepare(_volume7(cuda, torch.float64), CFG)
        x = clustering.core_inputs(g, CFG, False)
        inputs, count, thr = ((x.states, x.tab, x.node_xyzr, x.klthr),
                              x.count, x.chi2_thr)
        assert 0 < int(count) < x.tab.shape[0]
    else:
        inputs = testing.cluster_rows(9, 99, 16, device=cuda)
        count, thr = torch.tensor(61, device=cuda), 1.0
    live = int(count)
    want = cluster_kernel.cluster_core_plain(*inputs, count, chi2_thr=thr,
                                             cfg=CFG)
    got = cluster_kernel.cluster_core(*inputs, count, chi2_thr=thr, cfg=CFG)
    uncounted = cluster_kernel.cluster_core(*inputs, chi2_thr=thr, cfg=CFG)
    torch.cuda.synchronize()
    _assert_core_equal(got, want, torch.float64)
    assert want[0][:live].any() and not got[0][live:].any()
    for a, b in zip(got, uncounted):
        assert torch.equal(a[:live], b[:live])
    assert not got[4][live:].any() and not got[1][live:].any()


@pytest.mark.gpu
def test_kernel_gate_on_the_card(cuda):
    """The kernel gate on volume 7 at float64: both kernels bitwise their
    plain versions on the event's own inputs, and the reference's
    counts."""
    g = _volume7(cuda, torch.float64)
    gate = testing.kernel_gate(g, CFG, [1055, 110, 2])
    assert gate["gmr_cluster"]["flips"] == 0
    pipeline.clear_programs()


@pytest.mark.gpu
def test_profile_stages_on_the_card(cuda):
    """profile_stages.profile on volume 7 at float64: every row captured
    bitwise its eager output, with device times and launches; 2
    gmr_cluster, 3 distinct_counts, 3 kf_fit and 3 row_merge launches over the leaf
    rows, as in the whole replay; the stage rows' kernel time within 25%
    of the replay's; the reference's counts; FastSV within R_CAP
    rounds."""
    from gnn_track_finding_tpu_torch import profile_stages
    from gnn_track_finding_tpu_torch.graph import cca
    prof = profile_stages.profile(_volume7(cuda, torch.float64), CFG)
    assert all(r.bitwise for r in prof.rows)
    assert all(r.device_ms > 0 and r.warm_ms > 0 and r.launches > 0
               for r in prof.rows)
    whole = prof.whole()
    assert prof.leaf_kernels() == whole.kernels == {
        "gmr_cluster": 2, "distinct_counts": 3, "kf_fit": 3, "row_merge": 3}
    assert 0.75 <= prof.stage_sum_ms("kernel_ms") / whole.kernel_ms <= 1.25
    assert prof.accepted == [1055, 110, 2]
    assert all(r <= cca.R_CAP for r in prof.rounds)
    assert prof.launch_node_ms > 0


@pytest.mark.gpu
def test_captured_stream_event_records_its_spans(cuda):
    """A streamed event replayed under the profiler records the launch and
    its four parts, then the readback wait and the unpack: one event id,
    the dispatch's number (its row 0 for the wait and the unpack)."""
    from torch.profiler import ProfilerActivity, profile
    pipeline.clear_programs()
    g, cfg = _toy_graph(cuda)
    pipeline.run_pipeline_fast(g, cfg)          # the capture, unprofiled
    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = list(pipeline.stream_pipeline(iter([g]), cfg))
    records = timing.spans()
    timing.clear_spans()
    assert not _bitwise_diff(out[0], pipeline.run_pipeline_eager(g, cfg))
    assert [r.name for r in records] == [
        "pipeline.launch", "pipeline.copy_in", "pipeline.replay",
        "pipeline.clone_out", "pipeline.unstack", "pipeline.wait",
        "pipeline.unpack"]
    assert [r.parent for r in records] == [None, 0, 0, 0, 0, None, None]
    dispatch = records[0].event
    assert [r.event for r in records] == [dispatch] * 5 + [(dispatch, 0)] * 2
    assert all(r.end_ns is not None for r in records)
    pipeline.clear_programs()


@pytest.mark.gpu
def test_graph_nodes_are_the_device_events_of_a_replay(cuda):
    """The capture record's node count is what the profiler counts as
    device work (kernels, copies, memsets) in one replay of the graph."""
    pipeline.clear_programs()
    g = _volume7(cuda, torch.float64)
    prog = pipeline.captured_program(g, CFG)
    busy = timing.busy_share(prog.graph.replay)
    assert busy.events == prog.capture.graph_nodes > 0
    assert prog.capture.bucket == (g.num_padded_nodes, g.num_padded_edges,
                                   g.max_degree, 1)
    pipeline.clear_programs()


@pytest.mark.gpu
def test_busy_share_counts_no_record_function_range(cuda):
    """A record_function range around the profiled call lies on the
    device's timeline too; busy_share counts the same device events with
    it as without, and no event of its name."""
    from torch.profiler import record_function
    pipeline.clear_programs()
    g, cfg = _toy_graph(cuda)
    prog = pipeline.captured_program(g, cfg)

    def wrapped():
        with record_function("test.wrapped"):
            prog.graph.replay()

    plain = [timing.busy_share(prog.graph.replay) for _ in range(2)]
    ranged = timing.busy_share(wrapped)
    assert plain[0].events == plain[1].events == ranged.events > 0
    assert not any("test.wrapped" in n for n in ranged.count_by_name)
    kernel_ms = [sum(ms for _, ms in b.ms_by_name) for b in plain + [ranged]]
    assert kernel_ms[2] <= 1.5 * max(kernel_ms[:2]), kernel_ms
    pipeline.clear_programs()
