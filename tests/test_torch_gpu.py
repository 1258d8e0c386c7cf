"""Each CUDA kernel of the port against its plain PyTorch version on the
card, the schedule's float64 counts through the kernels, and the host
driver on the card (leak replay against the same driver on the CPU, host
CCA labels, the reference digest), and the calibrated path (the clustering
kernel under the runner's LUT thresholds, a calibrated toy run against the
same run on the CPU), and the edge-partitioned schedule on the card (2
gloo ranks on one card, 1 NCCL rank, the clustering kernel on routed
owner rows).
These tests need a CUDA device and skip without one; they import no JAX,
so they run on a machine that has only torch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: at float64 the kernels repeat their plain versions' order of
operations with no contraction (nvcc -fmad=false), so flags, masks,
counts and values are bitwise equal; at float32 the band of
tests/test_pallas_cluster.py (under 6% flag flips, rtol 1e-5 where both
merge)."""

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
                                             distinct_kernel)

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


@pytest.mark.gpu
def test_volume7_counts_through_the_kernels(cuda):
    cluster_kernel.cluster_core.launches = 0
    distinct_kernel.distinct_counts.launches = 0
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
    cluster_kernel.cluster_core.launches = 0
    distinct_kernel.distinct_counts.launches = 0
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
    here first, so the ranks load them), and the single-device run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gnn_track_finding_tpu_torch import _build
    _build.library()
    root = tmp_path_factory.mktemp("sharded")
    runs = {backend: testing.spawn_ranks(
        "schedule", world, root / backend, backend=backend, device="cuda:0",
        event={"npz": str(VOL7_NPZ)}, check_kernels=True).join()
        for backend, world in (("gloo", 2), ("nccl", 1))}
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
