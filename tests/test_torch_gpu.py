"""Each CUDA kernel of the port against its plain PyTorch version on the
card, and the schedule's float64 counts through the kernels.  These tests
need a CUDA device and skip without one; they import no JAX, so they run
on a machine that has only torch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: at float64 the kernels repeat their plain versions' order of
operations with no contraction (nvcc -fmad=false), so flags, masks and
counts are exact and values agree to rtol 1e-12; at float32 the band of
tests/test_pallas_cluster.py (under 6% flag flips, rtol 1e-5 where both
merge)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             distinct_kernel)

VOL7_NPZ = (Path(__file__).resolve().parents[1] / ".event_cache"
            / "event_fafb3309e4598e9b.npz")
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


@pytest.mark.gpu
@pytest.mark.parametrize("kc", [4, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cluster_kernel_matches_plain(cuda, kc, dtype):
    g = pipeline.prepare(_volume7(cuda, dtype), CFG)
    thr = 2.0 + torch.arange(g.num_padded_nodes, device=cuda) % 7
    x = clustering.core_inputs(g, CFG, False, thr, kc=kc)
    args = (x.pk, x.node_xyzr, x.gate, x.klthr, x.valid)
    before = cluster_kernel.cluster_core.launches
    got = cluster_kernel.cluster_core(*args, chi2_thr=x.chi2_thr, cfg=CFG)
    assert cluster_kernel.cluster_core.launches == before + 1
    want = cluster_kernel.cluster_core_plain(*args, chi2_thr=x.chi2_thr,
                                             cfg=CFG)
    torch.cuda.synchronize()
    f = want[0]
    assert f.any()
    if dtype == torch.float64:
        assert torch.equal(got[0], f) and torch.equal(got[4], want[4])
        for a, b in zip(got[1:4], want[1:4]):
            torch.testing.assert_close(a[f], b[f], rtol=1e-12, atol=1e-14)
    else:
        assert (got[0] != f).float().mean() < 0.06
        both = got[0] & f
        for a, b in zip(got[1:4], want[1:4]):
            torch.testing.assert_close(a[both], b[both], rtol=1e-5, atol=1e-7)


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
def test_volume7_counts_through_the_kernels(cuda):
    cluster_kernel.cluster_core.launches = 0
    distinct_kernel.distinct_counts.launches = 0
    out = pipeline.run_pipeline_fast(_volume7(cuda, torch.float64), CFG)
    per_it = [sum(1 for c in out.candidates if c.iteration == i)
              for i in (1, 2, 3)]
    assert per_it == [1055, 110, 2]
    assert cluster_kernel.cluster_core.launches > 0
    assert distinct_kernel.distinct_counts.launches > 0
