"""The port's whole schedule vs the JAX fast driver, at float64 on the CPU.

Candidate node sets per iteration are exact; p-values agree to rtol 1e-9
(they pass through atan2/cos/sin and the incomplete gamma function, whose
implementations differ between the two libraries in the last ulps)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import pipeline as jax_pipeline
from gnn_track_finding_tpu.models import toymc

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline

REPO = Path(__file__).resolve().parents[1]
VOL7_NPZ = REPO / ".event_cache" / "event_fafb3309e4598e9b.npz"
JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def _toy_graphs(seed):
    ev = toymc.generate_event(seed=seed, num_tracks=20, edge_dphi_window=0.12)
    jg, host = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, JCFG)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                          device="cpu", mirror=host.mirror)
    return jg, g


def _by_iteration(cands):
    return [(c.iteration, tuple(int(x) for x in c.nodes), c.pval_xy,
             c.pval_zr) for c in cands]


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_candidates_match_jax_fast_driver(seed):
    jg, g = _toy_graphs(seed)
    ref = _by_iteration(jax_pipeline.run_pipeline_fast(jg, JCFG).candidates)
    out = _by_iteration(pipeline.run_pipeline_fast(g, CFG).candidates)
    assert len(ref) > 0
    assert [c[:2] for c in out] == [c[:2] for c in ref]
    np.testing.assert_allclose([c[2:] for c in out], [c[2:] for c in ref],
                               rtol=1e-9)


def test_volume7_event_counts():
    xyzr, vivl, tp, pairs, extra, pre = load_npz(VOL7_NPZ)
    g = build_graph_state(xyzr, vivl, tp, pairs, PipelineConfig(),
                          device="cpu", mirror=pre["mirror"],
                          component=pre["component"])
    out = pipeline.run_pipeline_fast(g, PipelineConfig())
    per_it = [sum(1 for c in out.candidates if c.iteration == i)
              for i in (1, 2, 3)]
    assert per_it == [1055, 110, 2]
    assert len(out.cca_rounds) == 3 and min(out.cca_rounds) >= 2


def test_stream_pipeline_matches_solo_runs():
    graphs = [_toy_graphs(s)[1] for s in (7, 11, 23)]
    solo = [_by_iteration(pipeline.run_pipeline_fast(g, CFG).candidates)
            for g in graphs]
    for depth in (1, 2):
        streamed = [_by_iteration(r.candidates)
                    for r in pipeline.stream_pipeline(iter(graphs), CFG,
                                                      depth=depth)]
        assert streamed == solo


def test_run_cli_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_track_finding_tpu_torch.run",
         "--event", str(VOL7_NPZ)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
