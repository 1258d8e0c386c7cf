"""Clean mode (bug_compat=False) and longer schedules of the port against
the JAX package, at float64 on the CPU.

Each toy event (16 tracks; seeds 7, 11 and 23 share one padded shape, so
the JAX stages compile once per configuration) is built by both packages
from the same numpy arrays.  Both port drivers, `run_pipeline` (host
union-find CCA) and `run_pipeline_fast` (the fused schedule), are held to
the JAX host driver's candidates: node sets per iteration exact, pval_xy
within rtol 1e-9 and pval_zr within rtol 1e-8, the bars of
tests/test_torch_analysis.py (the JAX fit is compiled by XLA:CPU, which
contracts it into fused multiply-adds).  Clean mode reads no mirror: both
ingests hold the identity there.

The clean volume-7 counts are the JAX package's (float64, CPU;
`tools/jax_runner_constants.py` prints them: its fused schedule compiles
for a minute at volume 7's shapes), the constant chip_smoke.py holds the
card to."""

import functools
from pathlib import Path

import numpy as np
import pytest

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
TOY = dict(node_bucket=64, edge_bucket=256)
MODES = {"clean": dict(bug_compat=False),
         "five_iterations": dict(num_iterations=5)}
# the JAX package's clean volume-7 counts per iteration
CLEAN_VOLUME7 = [1056, 135, 1]


def _candidates(out):
    return [(c.iteration, tuple(int(x) for x in c.nodes))
            for c in out.candidates]


def _pvals(out):
    return np.array([(c.pval_xy, c.pval_zr) for c in out.candidates])


@functools.lru_cache(maxsize=None)
def _toy(mode, seed):
    """The port's state of the toy event and the JAX host driver's result."""
    jcfg = JaxConfig(**TOY, **MODES[mode])
    ev = toymc.generate_event(seed=seed, num_tracks=16, edge_dphi_window=0.12)
    jg, host = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, jcfg)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                          PipelineConfig(**TOY, **MODES[mode]), device="cpu",
                          mirror=host.mirror)
    np.testing.assert_array_equal(g.mirror.numpy(), np.asarray(jg.mirror))
    return g, jax_pipeline.run_pipeline(jg, jcfg)


@pytest.mark.parametrize("driver", ["run_pipeline", "run_pipeline_fast"])
@pytest.mark.parametrize("mode,seed", [("clean", 7), ("clean", 11),
                                       ("clean", 23), ("five_iterations", 7),
                                       ("five_iterations", 11)])
def test_mode_matches_jax(mode, seed, driver):
    g, ref = _toy(mode, seed)
    cfg = PipelineConfig(**TOY, **MODES[mode])
    out = getattr(pipeline, driver)(g, cfg)
    assert len(ref.candidates) > 0
    assert _candidates(out) == _candidates(ref)
    if mode == "five_iterations":
        assert len(ref.per_iteration) == 5
        assert len(out.cca_rounds) == 5
    got, want = _pvals(out), _pvals(ref)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-8, atol=0)


def test_clean_volume7_counts():
    xyzr, vivl, tp, pairs, extra, pre = load_npz(VOL7_NPZ)
    cfg = PipelineConfig(bug_compat=False)
    g = build_graph_state(xyzr, vivl, tp, pairs, cfg, device="cpu",
                          component=pre["component"])
    assert np.array_equal(g.mirror.numpy(), np.arange(g.num_padded_edges))
    for driver in (pipeline.run_pipeline_fast, pipeline.run_pipeline):
        out = driver(g, cfg)
        assert [sum(1 for c in out.candidates if c.iteration == i)
                for i in (1, 2, 3)] == CLEAN_VOLUME7
