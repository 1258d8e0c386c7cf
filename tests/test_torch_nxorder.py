"""The port's NetworkX-order tracker and mirror against the JAX package's.

Both trackers are plain Python over genuine set()s, so their outputs must
be identical: the neighbour orders element for element, and the
extraction-leak mutations (node and float64 coordinates) exactly, when fed
the same active mask and accepted sets.  The port's recomputed mirror must
equal the mirror each committed event cache holds."""

from pathlib import Path

import numpy as np
import pytest

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph.build import build_event
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import extract

CACHE = Path(__file__).resolve().parents[1] / ".event_cache"
VOL7_NPZ = CACHE / "event_fafb3309e4598e9b.npz"
FULL_NPZ = CACHE / "event_7bba1cb4ae95bca1.npz"


def _trackers():
    """(JAX tracker, port graph, port tracker) of the volume-7 event."""
    xyzr, vivl, tp, pairs, extra, pre = load_npz(VOL7_NPZ)
    _, jhost = jax_build(xyzr, vivl, tp, pairs, JaxConfig(),
                         host_extra=extra, precomputed=pre, with_tracker=True)
    g, host = build_event(xyzr, vivl, tp, pairs, PipelineConfig(),
                          device="cpu", mirror=pre["mirror"],
                          component=pre["component"],
                          node_ids=extra["node_ids"])
    return jhost.tracker, g, host.tracker


def test_neighbour_orders_match_jax():
    jtr, _, tr = _trackers()
    ref = jtr.neighbour_orders()
    got = tr.neighbour_orders()
    assert len(got) == len(ref) == 8748
    assert got == ref


def test_extraction_merges_match_jax():
    """Two extractions of the port's schedule, each replayed by both
    trackers from the same inputs."""
    jtr, g, tr = _trackers()
    cfg = PipelineConfig()
    vivl = g.vivl.numpy()
    xyzr = g.xyzr.numpy()
    g = pipeline.prepare(g, cfg)
    n_muts = 0
    for i in (1, 2):
        g = pipeline.stage_step(g, cfg, i)
        active = (g.edge_mask & g.active).numpy()
        res = extract.extract_candidates(g, cfg)
        g = extract.apply_extraction(g, res, cfg)
        acc = [set(row[row >= 0].tolist()) for row in res.acc_nodes.numpy()]
        args = (active, vivl, xyzr, acc, cfg.min_track_hits,
                cfg.node_merge_distance)
        ref = jtr.extraction_merges(*args)
        got = tr.extraction_merges(*args)
        assert got == ref
        n_muts += len(got)
    assert n_muts > 0
    assert [s.node_order for s in tr.subgraphs] == \
        [s.node_order for s in jtr.subgraphs]


@pytest.mark.parametrize("path", [VOL7_NPZ, FULL_NPZ], ids=["volume7", "full"])
def test_recomputed_mirror_equals_cached_mirror(path):
    xyzr, vivl, tp, pairs, extra, pre = load_npz(path)
    cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                         max_volume=int(vivl[:, 0].max()))
    g, host = build_event(xyzr, vivl, tp, pairs, cfg, device="cpu",
                          node_ids=extra["node_ids"])
    np.testing.assert_array_equal(host.mirror, pre["mirror"])
    np.testing.assert_array_equal(g.mirror[:g.n_edges].numpy(), pre["mirror"])
    np.testing.assert_array_equal(g.component[:g.n_nodes].numpy(),
                                  pre["component"])
