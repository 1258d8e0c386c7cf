"""The port against the reference pipeline's own outputs, at float64 on
the CPU.

The reference side is the committed digest tests/data/ref_digest.npz (see
tests/test_reference_artifacts.py).  The port side is
tools/validate_port_vs_reference.compute_port_states: the port ingests the
committed volume-7 event cache WITHOUT its cached mirror and component
labels (it recomputes both through its NetworkX-order tracker) and runs to
the iteration-2 boundary with the iteration-1 extraction leak applied.
The bars are those of tests/test_reference_artifacts.py."""

import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import validate_port_vs_reference as vpr  # noqa: E402
from tools import validate_vs_reference as vvr  # noqa: E402

from gnn_track_finding_tpu_torch.config import PipelineConfig  # noqa: E402
from gnn_track_finding_tpu_torch.data.event_cache import load_npz  # noqa: E402
from gnn_track_finding_tpu_torch.graph.build import build_event  # noqa: E402
from gnn_track_finding_tpu_torch.models import pipeline  # noqa: E402

VOL7_NPZ = Path(vpr.VOL7_NPZ)


@pytest.fixture(scope="module")
def port_states():
    return vpr.compute_port_states("cpu")


@pytest.fixture(scope="module")
def parity(port_states):
    return vpr.compare(vpr.load_digest(), port_states, log=lambda *a: None)


def test_port_tool_compare_is_the_reference_tools(port_states, parity):
    """The port's tool carries its own copy of the digest comparison (the
    card's machine runs it without the JAX package's tools); on the same
    inputs it gives what tools/validate_vs_reference.compare gives."""
    assert vpr.load_digest().keys() == vvr.load_digest().keys()
    assert vvr.compare(vvr.load_digest(), port_states,
                       log=lambda *a: None) == parity


def test_port_seed_states_match_reference(parity):
    assert parity["seed_cmp"] == 14766
    assert parity["seed_sv"] == 1.0
    assert parity["seed_cov"] == 1.0


def test_port_extraction_coordinate_leak_matches_reference(parity):
    assert parity["leak"] == 1.0


def test_port_merged_states_match_reference(parity):
    assert parity["clus_cmp"] == 8748
    assert parity["clus_flag"] == 1.0
    assert parity["clus_val"] == 1.0


def test_port_updated_states_match_reference(parity):
    assert parity["upd_cmp"] == 434
    assert parity["upd_flag"] == 1.0
    assert parity["upd_val"] == 1.0
    assert parity["upd_joint"] == 1.0


def test_port_host_driver_volume7_counts():
    """The whole host driver with the leak replay, from an ingest that
    computed its own mirror, gives the reference's counts; without the
    tracker its candidates equal the fast driver's."""
    xyzr, vivl, tp, pairs, extra, pre = load_npz(VOL7_NPZ)
    cfg = PipelineConfig()
    g, host = build_event(xyzr, vivl, tp, pairs, cfg, device="cpu",
                          node_ids=extra["node_ids"])
    assert (host.mirror == pre["mirror"]).all()
    out = pipeline.run_pipeline(g, cfg, tracker=host.tracker)
    assert [sum(c.iteration == i for c in out.candidates)
            for i in (1, 2, 3)] == [1055, 110, 2]
    cands = lambda r: [(c.iteration, c.nodes.tolist()) for c in r.candidates]
    assert cands(pipeline.run_pipeline(g, cfg)) == \
        cands(pipeline.run_pipeline_fast(g, cfg))
