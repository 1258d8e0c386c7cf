"""The port's NetworkX-order tracker and mirror against the JAX package's.

Both trackers are plain Python over genuine set()s, so their outputs must
be identical: the neighbour orders element for element, and the
extraction-leak mutations (node and float64 coordinates) exactly, when fed
the same active mask and accepted sets.  The port's recomputed mirror must
equal the mirror each committed event cache holds.  The close-proximity
merge, whose frequency count the port takes with a Counter (linear) where
the JAX module calls list.count per element (quadratic), must give the
JAX module's mutations on every candidate."""

import time
from pathlib import Path

import numpy as np
import pytest

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.graph.nxorder import \
    RefOrderTracker as JaxRefOrderTracker
from gnn_track_finding_tpu.models import toymc as jax_toymc

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph.build import build_event
from gnn_track_finding_tpu_torch.graph.nxorder import RefOrderTracker
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
        acc = [set(row[row >= 0].tolist())
               for row in extract.accepted_rows(res)[0].numpy()]
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


def _proximity(tracker_cls, cands, vivl, xyzr, threshold=8.0):
    """The close-proximity merge of each candidate, as extraction runs it
    (the method reads nothing of the tracker's state)."""
    return [tracker_cls._proximity_mutations(None, list(c), vivl, xyzr,
                                             threshold) for c in cands]


def _volume7_components():
    xyzr, vivl, _, _, _, pre = load_npz(VOL7_NPZ)
    comp = pre["component"]
    order = np.argsort(comp, kind="stable")
    cands = np.split(order, np.flatnonzero(np.diff(comp[order])) + 1)
    return [c for c in cands if len(c) >= 4], vivl, xyzr


def _toy_with_duplicates(seed):
    """Per track, the hit list with a second hit beside one of its hits
    (tests/test_torch_driver.py's leak case), in shuffled order."""
    ev = jax_toymc.generate_event(seed=seed, num_tracks=20)
    rng = np.random.default_rng(seed)
    xyzr, vivl, truth = ev.xyzr, ev.vivl, ev.truth
    n = xyzr.shape[0]
    extra = []
    for t in range(0, int(truth.max()) + 1, 2):
        hits = np.flatnonzero(truth == t)
        h = hits[len(hits) // 2]
        x = xyzr[h, :3] + np.array([0.6, -0.4, 0.5])
        extra.append((h, [x[0], x[1], x[2], np.hypot(x[0], x[1])]))
    xyzr = np.concatenate([xyzr, [c for _, c in extra]])
    vivl = np.concatenate([vivl, [vivl[h] for h, _ in extra]])
    truth = np.concatenate([truth, [truth[h] for h, _ in extra]])
    cands = [rng.permutation(np.flatnonzero(truth == t))
             for t in range(int(truth.max()) + 1)]
    assert n < xyzr.shape[0]
    return cands, vivl, xyzr


def _synthetic_candidate(n):
    """One n-node candidate, every (volume, layer) distinct but two doubled
    layers whose hits lie within the merge distance, in shuffled order."""
    rng = np.random.default_rng(n)
    vivl = np.stack([7 + np.arange(n) // 1000, np.arange(n) % 1000], axis=1)
    xyzr = rng.normal(size=(n, 4)) * 100.0
    for a, b in ((5, 17), (n // 2, n - 1)):
        vivl[b] = vivl[a]
        xyzr[b, :3] = xyzr[a, :3] + 0.5
    return [rng.permutation(n)], vivl, xyzr


@pytest.mark.parametrize("case", ["volume7", "toy7", "toy23", "synthetic5000"])
def test_proximity_mutations_match_jax(case):
    if case == "volume7":
        cands, vivl, xyzr = _volume7_components()
    elif case.startswith("toy"):
        cands, vivl, xyzr = _toy_with_duplicates(int(case[3:]))
    else:
        cands, vivl, xyzr = _synthetic_candidate(5000)
    got = _proximity(RefOrderTracker, cands, vivl, xyzr)
    ref = _proximity(JaxRefOrderTracker, cands, vivl, xyzr)
    assert got == ref
    assert sum(map(len, got)) > 0


def test_proximity_mutations_are_linear_on_a_40000_node_candidate():
    """The list.count frequency count took about 70 s here; the Counter
    must take well under a second.  The mutations: node1 of each doubled
    layer is the first of the pair in candidate order, moved to the pair's
    midpoint (the JAX module gives the same on the 5,000-node case)."""
    n = 40_000
    cands, vivl, xyzr = _synthetic_candidate(n)
    t0 = time.perf_counter()
    got = _proximity(RefOrderTracker, cands, vivl, xyzr)[0]
    assert time.perf_counter() - t0 < 10.0
    pos = np.empty(n, np.int64)
    pos[cands[0]] = np.arange(n)
    want = []
    for a, b in ((5, 17), (n // 2, n - 1)):
        first = a if pos[a] < pos[b] else b
        m = (xyzr[a, :3] + xyzr[b, :3]) / 2.0
        want.append((first, (float(m[0]), float(m[1]), float(m[2]),
                             float(np.sqrt(m[0] * m[0] + m[1] * m[1])))))
    # the doubled layers come in set() order
    assert sorted(got) == sorted(want)
