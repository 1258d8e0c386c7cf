"""The port's toy-MC generator against the JAX package's.

Both are the same numpy code, so the same seed must give bit-identical
arrays and edge pairs (exact equality, no tolerance), with hit dropping,
for the straight-track generator, and through `to_networkx`."""

import numpy as np
import pytest

from gnn_track_finding_tpu.models import toymc as jax_toymc

from gnn_track_finding_tpu_torch.models import toymc

FIELDS = ("xyzr", "vivl", "truth", "edge_pairs")


def _assert_events_equal(got, ref):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.layer_radii == ref.layer_radii


@pytest.mark.parametrize("kwargs", [
    dict(seed=0), dict(seed=1, num_tracks=50), dict(seed=13, num_tracks=20),
    dict(seed=5, num_tracks=16, edge_dphi_window=0.25, edge_dtau_window=1.0),
    dict(seed=3, num_tracks=30, drop_hit_prob=0.2),
    dict(seed=9, num_tracks=12, drop_hit_prob=0.5, max_kappa=5e-4),
], ids=["seed0", "seed1_50", "seed13", "wide_windows", "drop0.2", "drop0.5"])
def test_generate_event_matches_jax(kwargs):
    got = toymc.generate_event(**kwargs)
    assert got.edge_pairs.shape[0] > 0
    _assert_events_equal(got, jax_toymc.generate_event(**kwargs))


@pytest.mark.parametrize("seed", [0, 4, 21])
def test_generate_linear_event_matches_jax(seed):
    kwargs = dict(seed=seed, num_tracks=8, num_layers=6)
    _assert_events_equal(toymc.generate_linear_event(**kwargs),
                         jax_toymc.generate_linear_event(**kwargs))


def test_hit_pair_predictor_and_measurement_match_jax():
    rng = np.random.default_rng(2)
    pred = toymc.HitPairPredictor(0.5, 0.3)
    jpred = jax_toymc.HitPairPredictor(0.5, 0.3)
    for x1, y1, x2, y2 in rng.normal(size=(200, 4)):
        m = (toymc.GNNMeasurement(x1, y1, 0.0, x1),
             toymc.GNNMeasurement(x2, y2, 0.0, x2))
        jm = (jax_toymc.GNNMeasurement(x1, y1, 0.0, x1),
              jax_toymc.GNNMeasurement(x2, y2, 0.0, x2))
        assert pred.predict(*m) == jpred.predict(*jm)


@pytest.mark.parametrize("reference_orders", [True, False])
def test_to_networkx_matches_jax(reference_orders):
    ev = toymc.generate_event(seed=7, num_tracks=10)
    got = toymc.to_networkx(ev, reference_orders)
    ref = jax_toymc.to_networkx(jax_toymc.generate_event(seed=7, num_tracks=10),
                                reference_orders)
    assert list(got.nodes) == list(ref.nodes)
    assert list(got.edges) == list(ref.edges)
    assert [list(got.predecessors(n)) for n in got] == \
        [list(ref.predecessors(n)) for n in ref]
    for n in got:
        a, b = got.nodes[n], ref.nodes[n]
        assert a["xyzr"] == b["xyzr"] and a["vivl_id"] == b["vivl_id"]
        assert a["truth_particle"] == b["truth_particle"]
