"""Seeded toy-MC event generator.

Copy of `gnn_track_finding_tpu.models.toymc` (toymc.py:1-230), numpy
only, so the same seed gives bit-identical arrays in both packages;
`to_networkx` imports networkx inside the function (the card's machine
has none).

The reference validates its math on small simulated events: straight/
parabolic tracks over fixed layers with Gaussian smearing and a
HitPairPredictor edge gate (src/toyMC_model/track_simulation_xy.py:36-188,
learn_KL_linear_model/generate_training_data/generate_events.py:36-153).
This generator produces the same kind of controlled, fully truth-labelled
events directly as arrays, in a cylindrical geometry so both barrel
(|z| < endcap_boundary) and endcap hits exercise the sigma-swap branches.

Tracks originate near the beamline with azimuth phi0, curvature kappa and
dip slope tau; a hit on layer radius R sits at
  phi = phi0 + kappa * R,   (x, y) = R (cos phi, sin phi),   z = tau * R,
Gaussian-smeared per coordinate.  Edges connect hits on adjacent layers
within an azimuth window (the HitPairPredictor analog,
src/toyMC_model/HitPairPredictor.py:10-16), which yields both true edges
and cross-track confusion edges for the pruning stages to remove.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

DEFAULT_LAYER_RADII = (60.0, 110.0, 170.0, 240.0, 320.0, 410.0, 510.0)


@dataclasses.dataclass
class GNNMeasurement:
    """Hit measurement record — API-compatible with the reference's
    GNN_Measurement (src/GNN_Measurement/GNN_Measurement.py:1-9)."""
    x: float
    y: float
    z: float
    r: float
    truth_particle: int = -1
    node: int = -1


class HitPairPredictor:
    """Straight-line hit-pair gate: extrapolate the segment through two
    hits back to x=0 and accept when |y0 intercept| is inside the window
    (src/toyMC_model/HitPairPredictor.py:10-16)."""

    def __init__(self, start_x: float, y0_range: float):
        self.start_x = start_x
        self.y0_range = y0_range

    def predict(self, m1: GNNMeasurement, m2: GNNMeasurement) -> bool:
        slope = (m2.y - m1.y) / (m2.x - m1.x)
        y0 = m1.y - slope * (m1.x - self.start_x)
        return abs(y0) <= self.y0_range


@dataclasses.dataclass
class ToyEvent:
    xyzr: np.ndarray          # (n, 4)
    vivl: np.ndarray          # (n, 2) int (volume, layer)
    truth: np.ndarray         # (n,) int track id
    edge_pairs: np.ndarray    # (m, 2) undirected, file order
    layer_radii: Tuple[float, ...]


def generate_event(
    num_tracks: int = 12,
    seed: int = 0,
    layer_radii: Tuple[float, ...] = DEFAULT_LAYER_RADII,
    sigma_xy: float = 0.3,
    sigma_z: float = 0.5,
    max_tau: float = 2.5,
    max_kappa: float = 1.5e-4,
    edge_dphi_window: float = 0.08,
    edge_dtau_window: float = 0.5,
    drop_hit_prob: float = 0.0,
) -> ToyEvent:
    rng = np.random.default_rng(seed)
    nl = len(layer_radii)

    xs, ys, zs, layers, tids = [], [], [], [], []
    for t in range(num_tracks):
        phi0 = rng.uniform(0.0, 2.0 * np.pi)
        kappa = rng.uniform(-max_kappa, max_kappa)
        tau = rng.uniform(-max_tau, max_tau)
        for li, r in enumerate(layer_radii):
            if drop_hit_prob and rng.uniform() < drop_hit_prob:
                continue
            phi = phi0 + kappa * r
            xs.append(r * np.cos(phi) + rng.normal(0.0, sigma_xy))
            ys.append(r * np.sin(phi) + rng.normal(0.0, sigma_xy))
            zs.append(tau * r + rng.normal(0.0, sigma_z))
            layers.append(li)
            tids.append(t)

    x = np.asarray(xs)
    y = np.asarray(ys)
    z = np.asarray(zs)
    layer = np.asarray(layers, np.int32)
    truth = np.asarray(tids, np.int64)
    r = np.sqrt(x * x + y * y)
    phi = np.arctan2(y, x)
    tau_hit = z / np.maximum(r, 1e-9)

    n = x.shape[0]
    # shuffle node order so node index carries no structure
    perm = rng.permutation(n)
    x, y, z, r, phi, tau_hit = (a[perm] for a in (x, y, z, r, phi, tau_hit))
    layer, truth = layer[perm], truth[perm]

    # adjacent-layer edge gate on (delta phi, delta tau)
    pairs = []
    for li in range(nl - 1):
        i_idx = np.flatnonzero(layer == li)
        j_idx = np.flatnonzero(layer == li + 1)
        for i in i_idx:
            dphi = np.angle(np.exp(1j * (phi[j_idx] - phi[i])))
            dtau = tau_hit[j_idx] - tau_hit[i]
            ok = (np.abs(dphi) < edge_dphi_window) & (np.abs(dtau) < edge_dtau_window)
            for j in j_idx[ok]:
                pairs.append((i, j))
    edge_pairs = np.asarray(pairs, np.int64).reshape(-1, 2)

    xyzr = np.stack([x, y, z, r], axis=1)
    vivl = np.stack([np.full(n, 7, np.int32), 2 * (layer + 1)], axis=1)
    return ToyEvent(xyzr=xyzr, vivl=vivl, truth=truth,
                    edge_pairs=edge_pairs, layer_radii=layer_radii)


def generate_linear_event(
    num_tracks: int = 10,
    num_layers: int = 10,
    seed: int = 0,
    layer_spacing: float = 1.0,
    start_x: float = 1.0,
    sigma_y: float = 0.1,
    max_slope: float = 0.5,
    y0_range: float = 0.5,
) -> ToyEvent:
    """The reference's straight-track toy: tracks y = m x + c over
    equally spaced x layers with Gaussian y smear and HitPairPredictor
    edges (src/toyMC_model/track_simulation_xy.py:36-188,
    learn_KL_linear_model/generate_training_data/generate_events.py:36-153).
    Mapped into the framework's cylindrical schema with x as 'radius'."""
    rng = np.random.default_rng(seed)
    xs, ys, layers, tids = [], [], [], []
    for t in range(num_tracks):
        m = rng.uniform(-max_slope, max_slope)
        c = rng.uniform(-y0_range / 2, y0_range / 2)
        for li in range(num_layers):
            x = start_x + li * layer_spacing
            xs.append(x)
            ys.append(m * x + c + rng.normal(0.0, sigma_y))
            layers.append(li)
            tids.append(t)
    x = np.asarray(xs)
    y = np.asarray(ys)
    layer = np.asarray(layers, np.int32)
    truth = np.asarray(tids, np.int64)
    n = len(x)
    perm = np.random.default_rng(seed + 1).permutation(n)
    x, y, layer, truth = x[perm], y[perm], layer[perm], truth[perm]

    predictor = HitPairPredictor(0.0, y0_range * 1.5)
    pairs = []
    for li in range(num_layers - 1):
        for i in np.flatnonzero(layer == li):
            for j in np.flatnonzero(layer == li + 1):
                m1 = GNNMeasurement(x[i], y[i], 0.0, x[i])
                m2 = GNNMeasurement(x[j], y[j], 0.0, x[j])
                if predictor.predict(m1, m2):
                    pairs.append((i, j))
    edge_pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    # cylindrical schema: r := x, z := small proportional dip
    r = x
    z = 0.1 * x
    xyzr = np.stack([x, y, z, r], axis=1)
    vivl = np.stack([np.full(n, 7, np.int32), 2 * (layer + 1)], axis=1)
    return ToyEvent(xyzr=xyzr, vivl=vivl, truth=truth,
                    edge_pairs=edge_pairs,
                    layer_radii=tuple(start_x + i * layer_spacing
                                      for i in range(num_layers)))


def to_networkx(ev: ToyEvent, reference_orders: bool = True):
    """NetworkX DiGraph with the reference's node-attribute schema, for
    oracle comparisons (helper.py:498-518).

    reference_orders=True (default) additionally replays the reference's
    event-conversion rebuild chain so adjacency iteration orders match
    what the reference actually seeds on; False returns the raw
    insertion-order graph (the layout of the device edge tables)."""
    import networkx as nx

    g = nx.DiGraph()
    for i in range(ev.xyzr.shape[0]):
        x, y, z, r = (float(v) for v in ev.xyzr[i])
        g.add_node(
            i,
            xy=(x, y), zr=(z, r), xyzr=(x, y, z, r),
            volume_id=int(ev.vivl[i, 0]),
            in_volume_layer_id=int(ev.vivl[i, 1]),
            vivl_id=(int(ev.vivl[i, 0]), int(ev.vivl[i, 1])),
            truth_particle=int(ev.truth[i]),
            module_id=np.array([int(ev.truth[i])]),
            hit_dissociation={"hit_id": np.array([i]),
                              "particle_id": [int(ev.truth[i])]},
        )
    for u, v in ev.edge_pairs:
        g.add_edge(int(u), int(v))
        g.add_edge(int(v), int(u))

    if not reference_orders:
        return g

    # The reference never seeds on the raw constructed graph: event
    # conversion rebuilds it (nx.DiGraph(G), event_conversion.py:80) and
    # splits it into per-component subgraph(c).copy() graphs (:84), which
    # scrambles predecessor adjacency and node order — orders the
    # numerics depend on (set(nx.all_neighbors), helper.py:280).  Rebuild
    # the same way and re-compose, preserving each copy's adjacency
    # orders, so oracle comparisons (and the nxorder emulation they
    # validate) see exactly what the reference would.
    g = nx.DiGraph(g)
    parts = [g.subgraph(c).copy() for c in nx.weakly_connected_components(g)]
    composed = nx.DiGraph()
    for part in parts:
        composed.add_nodes_from(part.nodes(data=True))
        composed.add_edges_from(part.edges(data=True))
    return composed
