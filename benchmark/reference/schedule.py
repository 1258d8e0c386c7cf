"""Plain PyTorch reference of the track-finding schedule, one event at a time.

The benchmark's yardstick for `correct`: the three-iteration
Gaussian-mixture Kalman schedule (seeding and priors; GMR clustering on
seed states; Kalman message passing with a double reweight, then the
metadata pruning; GMR clustering on updated states; after every stage a
CCA extraction with two-plane Kalman fits) in plain eager torch
operations, from the raw event arrays.

It imports nothing of the program under test: it is a frozen copy of the
single-device arithmetic of `gnn_track_finding_tpu_torch` as of the
benchmark's first version (ops/linalg.py, ops/seeding.py, ops/priors.py,
ops/clustering.py, ops/cluster_kernel.py's plain core, ops/extrapolate.py,
ops/metadata.py, ops/extract.py, graph/build.py, models/pipeline.py),
with the operation order kept, so that at float64 on the same device its
answers are the schedule's to the last bit.  Where the program takes a
faster or capturable path the reference takes the plain one:

  * the GMR core is the masked (rows, kc, kc) tensor version, never the
    CUDA kernel;
  * the side-norm distinct counts are the (N, K, K) comparison, never the
    CUDA kernel;
  * the extraction's components come from scipy's union-find on the host,
    not from fixed-round FastSV, and every accepted row is pulled (no cap
    on the accepted head, no fallback).

Only the edge-pair file's `mirror` (the reference implementation's
set()-order tau pairing, a property of the original NetworkX code) is read
as given; the graph, its tables, the components and every state are
built here.  Several events of one pad bucket run as their disjoint union
in one schedule, as the program stacks a batch: every operation is per
node, edge or candidate row, so each event's answer is its own run's.
`work` (optional) is told the inputs of each kernel call the program
makes: `cluster(tab, ids, found, deact, bug_compat, dtype)` per clustering
round (rows of nodes `ids`, N past the live ones) and `distinct(ok, x)`
per distinct-count table.

`calibration` (optional: a configuration's calibration block, a KL-
threshold table by feature bin) gives each node a KL threshold of its
own, used in both clustering rounds in place of the configuration's two
scalars (the chi2 thresholds stay scalar): what the program's host
driver computes as `run_pipeline(g, cfg, kl_thresholds=
calib.lut.node_thresholds(table, g, cfg))`.  The feature is `emp_var`,
each node's xy-gradient variance over its in-edges on the built state
before the first stage, summed as the program's seeding sums it (the
in-edge table's row sums in slot order, the count clamped to 1, the
variance to 0), so that it is the program's to the last bit, NaN where
a gradient is infinite.  The table is read as numpy reads it
(`KLThresholdLUT.thresholds_for`): bin trunc(emp_var / bin width),
clipped to the table; a value numpy's cast to int64 cannot hold (NaN,
inf, 2**63 and beyond) falls in bin 0, as that cast sends it to the most
negative integer; the threshold is the bin's upper edge times the KL
bin width in float64, then cast to the run's dtype.  Without a
calibration no emp_var is computed and every operation is as before.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

KC = 16  # compact clustering table width (the degree gate's upper end)


class State(dict):
    """One event's padded tensors by name; `replace` returns a new State
    (states are never written in place)."""

    __getattr__ = dict.__getitem__

    def replace(self, **changes) -> "State":
        return State({**self, **changes})

    @property
    def n(self) -> int:
        return self["node_mask"].shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self["xyzr"].dtype

    @property
    def device(self) -> torch.device:
        return self["xyzr"].device


class Config(NamedTuple):
    """The PipelineConfig fields the schedule reads (a configuration
    file's `pipeline` object)."""
    sigma0xy: float
    sigma0rz: float
    sigma0rz2: float
    sigma_O: float
    endcap_boundary: float
    ms_factor: float
    ms_sqrt_xx0: float
    ms_pt: float
    num_iterations: int
    chi2_threshold_seed: float
    kl_threshold_seed: float
    chi2_threshold_updated: float
    kl_threshold_updated: float
    cluster_min_edges: int
    cluster_max_edges: int
    chi2_cut_factor: float
    reweight_threshold: float
    track_acceptance_pval: float
    min_track_hits: int
    separation_3d_threshold: float
    node_merge_distance: float
    ou_alpha: float
    ou_sigma: float
    max_node_degree: int
    max_track_hits: int
    node_bucket: int
    edge_bucket: int
    bug_compat: bool

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(**{k: d[k] for k in cls._fields})

    def ms_coefficient(self) -> float:
        return (self.ms_factor * self.ms_sqrt_xx0 / self.ms_pt) ** 2

    def cluster_thresholds(self, use_updated: bool):
        if use_updated:
            return self.chi2_threshold_updated, self.kl_threshold_updated
        return self.chi2_threshold_seed, self.kl_threshold_seed


class Accepted(NamedTuple):
    """One iteration's accepted candidates, in candidate-row order."""
    nodes: List[np.ndarray]     # graph node indices, radius-descending
    pvals: np.ndarray           # (A, 2) (pval_xy, pval_zr)


# ------------------------------------------------------------ small algebra

def tiny(dtype: torch.dtype) -> float:
    return 1e-300 if dtype == torch.float64 else 1e-30


def mat2_vec(m, v):
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    v0, v1 = v[..., 0], v[..., 1]
    return torch.stack([a * v0 + b * v1, c * v0 + d * v1], dim=-1)


def sandwich2(f, c):
    f00, f01 = f[..., 0, 0], f[..., 0, 1]
    f10, f11 = f[..., 1, 0], f[..., 1, 1]
    c00, c01 = c[..., 0, 0], c[..., 0, 1]
    c10, c11 = c[..., 1, 0], c[..., 1, 1]
    m00 = f00 * c00 + f01 * c10
    m01 = f00 * c01 + f01 * c11
    m10 = f10 * c00 + f11 * c10
    m11 = f10 * c01 + f11 * c11
    return torch.stack([
        torch.stack([m00 * f00 + m01 * f01, m00 * f10 + m01 * f11], dim=-1),
        torch.stack([m10 * f00 + m11 * f01, m10 * f10 + m11 * f11], dim=-1),
    ], dim=-2)


def det3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adj3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    row0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1)
    row1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1)
    row2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inv3(m):
    return adj3(m) / det3(m)[..., None, None]


def unpack3(m):
    return tuple(m[..., i, j] for i in range(3) for j in range(3))


def pack3(c):
    rows = [torch.stack(c[3 * i:3 * i + 3], dim=-1) for i in range(3)]
    return torch.stack(rows, dim=-2)


def _matmul3_c(a, b):
    return tuple(
        a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3) for j in range(3))


def mat3_vec(m, v):
    c = unpack3(m)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        c[0] * v0 + c[1] * v1 + c[2] * v2,
        c[3] * v0 + c[4] * v1 + c[5] * v2,
        c[6] * v0 + c[7] * v1 + c[8] * v2,
    ], dim=-1)


def sandwich3(f, c):
    fc_ = unpack3(f)
    fcm = _matmul3_c(fc_, unpack3(c))
    return pack3(tuple(
        fcm[3 * i] * fc_[3 * j] + fcm[3 * i + 1] * fc_[3 * j + 1]
        + fcm[3 * i + 2] * fc_[3 * j + 2]
        for i in range(3) for j in range(3)))


def merge_gaussians(mean1, cov1, mean2, cov2):
    i1 = inv3(cov1)
    i2 = inv3(cov2)
    merged_cov = inv3(i1 + i2)
    merged_mean = mat3_vec(merged_cov, mat3_vec(i1, mean1) + mat3_vec(i2, mean2))
    return merged_mean, merged_cov


def kl_distance(mean1, cov1, mean2, cov2, bug_compat: bool):
    i1 = inv3(cov1)
    i2 = inv3(cov2)
    dc = unpack3(cov1 - cov2)
    di = unpack3(i2 - i1)
    if bug_compat:
        trace = dc[0] * di[0] + dc[4] * di[4] + dc[8] * di[8]
    else:
        trace = dc[0] * di[0]
        for i in range(3):
            for j in range(3):
                if i or j:
                    trace = trace + dc[3 * i + j] * di[3 * j + i]
    dm = mean1 - mean2
    s = unpack3(i1 + i2)
    d0, d1, d2 = dm[..., 0], dm[..., 1], dm[..., 2]
    quad = (d0 * (s[0] * d0 + s[1] * d1 + s[2] * d2)
            + d1 * (s[3] * d0 + s[4] * d1 + s[5] * d2)
            + d2 * (s[6] * d0 + s[7] * d1 + s[8] * d2))
    return trace + quad


# ------------------------------------------------------------------ tables

def slot_table(rows, slots, vals, n_rows: int, width: int, fill):
    """(n_rows, width, ...) table with vals at (rows, slots), fill
    elsewhere; row n_rows is a dump row that is sliced off."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.full((), vals, device=rows.device)
    tab = torch.full((n_rows + 1, width) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=rows.device)
    tab[rows, slots] = vals
    return tab[:n_rows]


def count_by(idx, mask, size: int):
    slot = torch.where(mask, idx, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=idx.device)
    out.index_add_(0, slot, torch.ones_like(slot))
    return out[:size]


# ------------------------------------------------------------------- build

def _slots(keys: np.ndarray) -> np.ndarray:
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    slot = np.empty(keys.shape[0], np.int64)
    slot[order] = np.arange(keys.shape[0]) - np.searchsorted(sk, sk, side="left")
    return slot


def components(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The minimum node index of each node's component over pairs (a, b)."""
    adj = coo_matrix((np.ones(a.shape[0], np.int8), (a, b)), shape=(n, n))
    _, lab = connected_components(adj, directed=False)
    root = np.full(lab.max(initial=-1) + 1, n, np.int64)
    np.minimum.at(root, lab, np.arange(n))
    return root[lab]


def _host(xyzr, vivl, pairs, mirror, cfg: Config) -> dict:
    """One event's padded host arrays: the undirected pairs deduplicated
    (first occurrence kept) as directed edges 2i = (u -> v), 2i + 1 =
    (v -> u), each edge's slot in its endpoints' tables, the layer index,
    the components (minimum node index) and the mirror."""
    n = xyzr.shape[0]
    a = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    b = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    _, first_idx = np.unique(a * n + b, return_index=True)
    pairs = pairs[np.sort(first_idx)].astype(np.int64)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    e = 2 * pairs.shape[0]
    src = pairs.reshape(-1)
    dst = pairs[:, ::-1].reshape(-1)
    layers, layer_idx = np.unique(vivl[:, 1], return_inverse=True)
    max_deg = int(max(np.bincount(dst, minlength=n).max(initial=0),
                      np.bincount(src, minlength=n).max(initial=0)))
    k = cfg.max_node_degree
    while k < max_deg:
        k *= 2
    mirror = np.asarray(mirror, np.int64)
    if mirror.shape != (e,):
        raise ValueError(f"mirror has shape {mirror.shape}, expected ({e},)")
    n_pad = -(-max(n, 1) // cfg.node_bucket) * cfg.node_bucket
    e_pad = -(-max(e, 1) // cfg.edge_bucket) * cfg.edge_bucket

    def pad(x, rows):
        out = np.zeros((rows,) + x.shape[1:], x.dtype)
        out[:x.shape[0]] = x
        return out

    return dict(
        n=n, e=e, k=k, n_pad=n_pad, e_pad=e_pad, n_layers=len(layers),
        xyzr=pad(np.asarray(xyzr, np.float64), n_pad),
        vivl=pad(np.asarray(vivl, np.int64), n_pad),
        layer=pad(layer_idx.astype(np.int64), n_pad),
        component=pad(components(n, pairs[:, 0], pairs[:, 1]), n_pad),
        src=pad(src, e_pad), dst=pad(dst, e_pad),
        slot_in=pad(_slots(dst), e_pad), slot_out=pad(_slots(src), e_pad),
        mirror=(pad(mirror, e_pad) if cfg.bug_compat
                else np.arange(e_pad, dtype=np.int64)))


def build(events: List[Dict[str, np.ndarray]], cfg: Config, *, device,
          dtype) -> State:
    """The padded state of one event or of several events of one pad
    bucket as their disjoint union (event b's nodes are rows [b N,
    (b + 1) N), its edges rows [b E, (b + 1) E), its indices offset so),
    from each event's raw arrays: hits (n, 4), their (volume, layer) ids,
    the undirected pairs in file order and the set()-order mirror of each
    directed edge after dedupe."""
    hs = [_host(a["xyzr"], a["vivl"], a["pairs"], a["mirror"], cfg)
          for a in events]
    h0 = hs[0]
    shape = ("k", "n_pad", "e_pad", "n_layers")
    if any(tuple(h[f] for f in shape) != tuple(h0[f] for f in shape)
           for h in hs):
        raise ValueError("the events' pad buckets differ")
    n_pad, e_pad, k = h0["n_pad"], h0["e_pad"], h0["k"]
    cat = lambda name, by=0: torch.from_numpy(np.concatenate(
        [h[name] + b * by for b, h in enumerate(hs)])).to(device)
    xyzr_t = cat("xyzr").to(dtype)
    src_t, dst_t = cat("src", n_pad), cat("dst", n_pad)
    slot_in_t, slot_out_t = cat("slot_in"), cat("slot_out")
    layer = cat("layer")
    mirror_t = cat("mirror", e_pad)
    n_all, e_all = len(hs) * n_pad, len(hs) * e_pad
    live = lambda count, rows: torch.cat([
        torch.arange(rows, device=device) < h[count] for h in hs])
    f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    bz = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    node_mask = live("n", n_pad)
    edge_mask = live("e", e_pad)
    e_idx = torch.arange(e_all, device=device)
    row_dst = torch.where(edge_mask, dst_t, n_all)
    table = lambda rows, slots, vals, fill: slot_table(rows, slots, vals,
                                                       n_all, k, fill)
    xyzr_src, xyzr_dst = xyzr_t[src_t], xyzr_t[dst_t]
    layer_src = layer[src_t]
    return State(
        n_layers=h0["n_layers"], n_event=n_pad, batch=len(hs),
        node_mask=node_mask, xyzr=xyzr_t, gnn_xyzr=xyzr_t,
        vivl=cat("vivl"), component=cat("component", n_pad),
        has_merged=bz(n_all), merged_state=f(n_all, 3),
        merged_cov=f(n_all, 3, 3), merged_prior=f(n_all),
        edge_mask=edge_mask, src=src_t, dst=dst_t, active=edge_mask,
        seed_sv=f(e_all, 3), seed_cov=f(e_all, 3, 3),
        seed_joint=f(e_all, 3), seed_joint_cov=f(e_all, 3, 3),
        seed_prior=f(e_all), seed_weight=f(e_all),
        has_updated=bz(e_all), upd_sv=f(e_all, 3), upd_cov=f(e_all, 3, 3),
        upd_joint=f(e_all, 3), upd_joint_cov=f(e_all, 3, 3),
        upd_prior=f(e_all), upd_weight=f(e_all), upd_likelihood=f(e_all),
        upd_xyzr=f(e_all, 4),
        in_edges=table(row_dst, slot_in_t, e_idx, -1),
        slot_in=slot_in_t, slot_out=slot_out_t,
        e_xyzr=torch.where(edge_mask[:, None],
                           torch.cat([xyzr_src, xyzr_dst], dim=1), 0.0),
        e_src_layer=torch.where(edge_mask, layer_src, 0),
        in_src_layer=table(row_dst, slot_in_t, layer_src, -1),
        mirror_src=torch.where(edge_mask, src_t[mirror_t], 0))


# ----------------------------------------------------------------- seeding

def rz_sigmas(z, cfg: Config):
    endcap = torch.abs(z) >= cfg.endcap_boundary
    s_rz = torch.full((), cfg.sigma0rz, dtype=z.dtype, device=z.device)
    s_rz2 = torch.full((), cfg.sigma0rz2, dtype=z.dtype, device=z.device)
    return torch.where(endcap, s_rz, s_rz2), torch.where(endcap, s_rz2, s_rz)


def tau_variance(node_zr, nb_zr, cfg: Config):
    z1, r1 = node_zr
    z2, r2 = nb_zr
    inv_dr = 1.0 / (r1 - r2)
    j1 = inv_dr
    j2 = -inv_dr
    j3 = -(z1 - z2) * inv_dr * inv_dr
    j4 = (z1 - z2) * inv_dr * inv_dr
    sz1, sr1 = rz_sigmas(z1, cfg)
    sz2, sr2 = rz_sigmas(z2, cfg)
    return (j1 * j1 * sz1 * sz1 + j2 * j2 * sz2 * sz2
            + j3 * j3 * sr1 * sr1 + j4 * j4 * sr2 * sr2)


def highland_var_ms(a, b, kappa_x, node_zr, nb_zr, cfg: Config):
    node_z, node_r = node_zr
    nb_z, nb_r = nb_zr
    dr = node_r - nb_r
    dz = node_z - nb_z
    hyp = torch.sqrt(dr * dr + dz * dz)
    sin_t = torch.abs(dr) / hyp
    u = 2.0 * a * kappa_x + b
    kappa = (2.0 * a) / (1.0 + u * u) ** 1.5
    var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
    endcap = torch.abs(node_z) >= cfg.endcap_boundary
    return torch.where(endcap, var_ms * torch.abs(dr / dz), var_ms)


def seed_track_states(g: State, cfg: Config) -> State:
    sx, sy, sz, sr = (g.e_xyzr[:, i] for i in range(4))
    dx_, dy_, dz_, dr_ = (g.e_xyzr[:, 4 + i] for i in range(4))
    azimuth = torch.atan2(dy_, dx_)
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    x_0 = (0.0 - dx_) * ca + (0.0 - dy_) * sa
    x_B = (sx - dx_) * ca + (sy - dy_) * sa
    m_B = -(sx - dx_) * sa + (sy - dy_) * ca
    ones = torch.ones_like(x_0)
    zeros = torch.zeros_like(x_0)
    H = torch.stack([
        torch.stack([0.5 * x_0 * x_0, x_0, ones], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
        torch.stack([0.5 * x_B * x_B, x_B, ones], dim=-1),
    ], dim=-2)
    H_inv = inv3(H)
    sv = H_inv[..., 2] * m_B[..., None]
    a, b = sv[..., 0], sv[..., 1]
    S = torch.zeros_like(H)
    S[..., 0, 0] = cfg.sigma_O ** 2
    S[..., 1, 1] = cfg.sigma0xy ** 2
    S[..., 2, 2] = cfg.sigma0xy ** 2
    cov = sandwich3(H_inv, S)
    var_ms = highland_var_ms(a, b, sx, (dz_, dr_), (sz, sr), cfg)
    cov[..., 1, 1] += var_ms
    tau = (sz - dz_) / (sr - dr_)
    if cfg.bug_compat:
        mrows = g.xyzr[g.mirror_src]
        msz, msr = mrows[:, 2], mrows[:, 3]
        tau = (msz - dz_) / (msr - dr_)
        var_tau = tau_variance((dz_, dr_), (msz, msr), cfg)
        var_tau_eff = var_tau * var_tau + var_ms
    else:
        var_tau = tau_variance((dz_, dr_), (sz, sr), cfg)
        var_tau_eff = var_tau + var_ms
    joint = torch.stack([a, b, tau], dim=-1)
    joint_cov = cov.clone()
    joint_cov[..., :, 2] = 0.0
    joint_cov[..., 2, :] = 0.0
    joint_cov[..., 2, 2] = var_tau_eff
    if cfg.bug_compat:
        cov = joint_cov
    em = g.edge_mask
    emv = em[:, None]
    emm = em[:, None, None]
    return g.replace(
        seed_sv=torch.where(emv, sv, 0.0),
        seed_cov=torch.where(emm, cov, 0.0),
        seed_joint=torch.where(emv, joint, 0.0),
        seed_joint_cov=torch.where(emm, joint_cov, 0.0))


# ------------------------------------------------------------------ priors

def compute_mixture_weights(g: State, use_updated: bool) -> State:
    member = g.has_updated if use_updated else g.edge_mask
    count = count_by(g.dst, member, g.n).to(g.dtype)
    w = 1.0 / torch.clamp(count, min=1.0)
    new_w = torch.where(member, w[g.dst], 0.0)
    return g.replace(**{"upd_weight" if use_updated else "seed_weight": new_w})


def compute_prior_probabilities(g: State, use_updated: bool) -> State:
    member = g.has_updated if use_updated else g.edge_mask
    eligible = member & g.active & g.edge_mask
    key = g.dst * g.n_layers + g.e_src_layer
    count = count_by(key, eligible, g.n * g.n_layers)
    prior = 1.0 / torch.clamp(count[key].to(g.dtype), min=1.0)
    name = "upd_prior" if use_updated else "seed_prior"
    return g.replace(**{name: torch.where(eligible, prior, g[name])})


def distinct_counts(ok_slot, x_slot, node_x, work=None):
    """(N, 2) distinct-x counts per (node, side), left = x < node x."""
    if work is not None:
        work.distinct(ok_slot, x_slot)
    left_slot = x_slot < node_x[:, None]
    k_tab = x_slot.shape[1]
    eqx = x_slot[:, :, None] == x_slot[:, None, :]
    same_side = left_slot[:, :, None] == left_slot[:, None, :]
    earlier = torch.tril(torch.ones((k_tab, k_tab), dtype=torch.bool,
                                    device=x_slot.device), diagonal=-1)
    dup_before = torch.any(eqx & same_side & ok_slot[:, None, :] & earlier[None],
                           dim=2)
    first = ok_slot & ~dup_before
    return torch.stack([torch.sum(first & left_slot, dim=1),
                        torch.sum(first & ~left_slot, dim=1)],
                       dim=1).to(x_slot.dtype)


def _layer_counts(ok_tab, layer_col, n_l: int):
    count = torch.zeros((ok_tab.shape[0], n_l + 1), dtype=torch.int64,
                        device=ok_tab.device)
    count.scatter_add_(1, layer_col, ok_tab.to(torch.int64))
    count[:, n_l] = 0
    return count


def reweight_stage(g: State, cfg: Config, n_passes: int, work=None) -> State:
    n = g.n
    n_l = g.n_layers
    k_tab = g.in_edges.shape[1]
    dtype = g.dtype
    member = g.has_updated & g.active & g.edge_mask
    row = torch.where(member, g.dst, n)
    x_tab = slot_table(row, g.slot_in, g.upd_xyzr[:, 0], n, k_tab,
                       float("inf"))
    node_x = g.gnn_xyzr[:, 0].contiguous()
    ok_tab = x_tab < float("inf")
    layer_tab = g.in_src_layer
    wl_tab = slot_table(row, g.slot_in, g.upd_weight * g.upd_likelihood, n,
                        k_tab, 0.0)
    lik_tab = slot_table(row, g.slot_in, g.upd_likelihood, n, k_tab, 0.0)
    left_tab = x_tab < node_x[:, None]
    prior_out = torch.zeros((n, k_tab), dtype=dtype, device=g.device)
    w_out = torch.zeros((n, k_tab), dtype=dtype, device=g.device)
    layer_col = torch.where(layer_tab >= 0, layer_tab, n_l)
    for _ in range(n_passes):
        start = ok_tab
        count_slot = torch.gather(_layer_counts(start, layer_col, n_l), 1,
                                  layer_col).to(dtype)
        prior_tab = 1.0 / torch.clamp(count_slot, min=1.0)
        denom = torch.sum(wl_tab, dim=1)
        counts2 = distinct_counts(start, x_tab, node_x, work)
        norm_tab = torch.clamp(
            torch.where(left_tab, counts2[:, 0:1], counts2[:, 1:2]), min=1.0)
        w_new = (wl_tab * prior_tab
                 / torch.clamp(denom, min=tiny(dtype))[:, None] / norm_tab)
        prior_out = torch.where(start, prior_tab, prior_out)
        w_out = torch.where(start, w_new, w_out)
        drop_tab = start & (w_new < cfg.reweight_threshold)
        ok_tab = start & ~drop_tab
        wl_tab = torch.where(ok_tab, w_new * lik_tab, 0.0)
    prior_e = prior_out[g.dst, g.slot_in]
    w_e = w_out[g.dst, g.slot_in]
    dropped_e = member & (w_e < cfg.reweight_threshold)
    return g.replace(
        upd_prior=torch.where(member, prior_e, g.upd_prior),
        upd_weight=torch.where(member, w_e, g.upd_weight),
        active=g.active & ~dropped_e)


# -------------------------------------------------------------- clustering

def _pairwise_chi2(node_xyzr, cfg: Config, nb_xyzr, valid, joint, jcov):
    dtype = node_xyzr.dtype
    dev = node_xyzr.device
    da = joint[:, :, None, 0] - joint[:, None, :, 0]
    db = joint[:, :, None, 1] - joint[:, None, :, 1]
    pair = lambda q: q[:, :, None] + q[:, None, :]
    c00 = pair(jcov[:, :, 0, 0])
    c01 = pair(jcov[:, :, 0, 1])
    c10 = pair(jcov[:, :, 1, 0])
    c11 = pair(jcov[:, :, 1, 1])
    idet = 1.0 / (c00 * c11 - c01 * c10)
    d1 = (da * (c11 * da - c01 * db) + db * (c00 * db - c10 * da)) * idet
    x_a = node_xyzr[:, 0][:, None]
    z_a = node_xyzr[:, 2][:, None]
    r_a = node_xyzr[:, 3][:, None]
    x_n = nb_xyzr[..., 0]
    z_n = nb_xyzr[..., 2]
    r_n = nb_xyzr[..., 3]
    s_rz = torch.tensor(cfg.sigma0rz, dtype=dtype, device=dev)
    s_rz2 = torch.tensor(cfg.sigma0rz2, dtype=dtype, device=dev)

    def sigmas(coord):
        endcap = torch.abs(coord) >= cfg.endcap_boundary
        return torch.where(endcap, s_rz, s_rz2), torch.where(endcap, s_rz2, s_rz)

    sza, sra = sigmas(x_a if cfg.bug_compat else z_a)
    szn, srn = sigmas(x_n if cfg.bug_compat else z_n)
    inv_b = 1.0 / (r_n - r_a)
    tau = (z_n - z_a) * inv_b
    j2 = inv_b[:, :, None]
    j3 = -inv_b[:, None, :]
    j1 = -j3 - j2
    j5 = (-(z_n - z_a) * inv_b * inv_b)[:, :, None]
    j6 = ((z_n - z_a) * inv_b * inv_b)[:, None, :]
    j4 = -j5 - j6
    var_dt = (j1 * j1 * (sza * sza)[:, :, None]
              + j2 * j2 * (szn * szn)[:, :, None]
              + j3 * j3 * (szn * szn)[:, None, :]
              + j4 * j4 * (sra * sra)[:, :, None]
              + j5 * j5 * (srn * srn)[:, :, None]
              + j6 * j6 * (srn * srn)[:, None, :])
    dt = tau[:, :, None] - tau[:, None, :]
    chi2 = d1 + dt * dt / var_dt
    k = valid.shape[1]
    ar = torch.arange(k, device=dev)
    tri = ar[:, None] > ar[None, :]
    ok = tri[None] & valid[:, :, None] & valid[:, None, :]
    return torch.where(ok, chi2, float("inf"))


def gmr_core(pk, valid, node_xyzr, klthr, *, chi2_thr: float, cfg: Config):
    """Row-space GMR core over packed (rows, kc, 29) slot rows: the best
    chi2 pair merged, then greedy KL absorption -> (found, pm, pc (rows,
    9), mprior, deact (rows, kc))."""
    rows, kc, _ = pk.shape
    dtype = pk.dtype
    dev = pk.device
    p_sv = pk[..., 0:3]
    p_cov = pk[..., 3:12].reshape(rows, kc, 3, 3)
    j_sv = pk[..., 12:15]
    j_cov = pk[..., 15:24].reshape(rows, kc, 3, 3)
    prior = pk[..., 24]
    nb_xyzr = pk[..., 25:29]
    eye = torch.eye(3, dtype=dtype, device=dev)
    p_cov = torch.where(valid[:, :, None, None], p_cov, eye)
    j_cov = torch.where(valid[:, :, None, None], j_cov, eye)
    chi2 = _pairwise_chi2(node_xyzr, cfg, nb_xyzr, valid, j_sv, j_cov)
    chi2 = torch.where(chi2 == 0.0, float("inf"), chi2)
    flat = chi2.reshape(rows, kc * kc)
    best = torch.argmin(flat, dim=1)
    best_val = torch.amin(flat, dim=1)
    i0 = best // kc
    i1 = best % kc
    found = (best_val < chi2_thr) & torch.isfinite(best_val)
    r = torch.arange(rows, device=dev)
    take = lambda arr, idx: arr[r, idx]
    pm, pc = merge_gaussians(take(p_sv, i0), take(p_cov, i0),
                             take(p_sv, i1), take(p_cov, i1))
    jm, jc = merge_gaussians(take(j_sv, i0), take(j_cov, i0),
                             take(j_sv, i1), take(j_cov, i1))
    mprior = take(prior, i0) + take(prior, i1)
    ar = torch.arange(kc, device=dev)[None, :]
    remaining = valid & (ar != i0[:, None]) & (ar != i1[:, None])
    stopped = ~found
    for _ in range(kc - 2):
        kl = kl_distance(j_sv, j_cov, jm[:, None], jc[:, None],
                         bug_compat=cfg.bug_compat)
        kl = torch.where(remaining, kl, float("inf"))
        k_best = torch.argmin(kl, dim=1)
        k_val = torch.amin(kl, dim=1)
        do = ~stopped & (k_val < klthr) & torch.isfinite(k_val)
        npm, npc = merge_gaussians(take(p_sv, k_best), take(p_cov, k_best),
                                   pm, pc)
        njm, njc = merge_gaussians(take(j_sv, k_best), take(j_cov, k_best),
                                   jm, jc)
        nprior = take(prior, k_best) + mprior
        pm = torch.where(do[:, None], npm, pm)
        pc = torch.where(do[:, None, None], npc, pc)
        jm = torch.where(do[:, None], njm, jm)
        jc = torch.where(do[:, None, None], njc, jc)
        mprior = torch.where(do, nprior, mprior)
        remaining = remaining & ~(do[:, None] & (ar == k_best[:, None]))
        stopped = stopped | ~do
    zero = torch.zeros((), dtype=dtype, device=dev)
    return (found, torch.where(found[:, None], pm, zero),
            torch.where(found[:, None], pc.reshape(rows, 9), zero),
            torch.where(found, mprior, zero), remaining & found[:, None])


def cluster(g: State, cfg: Config, use_updated: bool, work=None,
            kl_thresholds=None) -> State:
    """One GMR clustering round: the nodes with 3..15 member in-edges
    (their first KC in insertion order, gated rows first) through the
    core, the merged states written and the unabsorbed edges
    deactivated; `kl_thresholds` (N,): each node's KL threshold in place
    of the configuration's scalar."""
    n, k = g.in_edges.shape
    member = (g.has_updated if use_updated else g.edge_mask) & g.edge_mask
    row = torch.where(member & g.edge_mask, g.dst, n)
    member_slot = slot_table(row, g.slot_in, True, n, k, False) & (g.in_edges >= 0)
    rank_slot = torch.cumsum(member_slot, dim=1) - 1
    member_e = member_slot[g.dst, g.slot_in]
    rank_e = rank_slot[g.dst, g.slot_in]
    ok = member_e & g.edge_mask & (rank_e >= 0) & (rank_e < KC)
    compact = slot_table(torch.where(ok, g.dst, n), torch.where(ok, rank_e, 0),
                         torch.arange(g.edge_mask.shape[0], device=g.device),
                         n, KC, -1)
    n_members = torch.sum(member_slot, dim=1)
    gate = ((n_members > cfg.cluster_min_edges - 1)
            & (n_members < cfg.cluster_max_edges + 1))
    chi2_thr, kl_thr = cfg.cluster_thresholds(use_updated)
    dest = torch.where(gate, torch.cumsum(gate, dim=0) - 1, n)
    ids = torch.full((n + 1,), n, dtype=torch.int64, device=g.device)
    ids[dest] = torch.arange(n, device=g.device)
    ids = ids[:n]
    node = torch.clamp(ids, max=n - 1)
    live = ids < n
    tab = torch.where(live[:, None], compact[node], -1)
    count = torch.sum(gate)
    if use_updated:
        fields = (g.upd_sv, g.upd_cov.reshape(-1, 9), g.upd_joint,
                  g.upd_joint_cov.reshape(-1, 9), g.upd_prior[:, None],
                  g.upd_xyzr)
    else:
        fields = (g.seed_sv, g.seed_cov.reshape(-1, 9), g.seed_joint,
                  g.seed_joint_cov.reshape(-1, 9), g.seed_prior[:, None],
                  g.e_xyzr[:, :4])
    pk = torch.cat(fields, dim=1)[torch.clamp(tab, min=0)]
    valid = torch.cumprod((tab >= 0).to(torch.uint8), dim=1).bool()
    valid = valid & (torch.arange(n, device=g.device) < count)[:, None]
    if kl_thresholds is None:
        klthr = torch.full((n,), kl_thr, dtype=g.dtype, device=g.device)
    else:
        klthr = kl_thresholds[node]
    core = gmr_core(pk, valid, g.xyzr[node], klthr, chi2_thr=chi2_thr,
                    cfg=cfg)
    if work is not None:
        work.cluster(tab, ids, core[0], core[4], cfg.bug_compat, g.dtype)

    def expand(vals):
        out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        out[ids] = vals
        return out[:n]

    found, pm, pc, mprior, deact_slot = (expand(v) for v in core)
    pc = pc.reshape(n, 3, 3)
    in_compact = member_e & (rank_e >= 0) & (rank_e < KC)
    deact = (in_compact & deact_slot[g.dst, torch.clamp(rank_e, 0, KC - 1)]
             & g.edge_mask)
    g = g.replace(
        has_merged=g.has_merged | found,
        merged_state=torch.where(found[:, None], pm, g.merged_state),
        merged_cov=torch.where(found[:, None, None], pc, g.merged_cov),
        merged_prior=torch.where(found, mprior, g.merged_prior),
        active=g.active & ~deact)
    g = compute_mixture_weights(g, use_updated)
    return compute_prior_probabilities(g, use_updated)


# ----------------------------------------------------------- extrapolation

def _jacobian(a, b, c, x_A, sp, cp):
    numer = x_A + c * sp
    inv1 = 1.0 / (cp + b * sp)
    inv1_2 = inv1 * inv1
    inv1_3 = inv1_2 * inv1
    s_star = -numer * (2.0 + (a * sp) * numer * inv1_2) * 0.5 * inv1
    asp = a * sp
    ds_da = -(sp * numer * numer) * inv1_3
    ds_db = (sp * numer * (1.0 + 3.0 * asp * numer * inv1_2)) * inv1_2
    ds_dc = -sp * (1.0 + 2.0 * asp * numer * inv1_2) * inv1
    inv2 = 1.0 / (cp + (2.0 * a + b) * sp)
    inv2_3 = inv2 * inv2 * inv2
    inv2_4 = inv2_3 * inv2
    da_da = inv2_3 * (1.0 - (6.0 * asp) * (s_star + a * ds_da) * inv2)
    da_db = (-3.0 * asp * (2.0 * a * ds_db + 1.0)) * inv2_4
    da_dc = (-6.0 * sp * ds_dc * a * a) * inv2_4
    tas = 2.0 * a * s_star + b
    inv3_ = 1.0 / (cp + tas * sp)
    br3 = (cp - (sp * (-sp + tas * cp)) * inv3_) * inv3_
    db_da = 2.0 * (s_star + a * ds_da) * br3
    db_db = (1.0 + 2.0 * a * ds_da) * br3
    db_dc = 2.0 * a * ds_dc * br3
    br4 = cp * (2.0 * a + b) - sp
    dc_da = ds_da * br4 + s_star * s_star * cp
    dc_db = ds_db * br4 + s_star * cp
    dc_dc = ds_dc * br4 + cp
    return torch.stack([
        torch.stack([da_da, da_db, da_dc], dim=-1),
        torch.stack([db_da, db_db, db_dc], dim=-1),
        torch.stack([dc_da, dc_db, dc_dc], dim=-1),
    ], dim=-2)


def _step_var_ms(a, b, tail_xyzr, head_xyzr, cfg: Config, tiny_):
    dr = head_xyzr[..., 3] - tail_xyzr[..., 3]
    dz = head_xyzr[..., 2] - tail_xyzr[..., 2]
    hyp = torch.sqrt(dr * dr + dz * dz)
    sin_t = torch.abs(dr) / torch.clamp(hyp, min=tiny_)
    u = 2.0 * a * head_xyzr[..., 0] + b
    rs = torch.rsqrt(1.0 + u * u)
    kappa = (2.0 * a) * (rs * rs * rs)
    var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
    endcap_n = torch.abs(tail_xyzr[..., 2]) >= cfg.endcap_boundary
    return torch.where(endcap_n, var_ms * torch.abs(dr) / torch.abs(dz),
                       var_ms)


def message_passing(g: State, cfg: Config) -> State:
    dtype = g.dtype
    tiny_ = tiny(dtype)
    n, k = g.in_edges.shape
    merged = g.merged_state[g.src]
    a, b, c = merged[:, 0], merged[:, 1], merged[:, 2]
    tail_xyzr = g.gnn_xyzr[g.src]
    nx_, ny_, nz_, nr_ = (tail_xyzr[:, i] for i in range(4))
    head_xyzr = g.gnn_xyzr[g.dst]
    mx_, my_, mz_, mr_ = (head_xyzr[:, i] for i in range(4))
    proc = g.edge_mask & g.active & g.has_merged[g.src]
    dr = mr_ - nr_
    dz = mz_ - nz_
    var_ms = torch.where(proc, _step_var_ms(a, b, tail_xyzr, head_xyzr, cfg,
                                            tiny_), 0.0)
    if cfg.bug_compat:
        slot_ms = slot_table(torch.where(proc, g.src, n), g.slot_out, var_ms,
                             n, k, 0.0)
        cum_e = torch.cumsum(slot_ms, dim=1)[g.src, g.slot_out]
        new_merged_cov = g.merged_cov.clone()
        new_merged_cov[:, 1, 1] += torch.where(g.has_merged,
                                               slot_ms.sum(dim=1), 0.0)
    else:
        cum_e = var_ms
        new_merged_cov = g.merged_cov
    cov_eff = g.merged_cov[g.src]
    cov_eff[:, 1, 1] += cum_e
    inv_rho_n = torch.rsqrt(torch.clamp(nx_ * nx_ + ny_ * ny_, min=tiny_))
    ca, sa = nx_ * inv_rho_n, ny_ * inv_rho_n
    x_A = (mx_ - nx_) * ca + (my_ - ny_) * sa
    cross = nx_ * my_ - ny_ * mx_
    dot = nx_ * mx_ + ny_ * my_
    inv_h = torch.rsqrt(torch.clamp(cross * cross + dot * dot, min=tiny_))
    sp, cp = cross * inv_h, dot * inv_h
    F = _jacobian(a, b, c, x_A, sp, cp)
    extrp = mat3_vec(F, merged)
    extrp_cov = sandwich3(F, cov_eff)
    S = extrp_cov[:, 2, 2] + cfg.sigma0xy ** 2
    chi2 = extrp[:, 2] * extrp[:, 2] / S
    passed = proc & (chi2 <= cfg.chi2_cut_factor)
    failed = proc & ~passed
    likelihood = torch.rsqrt(2.0 * math.pi * torch.abs(S)) * torch.exp(-0.5 * chi2)
    Q = torch.zeros_like(extrp_cov)
    Q[:, 1, 1] = var_ms
    if cfg.bug_compat:
        x_pred = mat3_vec(F, extrp)
        P_pred = sandwich3(F, extrp_cov) + Q
    else:
        x_pred = extrp
        P_pred = extrp_cov + Q
    R = cfg.sigma0xy ** 2
    Sk = P_pred[:, 2, 2] + R
    K = P_pred[:, :, 2] / Sk[:, None]
    x_post = x_pred + K * (0.0 - x_pred[:, 2])[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=g.device)
    ikh = eye3 - K[:, :, None] * eye3[2][None, None, :]
    P_post = sandwich3(ikh, P_pred) + R * K[:, :, None] * K[:, None, :]
    tau = dz / dr
    sz1, sr1 = rz_sigmas(nz_, cfg)
    sz2, sr2 = rz_sigmas(mz_, cfg)
    inv_dr = 1.0 / dr
    t = dz * inv_dr * inv_dr
    var_tau = (inv_dr * inv_dr * (sz1 * sz1 + sz2 * sz2)
               + t * t * (sr1 * sr1 + sr2 * sr2))
    joint = torch.stack([x_post[:, 0], x_post[:, 1], tau], dim=-1)
    joint_cov = P_post.clone()
    joint_cov[:, :, 2] = 0.0
    joint_cov[:, 2, :] = 0.0
    joint_cov[:, 2, 2] = var_tau + var_ms
    if cfg.bug_compat:
        P_post = joint_cov
    w = g.seed_weight.reshape(-1, 2).flip(1).reshape(-1)
    sel = passed
    sv_ = lambda new, old: torch.where(sel[:, None], new, old)
    sm_ = lambda new, old: torch.where(sel[:, None, None], new, old)
    return g.replace(
        merged_cov=new_merged_cov, active=g.active & ~failed,
        has_updated=g.has_updated | sel,
        upd_sv=sv_(x_post, g.upd_sv), upd_cov=sm_(P_post, g.upd_cov),
        upd_joint=sv_(joint, g.upd_joint),
        upd_joint_cov=sm_(joint_cov, g.upd_joint_cov),
        upd_weight=torch.where(sel, w, g.upd_weight),
        upd_likelihood=torch.where(sel, likelihood, g.upd_likelihood),
        upd_xyzr=torch.where(sel[:, None], tail_xyzr, g.upd_xyzr))


# -------------------------------------------------------------- extraction

def _candidate_matrix(g: State, labels, h: int, min_hits: int):
    n = g.n
    dev = g.device
    c = -(-(n // min_hits + 1) // 64) * 64
    alive = g.node_mask
    lab = torch.where(alive, labels, n)
    sizes = count_by(lab, alive, n)
    eligible = (sizes >= min_hits) & (sizes <= h)
    row_of_label = torch.where(eligible, torch.cumsum(eligible, dim=0) - 1, -1)
    o1 = torch.sort(-g.xyzr[:, 3], stable=True).indices
    o2 = torch.sort(lab[o1], stable=True).indices
    order = o1[o2]
    sorted_lab = lab[order]
    pos_all = torch.arange(n, device=dev)
    change = torch.ones(n, dtype=torch.bool, device=dev)
    change[1:] = sorted_lab[1:] != sorted_lab[:-1]
    seg_start = torch.cummax(torch.where(change, pos_all, 0), dim=0).values
    pos = pos_all - seg_start
    sorted_row = torch.where(
        sorted_lab < n, row_of_label[torch.clamp(sorted_lab, max=n - 1)], -1)
    ok = (sorted_row >= 0) & (pos < h)
    mat = torch.full((c, h), -1, dtype=torch.int64, device=dev)
    mat[torch.where(ok, sorted_row, c - 1), torch.where(ok, pos, 0)] = \
        torch.where(ok, order, -1)
    size = torch.zeros(c, dtype=torch.int64, device=dev)
    size[torch.where(eligible, row_of_label, c - 1)] = torch.where(
        eligible, sizes, 0)
    row_of_node = torch.where(
        alive, row_of_label[torch.clamp(lab, max=n - 1)], -1)
    return mat, size, row_of_node


def _proximity_merge(g: State, cfg: Config, mat):
    c, h = mat.shape
    dev = mat.device
    valid = mat >= 0
    node = torch.clamp(mat, min=0)
    coords = torch.where(valid[..., None], g.xyzr[node], 0.0)
    vivl = g.vivl[node]
    key = torch.where(valid, vivl[..., 0] * 1000 + vivl[..., 1],
                      -1 - torch.arange(h, device=dev)[None])
    same = key[:, :, None] == key[:, None, :]
    freq = torch.sum(same & valid[:, None, :], dim=2)
    freq = torch.where(valid, freq, 0)
    earlier = torch.tril(torch.ones((h, h), dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup_before = torch.any(same & earlier[None], dim=2)
    is_first = valid & ~dup_before
    has2 = torch.any(freq == 2, dim=1)
    layers_with_2 = torch.sum(is_first & (freq == 2), dim=1)
    has_ge3 = torch.any(freq >= 3, dim=1)
    pair_mask = same & earlier.T[None]
    pair_lead = is_first & (freq == 2)
    partner = torch.argmax(pair_mask.to(torch.uint8), dim=2)
    p_coords = torch.gather(coords, 1, partner[..., None].expand(-1, -1, 4))
    dd = coords[..., :3] - p_coords[..., :3]
    d3 = torch.sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
                    + dd[..., 2] * dd[..., 2])
    pairs_ok = torch.all(
        torch.where(pair_lead, d3 <= cfg.node_merge_distance, True), dim=1)
    mergeable = has2 & (layers_with_2 <= 2) & ~has_ge3 & pairs_ok
    clean = ~torch.any(freq >= 2, dim=1)
    can_process = clean | mergeable
    mid_xyz = 0.5 * (coords[..., :3] + p_coords[..., :3])
    mid_r = torch.sqrt(mid_xyz[..., 0] * mid_xyz[..., 0]
                       + mid_xyz[..., 1] * mid_xyz[..., 1])
    mid = torch.cat([mid_xyz, mid_r[..., None]], dim=-1)
    do_merge = mergeable[:, None] & pair_lead
    coords = torch.where(do_merge[..., None], mid, coords)
    kill = torch.any(pair_mask & do_merge[:, :, None], dim=1)
    return coords, valid & ~kill, can_process


def _compact_rows(coords, valid_m):
    c, h = valid_m.shape
    n_hits = torch.sum(valid_m, dim=1)
    rank = torch.cumsum(valid_m, dim=1) - 1
    dest = torch.where(valid_m, rank, h)
    coords_c = torch.zeros((c, h + 1, 4), dtype=coords.dtype,
                           device=coords.device)
    coords_c.scatter_(1, dest[..., None].expand(-1, -1, 4), coords)
    valid_c = torch.arange(h, device=coords.device)[None, :] < n_hits[:, None]
    return coords_c[:, :h], valid_c, n_hits


def _rotate_tracks(coords, valid, n_hits, cfg: Config):
    take = lambda i: torch.gather(
        coords, 1, torch.clamp(i, min=0)[:, None, None].expand(-1, 1, 4))[:, 0]
    p1 = take(n_hits - 1)
    p2a = take(n_hits - 2)
    p3 = take(n_hits - 3)
    dd = p1[:, :3] - p2a[:, :3]
    d = torch.sqrt(dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1] + dd[:, 2] * dd[:, 2])
    p2 = torch.where((d < cfg.separation_3d_threshold)[:, None], p3, p2a)
    angle_xy = torch.atan2(p2[:, 1] - p1[:, 1], p2[:, 0] - p1[:, 0])
    angle_zr = torch.atan2(p2[:, 2] - p1[:, 2], p2[:, 3] - p1[:, 3])
    cxy, sxy = torch.cos(angle_xy)[:, None], torch.sin(angle_xy)[:, None]
    czr, szr = torch.cos(angle_zr)[:, None], torch.sin(angle_zr)[:, None]
    x, y, z, r = (coords[..., i] for i in range(4))
    xn = x * cxy + y * sxy
    yn = -x * sxy + y * cxy
    if cfg.bug_compat:
        rn = r * czr + r * szr
        zn = -z * szr + z * czr
    else:
        rn = r * czr + z * szr
        zn = -z * szr + r * czr
    out = torch.stack([xn, yn, zn, rn], dim=-1)
    return torch.where(valid[..., None], out, 0.0)


def _kf_fit(coords, n_hits, cfg: Config):
    """Two-plane Kalman track fit over every candidate row -> p-values."""
    c, h, _ = coords.shape
    dtype = coords.dtype
    dev = coords.device
    tiny_ = tiny(dtype)
    sxy2 = cfg.sigma0xy ** 2
    srz2 = cfg.sigma0rz ** 2
    zero = torch.zeros(c, dtype=dtype, device=dev)
    one = torch.ones(c, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    h_xy = eye3[0]
    h_rz = eye2[0]
    P_xy = eye3.clone()
    P_xy[0, 0].fill_(sxy2)
    P_rz = torch.zeros((2, 2), dtype=dtype, device=dev)
    P_rz[0, 0].fill_(srz2)
    P_rz[1, 1].fill_(1000.0)
    x_xy = torch.stack([coords[:, 0, 1], zero, zero], dim=1)
    P_xy = P_xy.expand(c, 3, 3)
    x_rz = torch.stack([coords[:, 0, 3], zero], dim=1)
    P_rz = P_rz.expand(c, 2, 2)
    chi_xy = zero
    chi_rz = zero
    sw2 = cfg.ou_sigma ** 2
    for i in range(h - 1):
        ok = i + 1 < n_hits
        x2, y2, z2, r2 = (coords[:, i, k] for k in range(4))
        x3, y3, z3, r3 = (coords[:, i + 1, k] for k in range(4))
        denom = (0.0 - x2) * (0.0 - x3) * (x2 - x3)
        denom = torch.where(denom == 0.0, tiny_, denom)
        a = (x3 * y2 - x2 * y3) / denom
        b = (-(x3 * x3) * y2 + (x2 * x2) * y3) / denom
        dr = r3 - r2
        dz = z3 - z2
        hyp = torch.sqrt(dr * dr + dz * dz)
        sin_t = torch.abs(dr) / torch.clamp(hyp, min=tiny_)
        u = 2.0 * a * x3 + b
        kappa = (2.0 * a) / (1.0 + u * u) ** 1.5
        var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
        endcap = torch.abs(z3) >= cfg.endcap_boundary
        var_ms = torch.where(
            endcap, var_ms * torch.abs(dr / torch.where(dz == 0, tiny_, dz)),
            var_ms)
        dx = x3 - x2
        e1 = torch.exp(-torch.abs(dx) * cfg.ou_alpha)
        f1 = (1.0 - e1) / cfg.ou_alpha
        g1 = (torch.abs(dx) - f1) / cfg.ou_alpha
        st2 = var_ms
        dx2 = dx * dx
        dxw2 = dx2 * sw2
        q02 = 0.5 * dxw2
        q01 = dx * (st2 + q02)
        q12 = dx * sw2
        F = torch.stack([
            torch.stack([one, dx, g1], dim=-1),
            torch.stack([zero, one, f1], dim=-1),
            torch.stack([zero, zero, e1], dim=-1)], dim=-2)
        Q = torch.stack([
            torch.stack([dx2 * (st2 + 0.25 * dxw2), q01, q02], dim=-1),
            torch.stack([q01, st2 + dxw2, q12], dim=-1),
            torch.stack([q02, q12, sw2 * one], dim=-1)], dim=-2)
        xp = mat3_vec(F, x_xy)
        Pp = sandwich3(F, P_xy) + Q
        Sk = Pp[:, 0, 0] + sxy2
        K = Pp[:, :, 0] / Sk[:, None]
        res = y3 - xp[:, 0]
        xn = xp + K * res[:, None]
        ikh = eye3 - K[:, :, None] * h_xy[None, None, :]
        Pn = sandwich3(ikh, Pp) + sxy2 * K[:, :, None] * K[:, None, :]
        res_post = y3 - xn[:, 0]
        S_post = Pn[:, 0, 0] + sxy2
        c_xy = res_post * res_post / S_post
        Frz = torch.stack([torch.stack([one, dz], dim=-1),
                           torch.stack([zero, one], dim=-1)], dim=-2)
        xrp = mat2_vec(Frz, x_rz)
        Prp = sandwich2(Frz, P_rz)
        if cfg.bug_compat:
            Prp = Prp + var_ms[:, None, None]
        else:
            Prp[:, 1, 1] += var_ms
        Srz = Prp[:, 0, 0] + srz2
        Krz = Prp[:, :, 0] / Srz[:, None]
        res_rz = r3 - xrp[:, 0]
        xrn = xrp + Krz * res_rz[:, None]
        ikh2 = eye2 - Krz[:, :, None] * h_rz[None, None, :]
        Prn = sandwich2(ikh2, Prp) + srz2 * Krz[:, :, None] * Krz[:, None, :]
        res_rz_post = r3 - xrn[:, 0]
        S_rz_post = Prn[:, 0, 0] + srz2
        c_rz = res_rz_post * res_rz_post / S_rz_post
        x_xy = torch.where(ok[:, None], xn, x_xy)
        P_xy = torch.where(ok[:, None, None], Pn, P_xy)
        x_rz = torch.where(ok[:, None], xrn, x_rz)
        P_rz = torch.where(ok[:, None, None], Prn, P_rz)
        chi_xy = chi_xy + torch.where(ok, c_xy, 0.0)
        chi_rz = chi_rz + torch.where(ok, c_rz, 0.0)
    dof = torch.clamp(n_hits - 2, min=1).to(dtype)
    return (torch.special.gammaincc(0.5 * dof, 0.5 * chi_xy),
            torch.special.gammaincc(0.5 * dof, 0.5 * chi_rz))


def extract(g: State, cfg: Config):
    """One extraction: components over the active edges (scipy, on the
    host), candidate rows, proximity merge, rotation and fit, then the
    accepted rows' nodes removed and the fragments they leave dropped ->
    (state, an Accepted per event, node indices the event's own)."""
    n = g.n
    dev = g.device
    edge_ok = (g.edge_mask & g.active).cpu().numpy()
    pair_ok = edge_ok[0::2] | edge_ok[1::2]
    a = g.src[0::2].cpu().numpy()[pair_ok]
    b = g.dst[0::2].cpu().numpy()[pair_ok]
    lab = torch.from_numpy(components(n, a, b)).to(dev)
    labels = torch.where(g.node_mask, lab, torch.arange(n, device=dev))
    h = cfg.max_track_hits
    mat, size, row_of_node = _candidate_matrix(g, labels, h,
                                               cfg.min_track_hits)
    big_enough = size >= cfg.min_track_hits
    coords, valid_m, can_process = _proximity_merge(g, cfg, mat)
    coords_c, valid_c, n_hits = _compact_rows(coords, valid_m)
    processed = big_enough & can_process & (n_hits >= cfg.min_track_hits)
    coords_r = _rotate_tracks(coords_c, valid_c, n_hits, cfg)
    pval_xy, pval_zr = _kf_fit(coords_r, n_hits, cfg)
    accepted = (processed & (pval_xy >= cfg.track_acceptance_pval)
                & (pval_zr >= cfg.track_acceptance_pval))
    rows = torch.nonzero(accepted).squeeze(1)
    acc_nodes = mat[rows].cpu().numpy()
    acc_pvals = torch.stack([pval_xy, pval_zr], dim=1)[rows].cpu().numpy()
    event = acc_nodes[:, 0] // g.n_event
    acc = [Accepted(nodes=[r[r >= 0] - b * g.n_event
                           for r in acc_nodes[event == b]],
                    pvals=acc_pvals[event == b].astype(np.float64))
           for b in range(g.batch)]
    # remove the accepted nodes, then components left under the fragment size
    row = row_of_node
    node_extracted = ((row >= 0) & accepted[torch.clamp(row, min=0)]
                      & g.node_mask)
    mask1 = g.node_mask & ~node_extracted
    comp = torch.where(mask1, g.component, 0)
    left = count_by(comp, mask1, n)
    frag = left[g.component] < cfg.min_track_hits
    new_node_mask = mask1 & ~frag
    alive_pair = new_node_mask[g.src[0::2]] & new_node_mask[g.dst[0::2]]
    alive_e = alive_pair[:, None].expand(-1, 2).reshape(-1)
    new_edge_mask = g.edge_mask & alive_e
    return g.replace(node_mask=new_node_mask, edge_mask=new_edge_mask,
                     active=g.active & new_edge_mask), acc


# ------------------------------------------------------------- calibration

def emp_var(g: State) -> torch.Tensor:
    """(N,) each node's xy-gradient variance over its in-edges on a built
    state: the in-edge table's row sums in slot order of the edge count,
    the gradients and their squares, the count clamped to 1 and the
    variance to 0 (NaN stays NaN)."""
    n, k = g.in_edges.shape
    em = g.edge_mask
    w = em.to(g.dtype)
    sx, sy = g.e_xyzr[:, 0], g.e_xyzr[:, 1]
    dx_, dy_ = g.e_xyzr[:, 4], g.e_xyzr[:, 5]
    gx = torch.where(em, (sy - dy_) / (sx - dx_), 0.0)
    row = torch.where(em, g.dst, n)
    s0, s1, s2 = (slot_table(row, g.slot_in, v, n, k, 0.0).sum(dim=1)
                  for v in (w, w * gx, w * gx * gx))
    safe = torch.clamp(s0, min=1.0)
    mean = s1 / safe
    return torch.clamp(s2 / safe - mean * mean, min=0.0)


def lut_thresholds(calibration: dict, feature: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """(N,) KL thresholds: the calibration table read at each node's
    feature value (module doc)."""
    upper = torch.as_tensor(calibration["upper"], dtype=torch.int64,
                            device=feature.device)
    # a true division (a scalar divisor may become a reciprocal product)
    q = feature / torch.full_like(feature, calibration["feature_bin_width"])
    # NaN, inf and 2**63 on (numpy's cast gives INT64_MIN) -> bin 0
    b = torch.where(q < 2.0 ** 63,
                    torch.clamp(torch.trunc(q), 0, upper.shape[0] - 1), 0.0)
    thr = upper[b.to(torch.int64)].to(torch.float64) \
        * calibration["kl_bin_width"]
    return thr.to(dtype)


# ---------------------------------------------------------------- schedule

def schedule(g: State, cfg: Config, work=None,
             calibration: dict | None = None) -> List[List[Accepted]]:
    """The whole schedule on a built state -> each event's accepted
    candidates, iteration by iteration; `calibration`: per-node KL
    thresholds from its table (module doc)."""
    kl_thresholds = None
    if calibration is not None:
        kl_thresholds = lut_thresholds(calibration, emp_var(g), g.dtype)
    g = seed_track_states(g, cfg)
    g = g.replace(active=g.edge_mask)
    g = compute_prior_probabilities(g, use_updated=False)
    g = compute_mixture_weights(g, use_updated=False)
    out = []
    for i in range(1, cfg.num_iterations + 1):
        if i % 2 == 0:
            g = message_passing(g, cfg)
            g = reweight_stage(g, cfg, n_passes=2, work=work)
        else:
            g = cluster(g, cfg, use_updated=i > 1, work=work,
                        kl_thresholds=kl_thresholds)
        g, acc = extract(g, cfg)
        out.append(acc)
        if i % 2 == 0:
            g = g.replace(has_updated=g.has_updated & g.edge_mask)
            g = compute_prior_probabilities(g, use_updated=False)
            g = reweight_stage(g, cfg, n_passes=1, work=work)
    return [list(per_event) for per_event in zip(*out)]


# padded nodes the reference runs as one union: four full events, whose
# (N, K, K) tables fit the card once the program's state is freed
BLOCK_NODES = 4 * 57_344


def blocks(count: int, n_pad: int) -> List[range]:
    """The pool indices run as one union, block by block, for `count`
    events of `n_pad` padded nodes."""
    per = max(1, BLOCK_NODES // n_pad)
    return [range(i, min(i + per, count)) for i in range(0, count, per)]


def run_events(events: List[Dict[str, np.ndarray]], cfg: Config, *, device,
               dtype=torch.float64, work=None,
               calibration: dict | None = None) -> List[List[Accepted]]:
    """build, then schedule, of events' raw arrays (xyzr, vivl, pairs,
    mirror), all in one union -> each event's answer."""
    return schedule(build(events, cfg, device=device, dtype=dtype), cfg,
                    work, calibration)
