"""Test support only: synthetic inputs that hold the edge cases of the
kernels' layouts.

Nothing in the pipeline imports this module.  The CPU tests
(tests/test_torch_kernels.py), the card-only tests (tests/test_torch_gpu.py)
and chip_smoke.py do: the inputs are made with numpy from a seed, so each
hands the same rows to a kernel and to its plain version.  It lives in the
package so that chip_smoke.py, run from a checkout, reaches it by the
package's import path.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_track_finding_tpu_torch.ops.cluster_kernel import SlotStates

# row kinds of cluster_rows, cycled over the rows
CLUSTER_KINDS = ("random", "nan_chi2", "nan_kl", "chi2_tie", "duplicates",
                 "all_equal", "absorb_all")


def cluster_rows(seed: int, rows: int, kc: int, counts=None, *,
                 dtype=torch.float64, device="cpu", kinds=CLUSTER_KINDS):
    """(states, tab, node_xyzr, klthr) for `rows` compacted rows.

    Row r has min(counts[r], kc) member slots (default: counts drawn from
    3..15, the gate's range) whose edge ids are scattered over the edge
    tensors; the rest of its tab row is -1.  Members sit close in [a, b]
    and tau, so most rows merge at the seed chi2 threshold (1.0).  The
    row kinds, cycled: random; a NaN [a, b] component (NaN chi2: not
    found); a NaN tau component (finite chi2, NaN KL); two identical slots
    (an exact chi2 tie on their pairs with slot 0, and chi2 = 0 between
    them); several identical slots (chi2 = 0 pairs); all slots identical
    (every chi2 = 0: not found); klthr 1e30 (full absorption).  xyzr is
    the (E, 4) head of an (E, 8) tensor, as in the seed round."""
    rng = np.random.default_rng(seed)
    if counts is None:
        counts = rng.integers(3, 16, size=rows)
    n = np.minimum(np.asarray(counts, dtype=np.int64), kc)
    n_edges = int(n.sum()) + 7                     # a few edges no row reads
    p_sv = rng.normal(size=(n_edges, 3))
    p_cov = _spd(rng, n_edges, 1.0)
    j_sv = np.zeros((n_edges, 3))
    j_cov = _spd(rng, n_edges, 1e-2)
    prior = rng.uniform(0.1, 1.0, size=n_edges)
    xyzr8 = rng.normal(size=(n_edges, 8)) * 100.0
    node = np.zeros((rows, 4))
    klthr = np.full(rows, 2.0)
    tab = np.full((rows, kc), -1, dtype=np.int64)
    perm = rng.permutation(n_edges)
    at = 0
    for r in range(rows):
        kind = kinds[r % len(kinds)]
        ids = perm[at:at + n[r]]
        at += n[r]
        tab[r, :n[r]] = ids
        ra = rng.uniform(30.0, 1000.0)
        node[r] = (rng.uniform(-700.0, 700.0), rng.normal() * 50.0,
                   rng.uniform(-1000.0, 1000.0), ra)
        slope = rng.uniform(-2.0, 2.0)
        centre = rng.normal(size=2)
        spread = rng.uniform(0.05, 0.8)
        sig = np.sqrt(np.diagonal(j_cov[ids][:, :2, :2], axis1=1, axis2=2))
        j_sv[ids, :2] = centre + spread * sig * rng.normal(size=(len(ids), 2))
        j_sv[ids, 2] = slope + rng.normal(size=len(ids)) * 1e-2
        dr = rng.choice([-1.0, 1.0], size=len(ids)) * rng.uniform(
            20.0, 200.0, size=len(ids))
        xyzr8[ids, 0] = rng.uniform(-700.0, 700.0, size=len(ids))
        xyzr8[ids, 3] = ra + dr
        xyzr8[ids, 2] = node[r, 2] + slope * dr + rng.normal(
            size=len(ids)) * 0.5
        if kind == "nan_chi2" and len(ids) > 1:
            j_sv[ids[1], 0] = np.nan
        elif kind == "nan_kl" and len(ids) > 2:
            j_sv[ids[-1], 2] = np.nan
        elif kind == "chi2_tie" and len(ids) > 2:
            _copy_edge(ids[2], ids[1], p_sv, p_cov, j_sv, j_cov, prior, xyzr8)
        elif kind == "duplicates":
            for e in ids[1:len(ids) // 2 + 1]:
                _copy_edge(e, ids[0], p_sv, p_cov, j_sv, j_cov, prior, xyzr8)
        elif kind == "all_equal":
            for e in ids[1:]:
                _copy_edge(e, ids[0], p_sv, p_cov, j_sv, j_cov, prior, xyzr8)
        elif kind == "absorb_all":
            klthr[r] = 1e30
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    states = SlotStates(t(p_sv), t(p_cov), t(j_sv), t(j_cov), t(prior),
                        t(xyzr8)[:, :4])
    return states, torch.from_numpy(tab).to(device), t(node), t(klthr)


def _spd(rng, n, scale):
    """n random symmetric positive definite 3x3 matrices near scale * I."""
    a = rng.normal(size=(n, 3, 3)) * 0.3
    return scale * (a @ np.swapaxes(a, 1, 2) + np.eye(3) * rng.uniform(
        0.5, 1.5, size=(n, 1, 1)))


def _copy_edge(dst, src, *fields):
    for f in fields:
        f[dst] = f[src]


def distinct_tables(seed: int, n: int, k: int, *, dtype=torch.float64,
                    device="cpu"):
    """(ok (n, k) bool, x (n, k), node_x (n,)) whose rows cycle through:
    empty rows; all-ok rows with duplicates; sparse random rows; rows whose
    x equal node_x; rows with NaN; rows with -0.0 beside 0.0 (node_x 0.0 or
    -0.0).  Cells that are not ok hold +inf, as in the reweight tables."""
    rng = np.random.default_rng(seed)
    pool = np.array([1.5, 2.5, 3.5, -1.0, 0.0])
    x = rng.choice(pool, size=(n, k))
    node_x = rng.normal(size=n) * 2.0
    ok = rng.uniform(size=(n, k)) < 0.1
    for r in range(n):
        kind = r % 6
        if kind == 0:
            ok[r] = False
        elif kind == 1:
            ok[r] = True
        elif kind == 3:
            node_x[r] = pool[r % len(pool)]
            ok[r] = rng.uniform(size=k) < 0.5
        elif kind == 4:
            x[r, rng.integers(0, k, size=3)] = np.nan
            ok[r] = rng.uniform(size=k) < 0.5
        elif kind == 5:
            x[r] = rng.choice([0.0, -0.0, 1.0, -1.0], size=k)
            node_x[r] = -0.0 if r % 12 == 5 else 0.0
            ok[r] = rng.uniform(size=k) < 0.5
    x = np.where(ok, x, np.inf)
    return (torch.from_numpy(ok).to(device),
            torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(node_x).to(device, dtype))
