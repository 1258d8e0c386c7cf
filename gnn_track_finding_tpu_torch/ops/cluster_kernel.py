"""GMR clustering core: CUDA kernel wrapper and its plain version.

The kernel (csrc/gmr_cluster.cu) replaces the TPU kernel
`gnn_track_finding_tpu/ops/pallas_cluster.py::_kernel`.  A group of 8
lanes works on one compacted row, so a warp holds 4 rows; the group
reads only the row's member slots, straight from the round's per-edge
state tensors through the compacted edge table, and enumerates only
their n(n-1)/2 real pairs (see the source's note).

`cluster_core` is the one entry of `clustering.cluster`: it launches the
kernel for CUDA tensors and raises on any other device than the CPU,
where it takes `cluster_core_plain` (the packed gather of `pack_rows`,
then the port of the JAX `clustering._cluster_core_xla`,
clustering.py:389-467).  Both return (found (rows,) bool, pm (rows, 3),
pc (rows, 9), mprior (rows,), deact (rows, kc) bool), with zero outputs
on rows that are not found.

Inputs: `states` (the round's per-edge fields, `SlotStates`), `tab`
(rows, kc) int64 edge ids of each row's member slots — the members are
the leading non-negative entries, -1 after them, as the rank compaction
of clustering.py builds them — node_xyzr (rows, 4) and klthr (rows,).
Every row is a gated row.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gnn_track_finding_tpu_torch import _build
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.ops import linalg

MAX_KC = 32   # slots per row the kernel takes (one bit each in its masks)


class SlotStates(NamedTuple):
    """The per-edge state fields one clustering round reads (E rows each);
    xyzr may be a strided view (the seed round's e_xyzr[:, :4])."""
    p_sv: torch.Tensor       # (E, 3) parabolic state
    p_cov: torch.Tensor      # (E, 3, 3)
    j_sv: torch.Tensor       # (E, 3) joint state
    j_cov: torch.Tensor      # (E, 3, 3)
    prior: torch.Tensor      # (E,)
    xyzr: torch.Tensor       # (E, 4) neighbour coordinates


def member_mask(tab: torch.Tensor) -> torch.Tensor:
    """(rows, kc) bool: the leading non-negative entries of each row."""
    return torch.cumprod((tab >= 0).to(torch.uint8), dim=1).bool()


def pack_states(states: SlotStates) -> torch.Tensor:
    """The (E, 29) packed state rows [p_sv 0:3 | p_cov 3:12 | j_sv 12:15 |
    j_cov 15:24 | prior 24 | nb_xyzr 25:29] of the JAX core."""
    return torch.cat([
        states.p_sv, states.p_cov.reshape(-1, 9), states.j_sv,
        states.j_cov.reshape(-1, 9), states.prior[:, None], states.xyzr],
        dim=1)


def unpack_states(packed: torch.Tensor) -> SlotStates:
    """Column views of (E, 29) packed state rows (strides 29, 3, 1)."""
    return SlotStates(
        packed[:, 0:3], packed[:, 3:12].unflatten(1, (3, 3)),
        packed[:, 12:15], packed[:, 15:24].unflatten(1, (3, 3)),
        packed[:, 24], packed[:, 25:29])


def pack_rows(states: SlotStates, tab: torch.Tensor):
    """The packed (rows, kc, 29) slot rows of the JAX core, and their
    (rows, kc) member mask.  Padding slots repeat edge 0."""
    return pack_states(states)[torch.clamp(tab, min=0)], member_mask(tab)


def _pairwise_chi2(node_xyzr, cfg: PipelineConfig, nb_xyzr, valid, joint,
                   jcov):
    """Masked (rows, kc, kc) lower-triangle chi2 matrix (clustering.py:80-141)."""
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

    # endcap test coordinate: X under bug_compat (clustering.py:49-57), else z
    sza, sra = sigmas(x_a if cfg.bug_compat else z_a)
    szn, srn = sigmas(x_n if cfg.bug_compat else z_n)

    inv_b = 1.0 / (r_n - r_a)
    tau = (z_n - z_a) * inv_b
    j2 = inv_b[:, :, None]                # state i
    j3 = -inv_b[:, None, :]               # state j
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
    d2 = dt * dt / var_dt

    chi2 = d1 + d2
    k = valid.shape[1]
    ar = torch.arange(k, device=dev)
    tri = ar[:, None] > ar[None, :]                                # i > j
    ok = tri[None] & valid[:, :, None] & valid[:, None, :]
    return torch.where(ok, chi2, float("inf"))


def core_rows_plain(pk, valid, node_xyzr, klthr, *, chi2_thr: float,
                    cfg: PipelineConfig):
    """Row-space GMR core over packed rows (every row gated): batched
    tensor ops plus a (kc - 2)-step loop."""
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
    # min over nonzero entries (clustering.py:119-120)
    chi2 = torch.where(chi2 == 0.0, float("inf"), chi2)
    flat = chi2.reshape(rows, kc * kc)
    best = torch.argmin(flat, dim=1)          # first occurrence
    best_val = torch.amin(flat, dim=1)
    i0 = best // kc
    i1 = best % kc
    found = (best_val < chi2_thr) & torch.isfinite(best_val)

    r = torch.arange(rows, device=dev)
    take = lambda arr, idx: arr[r, idx]
    pm, pc = linalg.merge_gaussians(take(p_sv, i0), take(p_cov, i0),
                                    take(p_sv, i1), take(p_cov, i1))
    jm, jc = linalg.merge_gaussians(take(j_sv, i0), take(j_cov, i0),
                                    take(j_sv, i1), take(j_cov, i1))
    mprior = take(prior, i0) + take(prior, i1)

    ar = torch.arange(kc, device=dev)[None, :]
    remaining = valid & (ar != i0[:, None]) & (ar != i1[:, None])
    stopped = ~found
    for _ in range(kc - 2):
        kl = linalg.kl_distance(j_sv, j_cov, jm[:, None], jc[:, None],
                                bug_compat=cfg.bug_compat)
        kl = torch.where(remaining, kl, float("inf"))
        k_best = torch.argmin(kl, dim=1)
        k_val = torch.amin(kl, dim=1)
        do = ~stopped & (k_val < klthr) & torch.isfinite(k_val)

        npm, npc = linalg.merge_gaussians(take(p_sv, k_best),
                                          take(p_cov, k_best), pm, pc)
        njm, njc = linalg.merge_gaussians(take(j_sv, k_best),
                                          take(j_cov, k_best), jm, jc)
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


def cluster_core_plain(states: SlotStates, tab, node_xyzr, klthr, *,
                       chi2_thr: float, cfg: PipelineConfig):
    """The packed gather, then the row-space core."""
    pk, valid = pack_rows(states, tab)
    return core_rows_plain(pk, valid, node_xyzr, klthr, chi2_thr=chi2_thr,
                           cfg=cfg)


class _Args(ctypes.Structure):
    """struct ClusterArgs of csrc/gmr_cluster.cu, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "tab", "p_sv", "p_cov", "j_sv", "j_cov", "prior", "xyzr", "nodex",
        "klthr", "found", "pm", "pc", "mprior", "deact")]
        + [(name, ctypes.c_longlong) for name in (
            "tab_stride", "p_sv_stride", "p_cov_stride", "j_sv_stride",
            "j_cov_stride", "prior_stride", "xyzr_stride")]
        + [(name, ctypes.c_int) for name in ("rows", "kc", "bug_compat")]
        + [(name, ctypes.c_double) for name in ("chi2_thr", "endcap", "s_rz",
                                                "s_rz2")])


def _row_stride(name: str, t: torch.Tensor, inner: tuple) -> int:
    """Row stride of an (E, *inner) tensor whose rows are contiguous."""
    want, step = [], 1
    for d in reversed(inner):
        want.insert(0, step)
        step *= d
    if t.shape[1:] != inner or t.stride()[1:] != tuple(want):
        raise ValueError(f"cluster_core: {name} is {tuple(t.shape)} with "
                         f"strides {t.stride()}; rows must be contiguous "
                         f"{inner}")
    return t.stride(0)


_INNER = {"p_sv": (3,), "p_cov": (3, 3), "j_sv": (3,), "j_cov": (3, 3),
          "prior": (), "xyzr": (4,)}


def cluster_core(states: SlotStates, tab, node_xyzr, klthr, *,
                 chi2_thr: float, cfg: PipelineConfig):
    """GMR core over compacted rows: the CUDA kernel on the card, the plain
    version for CPU tensors."""
    if tab.device.type == "cpu":
        return cluster_core_plain(states, tab, node_xyzr, klthr,
                                  chi2_thr=chi2_thr, cfg=cfg)
    if tab.device.type != "cuda":
        raise ValueError(f"cluster_core: unsupported device {tab.device}")
    rows, kc = tab.shape
    dev = tab.device
    dtype = node_xyzr.dtype
    if not 2 <= kc <= MAX_KC or tab.dtype != torch.int64 or (
            rows and tab.stride(1) != 1):
        raise ValueError(f"cluster_core: tab is {tuple(tab.shape)} "
                         f"{tab.dtype}, expected (rows, 2..{MAX_KC}) int64 "
                         "with contiguous rows")
    expect = {"node_xyzr": (rows, 4), "klthr": (rows,)}
    for name, t in zip(expect, (node_xyzr, klthr)):
        if tuple(t.shape) != expect[name] or not t.is_contiguous():
            raise ValueError(f"cluster_core: {name} is {tuple(t.shape)}, "
                             f"expected contiguous {expect[name]}")
    strides = [_row_stride(name, t, _INNER[name])
               for name, t in zip(states._fields, states)]
    n_edges = states.prior.shape[0]
    if any(t.shape[0] != n_edges for t in states) or any(
            t.device != dev or t.dtype != dtype
            for t in list(states) + [node_xyzr, klthr]):
        raise ValueError("cluster_core: the state fields (one row per edge), "
                         "node_xyzr and klthr must share tab's CUDA device "
                         f"and the dtype {dtype}")
    found = torch.empty((rows,), dtype=torch.bool, device=dev)
    pm = torch.empty((rows, 3), dtype=dtype, device=dev)
    pc = torch.empty((rows, 9), dtype=dtype, device=dev)
    mprior = torch.empty((rows,), dtype=dtype, device=dev)
    deact = torch.empty((rows, kc), dtype=torch.bool, device=dev)
    if rows == 0:
        return found, pm, pc, mprior, deact
    args = _Args(
        tab.data_ptr(), *(t.data_ptr() for t in states),
        node_xyzr.data_ptr(), klthr.data_ptr(), found.data_ptr(),
        pm.data_ptr(), pc.data_ptr(), mprior.data_ptr(), deact.data_ptr(),
        tab.stride(0), *strides, rows, kc,
        int(cfg.bug_compat), float(chi2_thr), float(cfg.endcap_boundary),
        float(cfg.sigma0rz), float(cfg.sigma0rz2))
    rc = _build.library().fn("gmr_cluster", dtype)(
        ctypes.byref(args), _build.stream_handle(dev))
    _build.check(rc, "gmr_cluster")
    cluster_core.launches += 1
    return found, pm, pc, mprior, deact


cluster_core.launches = 0


def occupancy(dtype, kc: int) -> dict:
    """Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    of the kernel at this dtype and kc, with its block shape."""
    out = (ctypes.c_int * 4)()
    rc = _build.library().fn("gmr_cluster_occupancy", dtype)(kc, out)
    _build.check(rc, "gmr_cluster_occupancy")
    blocks, threads, smem, group = out
    return {"blocks_per_sm": blocks, "threads_per_block": threads,
            "smem_bytes_per_block": smem, "lanes_per_row": group,
            "warps_per_sm": blocks * threads // 32,
            "rows_per_sm": blocks * threads // group}
