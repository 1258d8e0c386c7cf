"""GMR clustering core: CUDA kernel wrapper and its plain version.

The kernel (csrc/gmr_cluster.cu) replaces the TPU kernel
`gnn_track_finding_tpu/ops/pallas_cluster.py::_kernel`.  It is bound by
float64 arithmetic latency, not memory: one warp per compacted row, lanes
over slots and slot pairs, warp-shuffle argmins (see the source's note).

`cluster_core` is the one entry of `clustering.cluster`: it launches the
kernel for CUDA tensors and raises on any other device than the CPU,
where it takes `cluster_core_plain` (the port of the JAX
`clustering._cluster_core_xla`, clustering.py:389-467).  Both return
(found (rows,) bool, pm (rows, 3), pc (rows, 9), mprior (rows,),
deact (rows, kc) bool), with zero outputs on rows that are not found.

Input layout, node-major: pk (rows, kc, 29) packed slot states
[p_sv 0:3 | p_cov 3:12 | j_sv 12:15 | j_cov 15:24 | prior 24 | nb_xyzr 25:29],
node_xyzr (rows, 4), gate (rows,) bool, klthr (rows,), valid (rows, kc) bool.
"""

from __future__ import annotations

import torch

from gnn_track_finding_tpu_torch import _build
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.ops import linalg

MAX_KC = 32   # slots per row the kernel takes (one lane each)


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


def cluster_core_plain(pk, node_xyzr, gate, klthr, valid, *, chi2_thr: float,
                       cfg: PipelineConfig):
    """Row-space GMR core as batched tensor ops plus a (kc - 2)-step loop."""
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
    found = gate & (best_val < chi2_thr) & torch.isfinite(best_val)

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


def cluster_core(pk, node_xyzr, gate, klthr, valid, *, chi2_thr: float,
                 cfg: PipelineConfig):
    """GMR core over compacted rows: the CUDA kernel on the card, the plain
    version for CPU tensors."""
    if pk.device.type == "cpu":
        return cluster_core_plain(pk, node_xyzr, gate, klthr, valid,
                                  chi2_thr=chi2_thr, cfg=cfg)
    if pk.device.type != "cuda":
        raise ValueError(f"cluster_core: unsupported device {pk.device}")
    rows, kc, width = pk.shape
    dev = pk.device
    dtype = pk.dtype
    if width != 29 or not 2 <= kc <= MAX_KC:
        raise ValueError(f"cluster_core: pk shape {tuple(pk.shape)}")
    expect = {"node_xyzr": ((rows, 4), dtype), "gate": ((rows,), torch.bool),
              "klthr": ((rows,), dtype), "valid": ((rows, kc), torch.bool)}
    for name, t in zip(expect, (node_xyzr, gate, klthr, valid)):
        shape, dt = expect[name]
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"cluster_core: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dt}")
    for t in (pk, node_xyzr, gate, klthr, valid):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("cluster_core: inputs must be contiguous tensors "
                             "on one CUDA device")
    found = torch.empty((rows,), dtype=torch.bool, device=dev)
    pm = torch.empty((rows, 3), dtype=dtype, device=dev)
    pc = torch.empty((rows, 9), dtype=dtype, device=dev)
    mprior = torch.empty((rows,), dtype=dtype, device=dev)
    deact = torch.empty((rows, kc), dtype=torch.bool, device=dev)
    lib = _build.library()
    rc = lib.fn("gmr_cluster", dtype)(
        pk.data_ptr(), node_xyzr.data_ptr(), gate.data_ptr(),
        klthr.data_ptr(), valid.data_ptr(), rows, kc, float(chi2_thr),
        float(cfg.endcap_boundary), float(cfg.sigma0rz),
        float(cfg.sigma0rz2), int(cfg.bug_compat), found.data_ptr(),
        pm.data_ptr(), pc.data_ptr(), mprior.data_ptr(), deact.data_ptr(),
        _build.stream_handle(dev))
    _build.check(rc, "gmr_cluster")
    cluster_core.launches += 1
    return found, pm, pc, mprior, deact


cluster_core.launches = 0
