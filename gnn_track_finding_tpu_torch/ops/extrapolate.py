"""Message passing: Kalman extrapolation of merged states along edges.

Port of `gnn_track_finding_tpu.ops.extrapolate.message_passing`
(extrapolate.py:41-285).  For every directed edge e = (n -> m) whose tail
has a merged state and which is active at stage start, the merged
parabolic state is transported into n's frame evaluated at m with the
analytic Jacobian F; a chi2 gate on the transported c-parameter either
deactivates the edge or runs a Kalman predict/update and stores the
updated state on the edge.

Sequential-semantics reproduction under bug_compat (extrapolate.py:15-27):
  * the k-th processed out-edge of n sees merged_cov plus the cumulative
    var_ms of out-edges 0..k (in-place mutation of the reference, ref
    :127-128): a row cumsum over the (N, K) out-edge table, gathered at
    (src, slot_out);
  * predict applies F a second time (ref :306-322);
  * the joint covariance aliases the updated covariance (ref :362-365);
  * the updated state's weight comes from the REVERSE edge e ^ 1's seed
    state (ref :384).

Under an edge partition (`group`, JAX extrapolate.py:152-190) a rank's
out-table holds only its own edges, and a cumsum cannot be taken over a
partial table: the ranks OR-combine the out-table activity flags (uint8)
and recompute the whole (N, K) var_ms table from replicated node data and
the out-table head coordinates, with the per-edge formula's operations in
its order, so the table and its cumsum equal the single-device ones.
"""

from __future__ import annotations

import math

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table
from gnn_track_finding_tpu_torch.ops import collect, linalg
from gnn_track_finding_tpu_torch.ops.seeding import rz_sigmas


def _jacobian_and_transport(a, b, c, x_A, sp, cp):
    """Jacobian F of the frame-changed parabola parameters (ref :63-110),
    in the division-light form of extrapolate.py:41-87."""
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
    inv3 = 1.0 / (cp + tas * sp)
    br3 = (cp - (sp * (-sp + tas * cp)) * inv3) * inv3
    db_da = 2.0 * (s_star + a * ds_da) * br3
    db_db = (1.0 + 2.0 * a * ds_da) * br3   # ds_da: ref :98 quirk
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


def _var_ms(a, b, tail_xyzr, head_xyzr, cfg: PipelineConfig, tiny):
    """Highland multiple-scattering variance of a step from the tail
    (merged state a, b) to the head (ref :112-124; global head x)."""
    dr = head_xyzr[..., 3] - tail_xyzr[..., 3]
    dz = head_xyzr[..., 2] - tail_xyzr[..., 2]
    hyp = torch.sqrt(dr * dr + dz * dz)
    sin_t = torch.abs(dr) / torch.clamp(hyp, min=tiny)
    u = 2.0 * a * head_xyzr[..., 0] + b
    rs = torch.rsqrt(1.0 + u * u)
    kappa = (2.0 * a) * (rs * rs * rs)
    var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
    endcap_n = torch.abs(tail_xyzr[..., 2]) >= cfg.endcap_boundary
    return torch.where(endcap_n, var_ms * torch.abs(dr) / torch.abs(dz),
                       var_ms)


def message_passing(g: GraphState, cfg: PipelineConfig,
                    group=None) -> GraphState:
    """One extrapolation round: per-edge updated states, chi2-failed edges
    deactivated, and (bug_compat) the tails' merged covariances advanced
    by their accumulated var_ms."""
    dtype = g.dtype
    tiny = linalg.tiny(dtype)
    n, k = g.out_edges.shape

    merged = g.merged_state[g.src]
    a, b, c = merged[:, 0], merged[:, 1], merged[:, 2]
    # coordinates ride the LIVE GNN view (ref :31-39)
    tail_xyzr = g.gnn_xyzr[g.src]
    nx_, ny_, nz_, nr_ = (tail_xyzr[:, i] for i in range(4))     # tail
    head_xyzr = g.gnn_xyzr[g.dst]
    mx_, my_, mz_, mr_ = (head_xyzr[:, i] for i in range(4))     # head

    proc = g.edge_mask & g.active & g.has_merged[g.src]

    # --- multiple scattering per edge (ref :112-124; global head x) ---
    dr = mr_ - nr_
    dz = mz_ - nz_
    var_ms = torch.where(proc, _var_ms(a, b, tail_xyzr, head_xyzr, cfg, tiny),
                         0.0)

    # --- cumulative in-place merged_cov mutation (ref :127-128) ---
    if cfg.bug_compat:
        if group is None:
            slot_ms = slot_table(torch.where(proc, g.src, n), g.slot_out,
                                 var_ms, n, k, 0.0)
        else:
            # the whole table from replicated data: activity flags of every
            # rank's out-edges, each tail's merged state and coordinates,
            # and the head coordinates cached in the out-table
            active = collect.allor(slot_table(
                torch.where(g.edge_mask & g.active, g.src, n), g.slot_out,
                True, n, k, False), group)
            proc_slot = active & g.has_merged[:, None] & (g.out_edges >= 0)
            slot_ms = torch.where(proc_slot, _var_ms(
                g.merged_state[:, 0:1], g.merged_state[:, 1:2],
                g.gnn_xyzr[:, None, :], g.out_head_xyzr, cfg, tiny), 0.0)
        cum_e = torch.cumsum(slot_ms, dim=1)[g.src, g.slot_out]
        new_merged_cov = g.merged_cov.clone()
        new_merged_cov[:, 1, 1] += torch.where(g.has_merged,
                                               slot_ms.sum(dim=1), 0.0)
    else:
        cum_e = var_ms
        new_merged_cov = g.merged_cov

    cov_eff = g.merged_cov[g.src]          # a fresh gather: safe to update
    cov_eff[:, 1, 1] += cum_e

    # --- frame change + transport (ref :40-79) ---
    inv_rho_n = torch.rsqrt(torch.clamp(nx_ * nx_ + ny_ * ny_, min=tiny))
    ca, sa = nx_ * inv_rho_n, ny_ * inv_rho_n
    x_A = (mx_ - nx_) * ca + (my_ - ny_) * sa
    cross = nx_ * my_ - ny_ * mx_
    dot = nx_ * mx_ + ny_ * my_
    inv_h = torch.rsqrt(torch.clamp(cross * cross + dot * dot, min=tiny))
    sp, cp = cross * inv_h, dot * inv_h

    F = _jacobian_and_transport(a, b, c, x_A, sp, cp)
    extrp = linalg.mat3_vec(F, merged)
    extrp_cov = linalg.sandwich3(F, cov_eff)

    # --- chi2 gate (ref :132-140,297-298) ---
    S = extrp_cov[:, 2, 2] + cfg.sigma0xy ** 2
    chi2 = extrp[:, 2] * extrp[:, 2] / S
    passed = proc & (chi2 <= cfg.chi2_cut_factor)
    failed = proc & ~passed

    # --- Kalman predict (double transport, ref :306-322) + Joseph update ---
    likelihood = torch.rsqrt(2.0 * math.pi * torch.abs(S)) * torch.exp(-0.5 * chi2)

    Q = torch.zeros_like(extrp_cov)
    Q[:, 1, 1] = var_ms
    if cfg.bug_compat:
        x_pred = linalg.mat3_vec(F, extrp)
        P_pred = linalg.sandwich3(F, extrp_cov) + Q
    else:
        x_pred = extrp
        P_pred = extrp_cov + Q
    R = cfg.sigma0xy ** 2
    Sk = P_pred[:, 2, 2] + R
    K = P_pred[:, :, 2] / Sk[:, None]          # gain for H = [0, 0, 1]
    x_post = x_pred + K * (0.0 - x_pred[:, 2])[:, None]
    h_row = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=g.device)
    ikh = (torch.eye(3, dtype=dtype, device=g.device)
           - K[:, :, None] * h_row[None, None, :])
    P_post = linalg.sandwich3(ikh, P_pred) + R * K[:, :, None] * K[:, None, :]

    # --- joint [a, b, tau] rebuild (ref :325-365) ---
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
        P_post = joint_cov                     # alias (ref :362-365)

    # --- write updated states on passing edges (ref :441-447) ---
    # reverse-edge weight (ref :384): the reverse of e is e ^ 1, a pair swap
    w = g.seed_weight.reshape(-1, 2).flip(1).reshape(-1)
    sel = passed
    sv_ = lambda new, old: torch.where(sel[:, None], new, old)
    sm_ = lambda new, old: torch.where(sel[:, None, None], new, old)
    return g.replace(
        merged_cov=new_merged_cov,
        active=g.active & ~failed,
        has_updated=g.has_updated | sel,
        upd_sv=sv_(x_post, g.upd_sv),
        upd_cov=sm_(P_post, g.upd_cov),
        upd_joint=sv_(joint, g.upd_joint),
        upd_joint_cov=sm_(joint_cov, g.upd_joint_cov),
        upd_weight=torch.where(sel, w, g.upd_weight),
        upd_likelihood=torch.where(sel, likelihood, g.upd_likelihood),
        # snapshot of the tail's GNN coords (ref :374-377)
        upd_xyzr=torch.where(sel[:, None], tail_xyzr, g.upd_xyzr),
    )
