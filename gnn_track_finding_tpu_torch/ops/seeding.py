"""Edge-parallel track-state seeding.

Port of `gnn_track_finding_tpu.ops.seeding` (seeding.py:39-199): for every
directed edge e = (src -> dst) the parabola through (beamline origin, dst,
src) in dst's local frame, its covariance H^-1 S H^-T, Highland multiple
scattering on the direction parameter, and the joint [a, b, tau] state.

bug_compat keeps the reference's squared tau variance (helper.py:421),
the parabolic/joint covariance aliasing (helper.py:422-425) and the
set()-order tau pairing: each edge's tau comes from its mirror edge,
recomputed from the mirror's tail coordinates (`mirror_src`).

The per-node gradient statistics are row sums over the (N, K) in-edge
table (one writer per cell) rather than a float scatter-add over edges,
whose CUDA atomics would reorder the sum from run to run.  Under an edge
partition (`group`, JAX seeding.py:169-188) each rank sums the rows of its
partial table (its own edges' cells) and the (N,) partials are all-summed:
JAX's wire pattern.  That reassociates the sums at rank boundaries, so
the statistics agree with the single-device ones to rtol 1e-12, not
bitwise; everything else is per edge and bitwise.
"""

from __future__ import annotations

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table
from gnn_track_finding_tpu_torch.ops import collect, linalg


def rz_sigmas(z, cfg: PipelineConfig):
    """(sigma_z, sigma_r) for hits at coordinate z: barrel sigma_r =
    sigma0rz, sigma_z = sigma0rz2, swapped in the endcap (helper.py:272-314)."""
    endcap = torch.abs(z) >= cfg.endcap_boundary
    s_rz = torch.tensor(cfg.sigma0rz, dtype=z.dtype, device=z.device)
    s_rz2 = torch.tensor(cfg.sigma0rz2, dtype=z.dtype, device=z.device)
    return torch.where(endcap, s_rz, s_rz2), torch.where(endcap, s_rz2, s_rz)


def tau_variance(node_zr, nb_zr, cfg: PipelineConfig):
    """Variance of tau = dz/dr from both hits' z/r errors (helper.py:316-331);
    1 = node (dst), 2 = neighbour (src)."""
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


def highland_var_ms(a, b, kappa_x, node_zr, nb_zr, cfg: PipelineConfig):
    """Highland multiple-scattering variance (helper.py:400-415)."""
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


def in_table_rowsum(g: GraphState, vals: torch.Tensor) -> torch.Tensor:
    """Per-node sum of an (E,) edge value over the head's in-edge table:
    real edges scatter into their (dst, slot_in) cell (one writer each;
    padded edges go to a dump row), then each row sums."""
    n, k = g.in_edges.shape
    row = torch.where(g.edge_mask, g.dst, n)
    return slot_table(row, g.slot_in, vals, n, k, 0.0).sum(dim=1)


def seed_track_states(g: GraphState, cfg: PipelineConfig,
                      group=None) -> GraphState:
    """Per-edge seed states for every directed edge, plus the per-node
    edge-gradient statistics (helper.py:446-447); `group`: the edge
    partition's process group (None: one device)."""
    sx, sy, sz, sr = (g.e_xyzr[:, i] for i in range(4))        # neighbour (tail)
    dx_, dy_, dz_, dr_ = (g.e_xyzr[:, 4 + i] for i in range(4))  # node (head)

    # --- local frame of the head node (helper.py:354-366) ---
    azimuth = torch.atan2(dy_, dx_)
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    x_0 = (0.0 - dx_) * ca + (0.0 - dy_) * sa
    x_B = (sx - dx_) * ca + (sy - dy_) * sa
    m_B = -(sx - dx_) * sa + (sy - dy_) * ca

    # --- parabola through (origin, node, neighbour) (helper.py:375-389) ---
    ones = torch.ones_like(x_0)
    zeros = torch.zeros_like(x_0)
    H = torch.stack([
        torch.stack([0.5 * x_0 * x_0, x_0, ones], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
        torch.stack([0.5 * x_B * x_B, x_B, ones], dim=-1),
    ], dim=-2)
    H_inv = linalg.inv3(H)
    sv = H_inv[..., 2] * m_B[..., None]    # measurement vector [0, 0, m_B]
    a, b = sv[..., 0], sv[..., 1]

    S = torch.zeros_like(H)
    S[..., 0, 0] = cfg.sigma_O ** 2
    S[..., 1, 1] = cfg.sigma0xy ** 2
    S[..., 2, 2] = cfg.sigma0xy ** 2
    cov = linalg.sandwich3(H_inv, S)

    # --- multiple scattering on the direction parameter (helper.py:391-418)
    var_ms = highland_var_ms(a, b, sx, (dz_, dr_), (sz, sr), cfg)
    cov[..., 1, 1] += var_ms

    # --- joint [a, b, tau] state (helper.py:419-425) ---
    tau = (sz - dz_) / (sr - dr_)
    if cfg.bug_compat:
        # the mirror neighbour's tau and tau variance, recomputed from its
        # tail coordinates (bitwise the donor's: e_xyzr tail == xyzr[src])
        mrows = g.xyzr[g.mirror_src]
        msz, msr = mrows[:, 2], mrows[:, 3]
        tau = (msz - dz_) / (msr - dr_)
        var_tau = tau_variance((dz_, dr_), (msz, msr), cfg)
        var_tau_eff = var_tau * var_tau + var_ms   # helper.py:421 squares it
    else:
        var_tau = tau_variance((dz_, dr_), (sz, sr), cfg)
        var_tau_eff = var_tau + var_ms
    joint = torch.stack([a, b, tau], dim=-1)
    joint_cov = cov.clone()
    joint_cov[..., :, 2] = 0.0
    joint_cov[..., 2, :] = 0.0
    joint_cov[..., 2, 2] = var_tau_eff
    if cfg.bug_compat:
        cov = joint_cov     # helper.py:422-425 aliasing

    # --- per-node gradient statistics over in-edges (helper.py:287-303) ---
    em = g.edge_mask
    w = em.to(g.dtype)
    grad_xy = (sy - dy_) / (sx - dx_)
    gx = torch.where(em, grad_xy, 0.0)
    gz = torch.where(em, tau, 0.0)
    # the five per-node sums, partial under a group, combined in one call
    sums = collect.allsum(torch.stack([
        in_table_rowsum(g, v) for v in
        (w, w * gx, w * gx * gx, w * gz, w * gz * gz)], dim=1), group)
    safe = torch.clamp(sums[:, 0], min=1.0)

    def mean_var(s1, s2):
        mean = s1 / safe
        var = s2 / safe - mean * mean
        return mean, torch.clamp(var, min=0.0)

    mx, vx = mean_var(sums[:, 1], sums[:, 2])
    mz, vz = mean_var(sums[:, 3], sums[:, 4])
    grad_stats = torch.stack([mx, vx, mz, vz], dim=-1)

    emv = em[:, None]
    emm = em[:, None, None]
    return g.replace(
        seed_sv=torch.where(emv, sv, 0.0),
        seed_cov=torch.where(emm, cov, 0.0),
        seed_joint=torch.where(emv, joint, 0.0),
        seed_joint_cov=torch.where(emm, joint_cov, 0.0),
        grad_stats=grad_stats,
    )
