"""Track-candidate extraction as batched tensor ops.

Port of `gnn_track_finding_tpu.ops.extract` (extract.py:56-438): FastSV
components over the active edges become rows of a (C, H) candidate matrix
(lexsort on (component, -r), so hits arrive radius-descending); a masked
H x H analysis does the close-proximity same-layer merge and the rows are
compacted (merge_rows: on the card one kernel, ops/merge_kernel.py, with
merge_rows_plain, _proximity_merge then _compact_rows, its plain
version); the innermost edge rotation keeps the reference's r/z typo
under bug_compat; the
two-plane Kalman fit runs as one H-1 step loop over all candidates; the
chi2 survival function gives the p-values (track_fit: on the card the
rotation and the fit are one kernel, ops/fit_kernel.py, and
track_fit_plain is its plain version); the first ACC_PULL_CAP
accepted rows are compacted, in row order, into a static head.  Nothing
here reads the device on the host (FastSV runs its fixed rounds, the
accepted count stays a device scalar), so the whole extraction can be
captured in a CUDA graph.

bug_compat reproduces the rotation typo (extract_track_candidates.py:
190-191) and filterpy's scalar-Q broadcast in the zr fit (:302).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph import cca
from gnn_track_finding_tpu_torch.graph.state import GraphState
from gnn_track_finding_tpu_torch.ops import fit_kernel, linalg, merge_kernel
from gnn_track_finding_tpu_torch.ops.priors import count_by

# Rows of the accepted head per extraction (JAX pipeline.py:315-319).  The
# densest extraction of the committed events accepts 1,504 rows (the full
# event, iteration 1); an event over the cap is rerun by the exact driver.
ACC_PULL_CAP = 2048


class ExtractionResult(NamedTuple):
    labels: torch.Tensor        # (N,) component label per node
    row_of_node: torch.Tensor   # (N,) candidate row per node, -1 if none
    cand_nodes: torch.Tensor    # (C, H) node indices per candidate row, -1 pad
    cand_size: torch.Tensor     # (C,) nodes in the candidate (pre-merge)
    processed: torch.Tensor     # (C,) candidate reached the KF fit
    accepted: torch.Tensor      # (C,) passed both p-value gates
    merged_pair: torch.Tensor   # (C,) number of proximity-merged node pairs
    pval_xy: torch.Tensor       # (C,)
    pval_zr: torch.Tensor       # (C,)
    acc_count: torch.Tensor     # () accepted rows
    acc_nodes: torch.Tensor     # (cap, H) the first cap accepted rows' node
                                # indices, in row order, -1 padded
    acc_pvals: torch.Tensor     # (cap, 2) their (pval_xy, pval_zr), 0 padded
    cca_rounds: torch.Tensor    # () FastSV hooking rounds (0: labels given)
    cca_converged: torch.Tensor  # () bool: the labels are the components
    # On a stacked batch of B events (g.batch > 1) the last five fields
    # are per event, with a leading (B,) axis: each event's own count,
    # head (its own cap, node ids local to the event) and FastSV verdict.


def candidate_rows(n: int, min_hits: int) -> int:
    """C, the candidate rows of an event of n padded nodes: a multiple of
    64 above n // min_hits + 1 (the last row is the scatter dump)."""
    return -(-(n // min_hits + 1) // 64) * 64


def _candidate_matrix(g: GraphState, labels: torch.Tensor, h: int,
                      min_hits: int):
    """Rows of node indices per eligible component (size in [min_hits, h]),
    radius-descending within a row (extract.py:56-114).  C is a multiple
    of 64 above N // min_hits + 1; the last row is the scatter dump."""
    n = g.num_padded_nodes
    dev = g.device
    c = candidate_rows(n, min_hits)
    alive = g.node_mask
    lab = torch.where(alive, labels, n)

    sizes = count_by(lab, alive, n)
    eligible = (sizes >= min_hits) & (sizes <= h)
    row_of_label = torch.where(eligible, torch.cumsum(eligible, dim=0) - 1, -1)

    # lexsort((-r, lab)): stable sort on the secondary key, then the primary
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


def _proximity_merge(g: GraphState, cfg: PipelineConfig, mat: torch.Tensor):
    """Close-proximity same-layer merge analysis (extract.py:117-174) ->
    (coords (C,H,4) post-merge, valid (C,H), can_process (C,), n_pairs (C,))."""
    c, h = mat.shape
    dev = mat.device
    valid = mat >= 0
    node = torch.clamp(mat, min=0)
    coords = torch.where(valid[..., None], g.xyzr[node], 0.0)
    vivl = g.vivl[node]
    key = torch.where(valid, vivl[..., 0] * 1000 + vivl[..., 1],
                      -1 - torch.arange(h, device=dev)[None])

    same = key[:, :, None] == key[:, None, :]             # (C,H,H)
    freq = torch.sum(same & valid[:, None, :], dim=2)
    freq = torch.where(valid, freq, 0)
    earlier = torch.tril(torch.ones((h, h), dtype=torch.bool, device=dev),
                         diagonal=-1)                     # j < i
    dup_before = torch.any(same & earlier[None], dim=2)
    is_first = valid & ~dup_before

    has2 = torch.any(freq == 2, dim=1)
    layers_with_2 = torch.sum(is_first & (freq == 2), dim=1)
    has_ge3 = torch.any(freq >= 3, dim=1)

    # partner of each first-occurrence duplicate: the later same-key slot
    # (exactly one where freq == 2, the only rows whose partner is read)
    pair_mask = same & earlier.T[None]                    # j > i
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

    # midpoint merge on mergeable rows (ref :48-55,109-132)
    mid_xyz = 0.5 * (coords[..., :3] + p_coords[..., :3])
    mid_r = torch.sqrt(mid_xyz[..., 0] * mid_xyz[..., 0]
                       + mid_xyz[..., 1] * mid_xyz[..., 1])
    mid = torch.cat([mid_xyz, mid_r[..., None]], dim=-1)
    do_merge = mergeable[:, None] & pair_lead
    coords = torch.where(do_merge[..., None], mid, coords)
    # a slot dies when some merged lead has it as its later partner
    kill = torch.any(pair_mask & do_merge[:, :, None], dim=1)
    n_pairs = torch.where(mergeable, layers_with_2, 0)
    return coords, valid & ~kill, can_process, n_pairs


def _compact_rows(coords, valid_m):
    """Each row's valid slots moved to the front, radius order kept ->
    (coords (C,H,4), valid (C,H), n_hits (C,))."""
    c, h = valid_m.shape
    n_hits = torch.sum(valid_m, dim=1)
    rank = torch.cumsum(valid_m, dim=1) - 1
    dest = torch.where(valid_m, rank, h)
    coords_c = torch.zeros((c, h + 1, 4), dtype=coords.dtype,
                           device=coords.device)
    coords_c.scatter_(1, dest[..., None].expand(-1, -1, 4), coords)
    valid_c = torch.arange(h, device=coords.device)[None, :] < n_hits[:, None]
    return coords_c[:, :h], valid_c, n_hits


def merge_rows_plain(g: GraphState, cfg: PipelineConfig, mat: torch.Tensor):
    """The proximity merge, then the row compaction: the kernel's plain
    version -> (coords (C,H,4), valid (C,H), n_hits (C,), can_process (C,),
    n_pairs (C,))."""
    coords, valid_m, can_process, n_pairs = _proximity_merge(g, cfg, mat)
    return (*_compact_rows(coords, valid_m), can_process, n_pairs)


def merge_rows(g: GraphState, cfg: PipelineConfig, mat: torch.Tensor):
    """The proximity merge and the row compaction of every candidate row,
    as merge_rows_plain gives them: the row_merge kernel on the card, the
    plain version for CPU tensors."""
    dev = mat.device
    if dev.type == "cpu":
        return merge_rows_plain(g, cfg, mat)
    if dev.type != "cuda":
        raise ValueError(f"merge_rows: unsupported device {dev}")
    return merge_kernel.merge_rows(mat, g.xyzr, g.vivl,
                                   cfg.node_merge_distance)


def _rotate_tracks(coords, valid, n_hits, cfg: PipelineConfig):
    """Innermost-edge rotation (extract.py:177-211); hits are
    radius-descending, so the innermost sit at n-1, n-2, n-3."""
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
        rn = r * czr + r * szr       # ref :190 typo kept
        zn = -z * szr + z * czr      # ref :191 typo kept
    else:
        rn = r * czr + z * szr
        zn = -z * szr + r * czr
    out = torch.stack([xn, yn, zn, rn], dim=-1)
    return torch.where(valid[..., None], out, 0.0)


def _kf_chi2(coords, n_hits, cfg: PipelineConfig):
    """Batched two-plane Kalman track fit (extract.py:214-327) -> each
    row's chi2 sums (chi_xy, chi_rz)."""
    c, h, _ = coords.shape
    dtype = coords.dtype
    dev = coords.device
    tiny = linalg.tiny(dtype)
    sxy2 = cfg.sigma0xy ** 2
    srz2 = cfg.sigma0rz ** 2
    zero = torch.zeros(c, dtype=dtype, device=dev)
    one = torch.ones(c, dtype=dtype, device=dev)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    h_xy = eye3[0]                       # [1, 0, 0]
    h_rz = eye2[0]                       # [1, 0]
    # the initial covariances, written on the device (no host copy)
    P_xy = eye3.clone()
    P_xy[0, 0].fill_(sxy2)               # diag(sxy2, 1, 1)
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

        # parabola through origin + both hits (ref :197-205,236-239)
        denom = (0.0 - x2) * (0.0 - x3) * (x2 - x3)
        denom = torch.where(denom == 0.0, tiny, denom)
        a = (x3 * y2 - x2 * y3) / denom
        b = (-(x3 * x3) * y2 + (x2 * x2) * y3) / denom

        dr = r3 - r2
        dz = z3 - z2
        hyp = torch.sqrt(dr * dr + dz * dz)
        sin_t = torch.abs(dr) / torch.clamp(hyp, min=tiny)
        u = 2.0 * a * x3 + b
        kappa = (2.0 * a) / (1.0 + u * u) ** 1.5
        var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
        endcap = torch.abs(z3) >= cfg.endcap_boundary
        var_ms = torch.where(
            endcap, var_ms * torch.abs(dr / torch.where(dz == 0, tiny, dz)),
            var_ms)

        # OU transition + process noise (ref :257-282)
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

        xp = linalg.mat3_vec(F, x_xy)
        Pp = linalg.sandwich3(F, P_xy) + Q
        # Joseph update, H = [1, 0, 0]
        Sk = Pp[:, 0, 0] + sxy2
        K = Pp[:, :, 0] / Sk[:, None]
        res = y3 - xp[:, 0]
        xn = xp + K * res[:, None]
        ikh = eye3 - K[:, :, None] * h_xy[None, None, :]
        Pn = linalg.sandwich3(ikh, Pp) + sxy2 * K[:, :, None] * K[:, None, :]
        res_post = y3 - xn[:, 0]
        S_post = Pn[:, 0, 0] + sxy2
        c_xy = res_post * res_post / S_post

        # zr plane: tracks r over dz steps, scalar-Q broadcast (ref :299-316)
        Frz = torch.stack([torch.stack([one, dz], dim=-1),
                           torch.stack([zero, one], dim=-1)], dim=-2)
        xrp = linalg.mat2_vec(Frz, x_rz)
        Prp = linalg.sandwich2(Frz, P_rz)
        if cfg.bug_compat:
            Prp = Prp + var_ms[:, None, None]     # filterpy scalar broadcast
        else:
            Prp[:, 1, 1] += var_ms             # Prp is a fresh tensor
        Srz = Prp[:, 0, 0] + srz2
        Krz = Prp[:, :, 0] / Srz[:, None]
        res_rz = r3 - xrp[:, 0]
        xrn = xrp + Krz * res_rz[:, None]
        ikh2 = eye2 - Krz[:, :, None] * h_rz[None, None, :]
        Prn = linalg.sandwich2(ikh2, Prp) + srz2 * Krz[:, :, None] * Krz[:, None, :]
        res_rz_post = r3 - xrn[:, 0]
        S_rz_post = Prn[:, 0, 0] + srz2
        c_rz = res_rz_post * res_rz_post / S_rz_post

        x_xy = torch.where(ok[:, None], xn, x_xy)
        P_xy = torch.where(ok[:, None, None], Pn, P_xy)
        x_rz = torch.where(ok[:, None], xrn, x_rz)
        P_rz = torch.where(ok[:, None, None], Prn, P_rz)
        chi_xy = chi_xy + torch.where(ok, c_xy, 0.0)
        chi_rz = chi_rz + torch.where(ok, c_rz, 0.0)

    return chi_xy, chi_rz


def _pvalues(chi_xy, chi_rz, n_hits):
    """(pval_xy, pval_zr): the chi2 survival function of each plane's sum
    at max(n_hits - 2, 1) degrees of freedom (extract.py:328-331)."""
    dof = torch.clamp(n_hits - 2, min=1).to(chi_xy.dtype)
    return (torch.special.gammaincc(0.5 * dof, 0.5 * chi_xy),
            torch.special.gammaincc(0.5 * dof, 0.5 * chi_rz))


def _kf_fit(coords, n_hits, cfg: PipelineConfig):
    """Batched two-plane Kalman track fit (extract.py:214-331) -> p-values."""
    return _pvalues(*_kf_chi2(coords, n_hits, cfg), n_hits)


def track_fit_plain(coords, valid, n_hits, cfg: PipelineConfig):
    """The rotation, then the batched fit loop: the kernel's plain version,
    on raw compacted rows (_compact_rows) -> (pval_xy, pval_zr)."""
    return _kf_fit(_rotate_tracks(coords, valid, n_hits, cfg), n_hits, cfg)


def track_fit(coords, valid, n_hits, cfg: PipelineConfig):
    """(pval_xy, pval_zr) of every compacted candidate row: the kf_fit
    kernel's chi2 sums on the card, the plain version for CPU tensors."""
    dev = coords.device
    if dev.type == "cpu":
        return track_fit_plain(coords, valid, n_hits, cfg)
    if dev.type != "cuda":
        raise ValueError(f"track_fit: unsupported device {dev}")
    return _pvalues(*fit_kernel.chi2_sums(coords, valid, n_hits, cfg), n_hits)


def extract_candidates(g: GraphState, cfg: PipelineConfig,
                       labels: torch.Tensor | None = None,
                       group=None) -> ExtractionResult:
    """One extraction round over the active edges (extract.py:334-406).

    labels: (N,) component labels computed elsewhere (the minimum node
    index of each weak component over the active edges, as the host
    union-find of data/native_loader.py gives them); FastSV on the device
    when absent, in cca.R_CAP fixed rounds.  cca_rounds is 0 when labels
    are given.
    group: the edge partition's process group, which FastSV combines its
    hooks over (JAX extract.py:334-361); everything after the labels is
    node- and candidate-space work on replicated inputs, the same on every
    rank."""
    h = cfg.max_track_hits
    dev = g.device
    if labels is None:
        labels, rounds, converged = cca.connected_components_fixed(
            g, g.edge_mask & g.active, group=group)
    else:
        rounds = torch.zeros(g.event_shape, dtype=torch.int64, device=dev)
        converged = torch.ones(g.event_shape, dtype=torch.bool, device=dev)
    mat, size, row_of_node = _candidate_matrix(g, labels, h,
                                               cfg.min_track_hits)
    big_enough = size >= cfg.min_track_hits

    coords_c, valid_c, n_hits, can_process, n_pairs = merge_rows(g, cfg, mat)
    # one hit per layer post-merge AND enough distinct layers (ref :427-429)
    processed = big_enough & can_process & (n_hits >= cfg.min_track_hits)

    pval_xy, pval_zr = track_fit(coords_c, valid_c, n_hits, cfg)

    accepted = (processed & (pval_xy >= cfg.track_acceptance_pval)
                & (pval_zr >= cfg.track_acceptance_pval))
    acc_count, acc_nodes, acc_pvals = _accepted_heads(
        mat, accepted, torch.stack([pval_xy, pval_zr], dim=1),
        g.event_shape, g.num_padded_nodes // g.batch, cfg.min_track_hits)
    return ExtractionResult(
        labels=labels, row_of_node=row_of_node, cand_nodes=mat,
        cand_size=size, processed=processed, accepted=accepted,
        merged_pair=n_pairs, pval_xy=pval_xy, pval_zr=pval_zr,
        acc_count=acc_count, acc_nodes=acc_nodes, acc_pvals=acc_pvals,
        cca_rounds=rounds, cca_converged=converged)


def _accepted_heads(mat, accepted, pvals, event_shape, n_event: int,
                    min_hits: int):
    """The static heads: each event ranks its own accepted rows (candidate
    rows come in event order, since labels are node indices), and
    accepted row r goes to its event's head row rank(r) while that is
    under the cap, every other row to a dump row that is sliced off; node
    ids are local to the event.  The cap is that of one event of n_event
    padded nodes.  -> (count, nodes (cap, H), pvals (cap, 2)), each with
    the leading event_shape: () for one event, (B,) for a batch.  Under a
    group the candidate rows come from the combined labels, the same on
    every rank, so on an edge-partitioned stack every rank finds the same
    per-event counts, local ids and caps."""
    batch = math.prod(event_shape)
    cap = min(ACC_PULL_CAP, candidate_rows(n_event, min_hits))
    dev = mat.device
    rank_acc = torch.cumsum(accepted, dim=0) - 1
    # each row's event, from its first node (an empty row is never accepted)
    event = torch.where(mat[:, 0] >= 0, mat[:, 0] // n_event, batch)
    count = count_by(event, accepted, batch)
    rank = rank_acc - (torch.cumsum(count, dim=0) - count)[
        torch.clamp(event, max=batch - 1)]
    ok = accepted & (rank < cap)
    at = (torch.where(ok, event, 0), torch.where(ok, rank, cap))
    nodes = torch.full((batch, cap + 1, mat.shape[1]), -1, dtype=mat.dtype,
                       device=dev)
    nodes[at] = torch.where(mat >= 0, mat - event[:, None] * n_event, -1)
    heads = torch.zeros((batch, cap + 1, 2), dtype=pvals.dtype, device=dev)
    heads[at] = pvals
    return (count.view(event_shape),
            nodes[:, :cap].reshape(*event_shape, cap, mat.shape[1]),
            heads[:, :cap].reshape(*event_shape, cap, 2))


def accepted_rows(res: ExtractionResult):
    """(nodes (A, H), pvals (A, 2)) of every accepted row in row order,
    however many: the host driver's exact pull (reads the count)."""
    rows = torch.nonzero(res.accepted).squeeze(1)
    return (res.cand_nodes[rows],
            torch.stack([res.pval_xy, res.pval_zr], dim=1)[rows])


def apply_extraction(g: GraphState, res: ExtractionResult,
                     cfg: PipelineConfig) -> GraphState:
    """Remove accepted candidates' nodes, then drop whole ingest components
    that fell below the fragment size (extract.py:409-438)."""
    n = g.num_padded_nodes
    row = res.row_of_node
    node_extracted = ((row >= 0) & res.accepted[torch.clamp(row, min=0)]
                      & g.node_mask)
    mask1 = g.node_mask & ~node_extracted
    comp = torch.where(mask1, g.component, 0)
    left = count_by(comp, mask1, n)
    frag = left[g.component] < cfg.min_track_hits
    new_node_mask = mask1 & ~frag
    # edge 2i+1 is edge 2i's reverse: test the pairs, then repeat
    alive_pair = new_node_mask[g.src[0::2]] & new_node_mask[g.dst[0::2]]
    alive_e = alive_pair[:, None].expand(-1, 2).reshape(-1)
    new_edge_mask = g.edge_mask & alive_e
    return g.replace(node_mask=new_node_mask, edge_mask=new_edge_mask,
                     active=g.active & new_edge_mask)
