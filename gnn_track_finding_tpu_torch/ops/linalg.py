"""Batched closed-form small-matrix algebra on torch tensors.

Port of `gnn_track_finding_tpu.ops.linalg` (linalg.py:22-173).  Every
function broadcasts over leading axes and is written as explicit
component arithmetic in the JAX module's order of operations, so the two
packages (and the CUDA clustering kernel, which repeats these formulas)
round alike.
"""

from __future__ import annotations

import torch


def tiny(dtype: torch.dtype) -> float:
    """Smallest safe positive guard constant for the dtype (1e-300
    underflows to 0 in float32)."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def mat2_vec(m, v):
    """(..., 2, 2) @ (..., 2) -> (..., 2)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    v0, v1 = v[..., 0], v[..., 1]
    return torch.stack([a * v0 + b * v1, c * v0 + d * v1], dim=-1)


def sandwich2(f, c):
    """F C F^T for (..., 2, 2) operands."""
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
    """Adjugate (transposed cofactor matrix) of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    row0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1)
    row1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1)
    row2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inv3(m):
    """Closed-form inverse of (..., 3, 3): adjugate divided by determinant."""
    return adj3(m) / det3(m)[..., None, None]


def unpack3(m):
    """(..., 3, 3) -> row-major 9-tuple of (...,) components."""
    return tuple(m[..., i, j] for i in range(3) for j in range(3))


def pack3(c):
    """Row-major 9-tuple -> (..., 3, 3)."""
    rows = [torch.stack(c[3 * i:3 * i + 3], dim=-1) for i in range(3)]
    return torch.stack(rows, dim=-2)


def _matmul3_c(a, b):
    """Componentwise 9-tuple matmul a @ b."""
    return tuple(
        a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3) for j in range(3))


def mat3_vec(m, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    c = unpack3(m)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        c[0] * v0 + c[1] * v1 + c[2] * v2,
        c[3] * v0 + c[4] * v1 + c[5] * v2,
        c[6] * v0 + c[7] * v1 + c[8] * v2,
    ], dim=-1)


def sandwich3(f, c):
    """F C F^T for (..., 3, 3) operands."""
    fc_ = unpack3(f)
    fcm = _matmul3_c(fc_, unpack3(c))
    return pack3(tuple(
        fcm[3 * i] * fc_[3 * j] + fcm[3 * i + 1] * fc_[3 * j + 1]
        + fcm[3 * i + 2] * fc_[3 * j + 2]
        for i in range(3) for j in range(3)))


def merge_gaussians(mean1, cov1, mean2, cov2):
    """Inverse-variance-weighted merge of two 3D Gaussians
    (clustering.py:97-105): C = (C1^-1 + C2^-1)^-1, mu = C (C1^-1 mu1 + C2^-1 mu2)."""
    i1 = inv3(cov1)
    i2 = inv3(cov2)
    merged_cov = inv3(i1 + i2)
    merged_mean = mat3_vec(merged_cov, mat3_vec(i1, mean1) + mat3_vec(i2, mean2))
    return merged_mean, merged_cov


def kl_distance(mean1, cov1, mean2, cov2, bug_compat: bool = True):
    """Symmetrised KL-style distance between two 3D Gaussians
    (clustering.py:90-94).  bug_compat keeps the reference's ELEMENTWISE
    product inside the trace (its diagonal only); clean mode uses the
    matrix-product trace."""
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
