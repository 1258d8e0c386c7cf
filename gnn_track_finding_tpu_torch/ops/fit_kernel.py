"""Track fit of extraction's candidate rows: CUDA kernel wrapper.

The kernel (csrc/kf_fit.cu) replaces no TPU kernel: it does
`extract._rotate_tracks` (the innermost-edge rotation) and
`extract._kf_chi2`'s two-plane Kalman loop in one launch, one thread per
candidate row, the rotated coordinates and both planes' state in
registers, where the torch ops take ~12,000 graph nodes an extraction
(see the source's note).  `chi2_sums` launches it and returns each row's
chi2 sums; `extract._kf_chi2(extract._rotate_tracks(...))` is its plain
version.  `extract.track_fit`, the one entry of extraction, takes the
kernel for CUDA tensors and the plain version for CPU tensors, and turns
the sums into p-values with torch ops after it.

Inputs, as extract.merge_rows gives them: coords (C, H, 4) raw
(x, y, z, r) per slot, each row's slots contiguous (its row stride may be
any: the row_merge kernel's rows are H slots long, the plain
compaction's H + 1); valid (C, H) bool, the row's first n_hits slots;
n_hits (C,) int64, at most H.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_track_finding_tpu_torch import _build
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.ops import linalg


class _Args(ctypes.Structure):
    """struct FitArgs of csrc/kf_fit.cu, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "coords", "valid", "n_hits", "chi_xy", "chi_rz")]
        + [(name, ctypes.c_longlong) for name in ("coords_stride",
                                                   "valid_stride")]
        + [(name, ctypes.c_int) for name in ("rows", "h", "bug_compat")]
        + [(name, ctypes.c_double) for name in (
            "sep3d", "endcap", "ms_coef", "ou_alpha", "inv_alpha", "sw2",
            "sxy2", "srz2", "tiny")])


def _reciprocal(x: float, dtype) -> float:
    """1 / x rounded in dtype: torch's CUDA kernels divide a tensor by a
    Python scalar as a multiplication by this."""
    one = torch.ones((), dtype=dtype)
    return (one / torch.tensor(x, dtype=dtype)).item()


def chi2_sums(coords: torch.Tensor, valid: torch.Tensor,
              n_hits: torch.Tensor, cfg: PipelineConfig):
    """The kernel on CUDA tensors -> each row's (chi_xy, chi_rz)."""
    dev = coords.device
    if dev.type != "cuda":
        raise ValueError(f"kf_fit: unsupported device {dev}")
    dtype = coords.dtype
    if coords.dim() != 3 or coords.shape[2] != 4 or dtype not in (
            torch.float32, torch.float64) or (coords.numel() and
                                              coords.stride()[1:] != (4, 1)):
        raise ValueError(f"kf_fit: coords is {tuple(coords.shape)} "
                         f"{dtype} with strides {coords.stride()}; expected "
                         "(C, H, 4) float32/float64, each row's slots "
                         "contiguous")
    c, h, _ = coords.shape
    if (valid.shape != (c, h) or valid.dtype != torch.bool
            or (c and valid.stride(1) != 1)):
        raise ValueError(f"kf_fit: valid is {tuple(valid.shape)} "
                         f"{valid.dtype}; expected ({c}, {h}) bool with "
                         "contiguous rows")
    if (n_hits.shape != (c,) or n_hits.dtype != torch.int64
            or not n_hits.is_contiguous()):
        raise ValueError(f"kf_fit: n_hits is {tuple(n_hits.shape)} "
                         f"{n_hits.dtype}; expected contiguous ({c},) int64")
    if valid.device != dev or n_hits.device != dev:
        raise ValueError("kf_fit: coords, valid and n_hits must share "
                         "one CUDA device")
    chi_xy = torch.empty((c,), dtype=dtype, device=dev)
    chi_rz = torch.empty((c,), dtype=dtype, device=dev)
    args = _Args(
        coords.data_ptr(), valid.data_ptr(), n_hits.data_ptr(),
        chi_xy.data_ptr(), chi_rz.data_ptr(), coords.stride(0),
        valid.stride(0), c, h, int(cfg.bug_compat),
        float(cfg.separation_3d_threshold), float(cfg.endcap_boundary),
        float(cfg.ms_coefficient()), float(cfg.ou_alpha),
        _reciprocal(cfg.ou_alpha, dtype), float(cfg.ou_sigma ** 2),
        float(cfg.sigma0xy ** 2), float(cfg.sigma0rz ** 2),
        linalg.tiny(dtype))
    rc = _build.library().fn("kf_fit", dtype)(ctypes.byref(args),
                                              _build.stream_handle(dev))
    _build.check(rc, "kf_fit")
    chi2_sums.launches += 1
    return chi_xy, chi_rz


chi2_sums.launches = 0


def occupancy(dtype) -> dict:
    """Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    of the kernel at this dtype, with its block shape."""
    out = (ctypes.c_int * 3)()
    rc = _build.library().fn("kf_fit_occupancy", dtype)(out)
    _build.check(rc, "kf_fit_occupancy")
    return {"blocks_per_sm": out[0], "threads_per_block": out[1],
            "smem_bytes_per_block": out[2],
            "warps_per_sm": out[0] * out[1] // 32}
