"""Proximity merge and row compaction of extraction's candidate rows: CUDA
kernel wrapper.

The kernel (csrc/row_merge.cu) replaces no TPU kernel: it does
`extract._proximity_merge` (the close-proximity same-layer merge) and
`extract._compact_rows` (the surviving slots moved to the front of each
row) in one launch, one warp per candidate row, where the torch ops build
(C, H, H) boolean planes over every padded row (see the source's note).
`merge_rows` launches it; `extract.merge_rows_plain`
(`extract._proximity_merge` then `extract._compact_rows`) is its plain
version.  `extract.merge_rows`, the one entry of extraction,
takes the kernel for CUDA tensors and the plain version for CPU tensors.

Inputs: mat (C, H) int64 node indices, -1 for an empty slot, each row's
slots contiguous (extract._candidate_matrix); the state's xyzr (N, 4)
float32/float64 and vivl (N, 2) int64, each row's entries contiguous;
every index in mat below N.  Outputs: coords (C, H, 4) contiguous, valid
(C, H) bool, n_hits (C,) int64, can_process (C,) bool, n_pairs (C,) int64.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_track_finding_tpu_torch import _build

# The widest row the kernel takes: H > 32 keeps 11 bytes a slot in shared
# memory, within the 48 KiB a block may have without opting in.
MAX_H = 4096


class _Args(ctypes.Structure):
    """struct MergeArgs of csrc/row_merge.cu, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "mat", "xyzr", "vivl", "coords_c", "valid_c", "n_hits",
        "can_process", "n_pairs")]
        + [(name, ctypes.c_longlong) for name in (
            "mat_stride", "xyzr_stride", "vivl_stride")]
        + [(name, ctypes.c_int) for name in ("rows", "h")]
        + [("merge_distance", ctypes.c_double)])


def _rows_ok(t: torch.Tensor, width: int | None, dtypes) -> bool:
    return (t.dim() == 2 and (width is None or t.shape[1] == width)
            and t.dtype in dtypes and (not t.numel() or t.stride(1) == 1))


def merge_rows(mat: torch.Tensor, xyzr: torch.Tensor, vivl: torch.Tensor,
               merge_distance: float):
    """The kernel on CUDA tensors -> (coords, valid, n_hits, can_process,
    n_pairs) of every candidate row."""
    dev = mat.device
    if dev.type != "cuda":
        raise ValueError(f"row_merge: unsupported device {dev}")
    if not _rows_ok(mat, None, (torch.int64,)) or mat.shape[1] > MAX_H:
        raise ValueError(f"row_merge: mat is {tuple(mat.shape)} {mat.dtype} "
                         f"with strides {mat.stride()}; expected (C, H) "
                         f"int64, H at most {MAX_H}, each row contiguous")
    if not _rows_ok(xyzr, 4, (torch.float32, torch.float64)):
        raise ValueError(f"row_merge: xyzr is {tuple(xyzr.shape)} "
                         f"{xyzr.dtype}; expected (N, 4) float32/float64, "
                         "each row contiguous")
    if not _rows_ok(vivl, 2, (torch.int64,)) or vivl.shape[0] != xyzr.shape[0]:
        raise ValueError(f"row_merge: vivl is {tuple(vivl.shape)} "
                         f"{vivl.dtype}; expected ({xyzr.shape[0]}, 2) int64, "
                         "each row contiguous")
    if xyzr.device != dev or vivl.device != dev:
        raise ValueError("row_merge: mat, xyzr and vivl must share one CUDA "
                         "device")
    c, h = mat.shape
    dtype = xyzr.dtype
    coords = torch.empty((c, h, 4), dtype=dtype, device=dev)
    valid = torch.empty((c, h), dtype=torch.bool, device=dev)
    n_hits = torch.empty((c,), dtype=torch.int64, device=dev)
    can_process = torch.empty((c,), dtype=torch.bool, device=dev)
    n_pairs = torch.empty((c,), dtype=torch.int64, device=dev)
    args = _Args(
        mat.data_ptr(), xyzr.data_ptr(), vivl.data_ptr(), coords.data_ptr(),
        valid.data_ptr(), n_hits.data_ptr(), can_process.data_ptr(),
        n_pairs.data_ptr(), mat.stride(0), xyzr.stride(0), vivl.stride(0),
        c, h, float(merge_distance))
    rc = _build.library().fn("row_merge", dtype)(ctypes.byref(args),
                                                 _build.stream_handle(dev))
    _build.check(rc, "row_merge")
    merge_rows.launches += 1
    return coords, valid, n_hits, can_process, n_pairs


merge_rows.launches = 0


def occupancy(dtype) -> dict:
    """Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    of the H <= 32 kernel at this dtype, with its block shape."""
    out = (ctypes.c_int * 3)()
    rc = _build.library().fn("row_merge_occupancy", dtype)(out)
    _build.check(rc, "row_merge_occupancy")
    return {"blocks_per_sm": out[0], "threads_per_block": out[1],
            "smem_bytes_per_block": out[2],
            "warps_per_sm": out[0] * out[1] // 32}
