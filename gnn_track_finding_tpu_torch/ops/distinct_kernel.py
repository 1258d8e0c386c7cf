"""Side-norm distinct-x counts: CUDA kernel wrapper and its plain version.

The kernel (csrc/distinct_counts.cu) replaces the TPU kernel
`gnn_track_finding_tpu/ops/pallas_distinct.py::_kernel`.  It is
memory-bound, mostly by the (N, K) ok table: one thread per node turns the
row's ok bytes into 64-bit masks (16-byte loads), leaves rows with no ok
slot after writing (0, 0), and compares x only among the set bits;
integer-exact.

`distinct_counts` launches the kernel for CUDA tensors and raises on any
other device than the CPU, where it takes the plain version
(`distinct_counts_plain`, the port of the JAX `priors._distinct_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from gnn_track_finding_tpu_torch import _build


def distinct_counts_plain(ok_slot: torch.Tensor, x_slot: torch.Tensor,
                          left_slot: torch.Tensor, dtype) -> torch.Tensor:
    """(N, 2) distinct-x count per (node, side): a masked first-occurrence
    count over (K, K) slot pairs with exact equality on raw values
    (helper.py:127-134 len(set(x)); priors.py:124-138)."""
    k_tab = x_slot.shape[1]
    eqx = x_slot[:, :, None] == x_slot[:, None, :]
    same_side = left_slot[:, :, None] == left_slot[:, None, :]
    earlier = torch.tril(torch.ones((k_tab, k_tab), dtype=torch.bool,
                                    device=x_slot.device), diagonal=-1)
    dup_before = torch.any(eqx & same_side & ok_slot[:, None, :] & earlier[None],
                           dim=2)
    first = ok_slot & ~dup_before
    return torch.stack([
        torch.sum(first & left_slot, dim=1),
        torch.sum(first & ~left_slot, dim=1)], dim=1).to(dtype)


def distinct_counts(ok_slot: torch.Tensor, x_slot: torch.Tensor,
                    node_x: torch.Tensor) -> torch.Tensor:
    """(N, 2) distinct-x counts per (node, side) from the (N, K) tables,
    left side = x_slot < node_x, in x_slot's dtype."""
    if x_slot.device.type == "cpu":
        return distinct_counts_plain(ok_slot, x_slot,
                                     x_slot < node_x[:, None], x_slot.dtype)
    if x_slot.device.type != "cuda":
        raise ValueError(f"distinct_counts: unsupported device {x_slot.device}")
    n, k = x_slot.shape
    dev = x_slot.device
    if ok_slot.shape != (n, k) or node_x.shape != (n,):
        raise ValueError(f"distinct_counts: shapes {tuple(ok_slot.shape)}, "
                         f"{tuple(x_slot.shape)}, {tuple(node_x.shape)}")
    if ok_slot.dtype != torch.bool or node_x.dtype != x_slot.dtype:
        raise TypeError("distinct_counts: ok must be bool and node_x share "
                        "x's dtype")
    for t in (ok_slot, x_slot, node_x):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("distinct_counts: inputs must be contiguous "
                             "tensors on one CUDA device")
    out = torch.empty((n, 2), dtype=x_slot.dtype, device=dev)
    if n == 0:
        return out
    lib = _build.library()
    rc = lib.fn("distinct_counts", x_slot.dtype)(
        x_slot.data_ptr(), ok_slot.data_ptr(), node_x.data_ptr(),
        out.data_ptr(), n, k, _build.stream_handle(dev))
    _build.check(rc, "distinct_counts")
    distinct_counts.launches += 1
    return out


distinct_counts.launches = 0


def occupancy(dtype) -> dict:
    """Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    of the kernel at this dtype, with its block shape."""
    out = (ctypes.c_int * 3)()
    rc = _build.library().fn("distinct_counts_occupancy", dtype)(out)
    _build.check(rc, "distinct_counts_occupancy")
    return {"blocks_per_sm": out[0], "threads_per_block": out[1],
            "smem_bytes_per_block": out[2],
            "warps_per_sm": out[0] * out[1] // 32}
