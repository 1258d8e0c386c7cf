"""The card's published peaks and the work the two hand-written kernels need.

Copied from chip_smoke.py (`HBM_BYTES_PER_S`, `PEAK_OPS_PER_S`, `bound`,
`cluster_bound`, `distinct_bound`, and the operation counts of
csrc/gmr_cluster.cu's pieces), so that the yardstick stays where it is
when the program's files change.  The work is counted from the inputs of
each call as the benchmark's reference derives them (the live rows of
the same events), so it is the algorithm's, whatever implements it.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and float64 / float32
# operations/s outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}

# float operations of the clustering kernel's pieces: a 3x3 inverse, a 3x3
# matrix-vector product, a merge (sum of inverses, inverse, sum of vectors,
# product), a KL distance
INV3, MAT3_VEC = 50, 15
MERGE = 9 + INV3 + 3 + MAT3_VEC
KL = {True: 56, False: 68}         # elementwise trace (bug_compat) or full
PAIR, SLOT = 43, 8                  # one pair's chi2; one slot's chi2 terms


def least_seconds(n_bytes: float, n_ops: float, dtype) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the dtype's peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype])


def cluster_work(tab: torch.Tensor, found: torch.Tensor,
                 deact: torch.Tensor, bug_compat: bool, dtype):
    """(bytes, operations) of one clustering round's live (gated) rows:
    tab (rows, kc) their member edge ids, -1 padded; found, deact the
    core's verdicts.  Bytes: per member slot its edge id, j_sv, j_cov and
    the coordinates the chi2 reads (x for the endcap test under
    bug_compat, z, r); per row the node's coordinates and the outputs; per
    found row klthr and, per merged slot, p_sv, p_cov and prior.
    Operations: per member slot its chi2 terms, per real pair its chi2;
    per found row the member inverses, the merge of the best pair for both
    states, and per greedy step evaluated the two inverses and a KL per
    remaining slot, per absorption the two merges."""
    w = torch.empty((), dtype=dtype).element_size()
    rows, kc = tab.shape
    n = torch.cumprod((tab >= 0).to(torch.uint8), dim=1).sum(1).double()
    merged = torch.where(found, n - deact.sum(1), 0).double()
    coords = 3 if bug_compat else 2
    n_bytes = (n.sum() * (8 + (12 + coords) * w) + rows * coords * w
               + found.sum() * w + merged.sum() * 13 * w
               + rows * (1 + 13 * w + kc))
    greedy = torch.clamp(merged - 2, min=0)
    steps = greedy + (merged < n).double()
    kl_evals = steps * (n - 2) - steps * (steps - 1) / 2
    per_found = (n * INV3 + 2 * (2 * (INV3 + MAT3_VEC) + MERGE) + 1
                 + steps * 2 * INV3 + kl_evals * KL[bool(bug_compat)]
                 + greedy * (2 * (INV3 + 2 * MAT3_VEC + MERGE) + 1))
    n_ops = (n.sum() * SLOT + (n * (n - 1) / 2).sum() * PAIR
             + torch.where(found, per_found, 0).sum())
    return float(n_bytes), float(n_ops)


def distinct_work(ok: torch.Tensor, x: torch.Tensor):
    """(bytes, operations) of one distinct-count table.  Bytes: the ok
    table, x of the ok slots, node_x of the rows with any ok slot, the
    (N, 2) output.  Operations: per ok slot its side test and three
    compares against each earlier ok slot of its row."""
    w = x.element_size()
    per_row = ok.sum(1).double()
    n_bytes = (ok.numel() + per_row.sum() * w + (per_row > 0).sum() * w
               + ok.shape[0] * 2 * w)
    n_ops = per_row.sum() + 3 * (per_row * (per_row - 1) / 2).sum()
    return float(n_bytes), float(n_ops)


class Work:
    """The least seconds of each kernel's calls, per event of the
    reference's union (reference.schedule's `work`): `seconds[kernel][b]`
    for event b, whose nodes are rows [b n_event, (b + 1) n_event)."""

    def __init__(self, batch: int, n_event: int):
        self.n_event = n_event
        self.seconds = {k: [0.0] * batch
                        for k in ("gmr_cluster", "distinct_counts")}

    def cluster(self, tab, ids, found, deact, bug_compat, dtype) -> None:
        """One round: rows (gated first) of nodes `ids`, n past the live
        ones."""
        live = ids < tab.shape[0]
        event = ids // self.n_event
        for b in range(len(self.seconds["gmr_cluster"])):
            m = live & (event == b)
            self.seconds["gmr_cluster"][b] += least_seconds(
                *cluster_work(tab[m], found[m], deact[m], bug_compat, dtype),
                dtype)

    def distinct(self, ok, x) -> None:
        """One (N, K) table of the union."""
        for b in range(len(self.seconds["distinct_counts"])):
            rows = slice(b * self.n_event, (b + 1) * self.n_event)
            self.seconds["distinct_counts"][b] += least_seconds(
                *distinct_work(ok[rows], x[rows]), x.dtype)
