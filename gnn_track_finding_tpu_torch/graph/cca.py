"""Device connected components by FastSV (Shiloach-Vishkin style hooking).

Port of `gnn_track_finding_tpu.graph.cca.connected_components_fastsv`
(cca.py:85-192), the extraction CCA of the production schedule; the
other CCA variants of that module were measured slower and are not
ported.  Per round, the parent labels of each undirected pair's endpoints
hook the larger onto the smaller (one scatter-min at the larger parent),
then labels shortcut twice (f <- f[f]).  The loop runs eagerly: one host
sync per round reads the convergence flag.  Labels are the minimum node
index of each weak component.

Under an edge partition (`group`, JAX cca.py:138-141,179,186-188) each
rank hooks with its local pairs and the partial hooks combine by one (N,)
all-reduce MIN before the shortcut, in the first round and in the loop;
the combined labels are the same on every rank, and so is the
convergence flag.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gnn_track_finding_tpu_torch.ops import collect


def connected_components_fastsv(g, edge_ok: torch.Tensor, group=None
                                ) -> Tuple[torch.Tensor, int]:
    """-> (labels (N,) int64, rounds).  Masked-out nodes keep their own
    index.  `rounds` counts the hooking rounds, the specialised first one
    included."""
    n = g.node_mask.shape[0]
    a = g.src[0::2]
    b = g.dst[0::2]
    ok = edge_ok[0::2] | edge_ok[1::2]   # weak connectivity
    init = torch.arange(n, device=a.device)

    def shortcut(f):
        # two pointer jumps per round, the JAX default (cca.py:87)
        f = f[f]
        return f[f]

    def hook(f, lo_e, hi_e):
        # masked pairs carry (lo = n, hi = 0): a no-op min at row 0
        return collect.allmin(
            f.scatter_reduce(0, hi_e, lo_e, "amin", include_self=True), group)

    # first round specialised: with f == identity, f[u] == u and f[v] == v
    f = shortcut(hook(init, torch.where(ok, torch.minimum(a, b), n),
                      torch.where(ok, torch.maximum(a, b), 0)))
    rounds = 1
    while True:
        fa = f[a]
        fb = f[b]
        new = shortcut(hook(f, torch.where(ok, torch.minimum(fa, fb), n),
                            torch.where(ok, torch.maximum(fa, fb), 0)))
        rounds += 1
        changed = bool(torch.any(new != f))
        f = new
        if not changed:
            break
    return torch.where(g.node_mask, f, init), rounds
