"""Device connected components by FastSV (Shiloach-Vishkin style hooking).

Port of `gnn_track_finding_tpu.graph.cca.connected_components_fastsv`
(cca.py:85-192), the extraction CCA of the production schedule; the
other CCA variants of that module were measured slower and are not
ported.  Per round, the parent labels of each undirected pair's endpoints
hook the larger onto the smaller (one scatter-min at the larger parent),
then labels shortcut twice (f <- f[f]).  Labels are the minimum node
index of each weak component.

JAX runs the rounds in a device `while_loop`.  A CUDA graph has no such
loop (the torch graph API offers conditional IF nodes only), so the
schedule runs a fixed R_CAP rounds: once the labels stop
changing a further round is the identity (each round is a function of the
labels alone), so the labels equal the adaptive loop's.  The rounds the
adaptive loop would run, and whether R_CAP sufficed, are counted on the
device and read back with the results; the drivers rerun an event whose
extraction needed more (models/pipeline.py).

Under an edge partition (`group`, JAX cca.py:138-141,179,186-188) each
rank hooks with its local pairs and the partial hooks combine by one (N,)
all-reduce MIN before the shortcut, in every round.  The combined labels
are the same on every rank, so the rounds count and the convergence flag
are too, without a further collective: the fixed-round schedule issues
R_CAP all-reduces per extraction and reads nothing on the host.  The
adaptive loop (one host read per round) is the exact drivers' fallback.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gnn_track_finding_tpu_torch.ops import collect

# Rounds of the fixed-round FastSV, the specialised first one included.
# The adaptive loop takes 6 rounds on the full event's three extractions
# and 6 / 4 / 4 on volume 7's (chip_smoke phase 5): twice the most seen.
R_CAP = 12


def _shortcut(f):
    # two pointer jumps per round, the JAX default (cca.py:87)
    f = f[f]
    return f[f]


def _pairs(g, edge_ok):
    """Each undirected pair's endpoints and its weak-connectivity flag."""
    a = g.src[0::2]
    b = g.dst[0::2]
    return a, b, edge_ok[0::2] | edge_ok[1::2]


def _round(f, a, b, ok, n, group=None):
    """One hooking round from labels f (masked pairs carry (lo = n,
    hi = 0): a no-op min at row 0), then the shortcut."""
    fa = f[a]
    fb = f[b]
    lo = torch.where(ok, torch.minimum(fa, fb), n)
    hi = torch.where(ok, torch.maximum(fa, fb), 0)
    return _shortcut(collect.allmin(
        f.scatter_reduce(0, hi, lo, "amin", include_self=True), group))


def _first_round(a, b, ok, init, n, group=None):
    # specialised: with f == identity, f[u] == u and f[v] == v
    lo = torch.where(ok, torch.minimum(a, b), n)
    hi = torch.where(ok, torch.maximum(a, b), 0)
    return _shortcut(collect.allmin(
        init.scatter_reduce(0, hi, lo, "amin", include_self=True), group))


def connected_components_fastsv(g, edge_ok: torch.Tensor, group=None
                                ) -> Tuple[torch.Tensor, int]:
    """Adaptive loop -> (labels (N,) int64, rounds).  Masked-out nodes keep
    their own index.  `rounds` counts the hooking rounds, the specialised
    first one and the last (which changes nothing) included; one host
    read per round."""
    n = g.node_mask.shape[0]
    a, b, ok = _pairs(g, edge_ok)
    init = torch.arange(n, device=a.device)
    f = _first_round(a, b, ok, init, n, group)
    rounds = 1
    while True:
        new = _round(f, a, b, ok, n, group)
        rounds += 1
        changed = bool(torch.any(new != f))
        f = new
        if not changed:
            break
    return torch.where(g.node_mask, f, init), rounds


def connected_components_fixed(g, edge_ok: torch.Tensor,
                               max_rounds: int | None = None, group=None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Fixed-round FastSV, nothing read on the host -> (labels (N,) int64,
    rounds () int64, converged () bool), the same on every rank of
    `group`.

    `rounds` is what the adaptive loop reports (its first round that
    changes nothing, counted on the device); `converged` is False when the
    last of the `max_rounds` (default R_CAP) rounds still changed a label,
    and then the labels may be short of the components.

    On a stacked batch (g.batch = B > 1) no component crosses an event,
    so the labels are each event's own (offset by its first node), and
    `rounds` and `converged` are per event, of shape (B,): what each
    event's own run reports.  Under a group on a stack (the union
    edge-partitioned) each round's labels are allmin-combined first, so
    every rank tests each event's convergence on the same labels."""
    max_rounds = R_CAP if max_rounds is None else max_rounds
    n = g.node_mask.shape[0]
    batch = g.batch
    a, b, ok = _pairs(g, edge_ok)
    init = torch.arange(n, device=a.device)
    f = _first_round(a, b, ok, init, n, group)
    rounds = torch.ones(batch, dtype=torch.int64, device=a.device)
    done = torch.zeros(batch, dtype=torch.bool, device=a.device)
    for _ in range(max_rounds - 1):
        new = _round(f, a, b, ok, n, group)
        rounds = rounds + (~done).to(torch.int64)
        done = done | (new == f).view(batch, -1).all(1)
        f = new
    return (torch.where(g.node_mask, f, init), rounds.view(g.event_shape),
            done.view(g.event_shape))
