"""Self-contained Leiden community detection (modularity flavour).

Port of `gnn_track_finding_tpu.analysis.leiden` (leiden.py:1-299), kept as
the port's own copy of the same pure-Python code: the same edge list and
seed give the same communities in the same order, and the same modularity
bit for bit (tests/test_torch_studies.py).

The reference's community-detection extraction runs leidenalg's
ModularityVertexPartition over the mixture-weight-weighted hit graph
(src/extract/community_detection.py:16-50).  igraph/leidenalg are not
dependencies, so this is a from-scratch implementation of the Leiden
algorithm (Traag, Waltman, van Eck 2019): local moving + REFINEMENT +
aggregation on the refined partition.  The refinement phase is what
distinguishes Leiden from Louvain and yields its guarantee that every
community is internally CONNECTED — the property the track-extraction
use case actually relies on (a disconnected "community" can never be one
track).

Pure host-side Python/NumPy: community detection is an experimental
extraction alternative gated OFF by default (extract_track_candidates.py:22),
never on the device hot path.
"""

from __future__ import annotations

import random
from typing import Dict, List, Set, Tuple

__all__ = ["leiden_communities", "modularity"]


def _build_adj(n_nodes: int, edges):
    """Adjacency dicts + self-loop weights + total degree.

    A (u, u, w) edge is a SELF-LOOP carrying internal weight w
    (contributing 2w to u's degree, the standard modularity convention);
    the aggregation step uses these to preserve each super-node's
    internal weight so upper-level modularity gains equal the
    original-graph gains."""
    adj: List[Dict[int, float]] = [dict() for _ in range(n_nodes)]
    self_w = [0.0] * n_nodes
    m2 = 0.0
    for u, v, w in edges:
        if u == v:
            self_w[u] += w
            m2 += 2.0 * w
            continue
        adj[u][v] = adj[u].get(v, 0.0) + w
        adj[v][u] = adj[v].get(u, 0.0) + w
        m2 += 2.0 * w
    return adj, self_w, m2


def modularity(n_nodes: int, edges, membership) -> float:
    """Newman modularity of a partition over a weighted undirected graph."""
    adj, self_w, m2 = _build_adj(n_nodes, edges)
    if m2 == 0.0:
        return 0.0
    deg = [sum(nb.values()) + 2.0 * self_w[i] for i, nb in enumerate(adj)]
    q = 0.0
    for u in range(n_nodes):
        q += 2.0 * self_w[u]
        for v, w in adj[u].items():
            if membership[u] == membership[v]:
                q += w
    sum_deg: Dict[int, float] = {}
    for u in range(n_nodes):
        sum_deg[membership[u]] = sum_deg.get(membership[u], 0.0) + deg[u]
    q /= m2
    q -= sum(s * s for s in sum_deg.values()) / (m2 * m2)
    return q


def _local_move(adj, deg, m2, membership, rng) -> bool:
    """Louvain-style queue-based local moving phase (Leiden step 1).

    The candidate set is the current community, every edge-adjacent
    community, and an EMPTY (fresh singleton) community — the empty
    target is part of leidenalg's ModularityVertexPartition move set and
    lets a node leave a community it is only weakly (or not at all)
    attached to even when no neighbouring community wants it."""
    n = len(adj)
    comm_deg: Dict[int, float] = {}
    for u in range(n):
        comm_deg[membership[u]] = comm_deg.get(membership[u], 0.0) + deg[u]
    next_comm = max(membership, default=-1) + 1
    order = list(range(n))
    rng.shuffle(order)
    queue = list(order)
    in_queue = [True] * n
    improved = False
    while queue:
        u = queue.pop()
        in_queue[u] = False
        cu = membership[u]
        comm_deg[cu] -= deg[u]
        # weight from u to each neighbouring community
        w_to: Dict[int, float] = {cu: 0.0}
        for v, w in adj[u].items():
            w_to[membership[v]] = w_to.get(membership[v], 0.0) + w
        # modularity gain of joining community c:
        #   w_to[c]/m - deg_u * sum_deg[c] / (2 m^2)   (u removed from cu)
        best_c, best_gain = cu, w_to.get(cu, 0.0) - deg[u] * comm_deg.get(
            cu, 0.0) / m2
        if best_gain < -1e-12:
            # the empty-community candidate: zero in-weight, zero
            # partner degree => gain exactly 0
            best_c, best_gain = next_comm, 0.0
        for c, wtc in w_to.items():
            gain = wtc - deg[u] * comm_deg.get(c, 0.0) / m2
            if gain > best_gain + 1e-12:
                best_c, best_gain = c, gain
        if best_c == next_comm:
            next_comm += 1
        membership[u] = best_c
        comm_deg[best_c] = comm_deg.get(best_c, 0.0) + deg[u]
        if best_c != cu:
            improved = True
            for v in adj[u]:
                if membership[v] != best_c and not in_queue[v]:
                    queue.append(v)
                    in_queue[v] = True
    return improved


def _refine(adj, deg, m2, membership, rng) -> List[int]:
    """Leiden refinement: within each community, merge SINGLETON
    sub-communities along internal edges when the merge improves
    modularity (Traag et al. 2019, MergeNodesSubset: only nodes still in
    a singleton sub-community are candidates to move, so each node
    merges at most once and the singleton's own degree/edge weights are
    exactly the sub-community's).  Union-find semantics (roots resolved
    at use, merges always root -> root) so pointer chains can never
    cycle.  Guarantees internally connected sub-communities (merges only
    follow edges)."""
    n = len(adj)
    refined = list(range(n))
    sub_deg = list(deg)
    sub_size = [1] * n

    def find(x: int) -> int:
        root = x
        while refined[root] != root:
            root = refined[root]
        while refined[x] != root:          # path compression
            refined[x], x = root, refined[x]
        return root

    order = list(range(n))
    rng.shuffle(order)
    for u in order:
        ru = find(u)
        if ru != u or sub_size[u] > 1:
            continue    # not a singleton sub-community any more (paper:
            #             only singleton nodes may be merged)
        cu = membership[u]
        w_to: Dict[int, float] = {}
        for v, w in adj[u].items():
            if membership[v] == cu:
                rv = find(v)
                if rv != ru:
                    w_to[rv] = w_to.get(rv, 0.0) + w
        best_s, best_gain = None, 0.0
        for s, wts in w_to.items():
            gain = wts - deg[u] * sub_deg[s] / m2
            if gain > 0.0 and (best_s is None or gain > best_gain):
                best_s, best_gain = s, gain
        if best_s is not None:
            sub_deg[best_s] += sub_deg[ru]
            sub_size[best_s] += sub_size[ru]
            refined[ru] = best_s
    return [find(u) for u in range(n)]


def _aggregate(adj, self_w, refined, membership):
    """Aggregate graph over refined sub-communities; the original
    communities seed the aggregate membership (Leiden step 3).  Internal
    weights become SELF-LOOPS of the super-nodes so degrees and m2 are
    preserved across levels."""
    ids = sorted(set(refined))
    remap = {r: i for i, r in enumerate(ids)}
    n_agg = len(ids)
    agg_edges: Dict[Tuple[int, int], float] = {}
    agg_self = [0.0] * n_agg
    for u in range(len(adj)):
        ru = remap[refined[u]]
        agg_self[ru] += self_w[u]
        for v, w in adj[u].items():
            if u < v:
                rv = remap[refined[v]]
                if ru != rv:
                    key = (min(ru, rv), max(ru, rv))
                    agg_edges[key] = agg_edges.get(key, 0.0) + w
                else:
                    agg_self[ru] += w
    agg_membership = [0] * n_agg
    for u in range(len(adj)):
        agg_membership[remap[refined[u]]] = membership[u]
    node_of = [[] for _ in range(n_agg)]
    for u in range(len(adj)):
        node_of[remap[refined[u]]].append(u)
    edges = [(a, b, w) for (a, b), w in agg_edges.items()]
    edges += [(i, i, w) for i, w in enumerate(agg_self) if w > 0.0]
    return n_agg, edges, agg_membership, node_of


def _one_pass(n_nodes: int, orig_edges, rng,
              init_membership=None, max_levels: int = 10) -> List[Set[int]]:
    """One full Leiden pass (local move + refine + aggregate through the
    levels), optionally seeded with an initial partition (the Leiden
    paper's iteration: feeding the previous partition back lets the
    local move climb further)."""
    # node -> original node sets through the aggregation levels
    carriers: List[Set[int]] = [{u} for u in range(n_nodes)]
    membership = (list(init_membership) if init_membership is not None
                  else list(range(n_nodes)))
    cur_edges = orig_edges
    cur_n = n_nodes

    final: Dict[int, Set[int]] = {}
    for _ in range(max_levels):
        adj, self_w, m2 = _build_adj(cur_n, cur_edges)
        if m2 == 0.0:
            break
        deg = [sum(nb.values()) + 2.0 * self_w[i]
               for i, nb in enumerate(adj)]
        improved = _local_move(adj, deg, m2, membership, rng)
        refined = _refine(adj, deg, m2, membership, rng)
        n_agg, agg_edges, agg_membership, node_of = _aggregate(
            adj, self_w, refined, membership)
        carriers = [set().union(*(carriers[u] for u in group))
                    for group in node_of]
        membership = agg_membership
        cur_edges = agg_edges
        cur_n = n_agg
        if not improved or n_agg == len(adj):
            break

    for i in range(cur_n):
        final.setdefault(membership[i], set()).update(carriers[i])

    # Hard connectivity guarantee: split any community that is not
    # internally connected in the ORIGINAL graph into its connected
    # parts.  Refinement makes sub-communities connected by
    # construction, but the top-level membership groups of super-nodes
    # are not forced to be; splitting a disconnected community strictly
    # increases modularity (the internal weight is unchanged while
    # sum_deg^2 decreases), so this is a pure improvement as well as the
    # property the extraction use case relies on.
    adj0: List[List[int]] = [[] for _ in range(n_nodes)]
    for u, v, _w in orig_edges:
        if u != v:
            adj0[u].append(v)
            adj0[v].append(u)
    out: List[Set[int]] = []
    for comm in final.values():
        remaining = set(comm)
        while remaining:
            start = next(iter(remaining))
            part = {start}
            stack = [start]
            while stack:
                x = stack.pop()
                for y in adj0[x]:
                    if y in remaining and y not in part:
                        part.add(y)
                        stack.append(y)
            out.append(part)
            remaining -= part
    return out


def leiden_communities(n_nodes: int, edges, seed: int = 0,
                       max_levels: int = 10,
                       n_iterations: int = 3) -> List[Set[int]]:
    """Partition a weighted undirected graph into communities.

    edges: iterable of (u, v, weight).  Returns node-id sets, one per
    community (singletons included), every one internally CONNECTED (the
    Leiden guarantee the track-extraction use relies on).  Deterministic
    for a given seed.

    n_iterations: Leiden is an iterative algorithm (Traag et al. 2019
    section "Leiden algorithm", leidenalg's n_iterations) — each pass
    restarts the local move from the previous partition, which can only
    keep or improve modularity; iteration stops early once a pass stops
    improving."""
    rng = random.Random(seed)
    orig_edges = [(u, v, float(w)) for u, v, w in edges]
    best: List[Set[int]] = []
    best_q = float("-inf")
    init = None
    for _ in range(max(n_iterations, 1)):
        comms = _one_pass(n_nodes, orig_edges, rng, init, max_levels)
        memb = {}
        for i, c in enumerate(comms):
            for u in c:
                memb[u] = i
        q = modularity(n_nodes, orig_edges, memb)
        if q <= best_q + 1e-12:
            break
        best, best_q = comms, q
        init = [memb[u] for u in range(n_nodes)]
    return best
