"""Host-side replica of the reference's NetworkX/CPython ordering semantics.

Port of `gnn_track_finding_tpu.graph.nxorder` (nxorder.py:1-315), the same
code to the element but for the linear frequency count of the
close-proximity merge: it is plain Python over genuine `set()`s, and the
CPython hash order those sets produce is the point.  The JAX module cannot
be imported here (its package imports jax).  Edge indices follow the
port's directed-edge order, which interleaves like the JAX ingest's:
edge 2i = u->v and 2i+1 = v->u of the i-th deduplicated pair.

The reference's numerics depend on iteration orders that NetworkX and
CPython produce as side effects:

  * ``compute_track_state_estimates`` iterates
    ``set(nx.all_neighbors(G, node))`` (helper.py:280) — a CPython
    hash-table order — and pairs each neighbour's seed tau with the
    MIRROR neighbour's (reversed lists indexed by the un-reversed loop
    variable, helper.py:349-429).
  * extraction's close-proximity merge picks ``node1`` as the FIRST of a
    same-layer pair in the candidate's node iteration order
    (extract_track_candidates.py:92-96) and then mutates that node's
    GNN_Measurement coordinates IN PLACE (:113-116).  Because every
    ``Graph.copy()`` only shallow-copies attribute dicts, the mutation
    leaks into the remaining network that message passing reads next
    iteration, while the node's ``'xyzr'`` attribute keeps the original
    coordinates.

Both orders are produced by the same chain of NetworkX rebuilds, each
replicated here with genuine Python sets (same interpreter => identical
collision behaviour):

  1. ``nx.DiGraph(G)`` (event_conversion.py:80) rebuilds via
     ``from_dict_of_dicts``: successor adjacency keeps CSV edge insertion
     order; predecessor adjacency is regrouped by source node in
     node-insertion order.
  2. ``nx.weakly_connected_components`` builds each component as a set,
     inserting the BFS source first, then per visited node successors
     (CSV order) before predecessors (NetworkX's _plain_bfs).
  3. ``G.subgraph(c)`` re-hashes the component into a fresh set
     (``show_nodes(self.nbunch_iter(nodes))``); iterating the view walks
     THAT set when ``2*len(c) < len(G)`` (FilterAtlas.__iter__
     "node_ok_shorter"), else parent node order.
  4. ``.copy()`` adds edges grouped by source in view order, so the
     copy's predecessor adjacency is ordered by the source's position in
     the view order; successor adjacency again keeps CSV order.
  5. extraction (extract_track_candidates.py:400-470): per remaining
     subgraph, ``subGraph.copy()`` (pred regroup by subgraph node order),
     ``CCA`` removes deactivated DIRECTED edges then re-splits via BFS +
     ``subgraph(component).copy()`` (:332-346) — candidate node order.
     Accepted candidates' nodes are removed from the ORIGINAL subgraph
     (dict deletion preserves the order of what remains, :461-463).

The RefOrderTracker maintains per-subgraph (node order, succ order, pred
order) through this chain and emits the extraction-time coordinate
mutations so the device pipeline can reproduce the leak exactly
(bug_compat mode; the clean mode never mutates).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


def _plain_bfs_set(start: int, succ: Dict[int, List[int]],
                   pred: Dict[int, List[int]],
                   key_of) -> Tuple[set, List[int]]:
    """NetworkX weakly_connected._plain_bfs: returns the BFS 'seen' set
    (hash-table order = insertion order effects) plus the dense members."""
    seen = {key_of(start)}
    members = [start]
    nextlevel = [start]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in succ[v]:
                kw = key_of(w)
                if kw not in seen:
                    seen.add(kw)
                    members.append(w)
                    nextlevel.append(w)
            for w in pred[v]:
                kw = key_of(w)
                if kw not in seen:
                    seen.add(kw)
                    members.append(w)
                    nextlevel.append(w)
    return seen, members


def _subgraph_copy_node_order(component_set: set, parent_order: Sequence[int],
                              parent_size: int, key_of, dense_of) -> List[int]:
    """Node order of ``parent.subgraph(c).copy()``.

    show_nodes re-hashes the component into a fresh set element-wise
    (nbunch_iter is a generator); the view walks that set when
    2*len(c) < len(parent), else the parent node order filtered.
    """
    show = set(x for x in component_set)
    if 2 * len(show) < parent_size:
        return [dense_of[x] for x in show]
    return [v for v in parent_order if key_of(v) in show]


class _SubgraphOrders:
    """Adjacency orders of one live subgraph (a conversion component with
    any extracted nodes removed)."""

    __slots__ = ("node_order", "succ", "pred", "alive")

    def __init__(self, node_order: List[int], succ: Dict[int, List[int]],
                 pred: Dict[int, List[int]]):
        self.node_order = node_order
        self.succ = succ
        self.pred = pred
        self.alive = True

    def remove_nodes(self, nodes: Set[int]) -> None:
        """nx remove_nodes_from: dict deletion preserves remaining order."""
        self.node_order = [v for v in self.node_order if v not in nodes]
        for v in nodes:
            self.succ.pop(v, None)
            self.pred.pop(v, None)
        for v in self.node_order:
            self.succ[v] = [w for w in self.succ[v] if w not in nodes]
            self.pred[v] = [w for w in self.pred[v] if w not in nodes]


class RefOrderTracker:
    """Tracks reference NetworkX orders from event conversion through
    every extraction, and emits the proximity-merge coordinate leaks."""

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray,
                 in_tab: np.ndarray, out_tab: np.ndarray,
                 orig_of: np.ndarray):
        self.n = n
        self.orig_of = np.asarray(orig_of, np.int64)
        self.dense_of = {int(o): i for i, o in enumerate(self.orig_of)}
        self._src = np.asarray(src)
        self._dst = np.asarray(dst)
        self._edge_of: Optional[Dict[Tuple[int, int], int]] = None
        key_of = lambda v: int(self.orig_of[v])

        # g2 = nx.DiGraph(G): succ = CSV insertion order, pred regrouped
        # ascending by source node position (== dense index).  Both lists
        # are carved out of flat numpy gathers (row-major flattening of the
        # slot tables preserves per-node insertion order) — the per-element
        # Python loops this replaces dominated full-event ingest.
        out_valid = out_tab >= 0
        flat_succ = dst[np.maximum(out_tab, 0)][out_valid].tolist()
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(out_valid.sum(1), out=offs[1:])
        offs_l = offs.tolist()
        succ_csv = [flat_succ[offs_l[i]:offs_l[i + 1]] for i in range(n)]

        in_valid = in_tab >= 0
        src_sorted = np.sort(np.where(in_valid, src[np.maximum(in_tab, 0)],
                                      np.int64(1) << 60), axis=1).tolist()
        counts_in = in_valid.sum(1).tolist()
        pred_g2 = [src_sorted[i][:counts_in[i]] for i in range(n)]

        # weakly_connected_components(g2) in node order
        seen: set = set()
        self.subgraphs: List[_SubgraphOrders] = []
        succ_map = {v: succ_csv[v] for v in range(n)}
        pred_map = {v: pred_g2[v] for v in range(n)}
        for v in range(n):
            if key_of(v) in seen:
                continue
            c, _members = _plain_bfs_set(v, succ_map, pred_map, key_of)
            seen.update(c)
            order = _subgraph_copy_node_order(c, range(n), n, key_of,
                                              self.dense_of)
            pos = {u: i for i, u in enumerate(order)}
            sub = _SubgraphOrders(
                node_order=order,
                succ={u: list(succ_csv[u]) for u in order},
                pred={u: sorted(pred_g2[u], key=pos.__getitem__)
                      for u in order},
            )
            self.subgraphs.append(sub)

    @property
    def edge_of(self) -> Dict[Tuple[int, int], int]:
        """(src, dst) -> directed edge index; built lazily (only the
        extraction-leak replay needs it)."""
        if self._edge_of is None:
            self._edge_of = {(int(s), int(d)): e for e, (s, d)
                             in enumerate(zip(self._src, self._dst))}
        return self._edge_of

    # ---- seeding orders (helper.py:280 set(nx.all_neighbors)) ----

    def neighbour_orders(self) -> List[Optional[List[int]]]:
        """Per-node neighbour lists of ORIGINAL ids in reference seed-time
        iteration order (predecessors in component-copy order, then
        successors in CSV order, through a genuine Python set)."""
        orders: List[Optional[List[int]]] = [None] * self.n
        for sub in self.subgraphs:
            for v in sub.node_order:
                orders[v] = list(set(
                    int(self.orig_of[w]) for w in sub.pred[v] + sub.succ[v]))
        return orders

    # ---- extraction emulation (extract_track_candidates.py:400-470) ----

    def extraction_merges(
        self, active: np.ndarray, vivl: np.ndarray, xyzr: np.ndarray,
        accepted_sets: Sequence[Set[int]], min_hits: int,
        merge_threshold: float,
    ) -> List[Tuple[int, Tuple[float, float, float, float]]]:
        """Replay one extraction stage.

        active: (E,) bool 'activated' flags at extraction input.
        vivl:   (N, 2) int vivl ids; xyzr: (N, 4) ORIGINAL coordinates
        (the merge distance and midpoints use the 'xyzr' attribute, which
        the leak never updates, :99-111,48-55).
        accepted_sets: dense node sets of the candidates the device
        accepted this stage (used for the remove_nodes bookkeeping).
        Returns the GNN-coordinate mutations [(node, (x, y, z, r)), ...]
        in reference application order, and updates the tracked orders.
        """
        mutations: List[Tuple[int, Tuple[float, float, float, float]]] = []
        remaining_accepted = [set(s) for s in accepted_sets]
        key_of = lambda v: int(self.orig_of[v])

        for sub in self.subgraphs:
            if not sub.alive or len(sub.node_order) == 0:
                continue
            # subCopy = subGraph.copy(): pred regrouped by subgraph order
            pos = {u: i for i, u in enumerate(sub.node_order)}
            csucc = {}
            cpred = {}
            removed_any = False
            for u in sub.node_order:
                s_ok, s_rm = [], False
                for w in sub.succ[u]:
                    if active[self.edge_of[(u, w)]]:
                        s_ok.append(w)
                    else:
                        s_rm = True
                csucc[u] = s_ok
                removed_any |= s_rm
                cpred[u] = [w for w in sorted(sub.pred[u], key=pos.__getitem__)
                            if active[self.edge_of[(w, u)]]]

            # CCA (:332-346)
            candidates: List[List[int]] = []
            if removed_any:
                seen: set = set()
                nsub = len(sub.node_order)
                for v in sub.node_order:
                    if key_of(v) in seen:
                        continue
                    c, _ = _plain_bfs_set(v, csucc, cpred, key_of)
                    seen.update(c)
                    candidates.append(_subgraph_copy_node_order(
                        c, sub.node_order, nsub, key_of, self.dense_of))
            else:
                candidates.append(list(sub.node_order))

            sub_removed: Set[int] = set()
            for cand in candidates:
                if len(cand) >= min_hits:
                    mutations.extend(self._proximity_mutations(
                        cand, vivl, xyzr, merge_threshold))
                # removal bookkeeping: match the device's accepted sets
                cand_set = set(cand)
                for acc in remaining_accepted:
                    if acc and acc == cand_set:
                        sub_removed |= acc
                        acc.clear()
                        break

            if sub_removed:
                sub.remove_nodes(sub_removed)
            size = len(sub.node_order)
            if 0 < size < min_hits:
                sub.alive = False        # fragments leave the pipeline (:465)
            elif size == 0:
                sub.alive = False
        return mutations

    def _proximity_mutations(self, cand: List[int], vivl: np.ndarray,
                             xyzr: np.ndarray, threshold: float):
        """check_close_proximity_nodes (:58-151): scenario 2 only; mutates
        node1 (FIRST of the pair in candidate node order) to the midpoint
        of the pair's ORIGINAL coordinates; stops at the first failed pair
        but keeps any mutations already applied."""
        vivl_ids = [(int(vivl[v, 0]), int(vivl[v, 1])) for v in cand]
        # reference builds {x: count} over the vivl list — dict order =
        # first occurrence; values() order follows (:59-63).  A Counter
        # has the same keys in the same order and the same counts, in
        # linear time (list.count per element is quadratic).
        vivl_ids_freq = collections.Counter(vivl_ids)
        freq_count = list(vivl_ids_freq.values())
        out = []
        if 2 not in freq_count:
            return out
        non2 = [x for x in freq_count if x != 2]
        if len(freq_count) - len(non2) > 2:
            return out
        if any(c != 1 for c in non2):
            return out
        duplicated = list(set(t for t in vivl_ids if vivl_ids_freq[t] > 1))
        for dup in duplicated:
            nodes_of_interest = [cand[i] for i, t in enumerate(vivl_ids)
                                 if t == dup]
            if len(nodes_of_interest) != 2:
                break
            n1, n2 = nodes_of_interest
            c1, c2 = xyzr[n1], xyzr[n2]
            d = float(np.sqrt((c1[0] - c2[0]) ** 2 + (c1[1] - c2[1]) ** 2
                              + (c1[2] - c2[2]) ** 2))
            if d > threshold:
                break
            xm = (float(c1[0]) + float(c2[0])) / 2.0
            ym = (float(c1[1]) + float(c2[1])) / 2.0
            zm = (float(c1[2]) + float(c2[2])) / 2.0
            rm = float(np.sqrt(xm * xm + ym * ym))
            out.append((n1, (xm, ym, zm, rm)))
        return out
