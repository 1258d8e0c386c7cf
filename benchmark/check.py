"""How `correct` is decided: the program's answers against the reference's.

Every event the timed path finished is judged by what it says: its
accepted candidates, iteration by iteration (the node indices of each, in
the order the program lists them), against the reference's answer for
the same pool event, and the two track-fit p-values of each candidate
that both sides accept.  The numbers compared, each with the limit the
configuration states (`limits`):

  * unanswered_events: events handed to the program in the window whose
    result never came back;
  * mismatched_candidates: candidates that one side accepts and the other
    does not, summed over the events compared;
  * pval_gap: the widest absolute gap between the program's p-value and
    the reference's over the candidates both accept.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

NAMES = ("unanswered_events", "mismatched_candidates", "pval_gap")


def _by_key(iterations: List[np.ndarray], nodes: List[np.ndarray],
            pvals: np.ndarray) -> Dict[tuple, np.ndarray]:
    return {(int(i), tuple(int(v) for v in nn)): pv
            for i, nn, pv in zip(iterations, nodes, pvals)}


def reference_keys(accepted) -> Dict[tuple, np.ndarray]:
    """The reference's answer (a list of Accepted per iteration) keyed by
    (iteration, nodes)."""
    its, nodes, pvals = [], [], []
    for it, acc in enumerate(accepted, start=1):
        its += [it] * len(acc.nodes)
        nodes += list(acc.nodes)
        pvals.append(np.asarray(acc.pvals, np.float64).reshape(-1, 2))
    return _by_key(its, nodes, np.concatenate(pvals) if pvals else
                   np.zeros((0, 2)))


def program_keys(candidates) -> Dict[tuple, np.ndarray]:
    """The program's answer (its Candidate objects) keyed alike."""
    return _by_key([c.iteration for c in candidates],
                   [c.nodes for c in candidates],
                   np.array([[c.pval_xy, c.pval_zr] for c in candidates],
                            np.float64).reshape(-1, 2))


def compare(done, references: Dict[int, Dict[tuple, np.ndarray]],
            handed: int) -> dict:
    """The numbers compared over the finished events `done` whose pool
    event has a reference answer -> {name: value, "events_compared": n}."""
    mismatched, gap, compared = 0, 0.0, 0
    for d in done:
        want = references.get(d.pool_index)
        if want is None:
            continue
        compared += 1
        got = program_keys(d.candidates)
        both = got.keys() & want.keys()
        mismatched += len(got) + len(want) - 2 * len(both)
        for k in both:
            diff = np.abs(got[k] - want[k])
            gap = max(gap, float(np.max(diff)) if np.all(np.isfinite(diff))
                      else float("inf"))
    return {"unanswered_events": handed - len(done),
            "mismatched_candidates": mismatched, "pval_gap": gap,
            "events_compared": compared}


def verdict(numbers: dict, limits: dict) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}} for each number compared."""
    return {name: {"value": numbers[name], "limit": limits[name],
                   "ok": numbers[name] <= limits[name]} for name in NAMES}
