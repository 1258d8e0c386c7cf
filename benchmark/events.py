"""The one traffic generator: a cell's events and their order from a
traffic mix's parameters and the seed.

Every traffic mix draws a pool of `pool` distinct events from the
configuration's event network: each rotated about the beam axis by an
angle drawn uniformly from [0, 2 pi), and its hits renumbered by a
cyclic shift drawn uniformly from [1, n) (hit i becomes hit (i + s) mod
n; the pairs, the mirror's edge order and the graph's shape stay, and
the hits' order keeps its locality but for one wrap).  The rotation
changes the floats, which the answers follow only at rounding level; the
shift changes every node index of the answers, so that no event's
answer passes for another's.  Every seed gets the same number of events
of the same sizes, in another order, at other angles and shifts.  The
driver named by the mix takes them:

  * `stream`: one event per dispatch, round-robin through the pool;
  * `batch`: `batch` events per dispatch, the pool's events in an order
    the seed shuffles anew for every dispatch;
  * `files`: as `stream`, each event read from a file of its own (the
    program's event-cache layout, written by the harness before the
    window), so that the program's ingest runs inside the window.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np

DRIVERS = ("stream", "batch", "files")


def draws(traffic: dict, seed: int, n: int):
    """(angles (pool,), shifts (pool,)) of the pool's events, n hits."""
    rng = np.random.default_rng([abs(int(seed)), int(seed < 0), 0])
    pool = int(traffic["pool"])
    return (rng.uniform(0.0, 2.0 * math.pi, pool),
            rng.integers(1, n, pool))


def orders(traffic: dict, seed: int) -> Iterator[List[int]]:
    """The pool indices of each dispatch, endlessly."""
    pool = int(traffic["pool"])
    if traffic["driver"] in ("stream", "files"):
        i = 0
        while True:
            yield [i % pool]
            i += 1
    elif traffic["driver"] == "batch":
        batch = int(traffic["batch"])
        if batch > pool:
            raise ValueError(f"batch {batch} over the pool of {pool}")
        rng = np.random.default_rng([abs(int(seed)), int(seed < 0), 1])
        while True:
            yield rng.permutation(pool)[:batch].tolist()
    else:
        raise ValueError(f"unknown driver {traffic['driver']!r}; "
                         f"one of {DRIVERS}")


def rotated(xyzr: np.ndarray, angle: float) -> np.ndarray:
    """Hits (n, 4) rotated about the beam axis in (x, y); r as given."""
    c, s = math.cos(angle), math.sin(angle)
    out = np.array(xyzr, dtype=np.float64, copy=True)
    x, y = out[:, 0].copy(), out[:, 1].copy()
    out[:, 0] = c * x - s * y
    out[:, 1] = s * x + c * y
    return out


def load(path) -> Dict[str, np.ndarray]:
    """The raw event arrays: hits, their (volume, layer) ids, truth ids,
    undirected pairs, the set()-order mirror and the ingest components."""
    with np.load(path) as z:
        return {k: z[k] for k in ("xyzr", "vivl", "truth_particle", "pairs",
                                  "mirror", "component")}


def shifted(raw: Dict[str, np.ndarray], s: int) -> Dict[str, np.ndarray]:
    """The event with hit i renumbered (i + s) mod n: the per-hit arrays
    rolled, the pairs' ids mapped (their order kept, so the directed
    edges and the mirror keep theirs); component labels stay labels."""
    n = raw["xyzr"].shape[0]
    out = {k: np.roll(raw[k], s, axis=0)
           for k in ("xyzr", "vivl", "truth_particle", "component")}
    out["pairs"] = (raw["pairs"].astype(np.int64) + s) % n
    out["mirror"] = raw["mirror"]
    return out


def pool_arrays(raw: Dict[str, np.ndarray], traffic: dict, seed: int
                ) -> List[Dict[str, np.ndarray]]:
    """Each pool event's raw arrays: rotated, then renumbered."""
    angles, shifts = draws(traffic, seed, raw["xyzr"].shape[0])
    return [dict(shifted(raw, int(s)), xyzr=rotated(
        np.roll(raw["xyzr"], int(s), axis=0), a))
            for a, s in zip(angles, shifts)]
