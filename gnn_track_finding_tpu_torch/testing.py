"""Test support only: synthetic inputs that hold the edge cases of the
kernels' layouts, the host-read audit of the captured programs, the event
loader (`load_event`, rotated copies included), the kernel gate (both
kernels against their plain versions on an event's own inputs, and its
accepted counts), and the rank workers of the edge-partitioned tests.

Nothing in the pipeline imports this module.  The CPU tests
(tests/test_torch_kernels.py, tests/test_torch_fit_kernel.py,
tests/test_torch_gate.py, tests/test_torch_parallel.py), the card-only
tests (tests/test_torch_gpu.py), chip_smoke.py and profile_stages do: the
inputs are made with numpy from a seed, so each hands the same rows to a
kernel and to its plain version.  It lives in the package so that
chip_smoke.py, run from a checkout, reaches it by the package's import
path, and so that a rank process started with `spawn` imports the workers
(`spawn_ranks`) without the test module, which imports JAX.
"""

from __future__ import annotations

import math
import pickle
import time
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import event_cache
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import GraphState
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                             distinct_kernel, extrapolate,
                                             priors)
from gnn_track_finding_tpu_torch.ops.cluster_kernel import SlotStates

# row kinds of cluster_rows, cycled over the rows
CLUSTER_KINDS = ("random", "nan_chi2", "nan_kl", "chi2_tie", "duplicates",
                 "all_equal", "absorb_all")


def cluster_rows(seed: int, rows: int, kc: int, counts=None, *,
                 dtype=torch.float64, device="cpu", kinds=CLUSTER_KINDS):
    """(states, tab, node_xyzr, klthr) for `rows` compacted rows.

    Row r has min(counts[r], kc) member slots (default: counts drawn from
    3..15, the gate's range) whose edge ids are scattered over the edge
    tensors; the rest of its tab row is -1.  Members sit close in [a, b]
    and tau, so most rows merge at the seed chi2 threshold (1.0).  The
    row kinds, cycled: random; a NaN [a, b] component (NaN chi2: not
    found); a NaN tau component (finite chi2, NaN KL); two identical slots
    (an exact chi2 tie on their pairs with slot 0, and chi2 = 0 between
    them); several identical slots (chi2 = 0 pairs); all slots identical
    (every chi2 = 0: not found); klthr 1e30 (full absorption).  xyzr is
    the (E, 4) head of an (E, 8) tensor, as in the seed round."""
    rng = np.random.default_rng(seed)
    if counts is None:
        counts = rng.integers(3, 16, size=rows)
    n = np.minimum(np.asarray(counts, dtype=np.int64), kc)
    n_edges = int(n.sum()) + 7                     # a few edges no row reads
    p_sv = rng.normal(size=(n_edges, 3))
    p_cov = _spd(rng, n_edges, 1.0)
    j_sv = np.zeros((n_edges, 3))
    j_cov = _spd(rng, n_edges, 1e-2)
    prior = rng.uniform(0.1, 1.0, size=n_edges)
    xyzr8 = rng.normal(size=(n_edges, 8)) * 100.0
    node = np.zeros((rows, 4))
    klthr = np.full(rows, 2.0)
    tab = np.full((rows, kc), -1, dtype=np.int64)
    perm = rng.permutation(n_edges)
    at = 0
    for r in range(rows):
        kind = kinds[r % len(kinds)]
        ids = perm[at:at + n[r]]
        at += n[r]
        tab[r, :n[r]] = ids
        ra = rng.uniform(30.0, 1000.0)
        node[r] = (rng.uniform(-700.0, 700.0), rng.normal() * 50.0,
                   rng.uniform(-1000.0, 1000.0), ra)
        slope = rng.uniform(-2.0, 2.0)
        centre = rng.normal(size=2)
        spread = rng.uniform(0.05, 0.8)
        sig = np.sqrt(np.diagonal(j_cov[ids][:, :2, :2], axis1=1, axis2=2))
        j_sv[ids, :2] = centre + spread * sig * rng.normal(size=(len(ids), 2))
        j_sv[ids, 2] = slope + rng.normal(size=len(ids)) * 1e-2
        dr = rng.choice([-1.0, 1.0], size=len(ids)) * rng.uniform(
            20.0, 200.0, size=len(ids))
        xyzr8[ids, 0] = rng.uniform(-700.0, 700.0, size=len(ids))
        xyzr8[ids, 3] = ra + dr
        xyzr8[ids, 2] = node[r, 2] + slope * dr + rng.normal(
            size=len(ids)) * 0.5
        if kind == "nan_chi2" and len(ids) > 1:
            j_sv[ids[1], 0] = np.nan
        elif kind == "nan_kl" and len(ids) > 2:
            j_sv[ids[-1], 2] = np.nan
        elif kind == "chi2_tie" and len(ids) > 2:
            _copy_edge(ids[2], ids[1], p_sv, p_cov, j_sv, j_cov, prior, xyzr8)
        elif kind == "duplicates":
            for e in ids[1:len(ids) // 2 + 1]:
                _copy_edge(e, ids[0], p_sv, p_cov, j_sv, j_cov, prior, xyzr8)
        elif kind == "all_equal":
            for e in ids[1:]:
                _copy_edge(e, ids[0], p_sv, p_cov, j_sv, j_cov, prior, xyzr8)
        elif kind == "absorb_all":
            klthr[r] = 1e30
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    states = SlotStates(t(p_sv), t(p_cov), t(j_sv), t(j_cov), t(prior),
                        t(xyzr8)[:, :4])
    return states, torch.from_numpy(tab).to(device), t(node), t(klthr)


def _spd(rng, n, scale):
    """n random symmetric positive definite 3x3 matrices near scale * I."""
    a = rng.normal(size=(n, 3, 3)) * 0.3
    return scale * (a @ np.swapaxes(a, 1, 2) + np.eye(3) * rng.uniform(
        0.5, 1.5, size=(n, 1, 1)))


def _copy_edge(dst, src, *fields):
    for f in fields:
        f[dst] = f[src]


def distinct_tables(seed: int, n: int, k: int, *, dtype=torch.float64,
                    device="cpu"):
    """(ok (n, k) bool, x (n, k), node_x (n,)) whose rows cycle through:
    empty rows; all-ok rows with duplicates; sparse random rows; rows whose
    x equal node_x; rows with NaN; rows with -0.0 beside 0.0 (node_x 0.0 or
    -0.0).  Cells that are not ok hold +inf, as in the reweight tables."""
    rng = np.random.default_rng(seed)
    pool = np.array([1.5, 2.5, 3.5, -1.0, 0.0])
    x = rng.choice(pool, size=(n, k))
    node_x = rng.normal(size=n) * 2.0
    ok = rng.uniform(size=(n, k)) < 0.1
    for r in range(n):
        kind = r % 6
        if kind == 0:
            ok[r] = False
        elif kind == 1:
            ok[r] = True
        elif kind == 3:
            node_x[r] = pool[r % len(pool)]
            ok[r] = rng.uniform(size=k) < 0.5
        elif kind == 4:
            x[r, rng.integers(0, k, size=3)] = np.nan
            ok[r] = rng.uniform(size=k) < 0.5
        elif kind == 5:
            x[r] = rng.choice([0.0, -0.0, 1.0, -1.0], size=k)
            node_x[r] = -0.0 if r % 12 == 5 else 0.0
            ok[r] = rng.uniform(size=k) < 0.5
    x = np.where(ok, x, np.inf)
    return (torch.from_numpy(ok).to(device),
            torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(node_x).to(device, dtype))


FIT_KINDS = ("short", "full", "repeated", "origin", "flat_z", "endcap",
             "close_pair", "twin", "helix")


def fit_rows(seed: int, rows: int, h: int = 32, *, dtype=torch.float64,
             device="cpu"):
    """(coords (rows, h, 4), valid (rows, h), n_hits (rows,)) in the layout
    of extract._compact_rows: coords a view of (rows, h + 1, 4) raw
    (x, y, z, r) hits, radius-descending, the first n_hits slots valid and
    random values in the rest.  The row kinds, cycled: n_hits 0, 1, 2, 3
    in turn; a row of all h slots; n_hits identical hits (denom == 0,
    hyp == 0, dz == 0, the innermost pair within the separation
    threshold); hits at the origin; a constant z at the endcap boundary or
    in the barrel (dz == 0 beside dr != 0); endcap hits; an innermost pair
    ~3 apart; one hit repeated in the middle of a track; tracks of 4..h
    hits.  Tracks are circles through the origin in xy with a straight
    line in (r, z), plus noise."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(rows, h + 1, 4)) * 500.0
    n_hits = np.zeros(rows, dtype=np.int64)

    def track(n, cot=None, z0=None):
        rr = np.sort(rng.uniform(30.0, 1000.0, size=n))[::-1]
        big_r = rng.uniform(600.0, 6000.0) * rng.choice([-1.0, 1.0])
        phi = rng.uniform(-np.pi, np.pi) + np.arcsin(rr / (2.0 * big_r))
        x = rr * np.cos(phi) + rng.normal(size=n) * 0.1
        y = rr * np.sin(phi) + rng.normal(size=n) * 0.1
        cot = rng.uniform(-1.5, 1.5) if cot is None else cot
        z0 = rng.normal() * 50.0 if z0 is None else z0
        return np.stack([x, y, z0 + rr * cot, np.sqrt(x * x + y * y)], 1)

    for r in range(rows):
        kind = FIT_KINDS[r % len(FIT_KINDS)]
        n = int(rng.integers(4, h + 1))
        if kind == "short":
            n = min((r // len(FIT_KINDS)) % 4, h)
            hits = track(n)
        elif kind == "full":
            n = h
            hits = track(n)
        elif kind == "repeated":
            hits = np.repeat(track(1), n, axis=0)
        elif kind == "origin":
            hits = np.zeros((n, 4))
        elif kind == "flat_z":
            hits = track(n, cot=0.0, z0=550.0 if r % 2 else 120.0)
        elif kind == "endcap":
            hits = track(n, cot=rng.choice([-1.0, 1.0]) * rng.uniform(3, 8),
                         z0=rng.choice([-1.0, 1.0]) * 600.0)
        elif kind == "close_pair":
            hits = track(n)
            hits[n - 2] = hits[n - 1] + np.array([2.0, 1.0, 2.0, 0.0])
        elif kind == "twin":
            hits = track(n)
            k = n // 2
            hits[k + 1] = hits[k]
        else:
            hits = track(n)
        coords[r, :n] = hits
        n_hits[r] = n
    valid = np.arange(h)[None, :] < n_hits[:, None]
    full = torch.from_numpy(coords).to(device, dtype)
    return (full[:, :h], torch.from_numpy(valid).to(device),
            torch.from_numpy(n_hits).to(device))


def extraction_rows(g, cfg) -> list:
    """The compacted rows (coords, valid, n_hits) that each extraction of
    an eager run of the schedule on g hands extract.track_fit, cloned: the
    inputs of the track-fit kernel at the main path's shapes."""
    from gnn_track_finding_tpu_torch.ops import extract
    entry, seen = extract.track_fit, []

    def recorded(coords, valid, n_hits, cfg):
        seen.append((coords.clone(), valid.clone(), n_hits.clone()))
        return entry(coords, valid, n_hits, cfg)

    extract.track_fit = recorded
    try:
        pipeline.full_pipeline_results(g, cfg)
    finally:
        extract.track_fit = entry
    return seen


class HostReads(TorchDispatchMode):
    """Records every aten op that reads a tensor's values on the host or
    sizes its output by them (.item / bool(), nonzero, boolean-mask
    indexing, masked_select, unique, bincount, repeat_interleave with
    tensor repeats): one such op in a schedule breaks its CUDA-graph
    capture on the card.  `ops` holds every op seen."""

    NAMES = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
             "aten.repeat_interleave.Tensor", "aten.bincount")

    def __init__(self):
        super().__init__()
        self.ops, self.reads = set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        self.ops.add(name)
        bool_index = func.overloadpacket in (
            torch.ops.aten.index, torch.ops.aten.index_put,
            torch.ops.aten.index_put_) and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in (args[1] if len(args) > 1 else ()) if i is not None)
        if name.startswith(self.NAMES) or "unique" in name or bool_index:
            self.reads.append(name)
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# the event loader and the kernel gate

FLIP_SHARE = 0.06   # float32: found-flag flips allowed, as a share of rows


class GateError(RuntimeError):
    """A kernel disagrees with its plain version, or a count is off."""


def load_event(path, cfg: PipelineConfig, *, device, dtype, copy: int = 0,
               copies: int = 1) -> GraphState:
    """The event's GraphState from its cache, with the cached set()-order
    mirror and components.  With `copy`, every hit rotated about the beam
    axis by copy * 2 pi / copies in (x, y) (r as cached): the same graph,
    other floats, so that `copies` such events make a batch of distinct
    events of one pad bucket; copy 0 is the event itself."""
    xyzr, vivl, tp, pairs, _, pre = event_cache.load_npz(path)
    if copy:
        phi = 2.0 * math.pi * copy / copies
        c, s = math.cos(phi), math.sin(phi)
        xyzr = xyzr.astype(np.float64, copy=True)
        x, y = xyzr[:, 0].copy(), xyzr[:, 1].copy()
        xyzr[:, 0] = c * x - s * y
        xyzr[:, 1] = s * x + c * y
    return build_graph_state(xyzr, vivl, tp, pairs, cfg, device=device,
                             dtype=dtype, mirror=pre["mirror"],
                             component=pre["component"])


def per_iteration(out: pipeline.PipelineResult, cfg: PipelineConfig) -> list:
    return [sum(1 for c in out.candidates if c.iteration == i)
            for i in range(1, cfg.num_iterations + 1)]


def _close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float,
           equal_nan: bool) -> bool:
    return bool(torch.isclose(a, b, rtol=rtol, atol=atol,
                              equal_nan=equal_nan).all())


def compare_cluster(inputs: tuple, *, chi2_thr: float, cfg: PipelineConfig,
                    kernel=cluster_kernel.cluster_core,
                    plain=cluster_kernel.cluster_core_plain,
                    require_merged: bool = True,
                    label: str = "gmr_cluster") -> dict:
    """`kernel` against `plain` on one round's compacted rows (inputs:
    states, tab, node_xyzr, klthr and optionally the live count; rows past
    it come out not found from both): bitwise at float64; at float32
    found-flag flips under FLIP_SHARE of the rows, and the merged values
    of the rows both find within rtol 1e-5 (NaN equal to NaN only at
    float64).  -> the agreement; raises
    GateError."""
    want = plain(*inputs, chi2_thr=chi2_thr, cfg=cfg)
    got = kernel(*inputs, chi2_thr=chi2_thr, cfg=cfg)
    rows = inputs[1].shape[0]
    both = got[0] & want[0]
    live = inputs[4] if len(inputs) > 4 and inputs[4] is not None else rows
    stats = {"rows": rows, "live": int(live), "found": int(got[0].sum()),
             "found_plain": int(want[0].sum()),
             "flips": int((got[0] != want[0]).sum()),
             "deact_diffs": int((got[4] != want[4]).sum()),
             "max_abs_diff": max(
                 float((a[both] - b[both]).abs().nan_to_num().max())
                 if both.any() else 0.0
                 for a, b in zip(got[1:4], want[1:4]))}
    if require_merged and not both.any():
        raise GateError(f"{label}: no row merged; {stats}")
    if inputs[2].dtype == torch.float64:
        ok = (stats["flips"] == 0 and stats["deact_diffs"] == 0
              and all(_close(a, b, 0.0, 0.0, True)
                      for a, b in zip(got[1:4], want[1:4])))
        bar = "bitwise at float64"
    else:
        ok = (stats["flips"] < FLIP_SHARE * max(rows, 1)
              and all(_close(a[both], b[both], 1e-5, 1e-7, False)
                      for a, b in zip(got[1:4], want[1:4])))
        bar = (f"float32: flips under {FLIP_SHARE:.0%} of the rows, merged "
               "values within rtol 1e-5")
    if not ok:
        raise GateError(f"{label} disagrees with its plain version ({bar}): "
                        f"{stats}")
    return stats


def _distinct_plain(ok: torch.Tensor, x: torch.Tensor,
                    node_x: torch.Tensor) -> torch.Tensor:
    return distinct_kernel.distinct_counts_plain(ok, x, x < node_x[:, None],
                                                 x.dtype)


def compare_distinct(ok: torch.Tensor, x: torch.Tensor, node_x: torch.Tensor,
                     *, kernel=distinct_kernel.distinct_counts,
                     plain=_distinct_plain) -> dict:
    """`kernel` against `plain` on one (N, K) reweight table: exact.
    -> the agreement; raises GateError."""
    got = kernel(ok, x, node_x)
    want = plain(ok, x, node_x)
    stats = {"rows": ok.shape[0], "ok_slots": int(ok.sum()),
             "count_sum": int(want.sum()),
             "diffs": int((got != want).sum())}
    if not torch.equal(got, want):
        raise GateError(f"distinct_counts disagrees with its plain version: "
                        f"{stats}")
    return stats


def kernel_gate(g: GraphState, cfg: PipelineConfig,
                expected: List[int] | None = None) -> dict:
    """Both kernels against their plain versions on g's own inputs (the
    root bench.py:133-160 only logs them): gmr_cluster on the seed round's
    rows of the prepared state, distinct_counts on iteration 2's first
    reweight table; then run_pipeline_fast's accepted counts per
    iteration against `expected`, or, when None, against
    run_pipeline_eager's.  -> the agreement; raises GateError."""
    prepared = pipeline.prepare(g, cfg)
    x = clustering.core_inputs(prepared, cfg, False)
    cluster = compare_cluster(
        (x.states, x.tab, x.node_xyzr, x.klthr, x.count), chi2_thr=x.chi2_thr,
        cfg=cfg, label="gmr_cluster, seed round")
    g2, _ = pipeline.iteration(prepared, cfg, 1)
    distinct = compare_distinct(
        *priors.distinct_inputs(extrapolate.message_passing(g2, cfg)))
    counts = per_iteration(pipeline.run_pipeline_fast(g, cfg), cfg)
    want = expected if expected is not None else per_iteration(
        pipeline.run_pipeline_eager(g, cfg), cfg)
    if counts != list(want):
        raise GateError(f"accepted counts {counts}, expected {list(want)}")
    return {"gmr_cluster": cluster, "distinct_counts": distinct,
            "accepted": counts}


# ---------------------------------------------------------------------------
# rank workers of the edge-partitioned tests


class Ranks:
    """Rank processes started by spawn_ranks; join() waits for them."""

    def __init__(self, context, out_dir: Path, timeout: float):
        self.context = context
        self.out_dir = out_dir
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        """Wait for every rank (raising if one fails or the time runs out,
        after killing the rest); -> each rank's result, in rank order."""
        while not self.context.join(timeout=5):
            if time.monotonic() > self.deadline:
                for p in self.context.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"rank processes in {self.out_dir} did "
                                   "not finish in time")
        out = []
        for r in range(len(self.context.processes)):
            with open(self.out_dir / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def spawn_ranks(job: str, world: int, out_dir, *, backend: str = "gloo",
                device: str = "cpu", timeout: float = 300.0,
                **params) -> Ranks:
    """Start `world` processes (spawn) that join one process group (file
    rendezvous in out_dir, a 60 s collective timeout) and each run
    JOBS[job](ctx, **params); rank r's return value is pickled to
    out_dir/rank<r>.pkl.  Returns at once: call .join()."""
    import torch.multiprocessing as mp
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rdv = out_dir / f"rdv_{job}_{time.monotonic_ns()}"
    context = mp.start_processes(
        _rank_main, args=(world, str(rdv), backend, device, job, str(out_dir),
                          params),
        nprocs=world, join=False, start_method="spawn")
    return Ranks(context, out_dir, timeout)


class RankContext(NamedTuple):
    rank: int
    world: int
    device: torch.device


def _rank_main(rank, world, rdv, backend, device, job, out_dir, params):
    import os

    import torch.distributed as dist

    from gnn_track_finding_tpu_torch.parallel import edge_shard, multihost
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    init = f"file://{rdv}"
    if world > 1:
        # as a launcher would set them: one host, all ranks on this card
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(dev.index or 0),
                          LOCAL_WORLD_SIZE=str(world))
        multihost.initialize(backend, init_method=init)
    else:
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init, rank=0,
                                world_size=1, timeout=edge_shard.TIMEOUT,
                                **kw)
    try:
        out = JOBS[job](RankContext(rank, world, dev), **params)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def collect_inputs(rank: int, world: int) -> dict:
    """Per-rank inputs of the collect ops (numpy, from rank and world)."""
    rng = np.random.default_rng(100 * world + rank)
    bucket = 4
    e_loc = 10
    owner = rng.integers(-1, world, size=e_loc)
    pos = rng.integers(0, bucket + 1, size=e_loc)        # bucket: not routed
    return {"x": rng.normal(size=(4 * world, 3)),
            "flags": rng.uniform(size=(4 * world, 5)) < 0.3,
            "ints": rng.integers(0, 1000, size=4 * world),
            "rows": rng.normal(size=(3, 2)),
            "values": rng.normal(size=(e_loc, 3)), "owner": owner,
            "pos": np.where(owner >= 0, pos, -1), "bucket": bucket}


def _job_collect(ctx: RankContext) -> dict:
    """Every collect op on collect_inputs(rank), over the default group."""
    import torch.distributed as dist

    from gnn_track_finding_tpu_torch.ops import collect
    group = dist.group.WORLD
    a = collect_inputs(ctx.rank, ctx.world)
    t = lambda v: torch.from_numpy(np.asarray(v)).to(ctx.device)
    with collect.census() as records:
        out = {
            "allsum": collect.allsum(t(a["x"]), group),
            "allor": collect.allor(t(a["flags"]), group),
            "allmin": collect.allmin(t(a["ints"]), group),
            "ownsum": collect.ownsum(t(a["x"]), group),
            "ownor": collect.ownor(t(a["flags"]), group),
            "gather_rows": collect.gather_rows(t(a["rows"]), group),
            "owner_block": collect.owner_block(t(a["x"]), group),
            "owner_block_interleaved": collect.owner_block_interleaved(
                t(a["x"]), group),
            "route_to_owners": collect.route_to_owners(
                t(a["values"]), t(a["owner"]), t(a["pos"]), a["bucket"], group),
        }
        out = {k: v.cpu().numpy() for k, v in out.items()}
    out["census"] = records
    out["owner_shards"] = [collect.owner_shards(n, group) for n in (6, 7, 8)]
    x = t(a["x"])
    out["identity"] = all(getattr(collect, f)(x, None) is x
                          for f in ("allsum", "allor", "allmin"))
    return out


def _state(arrays: dict, meta: dict, device, dtype=torch.float64):
    from gnn_track_finding_tpu_torch.graph import state as tstate
    return tstate.from_numpy(arrays, device=device, dtype=dtype, **meta)


def _result_numpy(res) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in res._asdict().items()}


def _sharded(ctx: RankContext, g, group):
    """(this rank's block of g, its routing) over `group`, of which this
    rank is a member."""
    import torch.distributed as dist

    from gnn_track_finding_tpu_torch.parallel import edge_shard
    r = edge_shard.build_owner_routing(g, dist.get_world_size(group))
    return (edge_shard.shard_graph(g, group),
            edge_shard.routing_shard(r, dist.get_rank(group)))


def _job_stages(ctx: RankContext, staged: dict, prepared: dict, meta: dict,
                cfg: dict) -> dict:
    """From given states (numpy, e.g. the JAX package's): the extrapolation
    stage with and without routing (staged), each of the three iterations
    in turn (prepared), and the census of the routed stage and of
    iterations 1 and 2; states gathered whole."""
    from gnn_track_finding_tpu_torch.ops import collect
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    group = edge_shard.edge_group()
    cfg = PipelineConfig(**cfg)
    out = {}
    g, r = _sharded(ctx, _state(staged, meta, ctx.device), group)
    for name, routing in (("stage_dense", None), ("stage_routed", r)):
        with collect.census() as out[f"census_{name}"]:
            s = edge_shard.extrapolation_stage_sharded(g, cfg, group, routing)
        out[name] = edge_shard.gather_graph(s, group).to_numpy()
    g, r = _sharded(ctx, _state(prepared, meta, ctx.device), group)
    for i in (1, 2, 3):
        with collect.census() as out[f"census_iteration{i}"]:
            g, res = edge_shard.iteration_sharded(g, cfg, i, group, r)
        out[f"iteration{i}"] = edge_shard.gather_graph(g, group).to_numpy()
        out[f"result{i}"] = _result_numpy(res)
    return out


def _graph(ctx: RankContext, event: dict, dtype=torch.float64):
    """(GraphState, config) of a toy event {"toy": (tracks, seed), "cfg":
    {...}, optionally "gen": {generate_event's other arguments}}, an event
    cache {"npz": path}, optionally {"copy": (b, copies)}, the cache's
    event rotated by b * 2 pi / copies (load_event), or a stack of such
    events {"stack": [...]} (graph/state.stack_events; the first event's
    config), on the rank's device."""
    from gnn_track_finding_tpu_torch.graph.state import stack_events
    from gnn_track_finding_tpu_torch.models import toymc
    if "stack" in event:
        graphs, cfgs = zip(*(_graph(ctx, e, dtype) for e in event["stack"]))
        return stack_events(graphs), cfgs[0]
    if "toy" in event:
        tracks, seed = event["toy"]
        ev = toymc.generate_event(num_tracks=tracks, seed=seed,
                                  **event.get("gen", {}))
        cfg = PipelineConfig(**event["cfg"])
        return build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                                 cfg, device=ctx.device, dtype=dtype), cfg
    vivl = event_cache.load_npz(event["npz"])[1]
    cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                         max_volume=int(vivl[:, 0].max()))
    copy, copies = event.get("copy", (0, 1))
    return load_event(event["npz"], cfg, device=ctx.device, dtype=dtype,
                      copy=copy, copies=copies), cfg


def _sync(ctx: RankContext) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _event_numpy(res) -> dict:
    """One event's ScheduleResults as numpy (its graph whole)."""
    return {"acc_count": res.acc_count.tolist(),
            "acc_nodes": res.acc_nodes.cpu().numpy(),
            "acc_pvals": res.acc_pvals.cpu().numpy(),
            "cca_rounds": res.cca_rounds.tolist(),
            "overflow": res.overflow.tolist(), "path": res.path,
            "graph": res.graph.to_numpy()}


def _schedule_numpy(res, group):
    """A ScheduleResults as numpy, the graph gathered whole; a stack's as
    a list of such dicts, one per event (pipeline.split_events)."""
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    whole = res._replace(graph=edge_shard.gather_graph(res.graph, group))
    per = [_event_numpy(r) for r in pipeline.split_events(whole)]
    return per if res.graph.batch > 1 else per[0]


def bitwise_fields(a, b) -> list:
    """The fields of two ScheduleResults (graph included) that differ bit
    for bit."""
    from gnn_track_finding_tpu_torch.graph.state import tensor_fields
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    pairs = [(k, getattr(a, k), getattr(b, k)) for k in a._fields
             if k not in ("graph", "path")]
    pairs += [(k, getattr(a.graph, k), getattr(b.graph, k))
              for k in tensor_fields()]
    bad = []
    for k, x, y in pairs:
        if x.dtype in bits and x.dtype == y.dtype:
            x, y = x.view(bits[x.dtype]), y.view(bits[y.dtype])
        if x.shape != y.shape or not torch.equal(x, y):
            bad.append(k)
    return bad


def _job_schedule(ctx: RankContext, event: dict, reps: int = 1,
                  check_kernels: bool = False,
                  kernel_inputs: bool = False, exact: bool = False) -> dict:
    """schedule_sharded over the default group on one event: the gathered
    final state and accepted candidates, the kernels' launches in the
    first run, the wall per run (reps runs, each ended by a barrier and
    the candidates' readback), the census of one run, and (check_kernels)
    both kernels against their plain versions on this rank's owner rows:
    the clustering core in both rounds, the distinct counts of
    iteration 2's first prior_reweight pass, whose inputs rank 0 returns
    with kernel_inputs; with `exact`, the exact fallback's results
    (FastSV's adaptive loop) and the fields in which they differ from the
    schedule's bit for bit."""
    import torch.distributed as dist

    from gnn_track_finding_tpu_torch.ops import collect
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    group = edge_shard.edge_group()
    g_full, cfg = _graph(ctx, event)
    g, r = _sharded(ctx, g_full, group)
    out = {"walls": []}
    for rep in range(reps):
        pipeline.reset_kernel_launches()
        dist.barrier(group)
        _sync(ctx)
        t0 = time.perf_counter()
        with collect.census() as records:
            res = edge_shard.schedule_sharded(g, cfg, group, r)
        acc = (res.acc_count.tolist(), res.acc_nodes.cpu().numpy(),
               res.acc_pvals.cpu().numpy())
        _sync(ctx)
        out["walls"].append(time.perf_counter() - t0)
        if rep == 0:
            out["launches"] = pipeline.kernel_launches()
    out["census"] = records
    out["acc_count"], out["acc_nodes"], out["acc_pvals"] = acc
    out["cca_rounds"] = res.cca_rounds.tolist()
    out["graph"] = edge_shard.gather_graph(res.graph, group).to_numpy()
    out["bucket"] = r.bucket
    if exact:
        ex = edge_shard.schedule_sharded_exact(g, cfg, group, r)
        out["exact"] = _schedule_numpy(ex, group)
        out["exact_differs"] = bitwise_fields(res, ex)
    if check_kernels:
        out["kernel_checks"], inputs = _owner_kernel_checks(g, cfg, group, r)
        if kernel_inputs and ctx.rank == 0:
            out["kernel_inputs"] = inputs
    return out


def _owner_kernel_checks(g, cfg, group, r):
    """Both kernels against their plain versions on the owner rows of the
    sharded schedule's clustering rounds and first reweight pass ->
    (verdicts, the inputs as numpy: each round's packed (rows, 29) state
    buffer, tab, node_xyzr, klthr and chi2_thr; the distinct counts' ok,
    x and node_x)."""

    inputs = {}

    def core(name, x):
        inputs[name] = {
            "packed": cluster_kernel.pack_states(x.states).cpu().numpy(),
            **{k: getattr(x, k).cpu().numpy()
               for k in ("tab", "node_xyzr", "klthr", "count")},
            "chi2_thr": x.chi2_thr}
        args = (x.states, x.tab, x.node_xyzr, x.klthr, x.count)
        got = cluster_kernel.cluster_core(*args, chi2_thr=x.chi2_thr, cfg=cfg)
        want = cluster_kernel.cluster_core_plain(*args, chi2_thr=x.chi2_thr,
                                                 cfg=cfg)
        return {"rows": int(x.tab.shape[0]), "live_rows": int(x.count),
                "found": int(got[0].sum()),
                "bitwise": not _core_differs(got, want),
                "kc": int(x.tab.shape[1])}

    gp = pipeline.prepare(g, cfg, group)
    out = {"cluster_seed": core("cluster_seed", clustering.owner_core_inputs(
        gp, cfg, False, group, r))}
    g1, _ = pipeline.iteration(gp, cfg, 1, group=group, routing=r)
    ok, x, _, nx, _ = priors.owner_tables(
        extrapolate.message_passing(g1, cfg, group), group, r)
    got = distinct_kernel.distinct_counts(ok, x, nx)
    want = distinct_kernel.distinct_counts_plain(ok, x, x < nx[:, None],
                                                 x.dtype)
    out["distinct"] = {"rows": int(ok.shape[0]), "ok_slots": int(ok.sum()),
                       "bitwise": bool(torch.equal(got, want))}
    inputs["distinct"] = {"ok": ok.cpu().numpy(), "x": x.cpu().numpy(),
                          "node_x": nx.cpu().numpy()}
    g2, _ = pipeline.iteration(g1, cfg, 2, group=group, routing=r)
    out["cluster_updated"] = core("cluster_updated",
                                  clustering.owner_core_inputs(
                                      g2, cfg, True, group, r))
    return out, inputs


def _core_differs(got, want) -> bool:
    """Whether two cluster_core outputs differ (NaN where NaN)."""
    return not all(torch.equal(a, b) if a.dtype == torch.bool else
                   torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                   and torch.equal(torch.isnan(a), torch.isnan(b))
                   for a, b in zip(got, want))


def _owner_rows_check(g, cfg, use_updated: bool, group, r) -> dict:
    """The static owner table of a clustering round against the exact
    compaction of the same gated rows (nonzero, read on the host): ids,
    count, rows and the plain core on each."""
    from gnn_track_finding_tpu_torch.ops import collect
    x = clustering.owner_core_inputs(g, cfg, use_updated, group, r)
    tab, gate, states, _ = clustering.owner_table(g, cfg, use_updated,
                                                  group, r)
    ids = torch.nonzero(gate).squeeze(1)
    n, rows = ids.shape[0], gate.shape[0]
    xyzr = collect.owner_block_interleaved(g.xyzr, group)[ids]
    klthr = torch.full(ids.shape, cfg.cluster_thresholds(use_updated)[1],
                       dtype=g.dtype, device=g.device)
    exact = cluster_kernel.cluster_core_plain(
        states, tab[ids], xyzr, klthr, chi2_thr=x.chi2_thr, cfg=cfg)
    static = cluster_kernel.cluster_core_plain(
        x.states, x.tab, x.node_xyzr, x.klthr, x.count, chi2_thr=x.chi2_thr,
        cfg=cfg)
    return {"rows": rows, "count": int(x.count), "exact_rows": n,
            "ids": torch.equal(x.ids[:n], ids)
            and bool((x.ids[n:] == rows).all()),
            "tab": torch.equal(x.tab[:n], tab[ids])
            and bool((x.tab[n:] == -1).all()),
            "node_xyzr": torch.equal(x.node_xyzr[:n], xyzr),
            "klthr": torch.equal(x.klthr[:n], klthr),
            "found": int(exact[0].sum()),
            "core": not _core_differs([v[:n] for v in static], exact),
            "core_dead_rows": not any(bool(v[n:].any()) for v in static)}


def _job_static_parts(ctx: RankContext, event: dict) -> dict:
    """The sharded schedule walked stage by stage on this rank: before each
    clustering round, its static owner table against the exact compaction
    (_owner_rows_check); at each extraction, fixed-round FastSV against
    the adaptive loop over the group (labels, rounds, convergence)."""
    from gnn_track_finding_tpu_torch.graph import cca
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    group = edge_shard.edge_group()
    g_full, cfg = _graph(ctx, event)
    g, r = _sharded(ctx, g_full, group)
    g = pipeline.prepare(g, cfg, group)
    out = {"owner": [], "fastsv": []}
    for i in range(1, cfg.num_iterations + 1):
        if i % 2:
            out["owner"].append(_owner_rows_check(g, cfg, i > 1, group, r))
        s = pipeline.stage_step(g, cfg, i, None, group, r)
        ok = s.edge_mask & s.active
        labels, rounds = cca.connected_components_fastsv(s, ok, group)
        fixed, f_rounds, converged = cca.connected_components_fixed(
            s, ok, group=group)
        out["fastsv"].append({"labels": torch.equal(fixed, labels),
                              "rounds": rounds, "fixed_rounds": int(f_rounds),
                              "converged": bool(converged)})
        g, _ = pipeline.extract_step(s, cfg, i, group, r)
    return out


def _job_fallback(ctx: RankContext, event: dict, limit: str) -> dict:
    """run_sharded with the head cap ("cap") or FastSV's rounds ("rounds")
    cut one below what the event needs (on a stack: the most any event
    needs): the body's overflow flags on this rank, the fallbacks counted,
    and the fallback's results beside the uncut run's and (one event) the
    exact schedule's; the path of the uncut run, the group's part of its
    program key and whether run_sharded captures.  A stack's results come
    per event."""
    from gnn_track_finding_tpu_torch.graph import cca
    from gnn_track_finding_tpu_torch.graph.state import unstack_events
    from gnn_track_finding_tpu_torch.ops import extract
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    group = edge_shard.edge_group()
    g_full, cfg = _graph(ctx, event)
    events = unstack_events(g_full)
    g, r = _sharded(ctx, g_full, group)
    full = edge_shard.run_sharded(g, cfg, group, r, events)
    out = {"full": _schedule_numpy(full, group),
           "key": list(pipeline.program_key(g, cfg, group, r)[-4:]),
           "captures": edge_shard.captures(g, group)}
    if g.batch == 1:
        out["exact"] = _schedule_numpy(
            edge_shard.schedule_sharded_exact(g, cfg, group, r), group)
    mod, name, need = ((extract, "ACC_PULL_CAP", full.acc_count)
                       if limit == "cap" else
                       (cca, "R_CAP", full.cca_rounds))
    keep = getattr(mod, name)
    setattr(mod, name, int(need.max()) - 1)
    try:
        out["overflow"] = edge_shard.schedule_sharded(
            g, cfg, group, r).overflow.tolist()
        before = pipeline.fallbacks
        fell = edge_shard.run_sharded(g, cfg, group, r, events)
        out["fallbacks"] = pipeline.fallbacks - before
    finally:
        setattr(mod, name, keep)
    out["fallback"] = _schedule_numpy(fell, group)
    return out


def _replay_ms(prog, reps: int = 3) -> float:
    """One replay of a captured program on the device (CUDA events), the
    best of `reps`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        prog.graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _job_captured(ctx: RankContext, event: dict, reps: int = 5,
                  check_kernels: bool = False) -> dict:
    """run_sharded on one event or a stack where it captures (an NCCL
    group on the card): its path; the fields in which its first call
    (capture and replay), a replay and a replay under
    torch.cuda.set_sync_debug_mode("error") differ bit for bit from the
    eager body's run; the first call's results, graph gathered (per event
    on a stack); the wall of run_sharded against the eager body (one
    event) or against the stack's events through run_sharded one by one
    (a stack: "in_turn", each event its own captured program), best of
    `reps` in turns (each ended by the candidates' readback); one
    replay's device time, capture and instantiate seconds, the graph
    pool, the kernels' launches per replay, the collectives of the eager
    run (one run's census) and of the first call (warm-up and capture),
    and the fallbacks.  A stack also gives the fields in which each event
    differs bit for bit from its single-device batched replay
    (pipeline.run_schedule_batched) and each rank's live edges; with
    check_kernels, both kernels against their plain versions on the
    owner rows, and their inputs (_owner_kernel_checks)."""
    import torch.distributed as dist

    from gnn_track_finding_tpu_torch.graph.state import unstack_events
    from gnn_track_finding_tpu_torch.ops import collect
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    group = edge_shard.edge_group()
    g_full, cfg = _graph(ctx, event)
    events = unstack_events(g_full)
    g, r = _sharded(ctx, g_full, group)
    pipeline.clear_programs()
    before = pipeline.fallbacks
    with collect.census() as census:
        eager = edge_shard.schedule_sharded(g, cfg, group, r)
    with collect.census() as first_census:
        first = edge_shard.run_sharded(g, cfg, group, r, events)
    prog = pipeline.captured_program(g, cfg, group, r)
    replay = edge_shard.run_sharded(g, cfg, group, r, events)
    _sync(ctx)
    torch.cuda.set_sync_debug_mode("error")
    try:
        quiet = prog.replay(g, r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    path = first.path[0] if g.batch > 1 else first.path
    out = {"path": path, "programs": len(pipeline._PROGRAMS),
           "differs": {"first": bitwise_fields(eager, first),
                       "replay": bitwise_fields(eager, replay),
                       "sync_debug": bitwise_fields(eager, quiet)},
           "result": _schedule_numpy(first, group),
           "replay_ms": _replay_ms(prog),
           "record_s": prog.capture.record_s,
           "instantiate_s": prog.capture.instantiate_s,
           "pool_bytes": prog.capture.pool_bytes,
           "launches": prog.kernel_launches,
           "census": census, "first_call_collectives": len(first_census),
           "bucket": r.bucket}
    runs = {"captured": lambda: edge_shard.run_sharded(
        g, cfg, group, r, events).acc_count}
    if g.batch > 1:
        whole = first._replace(graph=edge_shard.gather_graph(first.graph,
                                                             group))
        out["paths"] = list(first.path)
        out["single_differs"] = [
            bitwise_fields(a, b) for a, b in zip(
                pipeline.split_events(whole),
                pipeline.run_schedule_batched(events, cfg))]
        out["live_edges"] = int(g.edge_mask.sum())
        blocks = [_sharded(ctx, e, group) for e in events]
        for g_b, r_b in blocks:         # capture each event's program
            edge_shard.run_sharded(g_b, cfg, group, r_b)
        runs["in_turn"] = lambda: torch.stack([
            edge_shard.run_sharded(g_b, cfg, group, r_b).acc_count
            for g_b, r_b in blocks])
    else:
        runs["eager"] = lambda: edge_shard.schedule_sharded(
            g, cfg, group, r).acc_count
    out["walls"] = {name: [] for name in runs}
    for _ in range(reps):
        for name, run in runs.items():
            dist.barrier(group)
            _sync(ctx)
            t0 = time.perf_counter()
            run().tolist()
            out["walls"][name].append(time.perf_counter() - t0)
    if check_kernels:
        out["kernel_checks"], out["kernel_inputs"] = _owner_kernel_checks(
            g, cfg, group, r)
    out["fallbacks"] = pipeline.fallbacks - before
    return out


def _job_batched(ctx: RankContext, events: list, shape, reps: int = 0,
                 check_kernels: bool = False) -> dict:
    """run_batched over a mesh of `shape` (the programs cleared and the
    kernels' counters zeroed first): this rank's events' gathered states
    and candidates, each with its path and the number of programs cached
    after the batch ("events"); the census of the run's collectives; the
    kernels' launches; this rank's live edges in each chunk's block
    ("live_edges") and, on the card, the peak allocation.  With reps, the
    wall of run_batched against this rank's events through
    edge_shard.run_sharded one by one (each routed, sharded and gathered
    on its own), best of `reps` in turns; with check_kernels, both
    kernels against their plain versions on the owner rows of this rank's
    first chunk (_owner_kernel_checks, its inputs on rank 0)."""
    import torch.distributed as dist

    from gnn_track_finding_tpu_torch.graph.state import stack_events
    from gnn_track_finding_tpu_torch.ops import collect
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    from gnn_track_finding_tpu_torch.parallel import mesh as pmesh
    graphs, cfgs = zip(*(_graph(ctx, e) for e in events))
    graphs, cfg = list(graphs), cfgs[0]
    mesh = pmesh.make_mesh(shape)
    lo, hi = pmesh.event_slice(len(graphs), mesh.data_index, shape[0])
    mine = graphs[lo:hi]
    chunks = [[mine[i] for i in c] for c in pmesh.batch_chunks(mine)]
    blocks = [edge_shard.shard_graph(stack_events(c), mesh.edge_group)
              for c in chunks]
    out = {"live_edges": [int(b.edge_mask.sum()) for b in blocks],
           "events": {}}
    pipeline.clear_programs()
    pipeline.reset_kernel_launches()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    with collect.census() as out["census"]:
        results = pmesh.run_batched(graphs, cfg, mesh)
    out["launches"] = pipeline.kernel_launches()
    for i, res in results:
        out["events"][i] = {**_event_numpy(res),
                            "programs": len(pipeline._PROGRAMS)}
    if ctx.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    if reps:
        def in_turn():
            for g_full in mine:
                g, r = _sharded(ctx, g_full, mesh.edge_group)
                res = edge_shard.run_sharded(g, cfg, mesh.edge_group, r)
                edge_shard.gather_graph(res.graph, mesh.edge_group)
                res.acc_count.tolist()

        runs = {"batched": lambda: [r.acc_count.tolist() for _, r in
                                    pmesh.run_batched(graphs, cfg, mesh)],
                "in_turn": in_turn}
        out["walls"] = {name: [] for name in runs}
        for _ in range(reps):
            for name, run in runs.items():
                dist.barrier()
                _sync(ctx)
                t0 = time.perf_counter()
                run()
                _sync(ctx)
                out["walls"][name].append(time.perf_counter() - t0)
    if check_kernels:
        g = blocks[0]
        r = edge_shard.routing_shard(edge_shard.build_owner_routing(
            stack_events(chunks[0]), shape[1]), mesh.edge_index)
        out["kernel_checks"], inputs = _owner_kernel_checks(
            g, cfg, mesh.edge_group, r)
        if ctx.rank == 0:
            out["kernel_inputs"] = inputs
    return out


def _job_multihost(ctx: RankContext, events: list, num_events: int) -> dict:
    """local_event_slice(num_events), the global mesh's shape and this
    rank's place in it (by default and with two data ranks), and
    scaling_report on the events."""
    from gnn_track_finding_tpu_torch.parallel import multihost
    graphs, cfgs = zip(*(_graph(ctx, e) for e in events))
    meshes = [multihost.global_mesh(), multihost.global_mesh(2)]
    return {"slice": multihost.local_event_slice(num_events),
            "meshes": [(m.shape, m.data_index, m.edge_index) for m in meshes],
            "report": multihost.scaling_report(list(graphs), cfgs[0])}


def _job_audit(ctx: RankContext, event: dict) -> dict:
    """schedule_sharded over the default group under HostReads: the ops
    that read the device on the host (none may), and whether the audit
    saw the schedule's collectives and kernels' plain versions."""
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    group = edge_shard.edge_group()
    g_full, cfg = _graph(ctx, event)
    g, r = _sharded(ctx, g_full, group)
    mode = HostReads()
    with mode:
        edge_shard.schedule_sharded(g, cfg, group, r)
    return {"reads": sorted(set(mode.reads)), "ops": sorted(mode.ops)}


def _job_sequence(ctx: RankContext, jobs: list) -> list:
    """Several jobs in one process group, in turn: [(job, params), ...]."""
    return [JOBS[name](ctx, **params) for name, params in jobs]


JOBS = {"collect": _job_collect, "stages": _job_stages, "audit": _job_audit,
        "schedule": _job_schedule, "static_parts": _job_static_parts,
        "fallback": _job_fallback, "captured": _job_captured,
        "batched": _job_batched,
        "multihost": _job_multihost, "sequence": _job_sequence}


def states_differ(want: dict, got: dict, rtol: float = 1e-12,
                  atol: float = 0.0, looser: dict | None = None) -> list:
    """Fields of two states (numpy dicts) that differ: masks and integers
    must be equal, floats agree to atol + rtol * |want| (NaN where NaN),
    with the rtol that `looser` names for a field.  The variance columns of grad_stats
    (1 and 3) are held relative to the second moment they are computed
    from, var + mean^2 (seeding.py: an edge partition reassociates the
    per-node sums, and var = s2 / n - mean^2 cancels)."""
    bad = []
    looser = looser or {}
    for name, a in want.items():
        b = np.asarray(got[name])
        a = np.asarray(a)
        if a.shape != b.shape:
            bad.append(f"{name}: shape {b.shape} != {a.shape}")
        elif a.dtype.kind in "biu":
            if not np.array_equal(a, b):
                bad.append(f"{name}: {int((a != b).sum())} entries differ")
        else:
            with np.errstate(invalid="ignore", over="ignore"):
                tol = atol + np.abs(a) * looser.get(name, rtol)
                if name == "grad_stats":
                    tol[:, 1::2] = atol + looser.get(name, rtol) * (
                        a[:, 1::2] + a[:, 0::2] ** 2)
                # infinities must match exactly
                tol = np.where(np.isfinite(a) & np.isfinite(tol), tol, 0.0)
            with np.errstate(invalid="ignore"):
                diff = np.abs(a - b)
                over = ~((a == b) | (diff <= tol)
                         | (np.isnan(a) & np.isnan(b)))
            if over.any():
                bad.append(f"{name}: {int(over.sum())} entries beyond the "
                           f"bar, max |diff| {np.max(diff[over]):.3e}")
    return bad
