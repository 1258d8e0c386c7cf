"""Test support only: synthetic inputs that hold the edge cases of the
kernels' layouts, and the rank workers of the edge-partitioned tests.

Nothing in the pipeline imports this module.  The CPU tests
(tests/test_torch_kernels.py, tests/test_torch_parallel.py), the card-only
tests (tests/test_torch_gpu.py) and chip_smoke.py do: the inputs are made
with numpy from a seed, so each hands the same rows to a kernel and to its
plain version.  It lives in the package so that chip_smoke.py, run from a
checkout, reaches it by the package's import path, and so that a rank
process started with `spawn` imports the workers (`spawn_ranks`) without
the test module, which imports JAX.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

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
    """(the rank's block of g, the rank's routing) over `group`, which
    holds every rank."""
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    r = edge_shard.build_owner_routing(g, ctx.world)
    return (edge_shard.shard_graph(g, group),
            edge_shard.routing_shard(r, ctx.rank))


def _job_stages(ctx: RankContext, staged: dict, prepared: dict, meta: dict,
                cfg: dict) -> dict:
    """From given states (numpy, e.g. the JAX package's): the extrapolation
    stage with and without routing (staged), each of the three iterations
    in turn (prepared), and the census of the routed stage and of
    iterations 1 and 2; states gathered whole."""
    from gnn_track_finding_tpu_torch.config import PipelineConfig
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
    {...}} or an event cache {"npz": path}, on the rank's device."""
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.data.event_cache import load_npz
    from gnn_track_finding_tpu_torch.graph.build import build_graph_state
    from gnn_track_finding_tpu_torch.models import toymc
    if "toy" in event:
        tracks, seed = event["toy"]
        ev = toymc.generate_event(num_tracks=tracks, seed=seed)
        cfg = PipelineConfig(**event["cfg"])
        return build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                                 cfg, device=ctx.device, dtype=dtype), cfg
    xyzr, vivl, tp, pairs, _, pre = load_npz(event["npz"])
    cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                         max_volume=int(vivl[:, 0].max()))
    return build_graph_state(xyzr, vivl, tp, pairs, cfg, device=ctx.device,
                             dtype=dtype, mirror=pre["mirror"],
                             component=pre["component"]), cfg


def _sync(ctx: RankContext) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _job_schedule(ctx: RankContext, event: dict, reps: int = 1,
                  check_kernels: bool = False,
                  kernel_inputs: bool = False) -> dict:
    """schedule_sharded over the default group on one event: the gathered
    final state and accepted candidates, the kernels' launches in the
    first run, the wall per run (reps runs, each ended by a barrier and
    the candidates' readback), the census of one run, and (check_kernels)
    both kernels against their plain versions on this rank's owner rows:
    the clustering core in both rounds, the distinct counts of
    iteration 2's first prior_reweight pass, whose inputs rank 0 returns
    with kernel_inputs."""
    import torch.distributed as dist

    from gnn_track_finding_tpu_torch.ops import (cluster_kernel, collect,
                                                 distinct_kernel)
    from gnn_track_finding_tpu_torch.parallel import edge_shard
    group = edge_shard.edge_group()
    g_full, cfg = _graph(ctx, event)
    g, r = _sharded(ctx, g_full, group)
    out = {"walls": []}
    for rep in range(reps):
        cluster_kernel.cluster_core.launches = 0
        distinct_kernel.distinct_counts.launches = 0
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
            out["launches"] = {
                "gmr_cluster": cluster_kernel.cluster_core.launches,
                "distinct_counts": distinct_kernel.distinct_counts.launches}
    out["census"] = records
    out["acc_count"], out["acc_nodes"], out["acc_pvals"] = acc
    out["cca_rounds"] = res.cca_rounds
    out["graph"] = edge_shard.gather_graph(res.graph, group).to_numpy()
    out["bucket"] = r.bucket
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
    from gnn_track_finding_tpu_torch.models import pipeline
    from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                                 distinct_kernel, extrapolate,
                                                 priors)

    inputs = {}

    def core(name, x):
        inputs[name] = {
            "packed": cluster_kernel.pack_states(x.states).cpu().numpy(),
            **{k: getattr(x, k).cpu().numpy()
               for k in ("tab", "node_xyzr", "klthr")},
            "chi2_thr": x.chi2_thr}
        args = (x.states, x.tab, x.node_xyzr, x.klthr)
        got = cluster_kernel.cluster_core(*args, chi2_thr=x.chi2_thr, cfg=cfg)
        want = cluster_kernel.cluster_core_plain(*args, chi2_thr=x.chi2_thr,
                                                 cfg=cfg)
        same = all(torch.equal(a, b) if a.dtype == torch.bool else
                   torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                   and torch.equal(torch.isnan(a), torch.isnan(b))
                   for a, b in zip(got, want))
        return {"rows": int(x.tab.shape[0]), "found": int(got[0].sum()),
                "bitwise": bool(same), "kc": int(x.tab.shape[1])}

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


def _job_batched(ctx: RankContext, events: list, shape) -> dict:
    """run_batched over a mesh of `shape`: this rank's events' gathered
    states and candidates."""
    from gnn_track_finding_tpu_torch.parallel import mesh as pmesh
    graphs, cfgs = zip(*(_graph(ctx, e) for e in events))
    out = pmesh.run_batched(list(graphs), cfgs[0], pmesh.make_mesh(shape))
    return {i: {"acc_count": res.acc_count.tolist(),
                "acc_nodes": res.acc_nodes.cpu().numpy(),
                "acc_pvals": res.acc_pvals.cpu().numpy(),
                "graph": res.graph.to_numpy()} for i, res in out}


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


def _job_sequence(ctx: RankContext, jobs: list) -> list:
    """Several jobs in one process group, in turn: [(job, params), ...]."""
    return [JOBS[name](ctx, **params) for name, params in jobs]


JOBS = {"collect": _job_collect, "stages": _job_stages,
        "schedule": _job_schedule, "batched": _job_batched,
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
