"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

Drives the port's production driver (`run_pipeline_fast`, `stream_pipeline`)
on the committed TrackML event caches and checks both hand-written CUDA
kernels against their plain PyTorch versions on the card:

  1. device: a CUDA device is required; prints its name and power limit;
  2. build: compiles csrc/*.cu with nvcc (sm_90a), one process per source,
     and prints the time, ptxas registers and spills, and each kernel's
     resident blocks per SM;
  3. GMR clustering kernel vs plain, bitwise at float64, on the real
     compacted rows of the full event (seed round after prepare, updated
     round after iteration 2) at float64 and float32, kc = 4 and kc = 32,
     klthr 1e30 (full absorption), and the synthetic edge cases of
     testing.cluster_rows;
  4. distinct-count kernel vs plain, exact, on the real reweight tables
     (K = 64), a duplicate-rich table and the edge cases of
     testing.distinct_tables (K = 32, 40, 64, 128), at both dtypes;
  5. the slice: float64 accepted counts per iteration on the volume-7 and
     full events against the reference's, the float32 counts beside the
     plain path's (the same schedule on CPU tensors), the kernels' launch
     counts in the main-path run, and a 3-event stream against the solo run;
  6. steady-state times: each kernel (device time with the L2 cache
     flushed before each call, and warm) and its plain version at the
     full-event shapes (both clustering rounds), the packed gather the
     kernel no longer needs, the clustering stage, each kernel's bound
     (the bytes and operations these inputs need, at 3.35 TB/s and the
     dtype's peak), per-stage and per-event wall times, streamed events/s;
  7. the host driver `run_pipeline` at float64: on volume 7 and the full
     event, ingest that recomputes the set()-order mirror (checked against
     the cached one) and builds the NetworkX-order tracker, the driver with
     the extraction-leak replay against the reference's counts (mutation
     counts, replay time per extraction, wall per event, both kernels'
     launch counts in the full-event run) and, at volume 7, against the
     same driver on CPU tensors (mutations and candidate nodes exact,
     p-values at rtol 1e-6, final states at rtol 1e-12), and the driver
     without a
     tracker against run_pipeline_fast; the reference digest at volume 7
     (tools/validate_port_vs_reference.py) on the card; and the volume-7
     event written as CSV files and read back through the C++ loader.

Every phase raises on failure, so the script exits non-zero.  The line
before the last is the kernels' JSON record (with bound_ms and bound_by);
the last line is
{"ok": true, "device": {...}}.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
VOL7 = REPO / ".event_cache" / "event_fafb3309e4598e9b.npz"
FULL = REPO / ".event_cache" / "event_7bba1cb4ae95bca1.npz"
EXPECTED_F64 = {VOL7: [1055, 110, 2], FULL: [1504, 436, 9]}
CLUSTER_SOURCE = "gnn_track_finding_tpu_torch/csrc/gmr_cluster.cu"
DISTINCT_SOURCE = "gnn_track_finding_tpu_torch/csrc/distinct_counts.cu"
CLUSTER_REPLACES = "gnn_track_finding_tpu/ops/pallas_cluster.py:118"
DISTINCT_REPLACES = "gnn_track_finding_tpu/ops/pallas_distinct.py:30"
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s,
# and float64 / float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# a buffer written between timed calls to empty the 50 MB L2 cache
L2_FLUSH_BYTES = 128 * 2**20
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(title: str) -> None:
    print(f"\n=== {title}", flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Time per call of fn over reps back-to-back calls (CUDA events): the
    device time, or the host's cost per call where that is larger."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Device time per call of fn: reps calls captured into one CUDA graph
    (the kernel wrappers launch on the current stream, which the capture
    takes over), the graph replayed between CUDA events, so the host's cost
    per call does not enter; the best of three replays.  fn must not
    synchronise with the host.

    Without flush the repeats find their inputs in the L2 cache wherever
    they fit (warm).  With flush, a device buffer larger than the L2, each
    captured call follows a write of the whole buffer, so fn reads its
    inputs from HBM (cold); a graph of the writes alone is timed the same
    way and its time taken off."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def graph_ms(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        graph.replay()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    if flush is None:
        return graph_ms(fn) / reps

    def cold():
        flush.zero_()
        fn()

    return (graph_ms(cold) - graph_ms(flush.zero_)) / reps


def bound(n_bytes: float, n_ops: float, dtype) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the dtype's peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


# float operations of the clustering kernel's pieces, as written in
# csrc/gmr_cluster.cu: a 3x3 inverse, a 3x3 matrix-vector product, a merge
# (sum of inverses, inverse, sum of vectors, product), a KL distance
INV3, MAT3_VEC = 50, 15
MERGE = 9 + INV3 + 3 + MAT3_VEC
KL = {True: 56, False: 68}         # elementwise trace (bug_compat) or full
PAIR, SLOT = 43, 8                  # one pair's chi2; one slot's chi2 terms


def cluster_bound(x, out, cfg) -> dict:
    """What this round's rows need, counted from the tensors of the run.
    Bytes: per member slot its edge id, j_sv, j_cov and the coordinates the
    chi2 reads (x for the endcap test under bug_compat, z, r); per row the
    node's coordinates and the outputs; per found row klthr and, per merged
    slot, p_sv, p_cov and prior.  Operations: per member slot its chi2
    terms, per real pair its chi2; per found row the member inverses, the
    merge of the best pair for both states, and per greedy step evaluated
    the two inverses and a KL per remaining slot, per absorption the two
    merges."""
    from gnn_track_finding_tpu_torch.ops import cluster_kernel
    dtype = x.node_xyzr.dtype
    w = x.node_xyzr.element_size()
    rows, kc = x.tab.shape
    n = cluster_kernel.member_mask(x.tab).sum(1).double()
    found = out[0]
    merged = torch.where(found, n - out[4].sum(1), 0).double()
    coords = 3 if cfg.bug_compat else 2
    n_bytes = (n.sum() * (8 + (12 + coords) * w) + rows * coords * w
               + found.sum() * w + merged.sum() * 13 * w
               + rows * (1 + 13 * w + kc))
    greedy = torch.clamp(merged - 2, min=0)
    steps = greedy + (merged < n).double()
    kl_evals = steps * (n - 2) - steps * (steps - 1) / 2
    per_found = (n * INV3 + 2 * (2 * (INV3 + MAT3_VEC) + MERGE) + 1
                 + steps * 2 * INV3 + kl_evals * KL[bool(cfg.bug_compat)]
                 + greedy * (2 * (INV3 + 2 * MAT3_VEC + MERGE) + 1))
    n_ops = (n.sum() * SLOT + (n * (n - 1) / 2).sum() * PAIR
             + torch.where(found, per_found, 0).sum())
    return bound(float(n_bytes), float(n_ops), dtype)


def distinct_bound(ok, x) -> dict:
    """Bytes: the ok table, x of the ok slots, node_x of the rows with any
    ok slot, the (N, 2) output.  Operations: per ok slot its side test and
    three compares against each earlier ok slot of its row."""
    w = x.element_size()
    per_row = ok.sum(1).double()
    n_bytes = (ok.numel() + per_row.sum() * w + (per_row > 0).sum() * w
               + ok.shape[0] * 2 * w)
    n_ops = per_row.sum() + 3 * (per_row * (per_row - 1) / 2).sum()
    return bound(float(n_bytes), float(n_ops), x.dtype)


def main() -> int:
    phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke needs a CUDA device; torch.cuda.is_available() is "
              "false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from gnn_track_finding_tpu_torch import _build, testing
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.data import native_loader, trackml
    from gnn_track_finding_tpu_torch.data.event_cache import load_npz
    from gnn_track_finding_tpu_torch.graph.build import (build_event,
                                                         build_graph_state)
    from gnn_track_finding_tpu_torch.models import pipeline
    from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                                 distinct_kernel, extract,
                                                 extrapolate, metadata,
                                                 priors)
    cuda = torch.device("cuda")

    phase("2. build")
    lib = _build.library(rebuild=True)
    print(f"nvcc build of {len(_build.sources())} sources: "
          f"{lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print("  " + line.strip())
    occupancy = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        occupancy[f"gmr_cluster {name}"] = cluster_kernel.occupancy(
            dtype, clustering.KC)
        occupancy[f"distinct_counts {name}"] = distinct_kernel.occupancy(dtype)
    for label, occ in occupancy.items():
        print(f"resident on one SM, {label}: {occ}")
    shutil.rmtree(native_loader.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    native_loader.library()
    print(f"g++ build of native/loader.cc: {time.perf_counter() - t0:.2f} s "
          f"-> {native_loader.library_path().name}")

    events = {}

    def graph(path, dtype, device=cuda):
        if path not in events:
            events[path] = load_npz(path)
        xyzr, vivl, tp, pairs, extra, pre = events[path]
        cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                             max_volume=int(vivl[:, 0].max()))
        g = build_graph_state(xyzr, vivl, tp, pairs, cfg, device=device,
                              dtype=dtype, mirror=pre["mirror"],
                              component=pre["component"])
        return g, cfg

    def counts(out, cfg):
        return [sum(1 for c in out.candidates if c.iteration == i)
                for i in range(1, cfg.num_iterations + 1)]

    record = {}

    phase("3. GMR clustering kernel vs plain (full event, edge cases)")

    def core_case(label, inputs, cfg, dtype, chi2_thr, check_found=True):
        """The kernel against the plain version: bitwise at float64, the
        flag band at float32.  Returns the largest |diff|."""
        want = cluster_kernel.cluster_core_plain(*inputs, chi2_thr=chi2_thr,
                                                 cfg=cfg)
        got = cluster_kernel.cluster_core(*inputs, chi2_thr=chi2_thr, cfg=cfg)
        torch.cuda.synchronize()
        f_k, f_p = got[0], want[0]
        rows, kc = inputs[1].shape
        flips = int((f_k != f_p).sum())
        both = f_k & f_p
        diff = max(float((a[both] - b[both]).abs().nan_to_num().max())
                   if both.any() else 0.0
                   for a, b in zip(got[1:4], want[1:4]))
        print(f"{label}: {rows} rows x kc={kc}, found {int(f_k.sum())} "
              f"(plain {int(f_p.sum())}), flag flips {flips}, deact diffs "
              f"{int((got[4] != want[4]).sum())}, max |diff| of merged "
              f"values {diff:.3e}")
        check(both.any() or not check_found, f"{label}: no merged rows")
        if dtype == torch.float64:
            check(flips == 0 and torch.equal(got[4], want[4]),
                  f"{label}: float64 flags differ")
            for a, b in zip(got[1:4], want[1:4]):
                torch.testing.assert_close(a, b, rtol=0, atol=0,
                                           equal_nan=True)
        else:
            check(flips < 0.06 * max(rows, 1), f"{label}: float32 flips")
            for a, b in zip(got[1:4], want[1:4]):
                torch.testing.assert_close(a[both], b[both], rtol=1e-5,
                                           atol=1e-7)
        return diff

    def round_case(label, x, cfg, dtype):
        return core_case(label, (x.states, x.tab, x.node_xyzr, x.klthr), cfg,
                         dtype, x.chi2_thr)

    cluster_inputs = {}
    record["cluster_max_abs_err"] = 0.0
    for dtype in (torch.float64, torch.float32):
        g, cfg = graph(FULL, dtype)
        g = pipeline.prepare(g, cfg)
        name = str(dtype).split(".")[1]
        x = clustering.core_inputs(g, cfg, False)
        err = round_case(f"seed round {name}", x, cfg, dtype)
        if dtype == torch.float64:
            record["cluster_max_abs_err"] = err
            for kc in (4, 32):
                round_case(f"seed round float64 kc={kc}",
                           clustering.core_inputs(g, cfg, False, kc=kc), cfg,
                           dtype)
            absorb = torch.full((g.num_padded_nodes,), 1e30, device=cuda)
            round_case("seed round float64 klthr 1e30 (full absorption)",
                       clustering.core_inputs(g, cfg, False, absorb), cfg,
                       dtype)
        for i in (1, 2):
            g, _ = pipeline.iteration(g, cfg, i)
        x_upd = clustering.core_inputs(g, cfg, True)
        round_case(f"updated round {name}", x_upd, cfg, dtype)
        cluster_inputs[dtype] = (x, x_upd, cfg)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        for kc in (4, 16, 32):
            hi = 33 if kc == 32 else 16
            for rows in (0, 1, 3, 33, 4096):
                members = 3 + (np.arange(rows) * 7) % (hi - 3)
                core_case(f"synthetic {name} rows={rows} kc={kc}",
                          testing.cluster_rows(rows + kc, rows, kc, members,
                                               dtype=dtype, device=cuda),
                          PipelineConfig(), dtype, 1.0,
                          check_found=rows >= 33)

    phase("4. distinct-count kernel vs plain")
    g, cfg = graph(FULL, torch.float64)
    g, _ = pipeline.iteration(pipeline.prepare(g, cfg), cfg, 1)
    g = extrapolate.message_passing(g, cfg)
    ok_t, x_t, nx_t = priors.distinct_inputs(g)
    per_row = ok_t.sum(1)
    print(f"reweight tables {tuple(ok_t.shape)}: {int(per_row.sum())} ok "
          f"slots in {int((per_row > 0).sum())} rows, at most "
          f"{int(per_row.max())} in a row, {int((per_row > 8).sum())} rows "
          "with more than 8")
    rng = np.random.default_rng(0)
    dup_ok = torch.from_numpy(rng.uniform(size=(4096, 64)) < 0.6).to(cuda)
    dup_x = torch.from_numpy(rng.choice([1.5, 2.5, 3.5, -1.0, 0.0],
                                        size=(4096, 64))).to(cuda)
    dup_nx = torch.from_numpy(rng.normal(size=4096) * 2.0).to(cuda)
    distinct_cases = {"reweight tables": (ok_t, x_t, nx_t),
                      "duplicate-rich": (dup_ok, dup_x, dup_nx)}
    for k in (32, 40, 64, 128):
        distinct_cases[f"edge cases K={k}"] = testing.distinct_tables(
            k, 4099, k, device=cuda)
    record["distinct_max_abs_err"] = 0.0
    for label, (ok, xx, nx) in distinct_cases.items():
        for dtype in (torch.float64, torch.float32):
            xd, nxd = xx.to(dtype), nx.to(dtype)
            got = distinct_kernel.distinct_counts(ok, xd, nxd)
            want = distinct_kernel.distinct_counts_plain(
                ok, xd, xd < nxd[:, None], dtype)
            err = float((got - want).abs().max())
            print(f"{label} {tuple(xd.shape)} {dtype}: ok slots "
                  f"{int(ok.sum())}, count sum {float(got.sum()):.0f}, "
                  f"max |diff| {err}")
            check(torch.equal(got, want), f"distinct counts differ: {label}")
            record["distinct_max_abs_err"] = max(
                record["distinct_max_abs_err"], err)

    phase("5. the slice: run_pipeline_fast / stream_pipeline")
    for path in (VOL7, FULL):
        g, cfg = graph(path, torch.float64)
        if path == FULL:
            cluster_kernel.cluster_core.launches = 0
            distinct_kernel.distinct_counts.launches = 0
        out, dt = sync_time(lambda: pipeline.run_pipeline_fast(g, cfg))
        if path == FULL:
            launches = {"gmr_cluster": cluster_kernel.cluster_core.launches,
                        "distinct_counts":
                            distinct_kernel.distinct_counts.launches}
        per_it = counts(out, cfg)
        print(f"{path.name} float64: accepted {per_it} (reference "
              f"{EXPECTED_F64[path]}), FastSV rounds {out.cca_rounds}, "
              f"{dt:.3f} s")
        check(per_it == EXPECTED_F64[path], f"{path.name} float64 counts")
    print(f"kernel launches in the full-event run: {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    solo = out

    g32, cfg = graph(FULL, torch.float32)
    out32 = pipeline.run_pipeline_fast(g32, cfg)
    g_cpu, _ = graph(FULL, torch.float32, device=torch.device("cpu"))
    out_cpu = pipeline.run_pipeline_fast(g_cpu, cfg)
    print(f"full event float32: accepted {counts(out32, cfg)} with the "
          f"kernels, {counts(out_cpu, cfg)} on the plain path (CPU)")

    def same_candidates(a, b):
        return (len(a.candidates) == len(b.candidates) and all(
            x.iteration == y.iteration and np.array_equal(x.nodes, y.nodes)
            and x.pval_xy == y.pval_xy and x.pval_zr == y.pval_zr
            for x, y in zip(a.candidates, b.candidates)))

    streamed = list(pipeline.stream_pipeline(
        (graph(FULL, torch.float64)[0] for _ in range(3)), cfg))
    check(len(streamed) == 3 and all(same_candidates(r, solo)
                                     for r in streamed),
          "streamed candidates differ from the solo run")
    print("stream of 3 full events: candidates identical to the solo run")

    phase("6. times (steady state, after warm-up)")
    print(f"card: {card}")
    # kernels: device time (CUDA graph replay) with the L2 flushed before
    # each call (their inputs cold, as the schedule's (N, K) tables between
    # them leave them) and warm, and time per call (events, host-paced
    # where the wrapper's host cost exceeds the kernel); plain versions:
    # time per call (they synchronise with the host)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=cuda)
    times, bounds = {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        x_seed, x_upd, cfg = cluster_inputs[dtype]
        for rnd, x in (("seed", x_seed), ("updated", x_upd)):
            inputs = (x.states, x.tab, x.node_xyzr, x.klthr)
            key = f"gmr_cluster {rnd} {name}"
            run = lambda: cluster_kernel.cluster_core(
                *inputs, chi2_thr=x.chi2_thr, cfg=cfg)
            times[key] = device_ms(run, flush=flush)
            times[f"{key} warm L2"] = device_ms(run)
            times[f"{key} per call"] = call_ms(run)
            times[f"{key} plain"] = call_ms(
                lambda: cluster_kernel.cluster_core_plain(
                    *inputs, chi2_thr=x.chi2_thr, cfg=cfg), reps=5)
            times[f"{key} packed gather"] = device_ms(
                lambda: cluster_kernel.pack_rows(x.states, x.tab))
            bounds[key] = cluster_bound(x, run(), cfg)
            print(f"{key}, {tuple(x.tab.shape)}: kernel device time "
                  f"{times[key]:.4f} ms (L2 flushed), "
                  f"{times[f'{key} warm L2']:.4f} ms (warm), per call "
                  f"{times[f'{key} per call']:.4f} ms, plain "
                  f"{times[f'{key} plain']:.4f} ms; the packed gather it "
                  f"no longer needs {times[f'{key} packed gather']:.4f} ms; "
                  f"bound {bounds[key]}")
        ok_d, x_d, nx_d = ok_t, x_t.to(dtype), nx_t.to(dtype)
        key = f"distinct_counts {name}"
        run = lambda: distinct_kernel.distinct_counts(ok_d, x_d, nx_d)
        times[key] = device_ms(run, flush=flush)
        times[f"{key} warm L2"] = device_ms(run)
        times[f"{key} per call"] = call_ms(run)
        times[f"{key} plain"] = call_ms(
            lambda: distinct_kernel.distinct_counts_plain(
                ok_d, x_d, x_d < nx_d[:, None], dtype))
        bounds[key] = distinct_bound(ok_d, x_d)
        print(f"{key}, {tuple(x_d.shape)}: kernel device time "
              f"{times[key]:.4f} ms (L2 flushed), "
              f"{times[f'{key} warm L2']:.4f} ms (warm), per call "
              f"{times[f'{key} per call']:.4f} ms, plain "
              f"{times[f'{key} plain']:.4f} ms, bound {bounds[key]}")
    del flush
    for rnd in ("seed", "updated"):
        g, cfg = graph(FULL, torch.float64)
        g = pipeline.prepare(g, cfg)
        if rnd == "updated":
            for i in (1, 2):
                g, _ = pipeline.iteration(g, cfg, i)
        key = f"cluster stage {rnd} float64"
        times[key] = call_ms(
            lambda: clustering.cluster(g, cfg, rnd == "updated"), reps=10)
        print(f"{key} (core_inputs, kernel, scatter; CUDA events, one host "
              f"sync inside): {times[key]:.4f} ms")

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        g, cfg = graph(FULL, dtype)
        pipeline.run_pipeline_fast(g, cfg)                   # warm-up
        walls = [sync_time(lambda: pipeline.run_pipeline_fast(g, cfg))[1]
                 for _ in range(3)]
        print(f"run_pipeline_fast full event {name}: per-event wall "
              f"{[round(w, 4) for w in walls]} s, best {min(walls):.4f} s")

        def stages():
            out = {}
            gg, t = sync_time(lambda: pipeline.prepare(g, cfg))
            out["prepare"] = t
            for i in (1, 2, 3):
                if i % 2 == 0:
                    gg, t = sync_time(lambda: pipeline.extrapolation_stage(gg, cfg))
                else:
                    gg, t = sync_time(lambda: pipeline.cluster_stage(gg, cfg, i > 1))
                out[f"stage{i}"] = t
                res, t = sync_time(lambda: extract.extract_candidates(gg, cfg))
                out[f"extract{i}"] = t
                gg = extract.apply_extraction(gg, res, cfg)
                if i % 2 == 0:
                    gg, t = sync_time(lambda: metadata.remove_state_metadata(gg, cfg))
                    out["metadata2"] = t
            return out

        stages()
        st = stages()
        print(f"per-stage wall {name} (ms): " + ", ".join(
            f"{k} {v * 1e3:.2f}" for k, v in st.items()))

        n_ev = 3
        t0 = time.perf_counter()
        n_cand = sum(len(r.candidates) for r in pipeline.stream_pipeline(
            (graph(FULL, dtype)[0] for _ in range(n_ev)), cfg))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"stream_pipeline {n_ev} full events {name} (ingest included): "
              f"{dt:.3f} s = {n_ev / dt:.3f} events/s, {n_cand} candidates")

    phase("7. the host driver: run_pipeline with the extraction-leak replay")
    from tools import validate_port_vs_reference as vpr
    print(f"card: {card}")

    def candidates_match(a, b, rtol):
        return (len(a.candidates) == len(b.candidates) and all(
            x.iteration == y.iteration and np.array_equal(x.nodes, y.nodes)
            and np.allclose([x.pval_xy, x.pval_zr], [y.pval_xy, y.pval_zr],
                            rtol=rtol, atol=0)
            for x, y in zip(a.candidates, b.candidates)))

    for path in (VOL7, FULL):
        graph(path, torch.float64)     # warm-up; reads the npz if needed
        (_, cfg), t_cached = sync_time(lambda: graph(path, torch.float64))
        xyzr, vivl, tp, pairs, extra, pre = events[path]
        _, t_tracker = sync_time(lambda: build_event(
            xyzr, vivl, tp, pairs, cfg, device=cuda, mirror=pre["mirror"],
            component=pre["component"], node_ids=extra["node_ids"]))

        def ingest(device):
            return build_event(xyzr, vivl, tp, pairs, cfg, device=device,
                               node_ids=extra["node_ids"])

        (g, host), t_ingest = sync_time(lambda: ingest(cuda))
        check(np.array_equal(host.mirror, pre["mirror"]),
              f"{path.name}: recomputed mirror differs from the cached one")
        print(f"{path.name} ingest: cached mirror {t_cached:.3f} s; cached "
              f"mirror + tracker {t_tracker:.3f} s (tracker build "
              f"{t_tracker - t_cached:.3f} s); tracker + recomputed mirror "
              f"and components {t_ingest:.3f} s; the recomputed mirror "
              f"equals the cached one ({host.mirror.shape[0]} edges)")
        replay = []
        merges = host.tracker.extraction_merges

        def timed_merges(*args):
            t0 = time.perf_counter()
            muts = merges(*args)
            replay.append(time.perf_counter() - t0)
            return muts

        host.tracker.extraction_merges = timed_merges
        cluster_kernel.cluster_core.launches = 0
        distinct_kernel.distinct_counts.launches = 0
        out, t_host = sync_time(lambda: pipeline.run_pipeline(
            g, cfg, tracker=host.tracker))
        path_launches = {
            "gmr_cluster": cluster_kernel.cluster_core.launches,
            "distinct_counts": distinct_kernel.distinct_counts.launches}
        per_it = counts(out, cfg)
        print(f"{path.name} run_pipeline(tracker) float64: accepted {per_it} "
              f"(reference {EXPECTED_F64[path]}), wall {t_host:.3f} s; "
              f"mutations per extraction {[len(m) for m in out.mutations]}, "
              f"leak replay per extraction {[round(t, 3) for t in replay]} s; "
              f"kernel launches {path_launches}")
        check(per_it == EXPECTED_F64[path],
              f"{path.name} run_pipeline(tracker) counts")
        check(len(out.mutations[0]) > 0,
              f"{path.name}: the leak replay found no merge")
        check(all(v > 0 for v in path_launches.values()),
              "a kernel was not launched by run_pipeline")
        if path == FULL:
            host_launches = path_launches
        else:
            # the leak path on the card against the same driver on CPU
            # tensors (held to the JAX driver by tests/test_torch_driver.py)
            g_cpu, host_cpu = ingest(torch.device("cpu"))
            ref = pipeline.run_pipeline(g_cpu, cfg, tracker=host_cpu.tracker)
            check(out.mutations == ref.mutations,
                  f"{path.name}: mutations differ between card and CPU")
            # p-values: rtol 1e-6.  The card's atan2/sin/cos differ from the
            # CPU's in the last ulp, and the track fit is ill-conditioned:
            # one ulp on each rotated coordinate moves the volume-7
            # p-values by up to 1.5e-8 relative on the CPU
            pv = lambda r: np.array([(c.pval_xy, c.pval_zr)
                                     for c in r.candidates])
            p_card, p_cpu = pv(out), pv(ref)
            if p_card.shape == p_cpu.shape:
                nz = p_cpu != 0
                print(f"{path.name} card vs CPU: max relative p-value diff "
                      f"{np.max(np.abs(p_card - p_cpu)[nz] / p_cpu[nz])}")
            check(candidates_match(out, ref, 1e-6),
                  f"{path.name}: candidates differ between card and CPU")
            errs = {}
            for name in ("gnn_xyzr", "out_head_xyzr", "upd_sv", "upd_cov"):
                a, b = getattr(out.graph, name).cpu(), getattr(ref.graph, name)
                torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14,
                                           msg=f"{path.name} {name}")
                errs[name] = float((a - b).abs().max())
            print(f"{path.name} run_pipeline(tracker) on the card vs on the "
                  f"CPU: mutations and candidate nodes identical, p-values "
                  f"within rtol 1e-6, states within rtol 1e-12 (max "
                  f"|diff|: {errs})")
        plain, t_plain = sync_time(lambda: pipeline.run_pipeline(g, cfg))
        fast = pipeline.run_pipeline_fast(g, cfg)
        check(candidates_match(plain, fast, 1e-12),
              f"{path.name}: run_pipeline without a tracker differs from "
              "run_pipeline_fast")
        print(f"{path.name} run_pipeline without a tracker (host CCA): "
              f"{t_plain:.3f} s, candidates identical to run_pipeline_fast")

    res = vpr.compare(vpr.load_digest(), vpr.compute_port_states(cuda))
    check((res["seed_cmp"], res["clus_cmp"], res["upd_cmp"])
          == (14766, 8748, 434), "reference digest: compared counts")
    check(all(v == 1.0 for k, v in res.items() if not k.endswith("_cmp")),
          f"reference digest: {res}")
    print("reference digest at volume 7 on the card: 1.0 on every check")

    csv_dir = REPO / "build" / "smoke_csv"
    shutil.rmtree(csv_dir, ignore_errors=True)
    xyzr, vivl, tp, pairs, extra, pre = events[VOL7]
    paths = trackml.write_csvs(csv_dir, xyzr, vivl, pairs, extra)
    nx, nv, nt, npairs, nex = native_loader.load_event_arrays_native(
        paths.nodes_csv, paths.edges_csv, paths.truth_csv, 7, 7)
    check(np.allclose(nx, xyzr, rtol=1e-15, atol=0)
          and np.array_equal(nv, vivl) and np.array_equal(nt, tp)
          and np.array_equal(npairs, pairs)
          and np.array_equal(nex["node_ids"], extra["node_ids"])
          and np.array_equal(nex["components"], pre["component"]),
          "CSV round trip: the loader's arrays differ from the cache's")
    cfg = PipelineConfig()
    (g, host), t_csv = sync_time(lambda: trackml.load_event(
        paths, cfg, device=cuda, cache_dir=csv_dir / "cache"))
    check(np.array_equal(host.mirror, pre["mirror"]), "CSV ingest mirror")
    per_it = counts(pipeline.run_pipeline(g, cfg, tracker=host.tracker), cfg)
    check(per_it == EXPECTED_F64[VOL7], "CSV ingest run_pipeline counts")
    print(f"volume 7 as CSV through the C++ loader: arrays equal the cache's, "
          f"load_event {t_csv:.3f} s, run_pipeline(tracker) {per_it}")
    shutil.rmtree(csv_dir, ignore_errors=True)

    kernels = [
        {"name": "gmr_cluster", "route": "cuda", "source": CLUSTER_SOURCE,
         "replaces": CLUSTER_REPLACES, "launches": launches["gmr_cluster"],
         "launches_run_pipeline": host_launches["gmr_cluster"],
         "max_abs_err": record["cluster_max_abs_err"],
         "ms": times["gmr_cluster seed float64"],
         "ms_warm_l2": times["gmr_cluster seed float64 warm L2"],
         "plain_ms": times["gmr_cluster seed float64 plain"],
         **{k: bounds["gmr_cluster seed float64"][k]
            for k in ("bound_ms", "bound_by")},
         "library_ms": None,
         "shape": "full event, seed round, float64",
         "updated_round": {
             "ms": times["gmr_cluster updated float64"],
             "ms_warm_l2": times["gmr_cluster updated float64 warm L2"],
             "plain_ms": times["gmr_cluster updated float64 plain"],
             **bounds["gmr_cluster updated float64"]},
         "times": {k: v for k, v in times.items()
                   if k.startswith(("gmr_cluster", "cluster stage"))},
         "occupancy": {k: v for k, v in occupancy.items()
                       if k.startswith("gmr_cluster")}},
        {"name": "distinct_counts", "route": "cuda", "source": DISTINCT_SOURCE,
         "replaces": DISTINCT_REPLACES,
         "launches": launches["distinct_counts"],
         "launches_run_pipeline": host_launches["distinct_counts"],
         "max_abs_err": record["distinct_max_abs_err"],
         "ms": times["distinct_counts float64"],
         "ms_warm_l2": times["distinct_counts float64 warm L2"],
         "plain_ms": times["distinct_counts float64 plain"],
         **{k: bounds["distinct_counts float64"][k]
            for k in ("bound_ms", "bound_by")},
         "library_ms": None,
         "shape": "full event reweight tables (57,344 x 64), float64",
         "times": {k: v for k, v in times.items()
                   if k.startswith("distinct_counts")},
         "occupancy": {k: v for k, v in occupancy.items()
                       if k.startswith("distinct_counts")}},
    ]
    print()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
