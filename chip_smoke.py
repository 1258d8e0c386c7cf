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
     event written as CSV files and read back through the C++ loader;
  8. the calibration, toy and evaluation paths at float64: the runner's
     toy run (50 tracks, seed 1) and its efficiency report against the JAX
     package's; the runner's calibration (20 toy events, seed 0, quantile
     LUT on emp_var) on the card, its rows and LUT bins against the JAX
     package's and its KL values against the same calibration on CPU
     tensors; the KL training rows of the full event on the card against
     the same function on CPU tensors; the clustering kernel against its
     plain version under the LUT's per-node thresholds (both rounds of the
     full event, bitwise; device time and bound); the calibrated full-event
     run_pipeline with the tracker against the JAX package's counts;
     stats_harness.accumulate_pvals over 10 toy runs against CPU tensors;
     and `python -m gnn_track_finding_tpu_torch.run --toy` and
     `--event <volume 7> --calibrate` as subprocesses;
  9. the edge-partitioned schedule (parallel/edge_shard.py) on the full
     event at float64: 2 ranks over gloo on this one card (rank processes
     started with spawn, after phase 2 built the kernels), then 1 rank
     over NCCL, each against the single-device port (counts, candidates,
     the gathered state: masks and integers exact, floats rtol 1e-12 and
     grad_stats' variances to 1e-12 of their second moment); volume 7
     twice through run_batched on a (2, 1) mesh, each event bitwise the
     single-device run's; both kernels against their plain versions on
     each rank's owner rows (both clustering rounds, the first reweight
     pass), bitwise, and their device times and bounds there; the
     sharded per-event wall (best of 3), the census of collectives (bytes
     per collective and caller), and each kernel's launches per rank.
     Two ranks on one card measure the code path, not scaling.

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
# The JAX package's answers on its runner's toy and calibration paths at
# float64 on the CPU (tools/jax_runner_constants.py): the toy run
# (run.py --toy), the calibration rows and quantile LUT (run.py
# --calibrate) and the calibrated run_pipeline with the tracker
EXPECTED_TOY = {"per_iteration": [13, 1, 0], "num_reference": 50,
                "num_reconstructed": 14, "efficiency_pct": 28.0,
                "track_purities": [1.0] * 14, "particle_purities": [1.0] * 14,
                "pure": 14}
EXPECTED_CALIBRATION = {
    "rows": 2858,
    "lower": [0, 0, 4, 0, 25] + [0] * 23,
    "upper": [1, 45, 95, 1, 26, 50, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
              0, 0, 0, 0, 0, 0, 0, 1, 20],
    "feature_bin_width": 705.5111035114334,
    "kl_bin_width": 4339417.077760651}
EXPECTED_CALIBRATED_F64 = {VOL7: [1022, 14, 0], FULL: [1468, 71, 0]}
# KL training rows of the full event (the port on CPU tensors)
FULL_TRAINING_ROWS = 1_956_687
TRAINING_BLOCK, CPU_TRAINING_BLOCK = 2048, 256
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


def core_case(label, inputs, cfg, dtype, chi2_thr, check_found=True):
    """The kernel against the plain version: bitwise at float64, the
    flag band at float32.  Returns the largest |diff|."""
    from gnn_track_finding_tpu_torch.ops import cluster_kernel
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


def calibration_phase(card, cuda, graph, counts, events):
    """Phase 8: the runner's toy, calibration and evaluation paths at
    float64 on the card.  Returns the clustering kernel's record under the
    LUT thresholds and both kernels' launches in the calibrated full-event
    run."""
    import re

    from gnn_track_finding_tpu_torch.analysis import stats_harness
    from gnn_track_finding_tpu_torch.calib import lut, training_data
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.evaluation import efficiency
    from gnn_track_finding_tpu_torch.graph import state as tstate
    from gnn_track_finding_tpu_torch.graph.build import build_event
    from gnn_track_finding_tpu_torch.models import pipeline, toymc
    from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                                 distinct_kernel)
    cpu = torch.device("cpu")
    f64 = torch.float64
    print(f"card: {card}")

    def zero_launches():
        cluster_kernel.cluster_core.launches = 0
        distinct_kernel.distinct_counts.launches = 0

    def launches():
        return {"gmr_cluster": cluster_kernel.cluster_core.launches,
                "distinct_counts": distinct_kernel.distinct_counts.launches}

    def max_rel(a, b):
        nz = b != 0
        return float(np.max(np.abs(a - b)[nz] / np.abs(b[nz]))) if nz.any() else 0.0

    # -- the toy run of `run.py --toy`
    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    ev = toymc.generate_event(num_tracks=50, seed=1)
    g, host = build_event(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                          device=cuda)
    zero_launches()
    out, t_toy = sync_time(lambda: pipeline.run_pipeline(
        g, cfg, tracker=host.tracker))
    toy_launches = launches()
    lists = [c.nodes for c in out.candidates]
    rep = efficiency.evaluate_toy(lists, ev.truth, ev.vivl, cfg)
    toy = {"per_iteration": counts(out, cfg),
           "num_reference": rep.num_reference,
           "num_reconstructed": rep.num_reconstructed,
           "efficiency_pct": rep.efficiency_pct,
           "track_purities": rep.track_purities.tolist(),
           "particle_purities": rep.particle_purities.tolist(),
           "pure": efficiency.pure_candidates(lists, ev.truth)}
    print(f"toy run (50 tracks, seed 1), run_pipeline(tracker): {toy}; "
          f"{t_toy:.3f} s; kernel launches {toy_launches}")
    check(toy == EXPECTED_TOY, "toy run or report differs from the JAX "
          f"package's {EXPECTED_TOY}")
    check(all(v > 0 for v in toy_launches.values()),
          "a kernel was not launched by the toy run")

    # -- the calibration of `run.py --calibrate`
    def calibrate(device):
        return training_data.generate_training_data(num_events=20, seed=0,
                                                    device=device)

    rows, t_cal = sync_time(lambda: calibrate(cuda))
    table = lut.fit_lut_quantile(rows, feature="emp_var")
    rows_cpu, t_cal_cpu = sync_time(lambda: calibrate(cpu))
    exp = EXPECTED_CALIBRATION
    print(f"calibration on the card: {rows.shape[0]} rows in {t_cal:.3f} s "
          f"(CPU tensors {t_cal_cpu:.3f} s); LUT lower {table.lower.tolist()}, "
          f"upper {table.upper.tolist()}, bin widths "
          f"{table.feature_bin_width!r} / {table.kl_bin_width!r}; KL card vs "
          f"CPU max relative diff {max_rel(rows[:, 0], rows_cpu[:, 0]):.3e}")
    check(rows.shape[0] == exp["rows"] and table.lower.tolist() == exp["lower"]
          and table.upper.tolist() == exp["upper"],
          "calibration rows or LUT bins differ from the JAX package's")
    check(np.allclose([table.feature_bin_width, table.kl_bin_width],
                      [exp["feature_bin_width"], exp["kl_bin_width"]],
                      rtol=1e-12, atol=0), "LUT bin widths")
    check(rows.shape == rows_cpu.shape
          and np.array_equal(rows[:, 2:], rows_cpu[:, 2:]),
          "calibration rows: degree or truth differ between card and CPU")
    check(np.allclose(rows[:, 0], rows_cpu[:, 0], rtol=1e-9, atol=0),
          "calibration KL differs between card and CPU")
    # emp_var: a per-node variance summed in another order on the card;
    # near-cancelling gradients leave a few 1e-17 absolute
    check(np.allclose(rows[:, 1], rows_cpu[:, 1], rtol=1e-9, atol=1e-14,
                      equal_nan=True),
          "calibration emp_var differs between card and CPU")

    # -- KL training rows of the full event
    g_raw, cfg_full = graph(FULL, f64)
    g_full = pipeline.prepare(g_raw, cfg_full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    meta, t_meta = sync_time(lambda: training_data.extract_metadata_trackml(
        cfg_full, g_full, block=TRAINING_BLOCK))
    peak = torch.cuda.max_memory_allocated() - base
    g_full_cpu = tstate.from_numpy(
        g_full.to_numpy(), n_nodes=g_full.n_nodes, n_edges=g_full.n_edges,
        max_degree=g_full.max_degree, n_layers=g_full.n_layers, device=cpu,
        dtype=f64)
    # the rows come in (node, i, j) order whatever the block; the CPU
    # takes smaller blocks, whose temporaries stay in its caches
    meta_cpu, t_meta_cpu = sync_time(
        lambda: training_data.extract_metadata_trackml(
            cfg_full, g_full_cpu, block=CPU_TRAINING_BLOCK))
    print(f"full-event training rows: {meta.shape[0]} at block "
          f"{TRAINING_BLOCK}, {t_meta:.3f} s on the card (peak "
          f"{peak / 2**30:.2f} GiB above the state), {t_meta_cpu:.3f} s on "
          f"CPU tensors at block {CPU_TRAINING_BLOCK}; KL max relative diff "
          f"{max_rel(meta[:, 0], meta_cpu[:, 0]):.3e}")
    check(meta.shape == meta_cpu.shape == (FULL_TRAINING_ROWS, 4),
          "full-event training row count")
    # emp_var is NaN at nodes whose gradient variance is undefined
    check(np.array_equal(meta[:, 1:], meta_cpu[:, 1:], equal_nan=True),
          "full-event training rows: emp_var, degree or truth differ")
    check(np.allclose(meta[:, 0], meta_cpu[:, 0], rtol=1e-9, atol=0),
          "full-event training KL differs between card and CPU")

    # -- the clustering kernel under the LUT's per-node thresholds
    thr = lut.node_thresholds(table, g_raw, cfg_full)
    n_nan = int(torch.isnan(g_full.grad_stats[:g_full.n_nodes, 1]).sum())
    levels, per = np.unique(thr[:g_full.n_nodes].cpu().numpy(),
                            return_counts=True)
    print(f"LUT thresholds of the full event's {g_full.n_nodes} nodes "
          f"({n_nan} NaN emp_var, in "
          f"bin 0): {dict(zip(levels.tolist(), per.tolist()))}")
    g2 = g_full
    for i in (1, 2):
        g2, _ = pipeline.iteration(g2, cfg_full, i, thr)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=cuda)
    lut_record = {}
    for rnd, x in (("seed", clustering.core_inputs(g_full, cfg_full, False,
                                                   thr)),
                   ("updated", clustering.core_inputs(g2, cfg_full, True,
                                                      thr))):
        inputs = (x.states, x.tab, x.node_xyzr, x.klthr)
        lv, n_lv = torch.unique(x.klthr, return_counts=True)
        rows_per = dict(zip(lv.tolist(), n_lv.tolist()))
        core_case(f"{rnd} round float64 under the LUT thresholds", inputs,
                  cfg_full, f64, x.chi2_thr)

        def run():
            return cluster_kernel.cluster_core(*inputs, chi2_thr=x.chi2_thr,
                                               cfg=cfg_full)

        rec = {"rows": int(x.tab.shape[0]), "rows_per_threshold": rows_per,
               "ms": device_ms(run, flush=flush), "ms_warm_l2": device_ms(run),
               "plain_ms": call_ms(lambda: cluster_kernel.cluster_core_plain(
                   *inputs, chi2_thr=x.chi2_thr, cfg=cfg_full), reps=5),
               **cluster_bound(x, run(), cfg_full)}
        lut_record[rnd] = rec
        print(f"gmr_cluster {rnd} round under the LUT thresholds, "
              f"{tuple(x.tab.shape)}, rows per threshold {rows_per}: kernel "
              f"device time {rec['ms']:.4f} ms (L2 flushed), "
              f"{rec['ms_warm_l2']:.4f} ms (warm), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}: {rec['bytes']} bytes, {rec['ops']} ops)")
    del flush

    # -- the calibrated full-event run of the host driver
    xyzr, vivl, tp, pairs, extra, pre = events[FULL]
    g, host = build_event(xyzr, vivl, tp, pairs, cfg_full, device=cuda,
                          mirror=pre["mirror"], component=pre["component"],
                          node_ids=extra["node_ids"])
    replay = []
    merges = host.tracker.extraction_merges

    def timed_merges(*args):
        t0 = time.perf_counter()
        muts = merges(*args)
        replay.append(time.perf_counter() - t0)
        return muts

    host.tracker.extraction_merges = timed_merges
    zero_launches()
    out, t_run = sync_time(lambda: pipeline.run_pipeline(
        g, cfg_full, kl_thresholds=thr, tracker=host.tracker))
    calibrated_launches = launches()
    per_it = counts(out, cfg_full)
    print(f"{FULL.name} calibrated run_pipeline(tracker) float64: accepted "
          f"{per_it} (JAX package {EXPECTED_CALIBRATED_F64[FULL]}), wall "
          f"{t_run:.3f} s; mutations per extraction "
          f"{[len(m) for m in out.mutations]}, leak replay per extraction "
          f"{[round(t, 3) for t in replay]} s; kernel launches "
          f"{calibrated_launches}")
    check(per_it == EXPECTED_CALIBRATED_F64[FULL],
          "calibrated full-event counts differ from the JAX package's")
    check(all(v > 0 for v in calibrated_launches.values()),
          "a kernel was not launched by the calibrated run")

    # -- p-value statistics over toy runs
    def stats(device):
        return stats_harness.accumulate_pvals(num_runs=10, seed=0,
                                              device=device)

    st, t_st = sync_time(lambda: stats(cuda))
    st_cpu = stats(cpu)
    diffs = [max_rel(st[k], st_cpu[k]) for k in ("pvals_xy", "pvals_zr")]
    uni = {k: stats_harness.uniformity_check(st[k])
           for k in ("pvals_xy", "pvals_zr")}
    print(f"accumulate_pvals over 10 toy runs: {st['pvals_xy'].size} "
          f"candidates in {t_st:.3f} s; card vs CPU max relative p-value diff "
          f"{diffs}; uniformity {uni}")
    check(np.array_equal(st["purity"], st_cpu["purity"]) and all(
        np.allclose(st[k], st_cpu[k], rtol=1e-6, atol=0)
        for k in ("pvals_xy", "pvals_zr")),
        "accumulate_pvals differs between card and CPU")

    # -- the runner's new paths as a user calls them
    for args, want in ((["--toy"], EXPECTED_TOY["per_iteration"]),
                       (["--event", str(VOL7), "--calibrate"],
                        EXPECTED_CALIBRATED_F64[VOL7])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gnn_track_finding_tpu_torch.run", *args],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        print(f"run.py {' '.join(args)}: exit {proc.returncode} in "
              f"{dt:.2f} s")
        for line in lines:
            print("  " + line)
        check(proc.returncode == 0, f"run.py {args}: {proc.stderr[-2000:]}")
        found = [re.search(r"candidates (\[[0-9, ]*\])", line)
                 for line in lines if line.startswith("[pipeline]")]
        check(bool(found) and found[0] is not None
              and json.loads(found[0].group(1)) == want,
              f"run.py {args}: counts differ from {want}")
    return lut_record, calibrated_launches


def sharded_phase(card, cuda, graph):
    """Phase 9: the edge-partitioned schedule.  Returns each kernel's
    record on the owner rows and its launches per rank on the sharded
    path."""
    from collections import defaultdict

    from gnn_track_finding_tpu_torch import testing
    from gnn_track_finding_tpu_torch.models import pipeline
    from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                                 distinct_kernel)
    f64 = torch.float64
    out_dir = REPO / "build" / "smoke_sharded"
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"card: {card}")

    def single(path):
        g, cfg = graph(path, f64)
        res = pipeline.full_pipeline_results(g, cfg)
        return res, res.graph.to_numpy()

    def same_candidates(rank_out, res, rtol):
        return (rank_out["acc_count"] == res.acc_count.tolist()
                and np.array_equal(rank_out["acc_nodes"],
                                   res.acc_nodes.cpu().numpy())
                and np.allclose(rank_out["acc_pvals"],
                                res.acc_pvals.cpu().numpy(), rtol=rtol,
                                atol=0))

    ref, ref_graph = single(FULL)
    ref7, ref7_graph = single(VOL7)
    check(ref.acc_count.tolist() == EXPECTED_F64[FULL],
          "single-device full-event counts")
    schedule = dict(event={"npz": str(FULL)}, reps=3, check_kernels=True)
    # the 2 gloo ranks also run run_batched: volume 7 twice on a (2, 1) mesh
    t0 = time.perf_counter()
    gloo = testing.spawn_ranks(
        "sequence", 2, out_dir / "gloo", device="cuda:0", timeout=300,
        jobs=[("schedule", dict(schedule, kernel_inputs=True)),
              ("batched", dict(events=[{"npz": str(VOL7)}] * 2,
                               shape=(2, 1)))]).join()
    t_gloo = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = testing.spawn_ranks("schedule", 1, out_dir / "nccl",
                               backend="nccl", device="cuda:0", timeout=300,
                               **schedule).join()
    runs = {"gloo": [r[0] for r in gloo], "nccl": nccl}
    print(f"rank processes: gloo world of 2 {t_gloo:.1f} s, NCCL world of 1 "
          f"{time.perf_counter() - t0:.1f} s (start, ingest, runs, checks)")
    for backend, label in (("gloo", "gloo, 2 ranks on cuda:0"),
                           ("nccl", "NCCL, 1 rank")):
        ranks = runs[backend]
        r0 = ranks[0]
        bad = testing.states_differ(ref_graph, r0["graph"], rtol=1e-12)
        bitwise = not testing.states_differ(ref_graph, r0["graph"], rtol=0.0)
        print(f"{FULL.name} schedule_sharded float64, {label}: accepted "
              f"{r0['acc_count']} (single device {ref.acc_count.tolist()}), "
              f"FastSV rounds {r0['cca_rounds']}, bucket {r0['bucket']}; "
              f"per-event wall {[round(w, 4) for w in r0['walls']]} s, best "
              f"{min(r0['walls']):.4f} s (single device: see phase 6); "
              f"gathered state within the bars: {not bad}, bitwise: "
              f"{bitwise}")
        check(r0["acc_count"] == EXPECTED_F64[FULL], f"{label}: counts")
        check(same_candidates(r0, ref, 1e-12), f"{label}: candidates differ "
              "from the single-device port's")
        check(not bad, f"{label}: gathered state differs: {bad}")
        for rank, o in enumerate(ranks):
            print(f"  rank {rank}: kernel launches {o['launches']}; owner "
                  f"rows against the plain versions {o['kernel_checks']}")
            check(all(v > 0 for v in o["launches"].values()),
                  f"{label}: rank {rank} launched a kernel no time")
            check(all(c["bitwise"] for c in o["kernel_checks"].values()),
                  f"{label}: rank {rank}: a kernel differs from its plain "
                  "version on the owner rows")
            check(o["acc_count"] == r0["acc_count"],
                  f"{label}: ranks disagree on the candidates")
        census = defaultdict(lambda: [0, 0])
        for c in r0["census"]:
            key = (c["caller"], c["op"], c["dtype"])
            census[key][0] += 1
            census[key][1] += c["bytes"]
        print(f"  census of one run (rank 0 sends; caller, collective, "
              f"dtype: calls, bytes): {sum(v[1] for v in census.values())} "
              f"bytes in {sum(v[0] for v in census.values())} collectives")
        for key, (n, b) in sorted(census.items()):
            print(f"    {key}: {n}, {b}")
        on_host = sorted({c["op"] for o in ranks for c in o["census"]
                          if c["device"] != "cuda"})
        check(not on_host, f"{label}: collectives on host tensors: {on_host}")
        print(f"  host-staged collectives: none ({backend} was handed the "
              f"CUDA tensors of all {len(r0['census'])} collectives)")

    per_event = {i: o for r in gloo for i, o in r[1].items()}
    check(sorted(per_event) == [0, 1], "run_batched: events per rank")
    for i, o in sorted(per_event.items()):
        check(same_candidates(o, ref7, 0.0)
              and not testing.states_differ(ref7_graph, o["graph"], rtol=0.0),
              f"run_batched event {i} differs from the single-device run")
    print(f"run_batched on a (2, 1) mesh (the gloo ranks), volume 7 twice: "
          f"accepted {[per_event[i]['acc_count'] for i in (0, 1)]}, each "
          f"event bitwise the single-device run's")

    # -- both kernels on rank 0's owner rows (D = 2): device time, plain
    # version and bound, as in phase 6
    cfg = graph(FULL, f64)[1]
    inputs = runs["gloo"][0]["kernel_inputs"]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=cuda)
    owner = {}
    put = lambda a: torch.from_numpy(a).to(cuda)
    for rnd in ("seed", "updated"):
        a = inputs[f"cluster_{rnd}"]
        x = clustering.CoreInputs(
            ids=None, tab=put(a["tab"]),
            states=cluster_kernel.unpack_states(put(a["packed"])),
            node_xyzr=put(a["node_xyzr"]), klthr=put(a["klthr"]),
            chi2_thr=a["chi2_thr"], member_slot=None)
        args = (x.states, x.tab, x.node_xyzr, x.klthr)
        core_case(f"owner rows (rank 0 of 2), {rnd} round float64", args,
                  cfg, f64, x.chi2_thr, check_found=x.tab.shape[0] > 0)

        def run():
            return cluster_kernel.cluster_core(*args, chi2_thr=x.chi2_thr,
                                               cfg=cfg)

        rec = {"rows": int(x.tab.shape[0]),
               "ms": device_ms(run, flush=flush), "ms_warm_l2": device_ms(run),
               "plain_ms": call_ms(lambda: cluster_kernel.cluster_core_plain(
                   *args, chi2_thr=x.chi2_thr, cfg=cfg), reps=5),
               **cluster_bound(x, run(), cfg)}
        owner[f"gmr_cluster {rnd}"] = rec
    a = inputs["distinct"]
    ok, xx, nx = put(a["ok"]), put(a["x"]), put(a["node_x"])
    run = lambda: distinct_kernel.distinct_counts(ok, xx, nx)
    check(torch.equal(run(), distinct_kernel.distinct_counts_plain(
        ok, xx, xx < nx[:, None], f64)), "distinct counts on the owner rows")
    owner["distinct_counts"] = {
        "rows": int(ok.shape[0]), "ms": device_ms(run, flush=flush),
        "ms_warm_l2": device_ms(run),
        "plain_ms": call_ms(lambda: distinct_kernel.distinct_counts_plain(
            ok, xx, xx < nx[:, None], f64)), **distinct_bound(ok, xx)}
    del flush
    for key, rec in owner.items():
        print(f"{key} on rank 0's owner rows ({rec['rows']} rows): kernel "
              f"device time {rec['ms']:.4f} ms (L2 flushed), "
              f"{rec['ms_warm_l2']:.4f} ms (warm), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}: {rec['bytes']} bytes, {rec['ops']} ops)")
    launches = {name: {"gloo_2_ranks": [o["launches"][name]
                                        for o in runs["gloo"]],
                       "nccl_1_rank": runs["nccl"][0]["launches"][name]}
                for name in ("gmr_cluster", "distinct_counts")}
    shutil.rmtree(out_dir, ignore_errors=True)
    return owner, launches


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

    phase("8. calibration, toy and evaluation paths (float64)")
    lut_record, calibrated_launches = calibration_phase(card, cuda, graph,
                                                        counts, events)

    phase("9. the edge-partitioned schedule (float64)")
    owner, sharded_launches = sharded_phase(card, cuda, graph)

    kernels = [
        {"name": "gmr_cluster", "route": "cuda", "source": CLUSTER_SOURCE,
         "replaces": CLUSTER_REPLACES, "launches": launches["gmr_cluster"],
         "launches_run_pipeline": host_launches["gmr_cluster"],
         "launches_calibrated": calibrated_launches["gmr_cluster"],
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
         "lut_thresholds": lut_record,
         "launches_sharded": sharded_launches["gmr_cluster"],
         "owner_rows": {rnd: owner[f"gmr_cluster {rnd}"]
                        for rnd in ("seed", "updated")},
         "times": {k: v for k, v in times.items()
                   if k.startswith(("gmr_cluster", "cluster stage"))},
         "occupancy": {k: v for k, v in occupancy.items()
                       if k.startswith("gmr_cluster")}},
        {"name": "distinct_counts", "route": "cuda", "source": DISTINCT_SOURCE,
         "replaces": DISTINCT_REPLACES,
         "launches": launches["distinct_counts"],
         "launches_run_pipeline": host_launches["distinct_counts"],
         "launches_calibrated": calibrated_launches["distinct_counts"],
         "max_abs_err": record["distinct_max_abs_err"],
         "ms": times["distinct_counts float64"],
         "ms_warm_l2": times["distinct_counts float64 warm L2"],
         "plain_ms": times["distinct_counts float64 plain"],
         **{k: bounds["distinct_counts float64"][k]
            for k in ("bound_ms", "bound_by")},
         "library_ms": None,
         "shape": "full event reweight tables (57,344 x 64), float64",
         "launches_sharded": sharded_launches["distinct_counts"],
         "owner_rows": owner["distinct_counts"],
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
