"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

Drives the port's production driver (`run_pipeline_fast`, `stream_pipeline`)
on the committed TrackML event caches, captured as one CUDA graph per pad
bucket, and checks the three hand-written CUDA kernels against their
plain PyTorch versions on the card:

  1. device: a CUDA device is required; prints its name and power limit;
  2. build: compiles csrc/*.cu with nvcc (sm_90a), one process per source,
     and prints the time, ptxas registers and spills, and each kernel's
     resident blocks per SM;
  3. GMR clustering kernel vs plain, bitwise at float64, on the real
     compacted rows of the full event (seed round after prepare, updated
     round after iteration 2) at float64 and float32, kc = 4 and kc = 32,
     klthr 1e30 (full absorption), clean mode (bug_compat=False: the full
     KL trace and the z endcap coordinate; ingest with the identity mirror)
     in both rounds at float64, and the synthetic edge cases of
     testing.cluster_rows;
  4. distinct-count kernel vs plain, exact, on the real reweight tables
     (K = 64), a duplicate-rich table and the edge cases of
     testing.distinct_tables (K = 32, 40, 64, 128), at both dtypes;
  5. the slice, eager: float64 accepted counts per iteration on the
     volume-7 and full events against the reference's, the float32 counts
     beside the plain path's (the same schedule on CPU tensors), the
     kernels' launch counts in the main-path run, a 3-event stream (the
     captured program) against the solo run, and the clean-mode volume-7
     counts against the JAX package's;
  6. steady-state times: each kernel (device time with the L2 cache
     flushed before each call, and warm) and its plain version at the
     full-event shapes (both clustering rounds), the packed gather the
     kernel no longer needs, the clustering stage, each kernel's bound
     (the bytes and operations these inputs need, at 3.35 TB/s and the
     dtype's peak), the clean-mode rounds' times and bounds, per-stage and
     per-event wall times, streamed events/s;
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
     and `python -m gnn_track_finding_tpu_torch.run --toy --json` (its
     last line, the JSON summary, against the toy run) and
     `--event <volume 7> --calibrate` as subprocesses;
  9. the edge-partitioned schedule (parallel/edge_shard.py) on the full
     event at float64: 2 ranks over gloo on this one card (rank processes
     started with spawn, after phase 2 built the kernels), then 1 rank
     over NCCL (NCCL refuses two ranks on one card), each against the
     single-device port (counts, candidates, the gathered state: masks and
     integers exact, floats rtol 1e-12 and grad_stats' variances to 1e-12
     of their second moment); volume 7 twice through run_batched on a
     (2, 1) gloo mesh (an edge group of one rank: each data rank's event
     one captured program, with no collective), each event bitwise the
     single-device run's; both kernels against their plain
     versions on each rank's owner rows (both clustering rounds, the
     first reweight pass; the static (N / D)-row table with its device
     count), bitwise, and their device times and bounds there; the
     sharded per-event wall (best of 3), the census of collectives (bytes
     per collective and caller), and each kernel's launches per rank.
     The NCCL rank's run_sharded captures the whole schedule as one CUDA
     graph, its collectives inside: the first call, a replay and a replay
     under torch.cuda.set_sync_debug_mode("error") bitwise the eager
     program and the single-device run; the per-event wall, captured and
     eager in turns, best of 5; capture and instantiate seconds, the graph
     pool, the kernels' launches per replay, no fallback; and run_batched
     on a (1, 1) NCCL mesh over volume 7 twice, the two events as one
     batched program captured, each event bitwise the single-device
     run's.  A failed capture raises.
     Two ranks on one card measure the code path, not scaling;
 10. the analysis and calibration studies at float64, each on the card
     against the same call on CPU tensors, with both kernels' launches per
     study: shared_hits.dendrogram_statistics over 10 toy runs (both
     kernels), node_dendrogram_maxima on the full event after iteration 1's
     clustering and iteration 2's extrapolation, calib.plots.
     lut_effect_study (the clustering kernel under LUT thresholds) and
     parabolic_vs_linear, community.detect_communities (Leiden) on volume 7
     and the full event's final state (the filters), and the volume-7
     run's pvals.csv and purity CSVs read back.  The plots,
     plot_decision_boundary and the Louvain branch need matplotlib,
     sklearn or networkx, which the card's machine lacks: they run only in
     the CPU tests (tests/test_torch_studies.py).

The production drivers replay one captured CUDA graph per pad bucket;
phases 5 and 6 hold the eager schedule (`run_pipeline_eager`, the same
program run op by op), so their rows stay comparable with earlier runs:
 11. the captured schedule (models/pipeline.CapturedSchedule): volume 7
     and the full event at float64 and clean volume 7 through
     run_pipeline_fast against the reference's and the JAX package's
     counts, the captured results (first call and a replay) bitwise the
     eager ones at float64 and float32 (candidates, p-values, FastSV
     rounds, every field of the final state); capture and instantiate
     seconds and the graph pool per program, the kernels' launches in the
     capture (each replay makes them; the counters see only the warm-up
     and the capture); the per-event wall, captured and eager in turn,
     best of 5, with one replay's device time and the cost of copying an
     event in and cloning the final state out; the device-busy share of
     one event under torch.profiler, captured and eager; a replay under
     torch.cuda.set_sync_debug_mode("error"); streamed events/s over 8
     copies of the full event ingested through data/prefetch.prefetch
     (the first stream captures while the prefetch thread works); and no
     event falls back to the host driver.  Its record is printed as one
     JSON line;
 12. the kernel gate (testing.kernel_gate) on the full event at float64
     and float32, in this process: both kernels against their plain
     versions on the event's own inputs (bitwise at float64; at float32
     under 6% flag flips and rtol 1e-5), the accepted counts against the
     reference's [1504, 436, 9] at float64 and the eager schedule's at
     float32, every kernel launched.  Its record is printed as one JSON
     line, {"kernel_gate": ...};
 13. the event batch (parallel/mesh.stack_events,
     pipeline.run_pipeline_batched): copies of the full event rotated
     about the beam axis (testing.load_event: the same graph, other
     floats) as one captured program.  At float64, 4 copies (copy b by
     b * 2 pi / 4): each event's candidates, p-values, FastSV rounds and
     final state bitwise its own single-event replay and the batched
     eager run (first call and a replay), copy 0 at the reference's
     counts, 2 gmr_cluster, 3 distinct_counts and 3 kf_fit launches per
     replay, the kernels launched in the first call (counters zeroed just
     before it),
     the stack, replay and readback under
     torch.cuda.set_sync_debug_mode("error"); at float32 each event's
     counts equal to its single replay's.  Both kernels against their
     plain versions on the 4 events' inputs (the seed round's rows, the
     first reweight table), bitwise at float64 and in the gate's band at
     float32, with device times (L2 flushed and warm), plain times and
     bounds.  Events/s of one batched replay against B single replays in
     turn, each clock ending in torch.cuda.synchronize() (best of 3), on
     the full event at B = 1, 2, 4, 8 (float32) and 4 (float64) and on
     volume 7 at B = 1, 8, 32 (float32), with the device time of one
     replay, capture and instantiate seconds, the graph pool, the peak
     allocation and the launches per replay.  Its record, with the card,
     is printed as one JSON line, {"event_batch": ...};
 14. batched x edge-sharded execution at float64 (parallel/mesh.run_batched
     and edge_shard.run_sharded on a stack: a data rank's events as their
     union, edge-partitioned as one program per rank), on rotated copies
     of the full event.  2 gloo ranks on cuda:0 run run_batched on a
     (1, 2) mesh over 2 copies: one program per rank (64 collectives, 2
     gmr_cluster, 3 distinct_counts and 3 kf_fit launches per rank, not
     per event), path "eager", each event's candidates exact against its own
     single-device replay and its gathered state within the sharded bars
     (bitwise but grad_stats' variances, to 1e-12 of their second
     moment), copy 0 at the reference's counts, both kernels bitwise
     against their plain versions on each rank's owner rows of the union;
     per-rank live edges, peak allocation and the wall per batch against
     the 2 events through run_sharded in turn.  1 NCCL rank runs the
     4-copy stack through run_sharded: one captured program, its first
     call, a replay and a replay under torch.cuda.set_sync_debug_mode
     ("error") bitwise the eager body, each event bitwise its
     single-device batched replay, 2 / 3 launches per replay; capture,
     instantiate, pool, one replay's device time, events/s against 4
     single-event sharded replays in turn; both kernels' device times,
     plain times and bounds on the union's owner rows; then
     multihost.scaling_report over the 4 copies (sequential single-event
     replays against one batched program), its checksums equal and its
     data ranks min(4 events, 1 rank).  Its record is printed as one
     JSON line, {"batched_sharded": ...};
 15. the stage and part profile (gnn_track_finding_tpu_torch/
     profile_stages.profile) of the full event at float64 and float32 and
     of 4 rotated copies stacked at float64: each stage and part of the
     schedule captured alone, with its device time (L2 flushed and warm),
     launches, byte floor, launch floor and the rest of each stage, one
     FastSV round, and the whole schedule's replay.  It fails if a
     captured part differs from its eager output at float64, if the leaf
     rows do not hold 2 gmr_cluster, 3 distinct_counts and 3 kf_fit
     launches, if the stage rows' kernel time sums to more than 25% off one replay's (their
     CUDA-event times are printed beside), or if FastSV needed more than
     R_CAP rounds.  Its summary is printed as one JSON line,
     {"stage_profile": ...};
 16. the track-fit kernel (csrc/kf_fit.cu) against its plain version
     (the rotation and the torch fit loop) on the rows each of the three
     extractions hands it, as eager runs record them: the full event
     (14,400 rows) and volume 7 in 32 rotated copies stacked (98,368
     rows).  Chi2 sums and p-values bitwise at float64 and float32 in
     both bug_compat modes, one launch per call; the kernel's device
     time (L2 flushed and warm), the plain loop's (captured) and the
     bound from the bytes and operations those rows need.

Every phase raises on failure, so the script exits non-zero.  The line
before the last is the kernels' JSON record (with bound_ms and bound_by);
the last line is
{"ok": true, "device": {...}}.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gnn_track_finding_tpu_torch.utils.timing import (busy_share, call_ms,
                                                      device_ms, sync_time)

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
# ... and its clean-mode (bug_compat=False) run_pipeline_fast on volume 7
EXPECTED_CLEAN_F64 = [1056, 135, 1]
# KL training rows of the full event (the port on CPU tensors)
FULL_TRAINING_ROWS = 1_956_687
TRAINING_BLOCK, CPU_TRAINING_BLOCK = 2048, 256
CLUSTER_SOURCE = "gnn_track_finding_tpu_torch/csrc/gmr_cluster.cu"
DISTINCT_SOURCE = "gnn_track_finding_tpu_torch/csrc/distinct_counts.cu"
FIT_SOURCE = "gnn_track_finding_tpu_torch/csrc/kf_fit.cu"
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
    kc = x.tab.shape[1]
    rows = int(x.count)            # the live rows; the rest hold no member
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


# float operations of the fit kernel's pieces, as written in
# csrc/kf_fit.cu (each +, -, *, /, negation, abs and math-library call
# once): one hit rotated; a row's innermost edge and its two angles' sin
# and cos; one step of both planes (the parabola and var_ms 40, the OU
# transition 21, the xy update 264, the zr update 90, the two sums)
FIT_HIT, FIT_ROW, FIT_STEP = 14, 19, 417


def fit_bound(coords, n_hits) -> dict:
    """What one fit needs, counted from the rows of the run.  Bytes: per
    row with 2 or more hits its first n_hits slots (4 coordinates and the
    valid flag each; the rest of the row is never read); per row its
    n_hits and both chi2 sums.  Operations: per such row its innermost
    edge and first hit, per step one step and one rotated hit."""
    w = coords.element_size()
    c = coords.shape[0]
    n = torch.clamp(n_hits, max=coords.shape[1])
    n = n[n >= 2].double()
    n_bytes = (n.sum() * (4 * w + 1) + c * n_hits.element_size()
               + 2 * c * w)
    n_ops = n.numel() * (FIT_ROW + FIT_HIT) + (n - 1).sum() * (FIT_STEP
                                                               + FIT_HIT)
    return bound(float(n_bytes), float(n_ops), coords.dtype)


def fit_phase(card, cuda, graph) -> dict:
    """The track-fit kernel (csrc/kf_fit.cu) against its plain version
    (extract._kf_chi2 of extract._rotate_tracks; extract.track_fit_plain
    for the p-values) on the rows each of the three extractions hands it:
    the full event and volume 7 in 32 rotated copies stacked, as their
    eager schedules record them (testing.extraction_rows).  At float64
    and float32, in both bug_compat modes: chi2 sums and p-values bitwise,
    and one launch per call.  At the configured mode: the kernel's device
    time (L2 flushed and warm), the plain loop's (captured, L2 flushed)
    and the bound (fit_bound).  Returns the phase's record."""
    from gnn_track_finding_tpu_torch import testing
    from gnn_track_finding_tpu_torch.ops import extract, fit_kernel
    from gnn_track_finding_tpu_torch.parallel import mesh
    print(f"card: {card}")
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    g, cfg = graph(FULL, torch.float64)
    cfg7 = graph(VOL7, torch.float64)[1]
    stack = mesh.stack_events([
        testing.load_event(VOL7, cfg7, device=cuda, dtype=torch.float64,
                           copy=b, copies=32) for b in range(32)])
    sets = {"full event": (testing.extraction_rows(g, cfg), cfg),
            "volume 7 x 32": (testing.extraction_rows(stack, cfg7), cfg7)}
    del g, stack
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=cuda)
    record = {"max_abs_err": 0.0, "calls": {}}
    for label, (rows, cfg) in sets.items():
        check(len(rows) == 3, f"{label}: {len(rows)} extractions recorded")
        for it, (coords, valid, n_hits) in enumerate(rows, 1):
            for dtype in (torch.float64, torch.float32):
                name = str(dtype).split(".")[1]
                cc = coords.to(dtype)
                for bug in (True, False):
                    c = dataclasses.replace(cfg, bug_compat=bug)
                    before = fit_kernel.chi2_sums.launches
                    got = (fit_kernel.chi2_sums(cc, valid, n_hits, c)
                           + extract.track_fit(cc, valid, n_hits, c))
                    check(fit_kernel.chi2_sums.launches == before + 2,
                          f"{label} extraction {it}: kf_fit launches "
                          f"{fit_kernel.chi2_sums.launches - before} for "
                          "chi2_sums and track_fit, not 2")
                    want = (extract._kf_chi2(extract._rotate_tracks(
                        cc, valid, n_hits, c), n_hits, c)
                        + extract.track_fit_plain(cc, valid, n_hits, c))
                    differ = [k for k, a, b in zip(
                        ("chi_xy", "chi_rz", "pval_xy", "pval_zr"), got,
                        want) if not torch.equal(a.view(bits[dtype]),
                                                 b.view(bits[dtype]))]
                    err = max(float(torch.where(a.isnan() & b.isnan(), 0.0,
                                                a - b).abs().max())
                              for a, b in zip(got, want))
                    record["max_abs_err"] = max(record["max_abs_err"], err)
                    check(not differ, f"kf_fit differs from its plain "
                          f"version: {label} extraction {it} {name} "
                          f"bug_compat={bug}: {differ}, max |diff| {err}")
                run = lambda: fit_kernel.chi2_sums(cc, valid, n_hits, cfg)
                plain = lambda: extract._kf_chi2(extract._rotate_tracks(
                    cc, valid, n_hits, cfg), n_hits, cfg)
                rec = {"rows": coords.shape[0],
                       "fitted_rows": int((n_hits >= 2).sum()),
                       "ms": device_ms(run, flush=flush),
                       "ms_warm_l2": device_ms(run),
                       "plain_ms": device_ms(plain, reps=2, warmup=1,
                                             flush=flush),
                       **fit_bound(cc, n_hits)}
                rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
                record["calls"][f"{label} extraction {it} {name}"] = rec
                print(f"kf_fit, {label} extraction {it} {name}: "
                      f"{rec['fitted_rows']} of {rec['rows']} rows fitted; "
                      f"chi2 sums and p-values bitwise the plain version in "
                      f"both bug_compat modes; kernel {rec['ms']:.4f} ms "
                      f"(L2 flushed), {rec['ms_warm_l2']:.4f} ms (warm), "
                      f"plain {rec['plain_ms']:.4f} ms (captured); bound "
                      f"{rec['bound_ms']:.6f} ms by {rec['bound_by']} "
                      f"({rec['bytes']} bytes, {rec['ops']} operations), "
                      f"share {rec['share_of_bound']:.4f}", flush=True)
    return record


def core_case(label, inputs, cfg, chi2_thr, check_found=True):
    """The kernel against the plain version with the kernel gate's bars
    (testing.compare_cluster: bitwise at float64, the flag band at float32),
    over every row (those past a live count in inputs[4] come out not
    found from both).  Returns the largest |diff|."""
    from gnn_track_finding_tpu_torch import testing
    s = testing.compare_cluster(inputs, chi2_thr=chi2_thr, cfg=cfg,
                                require_merged=check_found, label=label)
    torch.cuda.synchronize()
    print(f"{label}: {s['live']} live rows of {s['rows']} x "
          f"kc={inputs[1].shape[1]}, found {s['found']} (plain "
          f"{s['found_plain']}), flag flips {s['flips']}, deact diffs "
          f"{s['deact_diffs']}, max |diff| of merged values "
          f"{s['max_abs_diff']:.3e}")
    return s["max_abs_diff"]


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
    from gnn_track_finding_tpu_torch.ops import cluster_kernel, clustering
    cpu = torch.device("cpu")
    f64 = torch.float64
    print(f"card: {card}")

    def zero_launches():
        pipeline.reset_kernel_launches()

    def launches():
        return pipeline.kernel_launches()

    def max_rel(a, b):
        nz = b != 0
        return float(np.max(np.abs(a - b)[nz] / np.abs(b[nz]))) if nz.any() else 0.0

    # -- the toy run of `run.py --toy`
    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    ev = toymc.generate_event(num_tracks=50, seed=1)
    g_toy, host = build_event(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                              device=cuda)
    zero_launches()
    out, t_toy = sync_time(lambda: pipeline.run_pipeline(
        g_toy, cfg, tracker=host.tracker))
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
        inputs = (x.states, x.tab, x.node_xyzr, x.klthr, x.count)
        live = int(x.count)
        lv, n_lv = torch.unique(x.klthr[:live], return_counts=True)
        rows_per = dict(zip(lv.tolist(), n_lv.tolist()))
        core_case(f"{rnd} round float64 under the LUT thresholds", inputs,
                  cfg_full, x.chi2_thr)

        def run():
            return cluster_kernel.cluster_core(*inputs, chi2_thr=x.chi2_thr,
                                               cfg=cfg_full)

        rec = {"rows": live, "rows_per_threshold": rows_per,
               "ms": device_ms(run, flush=flush), "ms_warm_l2": device_ms(run),
               "plain_ms": call_ms(lambda: cluster_kernel.cluster_core_plain(
                   *inputs, chi2_thr=x.chi2_thr, cfg=cfg_full), reps=5),
               **cluster_bound(x, run(), cfg_full)}
        lut_record[rnd] = rec
        print(f"gmr_cluster {rnd} round under the LUT thresholds, "
              f"{live} live rows of {tuple(x.tab.shape)}, rows per threshold "
              f"{rows_per}: kernel "
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

    # -- the runner's new paths as a user calls them; --json's summary is
    # the last line
    for args, want in ((["--toy", "--json"],
                        {"nodes": g_toy.n_nodes, "edges": g_toy.n_edges,
                         "candidates": sum(EXPECTED_TOY["per_iteration"]),
                         "pure": EXPECTED_TOY["pure"]}),
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
        if "--json" in args:
            summary = json.loads(lines[-1])
            check({k: summary.get(k) for k in want} == want
                  and summary["pipeline_seconds"] > 0,
                  f"run.py {args}: summary {summary} differs from {want}")
            continue
        found = [re.search(r"candidates (\[[0-9, ]*\])", line)
                 for line in lines if line.startswith("[pipeline]")]
        check(bool(found) and found[0] is not None
              and json.loads(found[0].group(1)) == want,
              f"run.py {args}: counts differ from {want}")
    return lut_record, calibrated_launches


def owner_rows_records(inputs, cfg, cuda, label) -> dict:
    """Both kernels on one rank's owner rows of the sharded schedule
    (testing._owner_kernel_checks' inputs: both clustering rounds and the
    first reweight pass), each against its plain version, with its device
    time (L2 flushed and warm), the plain version's time and its bound;
    printed and returned by kernel."""
    from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                                 distinct_kernel)
    f64 = torch.float64
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=cuda)
    owner = {}
    put = lambda a: torch.from_numpy(a).to(cuda)
    for rnd in ("seed", "updated"):
        a = inputs[f"cluster_{rnd}"]
        x = clustering.CoreInputs(
            ids=None, tab=put(a["tab"]),
            states=cluster_kernel.unpack_states(put(a["packed"])),
            node_xyzr=put(a["node_xyzr"]), klthr=put(a["klthr"]),
            chi2_thr=a["chi2_thr"], member_slot=None, count=put(a["count"]))
        args = (x.states, x.tab, x.node_xyzr, x.klthr, x.count)
        err = core_case(f"owner rows ({label}), {rnd} round float64", args,
                        cfg, x.chi2_thr, check_found=int(x.count) > 0)

        def run():
            return cluster_kernel.cluster_core(*args, chi2_thr=x.chi2_thr,
                                               cfg=cfg)

        rec = {"rows": int(x.tab.shape[0]), "live_rows": int(x.count),
               "max_abs_err": err,
               "ms": device_ms(run, flush=flush), "ms_warm_l2": device_ms(run),
               "plain_ms": call_ms(lambda: cluster_kernel.cluster_core_plain(
                   *args, chi2_thr=x.chi2_thr, cfg=cfg), reps=5),
               **cluster_bound(x, run(), cfg)}
        owner[f"gmr_cluster {rnd}"] = rec
    a = inputs["distinct"]
    ok, xx, nx = put(a["ok"]), put(a["x"]), put(a["node_x"])
    run = lambda: distinct_kernel.distinct_counts(ok, xx, nx)
    check(torch.equal(run(), distinct_kernel.distinct_counts_plain(
        ok, xx, xx < nx[:, None], f64)),
        f"distinct counts on the owner rows ({label})")
    owner["distinct_counts"] = {
        "rows": int(ok.shape[0]), "max_abs_err": 0.0,
        "ms": device_ms(run, flush=flush), "ms_warm_l2": device_ms(run),
        "plain_ms": call_ms(lambda: distinct_kernel.distinct_counts_plain(
            ok, xx, xx < nx[:, None], f64)), **distinct_bound(ok, xx)}
    del flush
    for key, rec in owner.items():
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        print(f"{key} on the owner rows ({label}; {rec['rows']} rows, "
              f"{rec.get('live_rows', rec['rows'])} live): kernel "
              f"device time {rec['ms']:.4f} ms (L2 flushed), "
              f"{rec['ms_warm_l2']:.4f} ms (warm), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}: {rec['bytes']} bytes, {rec['ops']} ops; "
              f"{rec['share_of_bound']:.1%} of it)")
    return owner


def sharded_phase(card, cuda, graph):
    """Phase 9: the edge-partitioned schedule.  Returns each kernel's
    record on the owner rows and its launches per rank on the sharded
    path."""
    from collections import defaultdict

    from gnn_track_finding_tpu_torch import testing
    from gnn_track_finding_tpu_torch.models import pipeline
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
    (nccl_jobs,) = testing.spawn_ranks(
        "sequence", 1, out_dir / "nccl", backend="nccl", device="cuda:0",
        timeout=400,
        jobs=[("schedule", schedule),
              ("captured", dict(event={"npz": str(FULL)}, reps=5)),
              ("batched", dict(events=[{"npz": str(VOL7)}] * 2,
                               shape=(1, 1)))]).join()
    runs = {"gloo": [r[0] for r in gloo], "nccl": [nccl_jobs[0]]}
    print(f"rank processes: gloo world of 2 {t_gloo:.1f} s, NCCL world of 1 "
          f"{time.perf_counter() - t0:.1f} s (start, ingest, runs, checks)")
    for backend, label in (("gloo", "gloo, 2 ranks on cuda:0, eager"),
                           ("nccl", "NCCL, 1 rank, eager")):
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

    cap = nccl_jobs[1]
    res = cap["result"]
    walls = cap["walls"]
    best = {k: min(v) for k, v in walls.items()}
    census = sum(c["bytes"] for c in cap["census"])
    print(f"{FULL.name} run_sharded float64, NCCL, 1 rank, path "
          f"{cap['path']} (one CUDA graph, its {len(cap['census'])} "
          f"collectives inside; routing bucket {cap['bucket']}): accepted "
          f"{res['acc_count']}, FastSV rounds {res['cca_rounds']}; "
          f"per-event wall, best of {len(walls['captured'])} in turns: "
          f"captured {best['captured']:.4f} s, eager {best['eager']:.4f} s "
          f"(captured {[round(w, 4) for w in walls['captured']]}, eager "
          f"{[round(w, 4) for w in walls['eager']]}); record "
          f"{cap['record_s']:.3f} s, instantiate "
          f"{cap['instantiate_s']:.3f} s; graph pool "
          f"{cap['pool_bytes'] / 2**30:.3f} GiB; kernel launches per replay "
          f"{cap['launches']}; census of one run {census} bytes in "
          f"{len(cap['census'])} collectives; fallbacks {cap['fallbacks']}; "
          f"fields differing bit for bit from the eager program (first "
          f"call, a replay, a replay under the sync debug mode): "
          f"{cap['differs']}")
    check(cap["path"] == "captured", "NCCL rank: run_sharded did not "
          "replay a captured program")
    check(res["acc_count"] == EXPECTED_F64[FULL], "captured NCCL rank: counts")
    check(not any(cap["differs"].values()),
          f"captured NCCL rank differs from the eager program: "
          f"{cap['differs']}")
    check(same_candidates(res, ref, 0.0)
          and not testing.states_differ(ref_graph, res["graph"], rtol=0.0),
          "captured NCCL rank differs from the single-device run")
    check(cap["launches"] == {"gmr_cluster": 2, "distinct_counts": 3,
                              "kf_fit": 3},
          f"captured NCCL rank: launches per replay {cap['launches']}")
    check(cap["first_call_collectives"] == 2 * len(cap["census"]),
          "captured NCCL rank: the warm-up and capture issued "
          f"{cap['first_call_collectives']} collectives")
    check(cap["fallbacks"] == 0, "captured NCCL rank: a fallback")
    print(f"  the captured program is bitwise the single-device run "
          f"(candidates, p-values, FastSV rounds, every field of the state)")
    sharded_record = {
        "accepted": res["acc_count"], "fastsv_rounds": res["cca_rounds"],
        "path": cap["path"], "collectives": len(cap["census"]),
        "census_bytes": census, "record_s": cap["record_s"],
        "instantiate_s": cap["instantiate_s"],
        "pool_gib": cap["pool_bytes"] / 2**30,
        "launches_per_replay": cap["launches"], "walls_s": walls,
        "best_s": best, "fallbacks": cap["fallbacks"], "card": card}

    for mesh_shape, jobs_out in (((2, 1), [r[1]["events"] for r in gloo]),
                                 ((1, 1), [nccl_jobs[2]["events"]])):
        per_event = {i: o for r in jobs_out for i, o in r.items()}
        check(sorted(per_event) == [0, 1], "run_batched: events per rank")
        for i, o in sorted(per_event.items()):
            check(same_candidates(o, ref7, 0.0)
                  and not testing.states_differ(ref7_graph, o["graph"],
                                                rtol=0.0),
                  f"run_batched event {i} differs from the single-device run")
        # an edge group of one rank runs its data slice as one program,
        # with no collective: captured on the card whatever the backend
        paths = sorted({o["path"] for o in per_event.values()})
        programs = [r[max(r)]["programs"] for r in jobs_out]
        check(paths == ["captured"],
              f"run_batched on {mesh_shape}: paths {paths}")
        check(programs == [1] * mesh_shape[0],
              f"run_batched on {mesh_shape}: programs per rank {programs}")
        who = "the gloo ranks" if mesh_shape == (2, 1) else "the NCCL rank"
        print(f"run_batched on a {mesh_shape} mesh ({who}), volume 7 "
              f"twice: accepted "
              f"{[per_event[i]['acc_count'] for i in (0, 1)]}, each event "
              f"bitwise the single-device run's; path {paths[0]}; programs "
              f"captured per rank {programs}")
        sharded_record[f"run_batched {mesh_shape}"] = {
            "paths": paths, "programs": programs}
    print(json.dumps({"sharded_captured": sharded_record}))

    # -- both kernels on rank 0's owner rows (D = 2): device time, plain
    # version and bound, as in phase 6
    owner = owner_rows_records(runs["gloo"][0]["kernel_inputs"],
                               graph(FULL, f64)[1], cuda, "rank 0 of 2")
    launches = {name: {"gloo_2_ranks": [o["launches"][name]
                                        for o in runs["gloo"]],
                       "nccl_1_rank": runs["nccl"][0]["launches"][name],
                       "nccl_1_rank_captured_per_replay":
                           cap["launches"][name]}
                for name in ("gmr_cluster", "distinct_counts", "kf_fit")}
    shutil.rmtree(out_dir, ignore_errors=True)
    return owner, launches


def studies_phase(card, cuda, graph, events):
    """Phase 10: the analysis and calibration studies on the card, each
    against the same call on CPU tensors.  Returns both kernels' launches
    per study (each study's counts zeroed before it and read after)."""
    import csv
    import warnings

    from gnn_track_finding_tpu_torch.analysis import (community,
                                                      distributions,
                                                      shared_hits)
    from gnn_track_finding_tpu_torch.calib import plots
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.data import event_cache, trackml
    from gnn_track_finding_tpu_torch.evaluation import efficiency
    from gnn_track_finding_tpu_torch.graph.build import build_event
    from gnn_track_finding_tpu_torch.graph.state import as_numpy
    from gnn_track_finding_tpu_torch.models import pipeline
    cpu = torch.device("cpu")
    f64 = torch.float64
    print(f"card: {card}")
    launches = {}

    def study(name, fn):
        """fn(device) on the card (its launches counted) and on CPU tensors;
        -> (card result, CPU result)."""
        pipeline.reset_kernel_launches()
        got, t_card = sync_time(lambda: fn(cuda))
        launches[name] = pipeline.kernel_launches()
        ref, t_cpu = sync_time(lambda: fn(cpu))
        print(f"{name}: {t_card:.3f} s on the card, {t_cpu:.3f} s on CPU "
              f"tensors; kernel launches {launches[name]}")
        return got, ref

    def max_rel(a, b):
        """Largest relative gap over the finite nonzero entries of b."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        nz = np.isfinite(b) & (b != 0)
        return float(np.max(np.abs(a - b)[nz] / np.abs(b[nz]))) if nz.any() else 0.0

    def same(a, b, rtol):
        return a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=0,
                                                  equal_nan=True)

    t_phase = time.perf_counter()
    # -- shared-hit dendrograms over 10 toy runs: clustering kernel in
    # stage 1, distinct counts in stage 2's reweight
    got, ref = study("dendrogram_statistics", lambda d: (
        shared_hits.dendrogram_statistics(num_runs=10, seed=0, device=d)))
    for key in ("iteration1", "iteration2"):
        print(f"  {key}: {got[key].size} maxima (CPU {ref[key].size}), card vs "
              f"CPU max relative gap {max_rel(got[key], ref[key]):.3e}")
        check(same(got[key], ref[key], 1e-9),
              f"dendrogram_statistics {key} differs between card and CPU")
    check(got["iteration1"].size > 0, "dendrogram_statistics: no maxima")
    check(all(v > 0 for v in launches["dendrogram_statistics"].values()),
          "dendrogram_statistics launched a kernel no time")

    # -- per-node dendrogram maxima on the full event after iteration 1's
    # clustering (seed weights) and iteration 2's extrapolation (updated
    # weights); the event's node truth agrees across few hit pairs, so the
    # maxima are also taken over every active in-edge (one label for all).
    # An in-edge with dx = 0 has an infinite gradient (the JAX module's
    # tiny divisor overflows), and its node's maxima are not finite
    def full_states(device):
        g, cfg = graph(FULL, f64, device=device)
        g1 = pipeline.stage_step(pipeline.prepare(g, cfg), cfg, 1)
        g2 = pipeline.stage_step(pipeline.extract_step(g1, cfg, 1)[0], cfg, 2)
        return g1, g2

    card_states, cpu_states = study("full-event stages 1-2", full_states)
    alike = np.zeros(card_states[0].num_padded_nodes, np.int64)
    for (gc, gr), upd in zip(zip(card_states, cpu_states), (False, True)):
        for label, truth in (("node truth", as_numpy(gc.truth)),
                             ("every in-edge", alike)):
            with np.errstate(over="ignore", invalid="ignore"):
                m_card, t_card = sync_time(
                    lambda: shared_hits.node_dendrogram_maxima(gc, truth, upd))
                m_cpu = shared_hits.node_dendrogram_maxima(gr, truth, upd)
            print(f"  node_dendrogram_maxima, full event, "
                  f"{'updated' if upd else 'seed'} weights, {label}: "
                  f"{m_card.size} maxima ({int((~np.isfinite(m_card)).sum())} "
                  f"not finite) in {t_card:.3f} s; card vs CPU max relative "
                  f"gap {max_rel(m_card, m_cpu):.3e}")
            check(same(m_card, m_cpu, 1e-9),
                  "node_dendrogram_maxima differ between card and CPU")
        check(m_card.size > 0, "node_dendrogram_maxima: no maxima")
    full_staged = card_states[0]
    del card_states, cpu_states

    # -- the LUT-effect study: the clustering kernel under per-node LUT
    # thresholds
    got, ref = study("lut_effect_study", lambda d: plots.lut_effect_study(
        num_events=10, seed=100, train_events=30, device=d))
    print(f"  rates {got}")
    check(got == ref, "lut_effect_study differs between card and CPU")
    check(launches["lut_effect_study"]["gmr_cluster"] > 0,
          "lut_effect_study launched the clustering kernel no time")

    # -- parabolic vs linear training rows
    got, ref = study("parabolic_vs_linear", lambda d: (
        plots.parabolic_vs_linear(num_events=20, seed=0, device=d)))
    print(f"  {got}")
    for model in ("parabolic", "linear"):
        check(got[model]["n"] == ref[model]["n"] and all(
            np.isclose(got[model][k], ref[model][k], rtol=1e-9, atol=0)
            for k in ("true_kl_median", "false_kl_median", "separation")),
            f"parabolic_vs_linear {model} differs between card and CPU")

    # -- Leiden communities of volume 7 (after iteration 1's clustering and
    # the final state) and of the full event (the same two states)
    xyzr, vivl, tp, pairs, extra, pre = events[VOL7]

    def volume7(device):
        cfg = PipelineConfig(min_volume=7, max_volume=7)
        g, host = build_event(xyzr, vivl, tp, pairs, cfg, device=device,
                              mirror=pre["mirror"], component=pre["component"],
                              node_ids=extra["node_ids"], with_tracker=False,
                              hit_particle_ids=event_cache.hit_particle_ids(
                                  extra))
        staged = pipeline.stage_step(pipeline.prepare(g, cfg), cfg, 1)
        return cfg, host, staged, pipeline.run_pipeline_fast(g, cfg)

    (cfg7, host7, staged, out7), (_, _, staged_cpu, out7_cpu) = study(
        "volume-7 run", volume7)
    for label, gc, gr in (("after iteration 1's clustering", staged,
                           staged_cpu),
                          ("final", out7.graph, out7_cpu.graph)):
        coms, t_card = sync_time(lambda: community.detect_communities(gc, cfg7))
        coms_cpu = community.detect_communities(gr, cfg7)
        print(f"  detect_communities(leiden), volume 7 {label}: {len(coms)} "
              f"communities in {t_card:.3f} s, equal to CPU tensors': "
              f"{coms == coms_cpu}")
        check(coms == coms_cpu, f"volume-7 communities ({label}) differ "
              "between card and CPU")
    g, cfg = graph(FULL, f64)
    vivl_full = as_numpy(g.vivl)
    for label, state in (("after iteration 1's clustering", full_staged),
                         ("final", pipeline.run_pipeline_fast(g, cfg).graph)):
        coms, t_full = sync_time(
            lambda: community.detect_communities(state, cfg))
        for c in coms:
            layers = [(int(vivl_full[n, 0]), int(vivl_full[n, 1])) for n in c]
            check(len(c) >= cfg.min_track_hits
                  and len(layers) == len(set(layers)),
                  "a full-event community fails the fragment or layer filter")
        print(f"  detect_communities(leiden), full event {label}: "
              f"{len(coms)} communities in {t_full:.3f} s, every one past "
              "both filters")
    del full_staged

    # -- pvals.csv and the purity CSVs of the volume-7 run, read back
    out_dir = REPO / "build" / "smoke_studies"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    distributions.save_pvals_csv(out7.candidates, str(out_dir / "pvals.csv"))
    with open(out_dir / "pvals.csv", newline="") as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["", "pvals_xy", "pvals_zr"]
          and [r[0] for r in rows[1:]] == [str(i) for i in
                                           range(len(out7.candidates))]
          and [(float(r[1]), float(r[2])) for r in rows[1:]]
          == [(c.pval_xy, c.pval_zr) for c in out7.candidates],
          "pvals.csv does not read back as the candidates' p-values")
    # the TrackML efficiency report of the run, through the event's CSV
    # files and a particles file that puts every particle above the pT cut
    # (the cache's truth mapping matches few of the graph's edges: few or
    # no candidates are reconstructed)
    paths = trackml.write_csvs(out_dir / "csv", xyzr, vivl, pairs, extra)
    pids = sorted(set(np.asarray(extra["pid_flat"]).tolist()) - {0})
    particles = out_dir / "csv" / "particles.csv"
    particles.write_text("particle_id,px,py,pz\n" + "".join(
        f"{p},10.0,0.0,0.0\n" for p in pids))
    rep = efficiency.evaluate([c.nodes for c in out7.candidates], host7,
                              str(particles), paths.truth_csv, cfg7)
    distributions.save_purity_csvs(rep, str(out_dir))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # an empty file warns
        back = [np.loadtxt(out_dir / f"extracted_{k}_purities.csv",
                           delimiter=",", ndmin=1)
                for k in ("track", "particle")]
    check(np.array_equal(back[0], rep.track_purities)
          and np.array_equal(back[1], rep.particle_purities),
          "purity CSVs do not read back as the report's purities")
    print(f"  volume-7 artifacts: pvals.csv ({len(out7.candidates)} rows) and "
          f"the purity CSVs ({len(rep.track_purities)} reconstructed of "
          f"{rep.num_reference}) read back bitwise")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches

def bitwise_diff(a, b) -> list:
    """What differs bit for bit between two PipelineResults: candidates
    (nodes and p-values), FastSV rounds, and each field of the final
    state (floats compared as their bits, so NaN and -0.0 count)."""
    bad = []
    if not (len(a.candidates) == len(b.candidates) and all(
            x.iteration == y.iteration and np.array_equal(x.nodes, y.nodes)
            and np.float64(x.pval_xy).tobytes() == np.float64(y.pval_xy).tobytes()
            and np.float64(x.pval_zr).tobytes() == np.float64(y.pval_zr).tobytes()
            for x, y in zip(a.candidates, b.candidates))):
        bad.append("candidates")
    if a.cca_rounds != b.cca_rounds:
        bad.append("cca_rounds")
    return bad + state_diff(a.graph, b.graph)


def state_diff(a, b) -> list:
    """The fields of two GraphStates that differ bit for bit (floats
    compared as their bits, so NaN and -0.0 count)."""
    from gnn_track_finding_tpu_torch.graph.state import tensor_fields
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    bad = []
    for name in tensor_fields():
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype in bits:
            x, y = x.view(bits[x.dtype]), y.view(bits[y.dtype])
        if x.shape != y.shape or not torch.equal(x, y):
            bad.append(name)
    return bad


def captured_phase(card, cuda, graph, counts):
    """Phase 11: run_pipeline_fast / stream_pipeline through the captured
    CUDA graph of each pad bucket.  Returns the record of the phase (the
    kernels' launches per replay among it)."""
    from gnn_track_finding_tpu_torch.data import prefetch
    from gnn_track_finding_tpu_torch.models import pipeline
    f64, f32 = torch.float64, torch.float32
    print(f"card: {card}")
    t_phase = time.perf_counter()
    pipeline.clear_programs()
    torch.cuda.empty_cache()
    fallbacks = pipeline.fallbacks

    def launches():
        return pipeline.kernel_launches()

    record = {"programs": {}}
    cases = (("volume 7 float64", VOL7, f64, {}, EXPECTED_F64[VOL7]),
             ("full event float64", FULL, f64, {}, EXPECTED_F64[FULL]),
             ("clean volume 7 float64", VOL7, f64, {"bug_compat": False},
              EXPECTED_CLEAN_F64),
             ("full event float32", FULL, f32, {}, None))
    for label, path, dtype, changes, want in cases:
        g, cfg = graph(path, dtype, **changes)
        pipeline.reset_kernel_launches()
        out, t_first = sync_time(lambda: pipeline.run_pipeline_fast(g, cfg))
        first = launches()
        prog = pipeline.captured_program(g, cfg)
        replayed = pipeline.run_pipeline_fast(g, cfg)
        check(launches() == first, f"{label}: a replay counted launches")
        eager = pipeline.run_pipeline_eager(g, cfg)
        bad = bitwise_diff(out, eager) + bitwise_diff(replayed, eager)
        per_it = counts(out, cfg)
        rec = {"accepted": per_it, "record_s": prog.capture.record_s,
               "instantiate_s": prog.capture.instantiate_s,
               "first_call_s": t_first,
               "pool_gib": prog.capture.pool_bytes / 2**30,
               "launches_per_replay": prog.kernel_launches,
               "launches_first_call": first, "fastsv_rounds": out.cca_rounds}
        record["programs"][label] = rec
        print(f"{label}, captured: accepted {per_it}"
              + (f" (expected {want})" if want else "")
              + f", FastSV rounds {out.cca_rounds}; first call {t_first:.3f} s "
              f"(eager warm-up {prog.capture.warmup_s:.3f} s, record "
              f"{prog.capture.record_s:.3f} s, instantiate "
              f"{prog.capture.instantiate_s:.3f} s, "
              f"{prog.capture.graph_nodes} graph nodes); "
              f"graph pool {rec['pool_gib']:.3f} GiB; kernel launches in the "
              f"first call {first} (warm-up + capture), per replay "
              f"{prog.kernel_launches}; captured vs eager, first call and a replay, "
              f"bitwise: {not bad} {bad}")
        check(all(v > 0 for v in first.values()), f"{label}: a kernel was not "
              "launched in the captured run")
        check(all(v > 0 for v in prog.kernel_launches.values()),
              f"{label}: a kernel is not in the captured graph")
        check(not bad, f"{label}: captured result differs from the eager one "
              f"in {bad}")
        if want is not None:
            check(per_it == want, f"{label}: counts")

    # per-event wall, captured against eager in turn, best of 5
    for dtype in (f64, f32):
        name = str(dtype).split(".")[1]
        g, cfg = graph(FULL, dtype)
        prog = pipeline.captured_program(g, cfg)
        walls = {"captured": [], "eager": []}
        for _ in range(5):
            for kind, fn in (("captured", pipeline.run_pipeline_fast),
                             ("eager", pipeline.run_pipeline_eager)):
                walls[kind].append(sync_time(lambda: fn(g, cfg))[1])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        replay = []
        for _ in range(5):
            torch.cuda.synchronize()
            start.record()
            prog.graph.replay()
            end.record()
            torch.cuda.synchronize()
            replay.append(start.elapsed_time(end))

        def copy_in():
            for key, t in prog.inputs.items():
                t.copy_(getattr(g, key))

        parts = {"replay_ms": min(replay), "copy_in_ms": call_ms(copy_in),
                 "clone_out_ms": call_ms(lambda: pipeline.clone_state(prog.out))}
        best = {k: min(v) for k, v in walls.items()}
        record[f"wall_{name}"] = {"best_s": best, "walls_s": walls, **parts}
        print(f"full event {name} per-event wall, best of 5: captured "
              f"{best['captured']:.4f} s, eager {best['eager']:.4f} s "
              f"(captured {[round(w, 4) for w in walls['captured']]}, eager "
              f"{[round(w, 4) for w in walls['eager']]}); one replay "
              f"{parts['replay_ms']:.3f} ms (CUDA events), inputs copied in "
              f"{parts['copy_in_ms']:.3f} ms, final state cloned out "
              f"{parts['clone_out_ms']:.3f} ms")

    # the device's busy share of one event (kernel intervals under
    # torch.profiler over the call's wall)
    g, cfg = graph(FULL, f64)
    shares = {kind: busy_share(lambda: fn(g, cfg))
              for kind, fn in (("captured", pipeline.run_pipeline_fast),
                               ("eager", pipeline.run_pipeline_eager))}
    record["busy_share"] = {k: v[0] for k, v in shares.items()}
    print("device busy share of one full event float64 (profiled wall): "
          + ", ".join(f"{k} " + (f"{v[0]:.3f}" if v[0] is not None else
                                 "not measured (no device events)")
                      + f" of {v[1]:.4f} s in {v[2]} device events"
                      for k, v in shares.items()))
    top = shares["captured"][3][:10]
    record["captured_device_ms_by_name"] = dict(top)
    print("  captured event, device time by kernel name (ms, the ten "
          "longest): " + "; ".join(f"{n[:70]} {t:.2f}" for n, t in top))

    # the replay and its enqueued readback under the sync debug mode
    prog = pipeline.captured_program(g, cfg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = prog.launch(g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(not bitwise_diff(pending.result(), pipeline.run_pipeline_eager(g, cfg)),
          "the replay under the sync debug mode differs")
    print("replay, state clone and readback copy enqueued under "
          "torch.cuda.set_sync_debug_mode('error'): no synchronising call")

    # streamed events/s: 8 copies of the full event ingested by the
    # prefetch thread while the device works, against the eager schedule
    # one event after another (ingest included in both)
    # (the first run captures the program while the prefetch thread
    # ingests the next events on the card: capture_error_mode thread_local)
    n_ev = 8
    ref = pipeline.run_pipeline_eager(g, cfg)
    pipeline.clear_programs()
    for run, depth in (("capture included, depth 1", 1), ("depth 1", 1),
                       ("depth 2", 2)):
        loader = prefetch.prefetch([lambda: graph(FULL, f64)[0]] * n_ev)
        t0 = time.perf_counter()
        outs = list(pipeline.stream_pipeline(loader, cfg, depth=depth))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(len(outs) == n_ev and all(not bitwise_diff(o, ref) for o in outs),
              "a streamed event differs from the eager run")
        record[f"stream_events_per_s {run}"] = n_ev / dt
        print(f"stream_pipeline, {n_ev} full events float64 through "
              f"data/prefetch.prefetch, {run}: {dt:.3f} s = "
              f"{n_ev / dt:.3f} events/s, each bitwise the eager run")
    t0 = time.perf_counter()
    for _ in range(n_ev // 2):
        pipeline.run_pipeline_eager(graph(FULL, f64)[0], cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    record["eager_sequential_events_per_s"] = (n_ev // 2) / dt
    print(f"eager, {n_ev // 2} full events one after another (ingest "
          f"included): {(n_ev // 2) / dt:.3f} events/s")

    record["fallbacks"] = pipeline.fallbacks - fallbacks
    check(record["fallbacks"] == 0, "an event fell back to the host driver")
    record["reserved_gib"] = torch.cuda.memory_reserved() / 2**30
    pipeline.clear_programs()
    torch.cuda.empty_cache()
    print(f"fallbacks {record['fallbacks']}; device memory reserved with the "
          f"phase's programs cached {record['reserved_gib']:.2f} GiB; phase "
          f"11: {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"captured_schedule": record}))
    return record


def gate_phase(card, cuda):
    """Phase 12: the kernel gate (testing.kernel_gate) on the full event
    at float64 and float32: both kernels against their plain versions on
    the event's own inputs (the seed round's rows of the prepared state,
    iteration 2's first reweight table), bitwise at float64 and in the
    gate's band at float32, and run_pipeline_fast's accepted counts
    against the reference's at float64 and the eager schedule's at
    float32; every kernel launched.  Returns the record of the phase
    (each dtype's agreement, counts and launches)."""
    from gnn_track_finding_tpu_torch import testing
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.models import pipeline
    t_phase = time.perf_counter()
    cfg = PipelineConfig(min_volume=7, max_volume=14)
    record = {"card": card}
    for dtype, expected in ((torch.float64, EXPECTED_F64[FULL]),
                            (torch.float32, None)):
        name = str(dtype).split(".")[1]
        pipeline.clear_programs()
        torch.cuda.empty_cache()
        pipeline.reset_kernel_launches()
        g = testing.load_event(FULL, cfg, device=cuda, dtype=dtype)
        rec = testing.kernel_gate(g, cfg, expected)
        rec["launches"] = pipeline.kernel_launches()
        check(all(v > 0 for v in rec["launches"].values()),
              f"kernel gate {name}: a kernel was not launched: "
              f"{rec['launches']}")
        record[name] = rec
        print(f"kernel gate, full event {name} ({card}): gmr_cluster "
              f"{rec['gmr_cluster']}; distinct_counts "
              f"{rec['distinct_counts']}; accepted {rec['accepted']}; "
              f"launches {rec['launches']}")
        del g
    pipeline.clear_programs()
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12: {record['seconds']:.1f} s")
    print(json.dumps({"kernel_gate": record}))
    return record


def batch_phase(card, cuda):
    """Phase 13: B events of one pad bucket as one captured program
    (parallel/mesh.stack_events, pipeline.run_pipeline_batched).  Copies
    of the full event rotated about the beam axis (testing.load_event: the
    same graph, other floats) make distinct events.  Returns the record of
    the phase (the kernels' launches, agreement, times and bounds on the
    batched inputs among it)."""
    from gnn_track_finding_tpu_torch import testing
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.data.event_cache import load_npz
    from gnn_track_finding_tpu_torch.models import pipeline
    from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,
                                                 distinct_kernel,
                                                 extrapolate, priors)
    from gnn_track_finding_tpu_torch.parallel import mesh
    f64, f32 = torch.float64, torch.float32
    print(f"card: {card}")
    t_phase = time.perf_counter()
    pipeline.clear_programs()
    torch.cuda.empty_cache()
    fallbacks = pipeline.fallbacks
    cfg = PipelineConfig(min_volume=7, max_volume=14)
    record = {"card": card}

    vivl = load_npz(VOL7)[1]
    vol7_cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                              max_volume=int(vivl[:, 0].max()))

    def copies(path, count, dtype, turn=8):
        """The first `count` copies of the event rotated by b * 2 pi / turn."""
        return [testing.load_event(path, cfg if path == FULL else vol7_cfg,
                                   device=cuda, dtype=dtype, copy=b,
                                   copies=turn)
                for b in range(count)]

    # float64, B = 4: copy b rotated by b * 2 pi / 4, against each copy's
    # single-event replay (the first call captures that program)
    evs = copies(FULL, 4, f64, turn=4)
    pipeline.run_pipeline_fast(evs[0], cfg)
    singles = [pipeline.run_pipeline_fast(g, cfg) for g in evs]
    pipeline.reset_kernel_launches()
    first = pipeline.run_pipeline_batched(evs, cfg)
    first_launches = pipeline.kernel_launches()
    check(all(v > 0 for v in first_launches.values()),
          f"a kernel was not launched in the batched run: {first_launches}")
    st = mesh.stack_events(evs)
    prog = pipeline.captured_program(st, cfg)
    replayed = pipeline.run_pipeline_batched(evs, cfg)
    check(pipeline.kernel_launches() == first_launches,
          "a batched replay counted launches")
    eager = pipeline.run_pipeline_batched(evs, cfg, eager=True)
    bad = {b: bitwise_diff(first[b], singles[b])
           + bitwise_diff(replayed[b], singles[b])
           + bitwise_diff(replayed[b], eager[b]) for b in range(4)}
    per_copy = [testing.per_iteration(o, cfg) for o in replayed]
    print(f"full event float64, 4 rotated copies in one captured program: "
          f"accepted {per_copy}, FastSV rounds "
          f"{[o.cca_rounds for o in replayed]}; kernel launches in the first "
          f"call {first_launches} (warm-up + capture), per replay "
          f"{prog.kernel_launches}; each event bitwise its own single-event replay "
          f"(first call and a replay) and the batched eager run: "
          f"{not any(bad.values())} {bad}")
    check(not any(bad.values()), f"batched results differ: {bad}")
    check(per_copy[0] == EXPECTED_F64[FULL], f"copy 0 counts {per_copy[0]}")
    check(prog.kernel_launches == {"gmr_cluster": 2, "distinct_counts": 3,
                                   "kf_fit": 3},
          f"launches per batched replay {prog.kernel_launches}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = prog.launch_batch(mesh.stack_events(evs), evs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    quiet = [p.result() for p in pending]
    check(not any(bitwise_diff(q, s) for q, s in zip(quiet, singles)),
          "the batched replay under the sync debug mode differs")
    print("stack, copy in, batched replay, state clone, unstack and readback "
          "copy enqueued under torch.cuda.set_sync_debug_mode('error'): no "
          "synchronising call")
    record["float64_b4"] = {"accepted": per_copy,
                            "launches_first_call": first_launches,
                            "launches_per_replay": prog.kernel_launches}

    # the kernels against their plain versions on the batched inputs
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=cuda)
    kernels = {}
    evs32 = copies(FULL, 4, f32, turn=4)
    for dtype, graphs in ((f64, evs), (f32, evs32)):
        name = str(dtype).split(".")[1]
        sb = mesh.stack_events(graphs)
        prepared = pipeline.prepare(sb, cfg)
        x = clustering.core_inputs(prepared, cfg, False)
        inputs = (x.states, x.tab, x.node_xyzr, x.klthr, x.count)
        err = core_case(f"gmr_cluster, 4 events' seed round {name}", inputs,
                        cfg, x.chi2_thr)
        run = lambda: cluster_kernel.cluster_core(*inputs,
                                                  chi2_thr=x.chi2_thr, cfg=cfg)
        rec = {"shape": f"{int(x.count)} live rows of {tuple(x.tab.shape)}",
               "max_abs_err": err, "ms": device_ms(run, flush=flush),
               "ms_warm_l2": device_ms(run),
               "plain_ms": call_ms(lambda: cluster_kernel.cluster_core_plain(
                   *inputs, chi2_thr=x.chi2_thr, cfg=cfg), reps=5),
               **cluster_bound(x, run(), cfg)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        kernels[f"gmr_cluster {name}"] = rec
        g2, _ = pipeline.iteration(prepared, cfg, 1)
        ok, xt, nx = priors.distinct_inputs(extrapolate.message_passing(g2,
                                                                        cfg))
        stats = testing.compare_distinct(ok, xt, nx)
        run = lambda: distinct_kernel.distinct_counts(ok, xt, nx)
        rec = {"shape": f"{tuple(ok.shape)}", "max_abs_err": 0.0,
               "ok_slots": stats["ok_slots"],
               "ms": device_ms(run, flush=flush),
               "ms_warm_l2": device_ms(run),
               "plain_ms": call_ms(lambda: testing._distinct_plain(ok, xt,
                                                                   nx)),
               **distinct_bound(ok, xt)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        kernels[f"distinct_counts {name}"] = rec
    del flush
    for key, rec in kernels.items():
        print(f"{key} on the 4 events' inputs ({rec['shape']}): device time "
              f"{rec['ms']:.4f} ms (L2 flushed), {rec['ms_warm_l2']:.4f} ms "
              f"(warm), plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.5f} ms by {rec['bound_by']} "
              f"({rec['share_of_bound']:.1%} of it), agreement max |diff| "
              f"{rec['max_abs_err']}")
    record["kernels"] = kernels

    # float32, B = 4: per-event counts equal the single-event replays'
    singles32 = [pipeline.run_pipeline_fast(g, cfg) for g in evs32]
    batched32 = pipeline.run_pipeline_batched(evs32, cfg)
    c32 = [testing.per_iteration(o, cfg) for o in batched32]
    check(c32 == [testing.per_iteration(o, cfg) for o in singles32],
          f"float32 batched counts {c32} differ from the single replays'")
    record["float32_b4"] = {"accepted": c32, "bitwise_single": not any(
        bitwise_diff(a, b) for a, b in zip(batched32, singles32))}
    print(f"full event float32, 4 rotated copies: accepted {c32}, each equal "
          f"to its single-event replay's (bitwise: "
          f"{record['float32_b4']['bitwise_single']})")
    del evs, evs32, singles, first, replayed, eager, quiet
    pipeline.clear_programs()
    torch.cuda.empty_cache()

    # events/s: one batched replay against B single-event replays back to
    # back, each clock ending in torch.cuda.synchronize(), best of 3 in
    # turns; the device time of one replay (CUDA events)
    def replay_ms(p):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            start.record()
            p.graph.replay()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    timing = {}
    cases = [("full event", FULL, f32, (1, 2, 4, 8)),
             ("full event", FULL, f64, (4,)),
             ("volume 7", VOL7, f32, (1, 8, 32))]
    for label, path, dtype, sizes in cases:
        name = str(dtype).split(".")[1]
        pool = copies(path, max(sizes), dtype, turn=max(sizes))
        single = pipeline.captured_program(pool[0], cfg if path == FULL
                                           else vol7_cfg)
        ecfg = single.cfg
        pipeline.run_pipeline_fast(pool[0], ecfg)
        single_ms = replay_ms(single)
        for b in sizes:
            graphs = pool[:b]
            torch.cuda.reset_peak_memory_stats()
            sb = mesh.stack_events(graphs)
            prog = pipeline.captured_program(sb, ecfg)
            check(prog.kernel_launches == {"gmr_cluster": 2, "distinct_counts": 3,
                                           "kf_fit": 3},
                  f"{label} B={b}: launches per replay {prog.kernel_launches}")
            walls = {"batched": [], "sequential": []}
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pend = prog.launch_batch(sb, graphs)
                torch.cuda.synchronize()
                walls["batched"].append(time.perf_counter() - t0)
                got = [testing.per_iteration(p.result(), ecfg)
                       for p in pend]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pend = [single.launch(g) for g in graphs]
                torch.cuda.synchronize()
                walls["sequential"].append(time.perf_counter() - t0)
                want = [testing.per_iteration(p.result(), ecfg)
                        for p in pend]
                check(got == want, f"{label} {name} B={b}: batched counts "
                      f"{got}, single {want}")
            best = {k: min(v) for k, v in walls.items()}
            rec = {"events_per_s_batched": b / best["batched"],
                   "events_per_s_sequential": b / best["sequential"],
                   "speedup": best["sequential"] / best["batched"],
                   "walls_s": walls,
                   "replay_ms": replay_ms(prog),
                   "single_replay_ms": single_ms,
                   "record_s": prog.capture.record_s,
                   "instantiate_s": prog.capture.instantiate_s,
                   "pool_gib": prog.capture.pool_bytes / 2**30,
                   "peak_allocated_gib":
                       torch.cuda.max_memory_allocated() / 2**30,
                   "launches_per_replay": prog.kernel_launches,
                   "accepted_per_event": got}
            timing[f"{label} {name} B={b}"] = rec
            print(f"{label} {name} B={b}: batched "
                  f"{rec['events_per_s_batched']:.3f} events/s against {rec['events_per_s_sequential']:.3f} for "
                  f"{b} single replays in turn (x{rec['speedup']:.3f}); one "
                  f"batched replay {rec['replay_ms']:.3f} ms on the device "
                  f"(a single replay {single_ms:.3f} ms); record "
                  f"{rec['record_s']:.3f} s, instantiate "
                  f"{rec['instantiate_s']:.3f} s, pool {rec['pool_gib']:.3f} "
                  f"GiB, peak allocated {rec['peak_allocated_gib']:.3f} GiB; "
                  f"launches per replay {prog.kernel_launches}")
            del sb, prog, pend
        del pool, single
        pipeline.clear_programs()
        torch.cuda.empty_cache()
    record["timing"] = timing
    record["fallbacks"] = pipeline.fallbacks - fallbacks
    check(record["fallbacks"] == 0, "an event fell back to the host driver")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"fallbacks {record['fallbacks']}; phase 13: "
          f"{record['seconds']:.1f} s")
    print(json.dumps({"event_batch": record}))
    return record


def batched_sharded_phase(card, cuda):
    """Phase 14: batched x edge-sharded execution at float64 on rotated
    copies of the full event (testing.load_event): a data rank's events as
    their union, edge-partitioned over the edge group as one program per
    rank (parallel/mesh.run_batched, edge_shard.run_sharded on a stack).
    Returns the record of the phase (the kernels' launches, agreement,
    times and bounds on the union's owner rows among it)."""
    from collections import Counter

    from gnn_track_finding_tpu_torch import testing
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.models import pipeline
    f64 = torch.float64
    cfg = PipelineConfig(min_volume=7, max_volume=14)
    t_phase = time.perf_counter()
    pipeline.clear_programs()
    torch.cuda.empty_cache()
    out_dir = REPO / "build" / "smoke_batched_sharded"
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"card: {card}")
    copies = lambda n: [{"npz": str(FULL), "copy": [b, n]} for b in range(n)]
    record = {"card": card}

    # 2 gloo ranks on cuda:0: run_batched on a (1, 2) mesh over 2 copies
    t0 = time.perf_counter()
    gloo = testing.spawn_ranks(
        "batched", 2, out_dir / "gloo", device="cuda:0", timeout=300,
        events=copies(2), shape=(1, 2), reps=2, check_kernels=True).join()
    t_gloo = time.perf_counter() - t0
    # 1 NCCL rank: the 4-copy stack through run_sharded, then
    # multihost.scaling_report over the 4 copies
    t0 = time.perf_counter()
    nccl_world = 1                  # NCCL refuses two ranks on one card
    (nccl,) = testing.spawn_ranks(
        "sequence", nccl_world, out_dir / "nccl", backend="nccl",
        device="cuda:0", timeout=400,
        jobs=[("captured", dict(event={"stack": copies(4)}, reps=3,
                                check_kernels=True)),
              ("multihost", dict(events=copies(4), num_events=4))]).join()
    t_nccl = time.perf_counter() - t0
    print(f"rank processes: gloo world of 2 {t_gloo:.1f} s, NCCL world of 1 "
          f"{t_nccl:.1f} s (start, ingest, runs, checks)")

    # the single-device reference: each copy's own captured replay
    refs = []
    for b in range(2):
        g = testing.load_event(FULL, cfg, device=cuda, dtype=f64, copy=b,
                               copies=2)
        (res,) = pipeline.run_schedule_batched([g], cfg)
        refs.append((res.acc_count.tolist(), res.acc_nodes.cpu().numpy(),
                     res.acc_pvals.cpu().numpy(), res.graph.to_numpy()))
        del g, res
    pipeline.clear_programs()
    torch.cuda.empty_cache()
    check(refs[0][0] == EXPECTED_F64[FULL], f"copy 0 single replay counts "
          f"{refs[0][0]}")

    bars = dict(rtol=0.0, looser={"grad_stats": 1e-12})
    gloo_rec = {"launches": [], "live_edges": [], "peak_gib": [],
                "walls_s": [], "accepted": None}
    for rank, o in enumerate(gloo):
        program = [c for c in o["census"] if c["caller"] != "gather_graph"]
        paths = sorted({e["path"] for e in o["events"].values()})
        check(sorted(o["events"]) == [0, 1], f"gloo rank {rank}: events")
        check(paths == ["eager"], f"gloo rank {rank}: paths {paths}")
        check(len(program) == 64, f"gloo rank {rank}: {len(program)} "
              "collectives in the batch, not one program's 64")
        check(o["launches"] == {"gmr_cluster": 2, "distinct_counts": 3,
                                "kf_fit": 3},
              f"gloo rank {rank}: launches {o['launches']} (one program: "
              "2 and 3)")
        check(all(c["bitwise"] for c in o["kernel_checks"].values()),
              f"gloo rank {rank}: a kernel differs from its plain version "
              "on the union's owner rows")
        for i, (count, nodes, pvals, state) in enumerate(refs):
            e = o["events"][i]
            check(e["acc_count"] == count
                  and np.array_equal(e["acc_nodes"], nodes)
                  and np.array_equal(e["acc_pvals"], pvals),
                  f"gloo rank {rank} event {i}: candidates differ from the "
                  "single-device replay's")
            bad = testing.states_differ(state, e["graph"], **bars)
            check(not bad, f"gloo rank {rank} event {i}: state {bad}")
        best = {k: min(v) for k, v in o["walls"].items()}
        print(f"gloo rank {rank} of 2, (1, 2) mesh: accepted "
              f"{[o['events'][i]['acc_count'] for i in (0, 1)]} (single "
              f"device {[r[0] for r in refs]}), paths {paths}; "
              f"{len(program)} collectives of the program "
              f"({dict(Counter(c['op'] for c in program))}) + "
              f"{len(o['census']) - len(program)} gathering the state; "
              f"kernel launches {o['launches']}; live edges in its block "
              f"{o['live_edges']}; peak allocated "
              f"{o['peak_bytes'] / 2**30:.3f} GiB; wall per batch of 2, "
              f"best of {len(o['walls']['batched'])} in turns: batched "
              f"{best['batched']:.4f} s, the 2 events through run_sharded "
              f"in turn {best['in_turn']:.4f} s; owner rows against the "
              f"plain versions {o['kernel_checks']}")
        gloo_rec["launches"].append(o["launches"])
        gloo_rec["live_edges"].append(o["live_edges"])
        gloo_rec["peak_gib"].append(o["peak_bytes"] / 2**30)
        gloo_rec["walls_s"].append(o["walls"])
    gloo_rec["accepted"] = [gloo[0]["events"][i]["acc_count"] for i in (0, 1)]
    record["gloo_2_ranks"] = gloo_rec

    cap, mh = nccl
    walls = cap["walls"]
    best = {k: min(v) for k, v in walls.items()}
    accepted = [e["acc_count"] for e in cap["result"]]
    print(f"4 copies stacked, run_sharded on the NCCL rank of 1 (routing "
          f"bucket {cap['bucket']}, {cap['live_edges']} live edges): paths "
          f"{cap['paths']}, accepted {accepted}; fields differing bit for "
          f"bit from the eager body (first call, a replay, a replay under "
          f"the sync debug mode): {cap['differs']}; from each event's "
          f"single-device batched replay: {cap['single_differs']}; record "
          f"{cap['record_s']:.3f} s, instantiate "
          f"{cap['instantiate_s']:.3f} s, pool "
          f"{cap['pool_bytes'] / 2**30:.3f} GiB; one replay "
          f"{cap['replay_ms']:.3f} ms on the device; kernel launches per "
          f"replay {cap['launches']}; {len(cap['census'])} collectives; "
          f"events/s, best of {len(walls['captured'])} in turns: stacked "
          f"{4 / best['captured']:.3f}, 4 single-event sharded replays in "
          f"turn {4 / best['in_turn']:.3f} (x"
          f"{best['in_turn'] / best['captured']:.3f}); fallbacks "
          f"{cap['fallbacks']}")
    check(cap["path"] == "captured" and cap["paths"] == ["captured"] * 4,
          f"NCCL rank: paths {cap['paths']}")
    check(not any(cap["differs"].values()),
          f"NCCL rank: the stacked replay differs from the eager body: "
          f"{cap['differs']}")
    check(not any(cap["single_differs"]), "NCCL rank: an event differs from "
          f"its single-device batched replay: {cap['single_differs']}")
    check(accepted[0] == EXPECTED_F64[FULL], f"NCCL rank: copy 0 {accepted[0]}")
    check(cap["launches"] == {"gmr_cluster": 2, "distinct_counts": 3,
                              "kf_fit": 3},
          f"NCCL rank: launches per replay {cap['launches']}")
    check(len(cap["census"]) == 64, f"NCCL rank: {len(cap['census'])} "
          "collectives in the stacked program")
    check(all(c["bitwise"] for c in cap["kernel_checks"].values()),
          "NCCL rank: a kernel differs from its plain version on the "
          "union's owner rows")
    check(cap["fallbacks"] == 0, "NCCL rank: a fallback")
    record["nccl_1_rank"] = {
        "accepted": accepted, "paths": cap["paths"],
        "record_s": cap["record_s"], "instantiate_s": cap["instantiate_s"],
        "pool_gib": cap["pool_bytes"] / 2**30, "replay_ms": cap["replay_ms"],
        "launches_per_replay": cap["launches"], "walls_s": walls,
        "events_per_s_stacked": 4 / best["captured"],
        "events_per_s_in_turn": 4 / best["in_turn"],
        "live_edges": cap["live_edges"], "bucket": cap["bucket"]}

    rep = mh["report"]
    print(f"multihost.scaling_report over the 4 copies, NCCL world of "
          f"{nccl_world}: {rep['devices']} data rank(s) used, sequential "
          f"(each event its own captured replay) "
          f"{rep['sequential_s']:.4f} s, parallel (one batched program) "
          f"{rep['parallel_s']:.4f} s, scaling efficiency "
          f"{rep['scaling_efficiency']:.3f}; checksums "
          f"{rep['sequential_checksum']} / {rep['parallel_checksum']}")
    check(rep["devices"] == min(4, nccl_world),
          f"scaling_report counts {rep['devices']} data ranks, not "
          f"min(4 events, {nccl_world} ranks)")
    check(rep["sequential_checksum"] == rep["parallel_checksum"]
          == sum(map(sum, accepted)), f"scaling_report checksums {rep}")
    record["scaling_report"] = rep

    owner = owner_rows_records(cap["kernel_inputs"], cfg, cuda,
                               "the 4-copy union, NCCL rank of 1")
    record["kernels"] = owner
    shutil.rmtree(out_dir, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14: {record['seconds']:.1f} s")
    print(json.dumps({"batched_sharded": record}))
    return record


def profile_phase(card, cuda):
    """Phase 15: profile_stages.profile (the port's stage and part
    profiler) on the full event at float64 and float32 and on 4 rotated
    copies stacked at float64: the table of each, and four checks that
    fail the run (each captured part bitwise its eager output at float64;
    2 gmr_cluster and 3 distinct_counts launches over the leaf rows, as
    in the whole schedule; the stage rows' kernel time within 25% of
    one replay's, their CUDA-event times printed beside; FastSV's needed
    rounds at most cca.R_CAP in every extraction).  Returns the phase's
    record."""
    from gnn_track_finding_tpu_torch import profile_stages, testing
    from gnn_track_finding_tpu_torch.graph import cca
    from gnn_track_finding_tpu_torch.graph.state import stack_events
    from gnn_track_finding_tpu_torch.models import pipeline
    f64, f32 = torch.float64, torch.float32
    print(f"card: {card}")
    t_phase = time.perf_counter()
    pipeline.clear_programs()
    torch.cuda.empty_cache()
    cfg = profile_stages.CFG
    runs = (("full event float64", f64, 1), ("full event float32", f32, 1),
            ("4 rotated full copies stacked float64", f64, 4))
    record = {}
    for label, dtype, copies in runs:
        t0 = time.perf_counter()
        g = stack_events([testing.load_event(FULL, cfg, device=cuda,
                                             dtype=dtype, copy=c,
                                             copies=copies)
                          for c in range(copies)])
        prof = profile_stages.profile(g, cfg)
        seconds = time.perf_counter() - t0
        print("\n".join(profile_stages.table(prof, label)))
        whole = prof.whole()
        ratio = prof.stage_sum_ms() / whole.device_ms
        kernel_ratio = prof.stage_sum_ms("kernel_ms") / whole.kernel_ms
        leaves = prof.leaf_kernels()
        rounds = [r for per in prof.rounds
                  for r in (per if isinstance(per, list) else [per])]
        one_round = [r.device_ms for r in prof.rows if r.level == "round"]
        not_bitwise = [f"{r.iteration} {r.name}" for r in prof.rows
                       if not r.bitwise]
        print(f"{label}: the stage rows sum to {prof.stage_sum_ms():.4f} ms "
              f"against {whole.device_ms:.4f} ms for one replay of the whole "
              f"schedule (ratio {ratio:.4f}; their kernels "
              f"{prof.stage_sum_ms('kernel_ms'):.4f} against "
              f"{whole.kernel_ms:.4f} ms, ratio {kernel_ratio:.4f}); "
              f"launches per replay "
              f"{whole.launches} ({prof.whole().launch_floor_ms:.4f} ms of "
              f"launch floor at {prof.launch_node_ms * 1e3:.3f} us a graph "
              f"node); kernels over the leaf rows {leaves}, in the whole "
              f"replay {whole.kernels}; FastSV rounds needed "
              f"{prof.rounds} of {cca.R_CAP}, one round "
              f"{[round(t, 4) for t in one_round]} ms; captured parts not "
              f"bitwise their eager output: {not_bitwise}; {seconds:.1f} s")
        if dtype == f64:
            check(not not_bitwise, f"{label}: captured parts differ from "
                  f"their eager output: {not_bitwise}")
        check(leaves == {"gmr_cluster": 2, "distinct_counts": 3,
                         "kf_fit": 3}
              == whole.kernels, f"{label}: kernel launches over the leaf "
              f"rows {leaves}, in the whole replay {whole.kernels}")
        # the kernels' own time: the gaps between graph nodes come and go
        # between replays (~0.34 us a node, PERF.md section 5)
        check(0.75 <= kernel_ratio <= 1.25, f"{label}: the stage rows' "
              f"kernels sum to {kernel_ratio:.3f} of one replay's")
        check(all(r <= cca.R_CAP for r in rounds),
              f"{label}: FastSV needed {prof.rounds} rounds")
        record[label] = {
            "seconds": seconds, "stage_sum_ms": prof.stage_sum_ms(),
            "replay_ms": whole.device_ms, "ratio": ratio,
            "stage_sum_kernel_ms": prof.stage_sum_ms("kernel_ms"),
            "replay_kernel_ms": whole.kernel_ms, "kernel_ratio": kernel_ratio,
            "launches": whole.launches, "launch_node_ms": prof.launch_node_ms,
            "leaf_kernels": leaves, "fastsv_rounds": prof.rounds,
            "one_round_ms": one_round, "accepted": prof.accepted,
            "rows": {f"{r.iteration} {r.level} {r.name}": [
                round(r.device_ms, 4), round(r.warm_ms, 4),
                round(r.kernel_ms, 4), r.launches, round(r.floor_ms, 4)]
                for r in prof.rows}}
        del prof, g
        torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15: {record['seconds']:.1f} s")
    print(json.dumps({"stage_profile": {
        k: {key: v[key] for key in (
            "seconds", "stage_sum_ms", "replay_ms", "ratio",
            "stage_sum_kernel_ms", "replay_kernel_ms", "kernel_ratio",
            "launches", "fastsv_rounds")}
        if isinstance(v, dict) else v for k, v in record.items()}}))
    return record


def main() -> int:
    t_start = time.perf_counter()
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
                                                 extrapolate, fit_kernel,
                                                 metadata, priors)
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
        occupancy[f"kf_fit {name}"] = fit_kernel.occupancy(dtype)
    for label, occ in occupancy.items():
        print(f"resident on one SM, {label}: {occ}")
    shutil.rmtree(native_loader.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    native_loader.library()
    print(f"g++ build of native/loader.cc: {time.perf_counter() - t0:.2f} s "
          f"-> {native_loader.library_path().name}")

    events = {}

    def graph(path, dtype, device=cuda, **cfg_changes):
        """The event's state and config; clean mode (bug_compat=False)
        ingests with the identity mirror."""
        if path not in events:
            events[path] = load_npz(path)
        xyzr, vivl, tp, pairs, extra, pre = events[path]
        cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                             max_volume=int(vivl[:, 0].max()), **cfg_changes)
        g = build_graph_state(xyzr, vivl, tp, pairs, cfg, device=device,
                              dtype=dtype,
                              mirror=pre["mirror"] if cfg.bug_compat else None,
                              component=pre["component"])
        return g, cfg

    def counts(out, cfg):
        return [sum(1 for c in out.candidates if c.iteration == i)
                for i in range(1, cfg.num_iterations + 1)]

    record = {}

    phase("3. GMR clustering kernel vs plain (full event, edge cases)")

    def round_case(label, x, cfg):
        return core_case(label, (x.states, x.tab, x.node_xyzr, x.klthr,
                                 x.count), cfg, x.chi2_thr)

    cluster_inputs = {}
    record["cluster_max_abs_err"] = 0.0
    for dtype in (torch.float64, torch.float32):
        g, cfg = graph(FULL, dtype)
        g = pipeline.prepare(g, cfg)
        name = str(dtype).split(".")[1]
        x = clustering.core_inputs(g, cfg, False)
        err = round_case(f"seed round {name}", x, cfg)
        if dtype == torch.float64:
            record["cluster_max_abs_err"] = err
            for kc in (4, 32):
                round_case(f"seed round float64 kc={kc}",
                           clustering.core_inputs(g, cfg, False, kc=kc), cfg)
            absorb = torch.full((g.num_padded_nodes,), 1e30, device=cuda)
            round_case("seed round float64 klthr 1e30 (full absorption)",
                       clustering.core_inputs(g, cfg, False, absorb), cfg)
        for i in (1, 2):
            g, _ = pipeline.iteration(g, cfg, i)
        x_upd = clustering.core_inputs(g, cfg, True)
        round_case(f"updated round {name}", x_upd, cfg)
        cluster_inputs[dtype] = (x, x_upd, cfg)
    # clean mode (bug_compat=False): the full KL trace and the z endcap
    # coordinate, in both rounds of the full event
    g, cfg = graph(FULL, torch.float64, bug_compat=False)
    check(torch.equal(g.mirror, torch.arange(g.num_padded_edges,
                                             device=cuda)),
          "clean ingest: the mirror is not the identity")
    g = pipeline.prepare(g, cfg)
    x = clustering.core_inputs(g, cfg, False)
    round_case("clean mode seed round float64", x, cfg)
    for i in (1, 2):
        g, _ = pipeline.iteration(g, cfg, i)
    x_upd = clustering.core_inputs(g, cfg, True)
    round_case("clean mode updated round float64", x_upd, cfg)
    cluster_inputs["clean"] = (x, x_upd, cfg)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        for kc in (4, 16, 32):
            hi = 33 if kc == 32 else 16
            for rows in (0, 1, 3, 33, 4096):
                members = 3 + (np.arange(rows) * 7) % (hi - 3)
                core_case(f"synthetic {name} rows={rows} kc={kc}",
                          testing.cluster_rows(rows + kc, rows, kc, members,
                                               dtype=dtype, device=cuda),
                          PipelineConfig(), 1.0, check_found=rows >= 33)

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

    phase("5. the slice, eager: run_pipeline_eager / stream_pipeline")
    for path in (VOL7, FULL):
        g, cfg = graph(path, torch.float64)
        if path == FULL:
            pipeline.reset_kernel_launches()
        out, dt = sync_time(lambda: pipeline.run_pipeline_eager(g, cfg))
        if path == FULL:
            launches = pipeline.kernel_launches()
        per_it = counts(out, cfg)
        print(f"{path.name} float64: accepted {per_it} (reference "
              f"{EXPECTED_F64[path]}), FastSV rounds {out.cca_rounds}, "
              f"{dt:.3f} s")
        check(per_it == EXPECTED_F64[path], f"{path.name} float64 counts")
    print(f"kernel launches in the full-event run: {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    solo = out

    g, cfg = graph(VOL7, torch.float64, bug_compat=False)
    pipeline.reset_kernel_launches()
    per_it = counts(pipeline.run_pipeline_eager(g, cfg), cfg)
    clean_launches = pipeline.kernel_launches()
    print(f"{VOL7.name} clean mode (bug_compat=False) float64: accepted "
          f"{per_it} (JAX package {EXPECTED_CLEAN_F64}); kernel launches "
          f"{clean_launches}")
    check(per_it == EXPECTED_CLEAN_F64, "clean volume-7 counts")

    g32, cfg = graph(FULL, torch.float32)
    out32 = pipeline.run_pipeline_eager(g32, cfg)
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
    print("stream of 3 full events (the captured program): candidates "
          "identical to the eager solo run")

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
            inputs = (x.states, x.tab, x.node_xyzr, x.klthr, x.count)
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
            print(f"{key}, {int(x.count)} live rows of {tuple(x.tab.shape)}: "
                  f"kernel device time "
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
    x_seed, x_upd, cfg = cluster_inputs["clean"]
    for rnd, x in (("seed", x_seed), ("updated", x_upd)):
        inputs = (x.states, x.tab, x.node_xyzr, x.klthr, x.count)
        key = f"gmr_cluster {rnd} clean float64"
        run = lambda: cluster_kernel.cluster_core(*inputs, chi2_thr=x.chi2_thr,
                                                  cfg=cfg)
        times[key] = device_ms(run, flush=flush)
        times[f"{key} warm L2"] = device_ms(run)
        times[f"{key} plain"] = call_ms(
            lambda: cluster_kernel.cluster_core_plain(
                *inputs, chi2_thr=x.chi2_thr, cfg=cfg), reps=5)
        bounds[key] = cluster_bound(x, run(), cfg)
        print(f"{key} (bug_compat=False), {int(x.count)} live rows of "
              f"{tuple(x.tab.shape)}: kernel device "
              f"time {times[key]:.4f} ms (L2 flushed), "
              f"{times[f'{key} warm L2']:.4f} ms (warm), plain "
              f"{times[f'{key} plain']:.4f} ms; bound {bounds[key]}")
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
        print(f"{key} (core_inputs, kernel, scatter; CUDA events, no host "
              f"sync inside): {times[key]:.4f} ms")

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        g, cfg = graph(FULL, dtype)
        pipeline.run_pipeline_eager(g, cfg)                  # warm-up
        walls = [sync_time(lambda: pipeline.run_pipeline_eager(g, cfg))[1]
                 for _ in range(3)]
        print(f"run_pipeline_eager full event {name}: per-event wall "
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
        print(f"stream_pipeline {n_ev} full events {name} (captured program; "
              f"capture and ingest included): "
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
        pipeline.reset_kernel_launches()
        out, t_host = sync_time(lambda: pipeline.run_pipeline(
            g, cfg, tracker=host.tracker))
        path_launches = pipeline.kernel_launches()
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

    phase("10. analysis and calibration studies (float64)")
    study_launches = studies_phase(card, cuda, graph, events)
    studies = lambda name: {k: v[name] for k, v in study_launches.items()}

    phase("11. the captured schedule: one CUDA graph per pad bucket")
    captured = captured_phase(card, cuda, graph, counts)
    per_replay = captured["programs"]["full event float64"][
        "launches_per_replay"]

    phase("12. the kernel gate on the full event (float64, float32)")
    gate_phase(card, cuda)

    phase("13. the event batch: B events in one captured program")
    batched = batch_phase(card, cuda)

    phase("14. batched x edge-sharded: a data rank's events as one "
          "edge-partitioned program per rank (float64)")
    batched_sharded = batched_sharded_phase(card, cuda)

    phase("15. stage and part profile (profile_stages.profile)")
    profile_phase(card, cuda)

    phase("16. the track-fit kernel vs plain (the extractions' rows)")
    fitted = fit_phase(card, cuda, graph)
    fit_calls = fitted["calls"]

    def batched_sharded_entry(name):
        """A kernel's launches, agreement, times and bound in phase 14."""
        rounds = (("seed", "updated") if name == "gmr_cluster" else (None,))
        recs = {rnd or "reweight": batched_sharded["kernels"][
            f"{name} {rnd}" if rnd else name] for rnd in rounds}
        return {"launches_gloo_2_ranks": [
                    o[name] for o in batched_sharded["gloo_2_ranks"][
                        "launches"]],
                "launches_nccl_per_replay": batched_sharded["nccl_1_rank"][
                    "launches_per_replay"][name],
                "shape": "owner rows of 4 full events' union, float64",
                **{k: {key: rec[key] for key in (
                    "rows", "live_rows", "max_abs_err", "ms", "ms_warm_l2",
                    "plain_ms", "bound_ms", "bound_by", "share_of_bound")
                    if key in rec} for k, rec in recs.items()}}

    def event_batch_launches(name):
        """A kernel's launches in phase 13."""
        return {"launches_first_call":
                    batched["float64_b4"]["launches_first_call"][name],
                "launches_per_replay": {
                    k: v["launches_per_replay"][name]
                    for k, v in batched["timing"].items()}}

    def event_batch(name):
        """A kernel's launches, agreement, times and bound in phase 13."""
        return {**event_batch_launches(name),
                **{dtype: batched["kernels"][f"{name} {dtype}"]
                   for dtype in ("float64", "float32")}}

    kernels = [
        {"name": "gmr_cluster", "route": "cuda", "source": CLUSTER_SOURCE,
         "replaces": CLUSTER_REPLACES, "launches": launches["gmr_cluster"],
         "launches_captured": per_replay["gmr_cluster"],
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
         "clean_mode": {rnd: {
             "ms": times[f"gmr_cluster {rnd} clean float64"],
             "ms_warm_l2": times[f"gmr_cluster {rnd} clean float64 warm L2"],
             "plain_ms": times[f"gmr_cluster {rnd} clean float64 plain"],
             **bounds[f"gmr_cluster {rnd} clean float64"]}
             for rnd in ("seed", "updated")},
         "launches_clean_volume7": clean_launches["gmr_cluster"],
         "launches_studies": studies("gmr_cluster"),
         "launches_sharded": sharded_launches["gmr_cluster"],
         "owner_rows": {rnd: owner[f"gmr_cluster {rnd}"]
                        for rnd in ("seed", "updated")},
         "times": {k: v for k, v in times.items()
                   if k.startswith(("gmr_cluster", "cluster stage"))},
         "occupancy": {k: v for k, v in occupancy.items()
                       if k.startswith("gmr_cluster")},
         "event_batch": event_batch("gmr_cluster"),
         "batched_sharded": batched_sharded_entry("gmr_cluster")},
        {"name": "distinct_counts", "route": "cuda", "source": DISTINCT_SOURCE,
         "replaces": DISTINCT_REPLACES,
         "launches": launches["distinct_counts"],
         "launches_captured": per_replay["distinct_counts"],
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
         "launches_clean_volume7": clean_launches["distinct_counts"],
         "launches_studies": studies("distinct_counts"),
         "owner_rows": owner["distinct_counts"],
         "times": {k: v for k, v in times.items()
                   if k.startswith("distinct_counts")},
         "occupancy": {k: v for k, v in occupancy.items()
                       if k.startswith("distinct_counts")},
         "event_batch": event_batch("distinct_counts"),
         "batched_sharded": batched_sharded_entry("distinct_counts")},
        {"name": "kf_fit", "route": "cuda", "source": FIT_SOURCE,
         "replaces": None,
         "launches": launches["kf_fit"],
         "launches_captured": per_replay["kf_fit"],
         "launches_run_pipeline": host_launches["kf_fit"],
         "launches_calibrated": calibrated_launches["kf_fit"],
         "max_abs_err": fitted["max_abs_err"],
         **{k: fit_calls["full event extraction 1 float64"][k]
            for k in ("ms", "ms_warm_l2", "plain_ms", "bound_ms",
                      "bound_by")},
         "library_ms": None,
         "shape": "full event, extraction 1 (14,400 rows), float64",
         "launches_sharded": sharded_launches["kf_fit"],
         "launches_clean_volume7": clean_launches["kf_fit"],
         "launches_studies": studies("kf_fit"),
         "calls": fit_calls,
         "occupancy": {k: v for k, v in occupancy.items()
                       if k.startswith("kf_fit")},
         "launches_event_batch": event_batch_launches("kf_fit"),
         "launches_batched_sharded": {
             "gloo_2_ranks": [o["kf_fit"] for o in batched_sharded[
                 "gloo_2_ranks"]["launches"]],
             "nccl_per_replay": batched_sharded["nccl_1_rank"][
                 "launches_per_replay"]["kf_fit"]}},
    ]
    print(f"\nchip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
