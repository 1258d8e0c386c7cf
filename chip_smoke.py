"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

Drives the port's production driver (`run_pipeline_fast`, `stream_pipeline`)
on the committed TrackML event caches and checks both hand-written CUDA
kernels against their plain PyTorch versions on the card:

  1. device: a CUDA device is required; prints its name and power limit;
  2. build: compiles csrc/*.cu with nvcc (sm_90a) and prints the time;
  3. GMR clustering kernel vs plain, on the real compacted rows of the
     full event (seed round after prepare, updated round after iteration
     2) at float64 and float32, kc = 16, plus a kc = 4 case;
  4. distinct-count kernel vs plain, on the real reweight tables (K = 64)
     and on a duplicate-rich table;
  5. the slice: float64 accepted counts per iteration on the volume-7 and
     full events against the reference's, the float32 counts beside the
     plain path's (the same schedule on CPU tensors), the kernels' launch
     counts in the main-path run, and a 3-event stream against the solo run;
  6. steady-state times: each kernel and its plain version at the full-event
     shapes, per-stage and per-event wall times, streamed events/s.

Every phase raises on failure, so the script exits non-zero.  The line
before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
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


def kernel_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over reps launches (CUDA events)."""
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

    from gnn_track_finding_tpu_torch import _build
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.data.event_cache import load_npz
    from gnn_track_finding_tpu_torch.graph.build import build_graph_state
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
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

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

    phase("3. GMR clustering kernel vs plain (full event)")

    def core_case(label, x, cfg, dtype):
        args = (x.pk, x.node_xyzr, x.gate, x.klthr, x.valid)
        got = cluster_kernel.cluster_core(*args, chi2_thr=x.chi2_thr, cfg=cfg)
        want = cluster_kernel.cluster_core_plain(*args, chi2_thr=x.chi2_thr,
                                                 cfg=cfg)
        torch.cuda.synchronize()
        f_k, f_p = got[0], want[0]
        flips = int((f_k != f_p).sum())
        both = f_k & f_p
        err = max(float((a[both] - b[both]).abs().max()) if both.any() else 0.0
                  for a, b in zip(got[1:4], want[1:4]))
        rows = x.pk.shape[0]
        print(f"{label}: {rows} rows x kc={x.pk.shape[1]}, found "
              f"{int(f_k.sum())} (plain {int(f_p.sum())}), flag flips "
              f"{flips}, deact diffs {int((got[4] != want[4]).sum())}, "
              f"max |diff| of merged values {err:.3e}")
        check(both.any(), f"{label}: no merged rows")
        if dtype == torch.float64:
            check(flips == 0 and torch.equal(got[4], want[4]),
                  f"{label}: float64 flags differ")
            for a, b in zip(got[1:4], want[1:4]):
                torch.testing.assert_close(a[f_p], b[f_p], rtol=1e-12,
                                           atol=1e-14)
        else:
            check(flips < 0.06 * max(rows, 1), f"{label}: float32 flips")
            for a, b in zip(got[1:4], want[1:4]):
                torch.testing.assert_close(a[both], b[both], rtol=1e-5,
                                           atol=1e-7)
        return err, x

    cluster_inputs = {}
    for dtype in (torch.float64, torch.float32):
        g, cfg = graph(FULL, dtype)
        g = pipeline.prepare(g, cfg)
        name = str(dtype).split(".")[1]
        err, x = core_case(f"seed round {name}", clustering.core_inputs(
            g, cfg, False), cfg, dtype)
        cluster_inputs[dtype] = (x, cfg)
        if dtype == torch.float64:
            record["cluster_max_abs_err"] = err
            core_case("seed round float64 kc=4", clustering.core_inputs(
                g, cfg, False, kc=4), cfg, dtype)
        for i in (1, 2):
            g, _ = pipeline.iteration(g, cfg, i)
        core_case(f"updated round {name}", clustering.core_inputs(
            g, cfg, True), cfg, dtype)

    phase("4. distinct-count kernel vs plain")
    g, cfg = graph(FULL, torch.float64)
    g, _ = pipeline.iteration(pipeline.prepare(g, cfg), cfg, 1)
    g = extrapolate.message_passing(g, cfg)
    ok_t, x_t, nx_t = priors.distinct_inputs(g)
    rng = np.random.default_rng(0)
    dup_ok = torch.from_numpy(rng.uniform(size=(4096, 64)) < 0.6).to(cuda)
    dup_x = torch.from_numpy(rng.choice([1.5, 2.5, 3.5, -1.0, 0.0],
                                        size=(4096, 64))).to(cuda)
    dup_nx = torch.from_numpy(rng.normal(size=4096) * 2.0).to(cuda)
    distinct_cases = {"reweight tables": (ok_t, x_t, nx_t),
                      "duplicate-rich": (dup_ok, dup_x, dup_nx)}
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
    x64, cfg = cluster_inputs[torch.float64]
    args = (x64.pk, x64.node_xyzr, x64.gate, x64.klthr, x64.valid)
    times = {}
    for label, fn in (
            ("gmr_cluster", lambda: cluster_kernel.cluster_core(
                *args, chi2_thr=x64.chi2_thr, cfg=cfg)),
            ("gmr_cluster_plain", lambda: cluster_kernel.cluster_core_plain(
                *args, chi2_thr=x64.chi2_thr, cfg=cfg)),
            ("distinct_counts", lambda: distinct_kernel.distinct_counts(
                ok_t, x_t, nx_t)),
            ("distinct_counts_plain",
             lambda: distinct_kernel.distinct_counts_plain(
                 ok_t, x_t, x_t < nx_t[:, None], x_t.dtype))):
        times[label] = kernel_ms(fn)
    print(f"gmr_cluster float64, {tuple(x64.pk.shape)}: kernel "
          f"{times['gmr_cluster']:.4f} ms, plain "
          f"{times['gmr_cluster_plain']:.4f} ms")
    print(f"distinct_counts float64, {tuple(x_t.shape)}: kernel "
          f"{times['distinct_counts']:.4f} ms, plain "
          f"{times['distinct_counts_plain']:.4f} ms")

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

    kernels = [
        {"name": "gmr_cluster", "route": "cuda", "source": CLUSTER_SOURCE,
         "replaces": CLUSTER_REPLACES, "launches": launches["gmr_cluster"],
         "max_abs_err": record["cluster_max_abs_err"],
         "ms": times["gmr_cluster"], "plain_ms": times["gmr_cluster_plain"]},
        {"name": "distinct_counts", "route": "cuda", "source": DISTINCT_SOURCE,
         "replaces": DISTINCT_REPLACES,
         "launches": launches["distinct_counts"],
         "max_abs_err": record["distinct_max_abs_err"],
         "ms": times["distinct_counts"],
         "plain_ms": times["distinct_counts_plain"]},
    ]
    print()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
