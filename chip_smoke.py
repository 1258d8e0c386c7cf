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
     shapes, per-stage and per-event wall times, streamed events/s;
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
before the last is the kernels' JSON record; the last line is
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
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())
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

    phase("7. the host driver: run_pipeline with the extraction-leak replay")
    from tools import validate_port_vs_reference as vpr
    from tools import validate_vs_reference as vvr
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

    res = vvr.compare(vvr.load_digest(), vpr.compute_port_states(cuda))
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
         "ms": times["gmr_cluster"], "plain_ms": times["gmr_cluster_plain"]},
        {"name": "distinct_counts", "route": "cuda", "source": DISTINCT_SOURCE,
         "replaces": DISTINCT_REPLACES,
         "launches": launches["distinct_counts"],
         "launches_run_pipeline": host_launches["distinct_counts"],
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
