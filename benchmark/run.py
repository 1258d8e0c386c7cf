"""Run one benchmark cell on the card and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json `workloads`) names
a configuration (benchmark/configs/<name>.json) and a traffic mix
(benchmark/traffic/<name>.json); its metrics are read by
benchmark/metrics/<name>.py.  A run:

  1. set-up (`setup_s`, from the interpreter's first line of this module):
     torch and the CUDA context, the event file checked against its
     sha256, the pool of distinct events drawn from the seed and built on
     the device by the program's ingest (for the `files` driver: written
     as files, each built inside the window instead), and the traffic's
     warm-up dispatches through the cell's driver (the kernel library
     loads or builds; the cell's one program is captured);
  2. the window: dispatches through the driver for --seconds, every
     result waited for (the end-to-end metrics);
  3. with --trace 1, a traced sub-window of the traffic's
     `trace_dispatches` further dispatches (the per-layer metrics);
  4. the peak device memory is read, the program's state freed, and the
     reference (benchmark/reference) run on every pool event at the
     configuration's precision, with the configuration's calibration
     table where it has one; every finished event is compared with it
     (benchmark/check.py).

The last line on stdout is the result's JSON; stderr ends with the
numbers compared, each beside its limit.  Without a CUDA device with as
many cards as the cell asks for the run prints no result and exits 2; if
JAX or the JAX package is loaded in this process once the window has
closed, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_track_finding_tpu")
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def log(*args) -> None:
    print("[benchmark]", *args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def smi(query: str) -> str:
    """One nvidia-smi reading of the first card, or "" without the tool."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


class Run(SimpleNamespace):
    """What a metric reader reads (benchmark/metrics/<name>.py)."""

    def kernel_seconds(self, name: str) -> float:
        """Summed durations of the traced device events named `name`."""
        return sum(b - a for n, a, b in self.trace.device if name in n) * 1e-9

    def least_seconds(self, kernel: str) -> float:
        """The least time of the kernel's calls in the traced sub-window,
        from the reference's work counts of its events."""
        return sum(self.work[d.pool_index][kernel] for d in self.trace_done)


def run_cell(cell: dict, cfg: dict, traffic: dict, *, seed: int,
             seconds: float, trace: bool, device, metrics: list,
             root: Path = ROOT) -> dict:
    """One run of a cell -> its result (the printed line's object)."""
    import torch

    from benchmark import check, drivers, events, roofline, spec
    from benchmark import trace as tracing
    from benchmark.reference import schedule as reference

    dtype = getattr(torch, cfg["dtype"])
    path = spec.event_file(cfg, root)
    pool = events.pool_arrays(events.load(path), traffic, seed)
    bucket = cfg["pad_bucket"]
    states = drivers.pool_states(traffic, pool, path, cfg, device, dtype)
    driver = drivers.Driver(traffic, seed, states, cfg)
    driver.run(dispatches=int(traffic["warmup_dispatches"]))
    if driver.shape != (bucket["nodes"], bucket["edges"],
                        bucket["max_degree"]):
        raise spec.SpecError(f"pad bucket {driver.shape}, the configuration "
                             f"states {bucket}")
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    sync()
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s; {len(states)} events in the pool")

    handed0 = driver.handed
    t_start = time.perf_counter()
    done = driver.run(until=t_start + seconds)
    sync()
    window_s = max(d.t_out for d in done) - t_start
    handed = driver.handed - handed0
    gaps = sorted(b.t_out - a.t_out for a, b in zip(done, done[1:])
                  if b.t_out > a.t_out)
    quart = [f"{gaps[int(q * (len(gaps) - 1))] * 1e3:.2f}" for q in
             (0, 0.25, 0.5, 0.75, 1)] if gaps else []
    log(f"window {window_s:.3f} s: {len(done)} of {handed} events; "
        f"dispatch period ms min/q1/median/q3/max {'/'.join(quart)}; "
        f"clocks.sm, power.draw: {smi('clocks.sm,power.draw')}")

    run = Run(kind=traffic["driver"], setup_s=setup_s, window_s=window_s,
              done=done, trace=None, trace_done=[], work={})
    if trace:
        handed0 = driver.handed
        run.trace_done, run.trace = tracing.traced(
            lambda: driver.run(dispatches=int(traffic["trace_dispatches"])))
        handed += driver.handed - handed0
        log(f"traced {len(run.trace_done)} events: window "
            f"{run.trace.window_s:.4f} s, busy {run.trace.busy_s:.4f} s, "
            f"idle under the profiler's own work {run.trace.profiler_s:.4f} "
            f"s, {len(run.trace.device)} device events")
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    # the reference, once the program's state is freed
    driver.free()
    del states
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rcfg = reference.Config.from_dict(cfg["pipeline"])
    calibration = spec.calibration(cfg)
    answers = {}
    for block in reference.blocks(len(pool), bucket["nodes"]):
        work = roofline.Work(len(block), bucket["nodes"])
        for k, acc in zip(block, reference.run_events(
                [pool[k] for k in block], rcfg, device=device, dtype=dtype,
                work=work, calibration=calibration)):
            answers[k] = check.reference_keys(acc)
            run.work[k] = {name: v[k - block.start]
                           for name, v in work.seconds.items()}
    log(f"reference: {len(pool)} events in {time.perf_counter() - t_ref:.3f} s")

    numbers = check.compare(done + run.trace_done, answers, handed)
    checks = check.verdict(numbers, cfg["limits"])
    values = {}
    for m in metrics:
        v = spec.metric_reader(m["name"], root / "benchmark").read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": handed,
        "failed": numbers["unanswered_events"],
        "metrics": values,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": memory_peak},
    }
    if trace:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
        result["breakdown"] = {
            "device_ops": tracing.by_name(
                (n, (b - a) * 1e-9) for n, a, b in run.trace.device),
            "idle_gaps": tracing.by_name(run.trace.gaps)}
    result["checks"] = {name: [c["value"], c["limit"]]
                        for name, c in checks.items()}
    result["checks"]["events_compared"] = [numbers["events_compared"], None]
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import spec
    bench = spec.benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}: no result")
        return 2
    try:
        import gnn_track_finding_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program under test is not importable ({e}): no result")
        return 2
    log(f"{args.workload}: {torch.cuda.get_device_name(0)}; name, "
        f"power.limit: {smi('name,power.limit')}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, cfg, traffic, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=device,
                      metrics=spec.metrics_for(bench, args.workload,
                                               bool(args.trace)))
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}; no result")
        return 3
    log(f"events compared: {result['checks']['events_compared'][0]}")
    for name, (value, limit) in result["checks"].items():
        if limit is not None:
            log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
