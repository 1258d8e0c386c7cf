"""Time the kernels of an earlier commit against the current ones on one
card, in turns (old, new, new, old), on the full event.

The earlier kernels are those whose clustering entry takes packed rows
(pk, node_xyzr, gate, klthr, valid, ...), as up to commit c136b8b.  Unpack
their sources into the git-ignored build/ and run from the repository root:

    mkdir -p build/ab_old
    git archive c136b8b gnn_track_finding_tpu_torch/csrc | tar -x -C build/ab_old
    python3 tools/kernel_ab.py build/ab_old/gnn_track_finding_tpu_torch/csrc

The earlier sources are compiled here with the package's nvcc flags and
loaded with ctypes; the package is not touched.  Per dtype it checks the
outputs equal (bitwise at float64) and then times, each as device time
per call (chip_smoke.device_ms) with the L2 flushed before every call and
warm: the earlier clustering kernel alone on the packed rows against the
current kernel, per round (seed, and updated after iterations 1-2), and
the distinct counts on the reweight tables.  At float64 it also times the
clustering stage (clustering.cluster, CUDA events over back-to-back
calls; it synchronises with the host) with the earlier path (the packed
gather, then the earlier kernel) in place of the current core.  Prints
one JSON line last.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from chip_smoke import L2_FLUSH_BYTES, call_ms, device_ms  # noqa: E402
from gnn_track_finding_tpu_torch import _build  # noqa: E402
from gnn_track_finding_tpu_torch.config import PipelineConfig  # noqa: E402
from gnn_track_finding_tpu_torch.data.event_cache import load_npz  # noqa: E402
from gnn_track_finding_tpu_torch.graph.build import build_graph_state  # noqa: E402
from gnn_track_finding_tpu_torch.models import pipeline  # noqa: E402
from gnn_track_finding_tpu_torch.ops import (cluster_kernel, clustering,  # noqa: E402
                                             distinct_kernel, extrapolate,
                                             priors)

FULL = REPO / ".event_cache" / "event_7bba1cb4ae95bca1.npz"
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the earlier C entry points, one per dtype suffix
OLD_SIGNATURES = {
    # x, ok, node_x, out, n, k, stream
    "distinct_counts": [_P, _P, _P, _P, _I, _I, _P],
    # pk, nodex, gate, klthr, valid, rows, kc, chi2_thr, endcap, s_rz,
    # s_rz2, bug_compat, found, pm, pc, mprior, deact, stream
    "gmr_cluster": [_P] * 5 + [_I, _I, _D, _D, _D, _D, _I] + [_P] * 6,
}


def build_old(csrc: Path) -> ctypes.CDLL:
    """Compile the earlier sources (one nvcc each, then linked) into the
    git-ignored build/ and load them."""
    out = REPO / "build" / "ab_old_lib"
    out.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out))
    srcs = sorted(Path(csrc).glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no .cu sources in {csrc}")
    objs = [tmp / f"{s.stem}.o" for s in srcs]
    _build._run_all([[_build._nvcc()] + _build.NVCC_FLAGS
                     + ["-c", "-o", str(o), str(s)]
                     for s, o in zip(srcs, objs)])
    path = tmp / "libold_kernels.so"
    _build._run_all([[_build._nvcc(), "-shared", "-o", str(path)]
                     + [str(o) for o in objs]])
    lib = ctypes.CDLL(str(path))
    for name, argtypes in OLD_SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card)
    lib = build_old(Path(argv[0]))
    cuda = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=cuda)

    def old_fn(name, dtype):
        suffix = "f64" if dtype == torch.float64 else "f32"
        return getattr(lib, f"{name}_{suffix}")

    def old_core(pk, valid, node_xyzr, klthr, chi2_thr, cfg):
        rows, kc = valid.shape
        dtype = pk.dtype
        gate = torch.ones((rows,), dtype=torch.bool, device=cuda)
        out = (torch.empty((rows,), dtype=torch.bool, device=cuda),
               torch.empty((rows, 3), dtype=dtype, device=cuda),
               torch.empty((rows, 9), dtype=dtype, device=cuda),
               torch.empty((rows,), dtype=dtype, device=cuda),
               torch.empty((rows, kc), dtype=torch.bool, device=cuda))
        rc = old_fn("gmr_cluster", dtype)(
            pk.data_ptr(), node_xyzr.data_ptr(), gate.data_ptr(),
            klthr.data_ptr(), valid.data_ptr(), rows, kc, float(chi2_thr),
            float(cfg.endcap_boundary), float(cfg.sigma0rz),
            float(cfg.sigma0rz2), int(cfg.bug_compat),
            *(t.data_ptr() for t in out), _build.stream_handle(cuda))
        _build.check(rc, "earlier gmr_cluster")
        return out

    def old_path(states, tab, node_xyzr, klthr, count=None, *, chi2_thr,
                 cfg):
        """The earlier clustering core: the packed gather, then the
        earlier kernel (cluster_kernel.cluster_core's signature; the rows
        past `count` hold no member, so it finds nothing there)."""
        pk, valid = cluster_kernel.pack_rows(states, tab)
        return old_core(pk, valid, node_xyzr, klthr, chi2_thr, cfg)

    def old_distinct(ok, x, node_x):
        out = torch.empty((x.shape[0], 2), dtype=x.dtype, device=cuda)
        rc = old_fn("distinct_counts", x.dtype)(
            x.data_ptr(), ok.data_ptr(), node_x.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], _build.stream_handle(cuda))
        _build.check(rc, "earlier distinct_counts")
        return out

    def in_turns(old, new) -> dict:
        res = {}
        for label, fl in (("flushed", flush), ("warm", None)):
            a1, b1, b2, a2 = (device_ms(f, flush=fl)
                              for f in (old, new, new, old))
            res[label] = {"old_ms": [a1, a2], "new_ms": [b1, b2]}
        return res

    xyzr, vivl, tp, pairs, extra, pre = load_npz(FULL)
    cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                         max_volume=int(vivl[:, 0].max()))
    result = {"card": card}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        g = pipeline.prepare(build_graph_state(
            xyzr, vivl, tp, pairs, cfg, device=cuda, dtype=dtype,
            mirror=pre["mirror"], component=pre["component"]), cfg)
        g1, _ = pipeline.iteration(g, cfg, 1)
        g2, _ = pipeline.iteration(g1, cfg, 2)
        for rnd, gr in (("seed", g), ("updated", g2)):
            x = clustering.core_inputs(gr, cfg, rnd == "updated")
            pk, valid = cluster_kernel.pack_rows(x.states, x.tab)
            old = lambda: old_core(pk, valid, x.node_xyzr, x.klthr,
                                   x.chi2_thr, cfg)
            new = lambda: cluster_kernel.cluster_core(
                x.states, x.tab, x.node_xyzr, x.klthr, x.count,
                chi2_thr=x.chi2_thr, cfg=cfg)
            want, got = old(), new()
            torch.cuda.synchronize()
            if dtype == torch.float64:
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, rtol=0, atol=0,
                                               equal_nan=True)
            else:
                print(f"{rnd} {name}: {int((got[0] != want[0]).sum())} flag "
                      "flips against the earlier kernel")
            key = f"gmr_cluster {rnd} {name}"
            res = {"rows": x.tab.shape[0], "live_rows": int(x.count),
                   "earlier kernel alone vs current": in_turns(old, new)}
            if dtype == torch.float64:
                stage = lambda: clustering.cluster(gr, cfg, rnd == "updated")
                current = cluster_kernel.cluster_core
                walls = {"old_ms": [], "new_ms": []}
                try:
                    for core, label in ((old_path, "old_ms"),
                                        (current, "new_ms"),
                                        (current, "new_ms"),
                                        (old_path, "old_ms")):
                        cluster_kernel.cluster_core = core
                        walls[label].append(call_ms(stage, reps=10))
                finally:
                    cluster_kernel.cluster_core = current
                res["clustering stage (gather + earlier kernel vs current)"] = walls
            result[key] = res
            print(key, json.dumps(res), flush=True)
        gm = extrapolate.message_passing(g1, cfg)
        ok_t, x_t, nx_t = priors.distinct_inputs(gm)
        if not torch.equal(old_distinct(ok_t, x_t, nx_t),
                           distinct_kernel.distinct_counts(ok_t, x_t, nx_t)):
            raise RuntimeError("distinct counts differ")
        key = f"distinct_counts {name}"
        result[key] = {"shape": list(x_t.shape), **in_turns(
            lambda: old_distinct(ok_t, x_t, nx_t),
            lambda: distinct_kernel.distinct_counts(ok_t, x_t, nx_t))}
        print(key, json.dumps(result[key]), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
