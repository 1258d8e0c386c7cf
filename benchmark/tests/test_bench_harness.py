"""CPU tests of the benchmark's harness: pieces found by name, seeded
traffic, the import rules, no result without a card, and the reference
against the program at volume 7.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, events, spec
from benchmark.reference import schedule as reference

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gnn_track_finding_tpu"}
PROGRAM = "gnn_track_finding_tpu_torch"


def _digests(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(d.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_pieces_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as new files and
    entries are found, and no file that was there changes."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "benchmark")
    (tmp_path / "benchmark" / "configs" / "extra_cfg.json").write_text(
        json.dumps({"marker": "cfg-found"}))
    (tmp_path / "benchmark" / "traffic" / "extra_mix.json").write_text(
        json.dumps({"driver": "batch", "pool": 4, "batch": 2}))
    (tmp_path / "benchmark" / "metrics" / "extra_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "extra_cfg", "source": "s",
                             "file": "benchmark/configs/extra_cfg.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "extra.cell", "config": "extra_cfg",
                               "traffic": "extra_mix", "chips": 1,
                               "why": "w"})
    bench["per_layer"].append({"name": "extra_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "l", "moves": "events_per_s",
                               "workloads": ["extra.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from benchmark import spec\n"
            "b = spec.benchmark()\n"
            "w = spec.workload(b, 'extra.cell')\n"
            "names = [m['name'] for m in spec.metrics_for(b, 'extra.cell', True)]\n"
            "print(spec.config(w['config'])['marker'],"
            " spec.traffic(w['traffic'])['driver'],"
            " spec.metric_reader('extra_metric').read(None), names)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:3] == ["cfg-found", "batch", "42.0"]
    assert "'extra_metric'" in out.stdout
    assert "'graph_nodes_per_event'" not in out.stdout
    after = _digests(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before


def test_every_named_piece_exists():
    """Each configuration, traffic mix and metric of BENCHMARK.json has its
    file, and each configuration's event file its stated sha256."""
    bench = spec.benchmark()
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert (ROOT / c["file"]).is_file()
        spec.event_file(cfg)
        assert set(cfg["limits"]) == set(check.NAMES)
    for w in bench["workloads"]:
        assert spec.traffic(w["traffic"])["driver"] in events.DRIVERS
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("name", ["device_stream", "device_batch32"])
def test_traffic_is_the_seeds(name):
    """The same seed gives the same events and order; another seed other
    angles and (batch) another order of the same pool."""
    traffic = spec.traffic(name)
    big = 2**31 + 12345
    d1, d2, d3 = (events.draws(traffic, s, 8748) for s in (big, big, big + 1))
    for a, b, c in zip(d1, d2, d3):
        assert a.shape == (traffic["pool"],)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
    assert d1[1].min() >= 1 and d1[1].max() < 8748
    take = lambda s: [next(o) for o in [events.orders(traffic, s)]
                      for _ in range(5)]
    o1, o2, o3 = take(big), take(big), take(-7)
    assert o1 == o2
    for order in o1 + o3:
        assert len(set(order)) == len(order)
        assert all(0 <= k < traffic["pool"] for k in order)
    if traffic["driver"] == "batch":
        assert o1 != o3 and o1[0] != o1[1]
        assert all(len(o) == traffic["batch"] for o in o1)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_and_an_independent_reference():
    """No file of the benchmark imports JAX or the JAX package (top-level
    names compared whole: the program's name begins with the JAX
    package's), and the reference imports nothing of the program."""
    files = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                   p.parts)
    assert files
    for p in files:
        assert not _imports(p) & FORBIDDEN, p
    for p in (HERE / "reference").rglob("*.py"):
        assert PROGRAM not in _imports(p), p
        assert "benchmark" not in _imports(p), p


@pytest.mark.parametrize("only_benchmark", [False, True])
def test_no_card_no_result(tmp_path, only_benchmark):
    """Without a CUDA device (or, in a directory that holds only
    BENCHMARK.json and the benchmark, without the program too) the
    command exits non-zero and prints no result line."""
    cwd = ROOT
    if only_benchmark:
        shutil.copytree(HERE, tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "v7-14.device_stream", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                          "PYTHONPATH": str(cwd)})
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines()
                if line.startswith("{")]


def test_reference_is_the_program_at_volume7():
    """At float64 on the CPU the reference's answers are the program's to
    the last bit (both run the same arithmetic in the same order), on a
    rotated volume-7 event."""
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.graph.build import build_graph_state
    from gnn_track_finding_tpu_torch.models import pipeline
    cfg = spec.config("trackml_v7_f64")
    raw = events.load(spec.event_file(cfg))
    arrays = events.pool_arrays(raw, {"pool": 1}, seed=99)[0]
    pcfg = PipelineConfig(**cfg["pipeline"])
    g = build_graph_state(arrays["xyzr"], arrays["vivl"],
                          arrays["truth_particle"], arrays["pairs"], pcfg,
                          device="cpu", mirror=arrays["mirror"],
                          component=arrays["component"])
    got = check.program_keys(pipeline.run_pipeline_eager(g, pcfg).candidates)
    want = check.reference_keys(reference.run_events(
        [arrays], reference.Config.from_dict(cfg["pipeline"]),
        device="cpu")[0])
    assert len(want) > 1000 and got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert set(reference.Config._fields) <= {
        f.name for f in dataclasses.fields(PipelineConfig)}
