"""CPU tests of the `files` driver: the pool's events written as files in
the program's event-cache layout, read back as the pool's arrays,
answered as the `stream` driver answers them, and removed when the run
ends; the traffic of the other mixes as before, and a files mix found by
name.

    python -m pytest benchmark/tests/test_bench_files.py -q -p no:cacheprovider
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, drivers, events, spec
from gnn_track_finding_tpu_torch.data import event_cache

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent
SEED = 2**31 + 4242
# sha256 of each mix's draws and first six dispatches at SEED, as the
# traffic generator gave them before the files driver was added
DIGESTS = {
    ("device_stream", 55701):
        "5e9382a6fc68510f24a077fe07f7292ad08d1af50fe994197f7c48fb838443ac",
    ("device_batch32", 8748):
        "2440432c61ea7889bee83fe8294b7d215bcca8a46c9be0ff1ae21725c5403d0f",
}
ARRAYS = ("xyzr", "vivl", "truth_particle", "pairs", "mirror", "component")


def _traffic_digest(traffic: dict, n: int) -> str:
    angles, shifts = events.draws(traffic, SEED, n)
    order = events.orders(traffic, SEED)
    dispatches = [next(order) for _ in range(6)]
    return hashlib.sha256(angles.tobytes() + shifts.astype(np.int64).tobytes()
                          + json.dumps(dispatches).encode()).hexdigest()


@pytest.mark.parametrize("name,n", list(DIGESTS))
def test_other_mixes_draw_as_before(name, n):
    assert _traffic_digest(spec.traffic(name), n) == DIGESTS[name, n]


def test_files_mix_draws_the_stream_pool():
    """A seed gives the files cell the stream cell's events and order."""
    files, stream = spec.traffic("file_stream"), spec.traffic("device_stream")
    assert files["pool"] == stream["pool"]
    for a, b in zip(events.draws(files, SEED, 55701),
                    events.draws(stream, SEED, 55701)):
        np.testing.assert_array_equal(a, b)
    take = lambda t: [next(o) for o in [events.orders(t, SEED)]
                      for _ in range(20)]
    assert take(files) == take(stream)


def test_unknown_driver_raises():
    with pytest.raises(ValueError, match="unknown driver"):
        next(events.orders({"driver": "nope", "pool": 2}, SEED))


@pytest.fixture(scope="module", params=["trackml_v7_f64", "trackml_v7-14_f64"])
def written(request):
    """Two pool events of a configuration written as files -> (pool,
    EventFiles)."""
    cfg = spec.config(request.param)
    path = spec.event_file(cfg)
    traffic = {"driver": "files", "pool": 2}
    pool = events.pool_arrays(events.load(path), traffic, SEED)
    files = drivers.EventFiles(pool, path, "cpu", torch.float64)
    yield pool, files
    files.remove()


def test_files_read_back_as_the_pool(written):
    """load_npz gives each pool event's arrays bitwise, dtypes included."""
    pool, files = written
    assert len(files) == len(pool)
    for arrays, path in zip(pool, files.paths):
        xyzr, vivl, tp, pairs, extra, pre = event_cache.load_npz(path)
        got = dict(xyzr=xyzr, vivl=vivl, truth_particle=tp, pairs=pairs,
                   mirror=pre["mirror"], component=pre["component"])
        for k in ARRAYS:
            assert got[k].dtype == arrays[k].dtype, k
            np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
        np.testing.assert_array_equal(extra["components"], arrays["component"])


def test_files_driver_answers_as_the_stream():
    """At volume 7 on the CPU, two dispatches of the files driver give the
    stream driver's candidates on the same pool; each factory's seconds
    and the feed's waits are recorded, the stream's are not, and the two
    ingest readers read them; the files lie under the temporary directory,
    and free() removes them."""
    cfg = spec.config("trackml_v7_f64")
    path = spec.event_file(cfg)
    traffic = {"driver": "files", "pool": 2, "depth": 1}
    pool = events.pool_arrays(events.load(path), traffic, SEED)
    files = drivers.pool_states(traffic, pool, path, cfg, "cpu",
                                torch.float64)
    assert Path(files.directory).parent == Path(tempfile.gettempdir())
    driver = drivers.Driver(traffic, SEED, files, cfg)
    got = driver.run(dispatches=2)
    assert driver.shape == (12288, 16384, 32) and driver.handed == 2
    stream = drivers.Driver(dict(traffic, driver="stream"), SEED,
                            drivers.build_states(pool, cfg, "cpu",
                                                 torch.float64), cfg)
    want = stream.run(dispatches=2)
    assert stream.shape == driver.shape
    assert [d.pool_index for d in got] == [d.pool_index for d in want] == \
        [0, 1]
    for a, b in zip(got, want):
        assert check.program_keys(a.candidates).keys() == \
            check.program_keys(b.candidates).keys()
        assert a.t_in <= a.t_out and a.ingest_s > 0 and a.wait_s >= 0
        assert b.ingest_s is None and b.wait_s is None
    for name in ("ingest_host_ms_per_event", "ingest_wait_ms_per_event"):
        reader = spec.metric_reader(name, HERE)
        assert reader.read(SimpleNamespace(done=got)) > 0
        assert reader.read(SimpleNamespace(done=want)) is None
    driver.free()
    stream.free()
    assert not os.path.exists(files.directory)


def _digests(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(d.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_mix_is_found_by_name(tmp_path):
    """A mix for the files driver added as a new file and a cell is found
    and ordered, and no file that was there changes."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "benchmark")
    (tmp_path / "benchmark" / "traffic" / "extra_files.json").write_text(
        json.dumps({"driver": "files", "pool": 4, "depth": 1,
                    "warmup_dispatches": 4, "trace_dispatches": 2}))
    bench["workloads"].append({"name": "extra.files", "config":
                               "trackml_v7_f64", "traffic": "extra_files",
                               "chips": 1, "why": "w"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from benchmark import events, spec\n"
            "b = spec.benchmark()\n"
            "w = spec.workload(b, 'extra.files')\n"
            "t = spec.traffic(w['traffic'])\n"
            "o = events.orders(t, 5)\n"
            "names = [m['name'] for m in spec.metrics_for(b, 'extra.files', True)]\n"
            "print(t['driver'], t['driver'] in events.DRIVERS,"
            " [next(o)[0] for _ in range(5)], names)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("files True [0, 1, 2, 3, 0]")
    assert "'ingest_host_ms_per_event'" not in out.stdout
    after = _digests(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before
