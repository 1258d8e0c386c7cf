"""A configuration's calibration block: the KL-threshold table by feature
bin that the program's runner fits (`run.py --calibrate`: the quantile
rule on 20 toy events, seed 0), checked by `spec.calibration`, applied
per node by the reference, and handed to the program's drivers as
`kl_lut=`.

On the CPU at float64 at volume 7: the reference's emp_var is the
program's `prepare(g).grad_stats[:, 1]` bit for bit, its table lookup is
`KLThresholdLUT.thresholds_for`, and its calibrated answers are those of
the program's host driver `run_pipeline(kl_thresholds=node_thresholds(..))`;
a program that drops the table is not correct; the drivers pass `kl_lut`
only where a configuration has a calibration; every malformed block is
refused.  On the card (marked `gpu`) the full event's calibrated answers
are held to the program's, and the reference's seconds over a stream
pool printed with the table and without.

    python -m pytest benchmark/tests/test_bench_calibration.py -q -p no:cacheprovider
    python -m pytest --noconftest -q -p no:cacheprovider -m gpu -s benchmark/tests/test_bench_calibration.py
"""

from __future__ import annotations

import copy
import hashlib
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, drivers, events, roofline, run, spec
from benchmark.reference import schedule as reference
from gnn_track_finding_tpu_torch.calib import lut
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import stack_events
from gnn_track_finding_tpu_torch.models import pipeline

HERE = Path(__file__).resolve().parents[1]          # benchmark/
# the runner's table (chip_smoke.py EXPECTED_CALIBRATION: the quantile
# rule on 20 toy events of seed 0, 28 emp_var bins)
BLOCK = {
    "feature": "emp_var",
    "feature_bin_width": 705.5111035114334,
    "kl_bin_width": 4339417.077760651,
    "lower": [0, 0, 4, 0, 25] + [0] * 23,
    "upper": [1, 45, 95, 1, 26, 50, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
              0, 0, 0, 0, 0, 0, 0, 1, 20],
    "source": "run.py --calibrate: calib/lut.fit_lut_quantile on 20 toy "
              "events of seed 0",
}
TABLE = lut.KLThresholdLUT(BLOCK["feature"], BLOCK["feature_bin_width"],
                           BLOCK["kl_bin_width"],
                           np.asarray(BLOCK["lower"], np.int64),
                           np.asarray(BLOCK["upper"], np.int64))
V7 = spec.config("trackml_v7_f64")
V7_LUT = dict(copy.deepcopy(V7), calibration=BLOCK)
PCFG = PipelineConfig(**V7["pipeline"])
RCFG = reference.Config.from_dict(V7["pipeline"])
# accepted candidates per iteration under the table (the program's host
# driver without a tracker)
COUNTS = {"unrotated": [1022, 14, 0], "seed99": [1022, 16, 1]}


def _program_state(arrays, device="cpu", dtype=torch.float64):
    return build_graph_state(arrays["xyzr"], arrays["vivl"],
                             arrays["truth_particle"], arrays["pairs"], PCFG,
                             device=device, dtype=dtype,
                             mirror=arrays["mirror"],
                             component=arrays["component"])


@pytest.fixture(scope="module")
def v7():
    """The unrotated volume-7 event and the pool event of seed 99, with
    each one's program state."""
    raw = events.load(spec.event_file(V7))
    arrays = {"unrotated": raw,
              "seed99": events.pool_arrays(raw, {"pool": 1}, seed=99)[0]}
    return {k: (a, _program_state(a)) for k, a in arrays.items()}


def _emp_var_pair(v7, which):
    """(reference, program) emp_var of an event or of both stacked."""
    names = ["unrotated", "seed99"] if which == "union" else [which]
    g_ref = reference.build([v7[k][0] for k in names], RCFG, device="cpu",
                            dtype=torch.float64)
    g = stack_events([v7[k][1] for k in names])
    return reference.emp_var(g_ref), pipeline.prepare(g, PCFG).grad_stats[:, 1]


@pytest.mark.parametrize("which", ["unrotated", "seed99", "union"])
def test_emp_var_is_the_programs(v7, which):
    got, want = _emp_var_pair(v7, which)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lookup_is_thresholds_for(v7, dtype):
    """The reference's table lookup reads as numpy's on both events'
    emp_var, NaN, inf, 0, every bin edge and beside it, and past the last
    bin, out to where numpy's cast to int64 overflows."""
    fbw, n_bins = BLOCK["feature_bin_width"], len(BLOCK["upper"])
    edges = np.arange(n_bins + 2) * fbw
    special = np.concatenate([
        [np.nan, np.inf, 0.0, 1e-300, 10 * n_bins * fbw, 1e18, 1e22, 1e30],
        edges, np.nextafter(edges, -np.inf), np.nextafter(edges, np.inf)])
    values = np.concatenate([_emp_var_pair(v7, "union")[1].numpy(), special])
    feature = torch.as_tensor(values).to(dtype)
    with np.errstate(invalid="ignore"):
        want = torch.as_tensor(TABLE.thresholds_for(feature.numpy())
                               ).to(dtype)
    got = reference.lut_thresholds(BLOCK, feature, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    first = torch.tensor(BLOCK["upper"][0] * BLOCK["kl_bin_width"],
                         dtype=torch.float64).to(dtype)
    assert torch.all(reference.lut_thresholds(BLOCK, torch.tensor(
        [np.nan, np.inf, 1e30], dtype=dtype), dtype) == first)


@pytest.fixture(scope="module")
def answers(v7):
    """Per event: the program's host driver under the table, and the
    reference with the calibration and without."""
    out = {}
    for k, (arrays, g) in v7.items():
        res = pipeline.run_pipeline(
            g, PCFG, kl_thresholds=lut.node_thresholds(TABLE, g, PCFG))
        out[k] = SimpleNamespace(
            program=res.candidates,
            reference=reference.run_events([arrays], RCFG, device="cpu",
                                           calibration=BLOCK)[0],
            plain=reference.run_events([arrays], RCFG, device="cpu")[0])
    return out


@pytest.mark.parametrize("which", list(COUNTS))
def test_calibrated_reference_is_the_program(answers, which):
    a = answers[which]
    got, want = check.program_keys(a.program), check.reference_keys(
        a.reference)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert [len(acc.nodes) for acc in a.reference] == COUNTS[which]


@pytest.mark.parametrize("which", list(COUNTS))
def test_calibration_changes_the_answer(answers, which):
    a = answers[which]
    plain, cal = (check.reference_keys(x) for x in (a.plain, a.reference))
    assert len(plain) > len(cal) > 1000 and plain.keys() != cal.keys()


def _dropped(stream):
    """A program that takes the table and does not apply it."""
    def broken(graphs, cfg, depth=1, kl_lut=None):
        assert kl_lut is not None
        return stream(graphs, cfg, depth)
    return broken


def _applied(stream):
    """A program that applies the table, through its host driver."""
    def honest(graphs, cfg, depth=1, kl_lut=None):
        for g in graphs:
            yield pipeline.run_pipeline(
                g, cfg, kl_thresholds=lut.node_thresholds(kl_lut, g, cfg))
    return honest


@pytest.mark.parametrize("make,correct", [(_dropped, False), (_applied, True)])
def test_a_program_that_drops_the_table_is_not_correct(monkeypatch, make,
                                                       correct):
    """A run of the harness on a calibrated copy of the volume-7
    configuration (the look for a card skipped): a program that ignores
    `kl_lut` answers with mismatched candidates; one that applies it
    through its host driver is correct."""
    monkeypatch.setattr(pipeline, "stream_pipeline",
                        make(pipeline.stream_pipeline))
    traffic = {"driver": "stream", "pool": 1, "depth": 1,
               "warmup_dispatches": 1, "trace_dispatches": 1}
    result = run.run_cell({"chips": 1}, V7_LUT, traffic, seed=2**31 + 91,
                          seconds=0.1, trace=False,
                          device=torch.device("cpu"), metrics=[])
    assert result["correct"] is correct, result["checks"]
    assert result["checks"]["events_compared"][0] >= 1
    assert (result["checks"]["mismatched_candidates"][0] > 0) is not correct


class _Recording:
    """A program's two production drivers that record their keywords and
    answer nothing."""

    def __init__(self):
        self.keywords = []

    def stream_pipeline(self, graphs, cfg, **kw):
        self.keywords.append(kw)
        for _ in graphs:
            yield SimpleNamespace(candidates=[])

    def run_pipeline_batched(self, graphs, cfg, **kw):
        self.keywords.append(kw)
        return [SimpleNamespace(candidates=[]) for _ in graphs]

    def clear_programs(self):
        pass


@pytest.mark.parametrize("driver", ["stream", "batch", "files"])
@pytest.mark.parametrize("config", ["trackml_v7-14_f64", "trackml_v7_f64",
                                    "calibrated copy"])
def test_kl_lut_only_with_a_calibration(monkeypatch, driver, config):
    cfg = V7_LUT if config == "calibrated copy" else spec.config(config)
    fake = _Recording()
    shape = SimpleNamespace(num_padded_nodes=1, num_padded_edges=1,
                            max_degree=1)
    monkeypatch.setattr(drivers, "program", lambda: (
        PipelineConfig, lambda *a, **kw: shape, fake))
    traffic = {"driver": driver, "pool": 2, "batch": 2, "depth": 1}
    if driver == "files":
        path = spec.event_file(V7)
        states = drivers.EventFiles(events.pool_arrays(
            events.load(path), traffic, 5), path, "cpu", torch.float64)
    else:
        states = [shape, shape]
    d = drivers.Driver(traffic, 5, states, cfg)
    done = d.run(dispatches=2)
    d.free()
    assert len(done) == (4 if driver == "batch" else 2)
    assert len(fake.keywords) == (2 if driver == "batch" else 1)
    for kw in fake.keywords:
        base = {} if driver == "batch" else {"depth": 1}
        if config != "calibrated copy":
            assert kw == base
            continue
        assert set(kw) == set(base) | {"kl_lut"}
        table = kw["kl_lut"]
        assert isinstance(table, lut.KLThresholdLUT)
        assert (table.feature, table.feature_bin_width, table.kl_bin_width) \
            == (BLOCK["feature"], BLOCK["feature_bin_width"],
                BLOCK["kl_bin_width"])
        for name in ("lower", "upper"):
            arr = getattr(table, name)
            assert arr.dtype == np.int64 and arr.tolist() == BLOCK[name]


def _malformed():
    cases = {f"no {k}": {x: v for x, v in BLOCK.items() if x != k}
             for k in spec.CALIBRATION_KEYS}
    bad = {"feature degree": ("feature", "degree"),
           "empty bins": ("lower", []),
           "lengths differ": ("upper", BLOCK["upper"][:-1]),
           "a float bin": ("upper", [1.5] + BLOCK["upper"][1:]),
           "a string bin": ("upper", ["1"] + BLOCK["upper"][1:]),
           "a bool bin": ("lower", [True] + BLOCK["lower"][1:]),
           "a negative bin": ("lower", [-1] + BLOCK["lower"][1:]),
           "lower over upper": ("lower", [2] + BLOCK["lower"][1:]),
           "zero width": ("feature_bin_width", 0.0),
           "negative width": ("kl_bin_width", -1.0),
           "infinite width": ("feature_bin_width", float("inf")),
           "NaN width": ("kl_bin_width", float("nan")),
           "string width": ("kl_bin_width", "1.0")}
    cases.update({name: dict(BLOCK, **{k: v}) for name, (k, v) in bad.items()})
    cases["not an object"] = [BLOCK]
    return cases


MALFORMED = _malformed()


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_block_is_refused(case):
    with pytest.raises(spec.SpecError):
        spec.calibration(dict(V7, calibration=MALFORMED[case]))


def _digests(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(d.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_calibrated_copy_is_found_by_name(tmp_path):
    """A configuration added as a new file with a block is found by name
    and its block read back; the committed ones have none; no file that
    was there changes."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    (tmp_path / "benchmark" / "configs" / "extra_lut_f64.json").write_text(
        json.dumps(V7_LUT))
    here = tmp_path / "benchmark"
    assert spec.calibration(spec.config("extra_lut_f64", here)) == BLOCK
    for name in ("trackml_v7-14_f64", "trackml_v7_f64"):
        assert spec.calibration(spec.config(name, here)) is None
    after = _digests(here)
    assert {k: after[k] for k in before} == before


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


FULL = spec.config("trackml_v7-14_f64")


@pytest.mark.gpu
def test_calibrated_full_event_is_the_program_on_the_card(cuda):
    """The unrotated full event at float64 on the card: the reference under
    the table against the program's eager host driver under the same
    table; the node thresholds alike, the keys equal, the p-values within
    1e-12."""
    raw = events.load(spec.event_file(FULL))
    cfg = PipelineConfig(**FULL["pipeline"])
    g = build_graph_state(raw["xyzr"], raw["vivl"], raw["truth_particle"],
                          raw["pairs"], cfg, device=cuda,
                          dtype=torch.float64, mirror=raw["mirror"],
                          component=raw["component"])
    ev = pipeline.prepare(g, cfg).grad_stats[:, 1]
    thr = lut.node_thresholds(TABLE, g, cfg)
    t0 = time.perf_counter()
    res = pipeline.run_pipeline(g, cfg, kl_thresholds=thr)
    torch.cuda.synchronize(cuda)
    t_program = time.perf_counter() - t0
    got = check.program_keys(res.candidates)
    del res, g
    torch.cuda.empty_cache()
    rcfg = reference.Config.from_dict(FULL["pipeline"])
    g_ref = reference.build([raw], rcfg, device=cuda, dtype=torch.float64)
    ev_ref = reference.emp_var(g_ref)
    thr_ref = reference.lut_thresholds(BLOCK, ev_ref, torch.float64)
    differ = int((ev_ref != ev).sum()) - int((ev_ref.isnan()
                                              & ev.isnan()).sum())
    t0 = time.perf_counter()
    acc = reference.schedule(g_ref, rcfg, calibration=BLOCK)[0]
    torch.cuda.synchronize(cuda)
    t_ref = time.perf_counter() - t0
    want = check.reference_keys(acc)
    counts = [len(a.nodes) for a in acc]
    gap = max((float(np.max(np.abs(got[k] - want[k])))
               for k in want.keys() & got.keys()), default=0.0)
    print(f"full event, calibrated, float64 on {torch.cuda.get_device_name(cuda)}: "
          f"reference {counts} in {t_ref:.3f} s, program "
          f"{[sum(1 for k in got if k[0] == i) for i in (1, 2, 3)]} in "
          f"{t_program:.3f} s; emp_var differs at {differ} nodes; "
          f"thresholds 0 at {int((thr_ref == 0).sum())} nodes, differ at "
          f"{int((thr_ref != thr).sum())}; widest p-value gap {gap!r}")
    assert torch.equal(thr_ref, thr)
    assert got.keys() == want.keys() and gap <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 505])
def test_calibrated_reference_seconds_on_the_card(cuda, seed):
    """The reference's seconds over the stream cell's pool of full events,
    blocked as a run blocks them, with the table and without; every
    event's answer differs between the two."""
    traffic = spec.traffic("device_stream")
    pool = events.pool_arrays(events.load(spec.event_file(FULL)), traffic,
                              seed)
    rcfg = reference.Config.from_dict(FULL["pipeline"])
    n_pad = FULL["pad_bucket"]["nodes"]
    seconds, answers = {}, {}
    for name, cal in (("plain", None), ("calibrated", BLOCK),
                      ("plain again", None), ("calibrated again", BLOCK)):
        torch.cuda.synchronize(cuda)
        t0 = time.perf_counter()
        keys = []
        for block in reference.blocks(len(pool), n_pad):
            work = roofline.Work(len(block), n_pad)
            keys += [check.reference_keys(a) for a in reference.run_events(
                [pool[k] for k in block], rcfg, device=cuda, work=work,
                calibration=cal)]
        torch.cuda.synchronize(cuda)
        seconds[name] = time.perf_counter() - t0
        answers[name] = keys
    print(f"reference over {len(pool)} full events (seed {seed}): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
          + "; accepted per event plain "
          + str([len(a) for a in answers["plain"]]) + ", calibrated "
          + str([len(a) for a in answers["calibrated"]]))
    for name in ("plain", "calibrated"):
        assert all(_same(a, b) for a, b in
                   zip(answers[name], answers[f"{name} again"]))
    assert all(a.keys() != b.keys() for a, b in
               zip(answers["plain"], answers["calibrated"]))


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
