"""What BENCHMARK.json names, found by name: cells, configurations,
traffic mixes and metric readers.

A configuration is `benchmark/configs/<name>.json`, a traffic mix
`benchmark/traffic/<name>.json`, a metric `benchmark/metrics/<name>.py`
(a module with `read(run) -> float | None`).  Adding one is adding its
file and its entry in BENCHMARK.json; no file here changes.

A configuration may carry a calibration block beside `pipeline` (which
stays the program's PipelineConfig field for field): the KL-threshold
table a run uses, by feature bin, as the program's calib/lut.py fits it
and its text file holds it (row i: i, lower, upper), with the two bin
widths the text file does not carry:

    "calibration": {"feature": "emp_var", "feature_bin_width": 705.51...,
                    "kl_bin_width": 4339417.07..., "lower": [...],
                    "upper": [...], "source": "..."}
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, is missing or malformed."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return _json(here / "configs" / f"{name}.json")


CALIBRATION_KEYS = ("feature", "feature_bin_width", "kl_bin_width", "lower",
                    "upper", "source")


def calibration(cfg: dict) -> dict | None:
    """The configuration's calibration block, checked, or None without
    one: the feature `emp_var`, two finite positive bin widths, and per
    feature bin an accepted KL band [lower, upper) in KL bins, whole
    numbers with lower <= upper."""
    block = cfg.get("calibration")
    if block is None:
        return None
    if not isinstance(block, dict):
        raise SpecError("the calibration block is not an object")
    missing = [k for k in CALIBRATION_KEYS if k not in block]
    if missing:
        raise SpecError(f"the calibration block lacks {missing}")
    if block["feature"] != "emp_var":
        raise SpecError(f"calibration feature {block['feature']!r}: only "
                        f"'emp_var' is read")
    for k in ("feature_bin_width", "kl_bin_width"):
        v = block[k]
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not math.isfinite(v) or v <= 0:
            raise SpecError(f"calibration {k} {v!r} is not a finite "
                            f"positive number")
    lower, upper = block["lower"], block["upper"]
    if not isinstance(lower, list) or not isinstance(upper, list) \
            or not lower or len(lower) != len(upper):
        raise SpecError("calibration lower and upper are not two lists of "
                        "one length of at least 1")
    for v in lower + upper:
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise SpecError(f"calibration bin value {v!r} is not a whole "
                            f"number of at least 0")
    bad = [i for i, (lo, hi) in enumerate(zip(lower, upper)) if lo > hi]
    if bad:
        raise SpecError(f"calibration lower > upper in bins {bad}")
    return {k: block[k] for k in CALIBRATION_KEYS}


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def metric_reader(name: str, here: Path = HERE) -> ModuleType:
    """The reader of metric `name`: metrics/<name>.py."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader metrics/{name}.py for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; an entry with `workloads` only in those."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def event_file(cfg: dict, root: Path = ROOT) -> Path:
    """The configuration's event file, checked against its sha256: the
    inputs are the yardstick's, and a changed file is refused."""
    path = root / cfg["event"]["file"]
    if not path.is_file():
        raise SpecError(f"event file {path} is missing")
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cfg["event"]["sha256"]:
        raise SpecError(f"{path} has sha256 {digest}, the configuration "
                        f"states {cfg['event']['sha256']}")
    return path
