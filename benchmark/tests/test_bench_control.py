"""The control of `correct`: the reference in the program's place, one
precision down, must come out not correct.

Each configuration states float64; the control is the benchmark's
reference run at float32 over a cell's own pool of events (its size and
its seeds), judged against the float64 reference by the comparison and
limits the benchmark applies to the program.  On the card (marked `gpu`)
it runs each cell's whole pool on three seeds and prints each reading;
two events of the volume-7 cell run on the CPU as well.

    python -m pytest --noconftest -q -p no:cacheprovider -m gpu -s benchmark/tests/test_bench_control.py
"""

from __future__ import annotations

from typing import NamedTuple

import pytest
import torch

from benchmark import check, events, spec
from benchmark.reference import schedule as reference

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


class _Candidate(NamedTuple):
    iteration: int
    nodes: object
    pval_xy: float
    pval_zr: float


class _Done(NamedTuple):
    pool_index: int
    candidates: list


def _as_candidates(accepted) -> list:
    return [_Candidate(it, nn, float(pv[0]), float(pv[1]))
            for it, acc in enumerate(accepted, start=1)
            for nn, pv in zip(acc.nodes, acc.pvals)]


def control_numbers(cell: str, seed: int, device, pool: int | None = None
                    ) -> dict:
    """The numbers compared when the float32 reference answers a cell's
    pool in the program's place (`pool`: fewer events than the cell's)."""
    w = spec.workload(spec.benchmark(), cell)
    cfg = spec.config(w["config"])
    traffic = dict(spec.traffic(w["traffic"]))
    if pool is not None:
        traffic["pool"] = pool
    arrays = events.pool_arrays(events.load(spec.event_file(cfg)), traffic,
                                seed)
    rcfg = reference.Config.from_dict(cfg["pipeline"])
    want, done = {}, []
    for block in reference.blocks(len(arrays), cfg["pad_bucket"]["nodes"]):
        part = [arrays[k] for k in block]
        f64 = reference.run_events(part, rcfg, device=device,
                                   dtype=torch.float64)
        f32 = reference.run_events(part, rcfg, device=device,
                                   dtype=torch.float32)
        for k, a64, a32 in zip(block, f64, f32):
            want[k] = check.reference_keys(a64)
            done.append(_Done(k, _as_candidates(a32)))
    return check.compare(done, want, handed=len(done))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["v7-14.device_stream", "v7.device_batch32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_float32_control_is_not_correct(cuda, cell, seed):
    cfg = spec.config(spec.workload(spec.benchmark(), cell)["config"])
    numbers = control_numbers(cell, seed, cuda)
    verdict = check.verdict(numbers, cfg["limits"])
    print(f"control {cell} seed {seed}: "
          + ", ".join(f"{k} {v['value']!r} (limit {v['limit']!r})"
                      for k, v in verdict.items()))
    assert not all(v["ok"] for v in verdict.values())


def test_float32_control_is_not_correct_on_the_cpu():
    """The same control on two events of the volume-7 cell, on the CPU."""
    cfg = spec.config("trackml_v7_f64")
    numbers = control_numbers("v7.device_batch32", SEEDS[0],
                              torch.device("cpu"), pool=2)
    verdict = check.verdict(numbers, cfg["limits"])
    assert not all(v["ok"] for v in verdict.values()), verdict
