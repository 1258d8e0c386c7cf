"""The comparison that decides `correct` fails each fault a cell can have.

Each case drives a run of the harness (`run.run_cell`, with the look for a
card skipped) on the CPU at volume 7 through the cell's own driver, with
the timed path broken underneath, and sees `correct` come out false;
the unbroken run comes out true.  The faults: a dispatch that hands back
the previous event's answer (its state unchanged), an answer altered
where it is produced (a node dropped from a candidate; a p-value moved),
half of a batch left out, half of a batch answered with the other half's
results, and (files driver) an ingest that hands back the first state it
built for every later file.  One chip runs each cell, so no exchange
between chips can be left out.

    python -m pytest benchmark/tests/test_bench_faults.py -q -p no:cacheprovider
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import run, spec
from gnn_track_finding_tpu_torch.graph import build
from gnn_track_finding_tpu_torch.models import pipeline

CFG = spec.config("trackml_v7_f64")
STREAM = {"driver": "stream", "pool": 2, "depth": 1, "warmup_dispatches": 1,
          "trace_dispatches": 1}
BATCH = {"driver": "batch", "pool": 2, "batch": 2, "warmup_dispatches": 1,
         "trace_dispatches": 1}
FILES = {"driver": "files", "pool": 2, "depth": 1, "warmup_dispatches": 1,
         "trace_dispatches": 1}
# the module of each function a fault replaces, where it is not pipeline
OWNER = {"build_graph_state": build}


def _stale(stream):
    """Every result after the run's first (the warm-up's) is that one's."""
    first = []

    def broken(graphs, cfg, depth=1):
        for res in stream(graphs, cfg, depth):
            if not first:
                first.append(res)
            yield first[0]
    return broken


def _altered(unpack, how):
    def broken(*args, **kw):
        out = unpack(*args, **kw)
        c = out.candidates[0]
        if how == "node":
            out.candidates[0] = dataclasses.replace(c, nodes=c.nodes[1:])
        else:
            out.candidates[0] = dataclasses.replace(
                c, pval_xy=c.pval_xy * (1 + 1e-3))
        return out
    return broken


def _first_state(ingest):
    """Every state the ingest builds after its first is that one."""
    first = []

    def broken(*args, **kw):
        g = ingest(*args, **kw)
        if not first:
            first.append(g)
        return first[0]
    return broken


def _half(batched, how):
    def broken(graphs, cfg, eager=False):
        res = batched(graphs, cfg, eager)
        half = len(res) // 2
        return res[:half] if how == "dropped" else \
            res[:half] + res[:len(res) - half]
    return broken


FAULTS = {
    "none_stream": (STREAM, None),
    "state_unchanged": (STREAM, ("stream_pipeline", _stale)),
    "node_dropped": (STREAM, ("unpack_packed",
                              lambda f: _altered(f, "node"))),
    "pval_moved": (STREAM, ("unpack_packed", lambda f: _altered(f, "pval"))),
    "none_batch": (BATCH, None),
    "half_batch_dropped": (BATCH, ("run_pipeline_batched",
                                   lambda f: _half(f, "dropped"))),
    "half_batch_repeated": (BATCH, ("run_pipeline_batched",
                                    lambda f: _half(f, "repeated"))),
    "none_files": (FILES, None),
    "files_state_unchanged": (FILES, ("stream_pipeline", _stale)),
    "files_node_dropped": (FILES, ("unpack_packed",
                                   lambda f: _altered(f, "node"))),
    "files_ingest_stale": (FILES, ("build_graph_state", _first_state)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(monkeypatch, fault):
    traffic, patch = FAULTS[fault]
    if patch is not None:
        name, make = patch
        owner = OWNER.get(name, pipeline)
        monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    result = run.run_cell({"chips": 1}, CFG, traffic, seed=2**31 + 77,
                          seconds=0.1, trace=False,
                          device=torch.device("cpu"), metrics=[])
    assert result["correct"] is (patch is None), result["checks"]
    assert result["checks"]["events_compared"][0] >= 1
