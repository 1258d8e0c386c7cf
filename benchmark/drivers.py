"""The timed path: the program's drivers, fed by the traffic generator.

Everything the benchmark calls of the program under test is here: its
configuration type, its ingest (`data.event_cache.load_npz`, which reads
an event's file, and `graph.build.build_graph_state`, which puts each
event's state on the device), its prefetcher (`data.prefetch.prefetch`),
its KL-threshold table type (`calib.lut.KLThresholdLUT`) and its two
production drivers, `models.pipeline.stream_pipeline` (one event per
dispatch) and `models.pipeline.run_pipeline_batched` (a stacked batch
per dispatch).  The `stream` and `batch` drivers take the
pool's states, built before the window (`build_states`); the `files`
driver takes the pool's events as files (`EventFiles`) and builds each
state inside the window: each event's ingest is a factory that
`prefetch` runs on its worker thread ahead of `stream_pipeline`, at the
program's defaults, as a user's job over stored events does.

A configuration with a calibration block (spec.calibration) has its table
built once, in the set-up, as the program's own KLThresholdLUT (int64
bins), and handed to both production drivers as the keyword `kl_lut=`:
the program takes the table and applies it to each event on the device
inside its captured program (each node's threshold read at its emp_var,
as the reference does after the window).  A program that does not take
the keyword stops at the first dispatch with a TypeError, and the run
prints no result.  Without a calibration the calls are as they were,
argument for argument.

A driver object runs dispatches in turn, continuing the traffic's order,
and returns one `Done` per event: the pool event it was, when the
harness handed it over, when its result came back, and the candidates.
Only the candidates are kept of a result, so that its final state (on the
device) is freed at once.  The kept candidates (some hundred thousand
objects over a window) are moved out of the garbage collector's
generations after each dispatch (`gc.freeze`), so that its full
collections do not grow with what the harness holds: a window once
showed one stall of 300-370 ms in each run from them.  The program's
calls and the harness's own work run under `record_function` spans
("stream_pipeline" / "run_pipeline_batched", "harness"), which name the
traced run's idle gaps where no torch op or CUDA call of the program
covers them; each factory of the `files` driver runs under one more
("ingest"), on the worker's thread.
"""

from __future__ import annotations

import functools
import gc
import os
import shutil
import tempfile
import time
import weakref
from typing import Callable, Dict, List, NamedTuple

import numpy as np
from torch.profiler import record_function

from benchmark import events, spec
from benchmark.trace import SPANS


class Done(NamedTuple):
    pool_index: int
    t_in: float          # host clock: the event handed to the driver
    t_out: float         # host clock: its result returned
    candidates: list     # the program's Candidate objects
    # the files driver only (host clock): the seconds of the event's
    # factory (its file read and its state built), and the seconds the
    # stream's feed was blocked on the prefetcher for it
    ingest_s: float | None = None
    wait_s: float | None = None


def program():
    """The program's modules (imported here, not at import time)."""
    from gnn_track_finding_tpu_torch.config import PipelineConfig
    from gnn_track_finding_tpu_torch.graph.build import build_graph_state
    from gnn_track_finding_tpu_torch.models import pipeline
    return PipelineConfig, build_graph_state, pipeline


def build_states(pool: List[Dict[str, np.ndarray]], cfg: dict, device,
                 dtype) -> list:
    """Each pool event's GraphState on the device, through the program's
    ingest, with the event file's mirror and components."""
    PipelineConfig, build_graph_state, _ = program()
    pcfg = PipelineConfig(**cfg["pipeline"])
    return [build_graph_state(a["xyzr"], a["vivl"], a["truth_particle"],
                              a["pairs"], pcfg, device=device, dtype=dtype,
                              mirror=a["mirror"], component=a["component"])
            for a in pool]


def pool_states(traffic: dict, pool: List[Dict[str, np.ndarray]], path,
                cfg: dict, device, dtype):
    """What the traffic's driver takes of the pool: its events' files for
    the `files` driver (with the truth lists of the raw event file at
    `path`), else their states built on the device."""
    if traffic["driver"] == "files":
        return EventFiles(pool, path, device, dtype)
    return build_states(pool, cfg, device, dtype)


def kl_lut(cfg: dict):
    """The configuration's calibration table as the program's
    KLThresholdLUT, or None without a calibration block."""
    block = spec.calibration(cfg)
    if block is None:
        return None
    from gnn_track_finding_tpu_torch.calib.lut import KLThresholdLUT
    return KLThresholdLUT(block["feature"], block["feature_bin_width"],
                          block["kl_bin_width"],
                          np.asarray(block["lower"], np.int64),
                          np.asarray(block["upper"], np.int64))


def _shape(g) -> tuple:
    """A state's pad bucket: padded nodes, padded edges, max degree."""
    return (g.num_padded_nodes, g.num_padded_edges, g.max_degree)


class EventFiles:
    """The pool's events as files, for the `files` driver: each one .npz
    in the program's event-cache layout (data/event_cache.py: the pool
    event's arrays, and the raw event's node ids and truth lists as they
    are, which nothing of a run reads), in a directory made for the run
    under the temporary directory, removed by `remove()` (at the latest
    when the process exits); and the device and dtype the program builds
    them on."""

    def __init__(self, pool: List[Dict[str, np.ndarray]], path, device,
                 dtype):
        from gnn_track_finding_tpu_torch.data.event_cache import TRUTH_KEYS
        with np.load(path) as z:
            truth = {k: z[k] for k in ("node_ids",) + TRUTH_KEYS}
        self.device, self.dtype = device, dtype
        self.directory = tempfile.mkdtemp(prefix="benchmark_events_")
        self.remove = weakref.finalize(self, shutil.rmtree, self.directory,
                                       True)
        self.paths = []
        for k, arrays in enumerate(pool):
            path = os.path.join(self.directory, f"event_{k}.npz")
            with open(path, "wb") as f:
                np.savez(f, **arrays, **truth)
            self.paths.append(path)

    def __len__(self) -> int:
        return len(self.paths)


class Driver:
    """One cell's driver over its pool of states (or, for `files`, of
    EventFiles)."""

    def __init__(self, traffic: dict, seed: int, states, cfg: dict,
                 clock: Callable[[], float] = time.perf_counter):
        PipelineConfig, self.build, self.pipeline = program()
        self.cfg = PipelineConfig(**cfg["pipeline"])
        lut = kl_lut(cfg)
        # the production drivers' keywords beyond the configuration
        self.keywords = {} if lut is None else {"kl_lut": lut}
        self.traffic = traffic
        self.kind = traffic["driver"]
        self.states = states
        self.order = events.orders(traffic, seed)
        self.clock = clock
        self.handed = 0          # events handed over, over every call
        # the pad bucket of the first state (files: of the first built)
        self.shape = None if self.kind == "files" else _shape(states[0])

    def run(self, dispatches: int | None = None,
            until: float | None = None) -> List[Done]:
        """`dispatches` dispatches, or as many as start before `until` on
        the clock (at least one); every result waited for."""
        if self.kind == "batch":
            return self._batch(dispatches, until)
        return self._stream(dispatches, until)

    def _more(self, i: int, dispatches, until) -> bool:
        if dispatches is not None:
            return i < dispatches
        return i == 0 or self.clock() < until

    def _stream(self, dispatches, until) -> List[Done]:
        """One event per dispatch through stream_pipeline: the pool's
        states, or (files) each event's state read and built on the
        prefetcher's worker."""
        # per event: [pool index, handed over, ingest seconds, wait seconds]
        handed: List[list] = []

        def order():
            i = 0
            while self._more(i, dispatches, until):
                rec = [next(self.order)[0], self.clock(), None, None]
                handed.append(rec)
                self.handed += 1
                yield rec
                i += 1

        feed = (self._ingested(order()) if self.kind == "files"
                else (self.states[rec[0]] for rec in order()))
        out = []
        with record_function(SPANS[0]):
            for j, res in enumerate(self.pipeline.stream_pipeline(
                    feed, self.cfg, depth=int(self.traffic["depth"]),
                    **self.keywords)):
                with record_function(SPANS[2]):
                    t = self.clock()
                    k, t_in, ingest_s, wait_s = handed[j]
                    out.append(Done(k, t_in, t, res.candidates, ingest_s,
                                    wait_s))
                    gc.freeze()
        return out

    def _ingested(self, recs):
        """The states of the events of `recs` in order, each read from its
        file and built by a factory that data/prefetch.prefetch runs on
        its worker thread, as far ahead as the program's defaults go; a
        record takes its factory's start (the event's hand-over) and
        seconds, and the seconds the feed waited for it."""
        from gnn_track_finding_tpu_torch.data import event_cache, prefetch
        files = self.states

        def ingest(rec: list):
            """One event's factory: its file read and its state built by
            the program's ingest (the calls of bench.load_event), with the
            file's mirror and components."""
            t0 = self.clock()
            with record_function(SPANS[3]):
                xyzr, vivl, tp, pairs, _, pre = event_cache.load_npz(
                    files.paths[rec[0]])
                g = self.build(xyzr, vivl, tp, pairs, self.cfg,
                               device=files.device, dtype=files.dtype,
                               mirror=pre["mirror"],
                               component=pre["component"])
            rec[1], rec[2] = t0, self.clock() - t0
            if self.shape is None:
                self.shape = _shape(g)
            return rec, g

        ready = prefetch.prefetch(functools.partial(ingest, rec)
                                  for rec in recs)
        while True:
            t = self.clock()
            item = next(ready, None)
            if item is None:
                return
            rec, g = item
            rec[3] = self.clock() - t
            yield g

    def _batch(self, dispatches, until) -> List[Done]:
        out = []
        i = 0
        while self._more(i, dispatches, until):
            ks = next(self.order)
            t_in = self.clock()
            self.handed += len(ks)
            with record_function(SPANS[1]):
                res = self.pipeline.run_pipeline_batched(
                    [self.states[k] for k in ks], self.cfg, **self.keywords)
            t = self.clock()
            with record_function(SPANS[2]):
                out += [Done(k, t_in, t, r.candidates)
                        for k, r in zip(ks, res)]
                gc.freeze()
            i += 1
        return out

    def free(self) -> None:
        """Drop the states (the files driver's files removed) and the
        captured programs; the collector takes back what the dispatches
        froze."""
        if self.kind == "files":
            self.states.remove()
        self.states = []
        self.pipeline.clear_programs()
        gc.unfreeze()
