"""The timed path: the program's drivers, fed by the traffic generator.

Everything the benchmark calls of the program under test is here: its
configuration type, its ingest (`graph.build.build_graph_state`, which
puts each event's state on the device) and its two production drivers,
`models.pipeline.stream_pipeline` (one event per dispatch) and
`models.pipeline.run_pipeline_batched` (a stacked batch per dispatch).

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
covers them.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np
from torch.profiler import record_function

from benchmark import events
from benchmark.trace import SPANS


class Done(NamedTuple):
    pool_index: int
    t_in: float          # host clock: the event handed to the driver
    t_out: float         # host clock: its result returned
    candidates: list     # the program's Candidate objects


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


class Driver:
    """One cell's driver over its pool of states."""

    def __init__(self, traffic: dict, seed: int, states: list, cfg: dict,
                 clock: Callable[[], float] = time.perf_counter):
        PipelineConfig, _, self.pipeline = program()
        self.cfg = PipelineConfig(**cfg["pipeline"])
        self.traffic = traffic
        self.kind = traffic["driver"]
        self.states = states
        self.order = events.orders(traffic, seed)
        self.clock = clock
        self.handed = 0          # events handed over, over every call

    def run(self, dispatches: int | None = None,
            until: float | None = None) -> List[Done]:
        """`dispatches` dispatches, or as many as start before `until` on
        the clock (at least one); every result waited for."""
        if self.kind == "stream":
            return self._stream(dispatches, until)
        return self._batch(dispatches, until)

    def _more(self, i: int, dispatches, until) -> bool:
        if dispatches is not None:
            return i < dispatches
        return i == 0 or self.clock() < until

    def _stream(self, dispatches, until) -> List[Done]:
        handed: List[tuple] = []

        def feed():
            i = 0
            while self._more(i, dispatches, until):
                k = next(self.order)[0]
                handed.append((k, self.clock()))
                self.handed += 1
                yield self.states[k]
                i += 1

        out = []
        with record_function(SPANS[0]):
            for j, res in enumerate(self.pipeline.stream_pipeline(
                    feed(), self.cfg, depth=int(self.traffic["depth"]))):
                with record_function(SPANS[2]):
                    t = self.clock()
                    k, t_in = handed[j]
                    out.append(Done(k, t_in, t, res.candidates))
                    gc.freeze()
        return out

    def _batch(self, dispatches, until) -> List[Done]:
        out = []
        i = 0
        while self._more(i, dispatches, until):
            ks = next(self.order)
            t_in = self.clock()
            self.handed += len(ks)
            with record_function(SPANS[1]):
                res = self.pipeline.run_pipeline_batched(
                    [self.states[k] for k in ks], self.cfg)
            t = self.clock()
            with record_function(SPANS[2]):
                out += [Done(k, t_in, t, r.candidates)
                        for k, r in zip(ks, res)]
                gc.freeze()
            i += 1
        return out

    def free(self) -> None:
        """Drop the states and the captured programs; the collector takes
        back what the dispatches froze."""
        self.states = []
        self.pipeline.clear_programs()
        gc.unfreeze()
