"""Checkpoint / resume of the device graph state.

Port of `gnn_track_finding_tpu.utils.checkpoint` (checkpoint.py:1-64).  The
reference's de-facto checkpointing is the gpickle-per-subgraph snapshot
after every stage (helper.py:585-587; restart by re-pointing INPUT at an
iteration directory, run_gnn_trackml_mod.sh:74-76).  Here the whole padded
GraphState is saved at an iteration boundary with `torch.save` (its
tensors, moved to the host), beside a JSON file with the static fields,
the iteration and the host-side candidate ledger.

The files are not compatible with the JAX package's orbax checkpoints:
each package restores only its own.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from gnn_track_finding_tpu_torch.graph.state import (STATIC_FIELDS, GraphState,
                                                     tensor_fields)
from gnn_track_finding_tpu_torch.models.pipeline import Candidate


def save(path: str, g: GraphState, candidates: Optional[List] = None,
         iteration: int = 0) -> None:
    """Write graph_<iteration>.pt and meta_<iteration>.json under path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    arrays = {name: getattr(g, name).detach().cpu() for name in tensor_fields()}
    torch.save(arrays, os.path.join(path, f"graph_{iteration}.pt"))
    meta = {k: getattr(g, k) for k in STATIC_FIELDS}
    meta["iteration"] = iteration
    if candidates is not None:
        meta["candidates"] = [
            {"nodes": np.asarray(c.nodes).tolist(), "iteration": c.iteration,
             "pval_xy": c.pval_xy, "pval_zr": c.pval_zr}
            for c in candidates]
    with open(os.path.join(path, f"meta_{iteration}.json"), "w") as f:
        json.dump(meta, f)


def restore(path: str, template: GraphState, iteration: int = 0
            ) -> Tuple[GraphState, List[Candidate]]:
    """-> (GraphState on the template's device, candidates).  The template
    gives the device; the static fields and every tensor come from the
    checkpoint."""
    path = os.path.abspath(path)
    arrays = torch.load(os.path.join(path, f"graph_{iteration}.pt"),
                        weights_only=True)
    with open(os.path.join(path, f"meta_{iteration}.json")) as f:
        meta = json.load(f)
    g = template.replace(
        **{k: meta[k] for k in STATIC_FIELDS},
        **{name: t.to(template.device) for name, t in arrays.items()})
    candidates = [Candidate(nodes=np.asarray(c["nodes"], np.int64),
                            iteration=c["iteration"],
                            pval_xy=c["pval_xy"], pval_zr=c["pval_zr"])
                  for c in meta.get("candidates", [])]
    return g, candidates
