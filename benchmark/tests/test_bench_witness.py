"""The reference against an independent witness: the reference
implementation's own run of the volume-7 event.

The witness is the committed digest of that run's outputs,
tests/data/ref_digest.npz (read as data; nothing of it is imported): the
seed states of all 14,766 directed edges, the merged states of the first
clustering (577 of 8,748 nodes), the 24 hit coordinates its first
extraction leaves changed, and the updated states of the 434 edges the
second iteration's message passing reaches.  Its first extraction
accepted 1,055 candidates (BASELINE.md).  The benchmark's reference runs
the same event at float64 on the CPU, stage by stage, and is held to
each, with the tolerances of the port's own check against the digest
(tools/validate_port_vs_reference.py).  The schedule the cells time does
not replay the leak; with the digest's 24 coordinates put in, the
updated states match in full, and without them only edges that touch a
changed hit differ.

    python -m pytest benchmark/tests/test_bench_witness.py -q -p no:cacheprovider
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import events, spec
from benchmark.reference import schedule as reference

DIGEST = Path(__file__).resolve().parents[2] / "tests" / "data" / \
    "ref_digest.npz"
ACCEPTED_FIRST = 1055     # the reference run's first extraction


@pytest.fixture(scope="module")
def witness():
    with np.load(DIGEST) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def stages(witness):
    """The reference's states after each stage of the unrotated event."""
    cfg = spec.config("trackml_v7_f64")
    path = spec.event_file(cfg)
    raw = events.load(path)
    with np.load(path) as z:
        remap = {int(n): i for i, n in enumerate(z["node_ids"])}
    rcfg = reference.Config.from_dict(cfg["pipeline"])
    g = reference.build([raw], rcfg, device="cpu", dtype=torch.float64)
    g = reference.seed_track_states(g, rcfg).replace(active=g.edge_mask)
    g = reference.compute_prior_probabilities(g, use_updated=False)
    seeded = reference.compute_mixture_weights(g, use_updated=False)
    clustered = reference.cluster(seeded, rcfg, use_updated=False)
    extracted, accepted = reference.extract(clustered, rcfg)
    leaked = extracted.gnn_xyzr.clone()
    for node, coords in zip(witness["leak_node"], witness["leak_coords"]):
        leaked[remap[int(node)]] = torch.as_tensor(coords, dtype=leaked.dtype)
    src, dst = seeded.src.numpy(), seeded.dst.numpy()
    return {"remap": remap, "seeded": seeded, "clustered": clustered,
            "accepted": accepted[0],
            "updated": reference.message_passing(extracted, rcfg),
            "updated_leak": reference.message_passing(
                extracted.replace(gnn_xyzr=leaked), rcfg),
            "edge": {(int(src[e]), int(dst[e])): e for e in
                     np.flatnonzero(seeded.edge_mask.numpy())}}


def _edges(stages, witness, prefix):
    remap, edge = stages["remap"], stages["edge"]
    return [edge.get((remap[int(s)], remap[int(d)])) for s, d in
            zip(witness[f"{prefix}_src"], witness[f"{prefix}_dst"])]


def test_seed_states_are_the_witness(stages, witness):
    g = stages["seeded"]
    sv, cov = g.seed_sv.numpy(), g.seed_cov.numpy()
    rows = _edges(stages, witness, "seed")
    assert len(rows) == 14766 and None not in rows
    assert all(np.allclose(sv[e], w, rtol=1e-8, atol=1e-12)
               for e, w in zip(rows, witness["seed_sv"]))
    assert all(np.allclose(cov[e], w, rtol=1e-7, atol=1e-12)
               for e, w in zip(rows, witness["seed_cov"]))


def test_merged_states_are_the_witness(stages, witness):
    g = stages["clustered"]
    has = g.has_merged.numpy()
    nodes = [stages["remap"][int(n)] for n in witness["clus_node"]]
    assert len(nodes) == 8748
    assert (has[nodes] == witness["clus_has_merged"]).all()
    merged = [n for n, h in zip(nodes, witness["clus_has_merged"]) if h]
    assert len(merged) == 577 == int(has.sum())
    assert np.allclose(g.merged_state.numpy()[merged],
                       witness["clus_merged_sv"], rtol=1e-7, atol=1e-12)
    assert np.allclose(g.merged_cov.numpy()[merged],
                       witness["clus_merged_cov"], rtol=1e-6, atol=1e-12)
    assert np.allclose(g.merged_prior.numpy()[merged],
                       witness["clus_merged_prior"])


def test_first_extraction_accepts_the_witness_count(stages):
    assert len(stages["accepted"].nodes) == ACCEPTED_FIRST


@pytest.mark.parametrize("leak", [True, False])
def test_updated_states_are_the_witness(stages, witness, leak):
    g = stages["updated_leak" if leak else "updated"]
    has = g.has_updated.numpy()
    sv, joint = g.upd_sv.numpy(), g.upd_joint.numpy()
    rows = _edges(stages, witness, "upd")
    assert len(rows) == 434 == int(has.sum()) and None not in rows
    assert has[rows].all()
    same = np.array([np.allclose(sv[e], w, rtol=1e-6, atol=1e-10) and
                     np.allclose(joint[e], j, rtol=1e-6, atol=1e-10)
                     for e, w, j in zip(rows, witness["upd_sv"],
                                        witness["upd_joint"])])
    if leak:
        assert same.all()
    else:
        changed = {stages["remap"][int(n)] for n in witness["leak_node"]}
        src, dst = g.src.numpy(), g.dst.numpy()
        touch = np.array([src[e] in changed or dst[e] in changed
                          for e in rows])
        assert same[~touch].all() and same.sum() >= 400
