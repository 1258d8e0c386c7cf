"""Validate the PyTorch port's states against the reference pipeline's outputs.

The port's counterpart of tools/validate_vs_reference.py: the same
comparison (`compare`, a copy of that tool's numpy-only function, so that
nothing here imports the JAX package's tools) against the committed digest
of a reference run (tests/data/ref_digest.npz, volume 7), with the
framework side computed by the port from the committed volume-7 event
cache.  The cache's mirror and
component labels are not read: the port recomputes both from the node ids,
so a full match also proves the port's NetworkX-order ingest.

Imports torch and numpy only (no JAX), so it runs where the port runs.

Usage:
  python tools/validate_port_vs_reference.py [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST_PATH = os.path.join(REPO, "tests", "data", "ref_digest.npz")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gnn_track_finding_tpu_torch.config import PipelineConfig  # noqa: E402
from gnn_track_finding_tpu_torch.data.event_cache import load_npz  # noqa: E402
from gnn_track_finding_tpu_torch.graph.build import build_event  # noqa: E402
from gnn_track_finding_tpu_torch.models import pipeline  # noqa: E402

VOL7_NPZ = os.path.join(REPO, ".event_cache", "event_fafb3309e4598e9b.npz")


def compute_port_states(device: torch.device | str = "cpu",
                        path: str = VOL7_NPZ) -> dict:
    """The port's schedule to the iteration-2 boundary at float64, with
    the extraction leak of iteration 1 applied: every array `compare`
    reads (validate_vs_reference.compute_framework_states, with port
    calls).  The iterations are those of the shipped host driver
    (pipeline.driver_steps: host union-find CCA, leak replay)."""
    xyzr, vivl, tp, pairs, extra, _ = load_npz(path)
    cfg = PipelineConfig(min_volume=int(vivl[:, 0].min()),
                         max_volume=int(vivl[:, 0].max()))
    g, host = build_event(xyzr, vivl, tp, pairs, cfg, device=device,
                          node_ids=extra["node_ids"])
    g = pipeline.prepare(g, cfg)
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    out = {"remap": {int(n): i for i, n in enumerate(host.node_ids)},
           "src": src, "dst": dst,
           "seed_sv": g.seed_sv.cpu().numpy(),
           "seed_cov": g.seed_cov.cpu().numpy(),
           "edge_index": {(int(src[e]), int(dst[e])): e
                          for e in range(g.n_edges)}}

    steps = pipeline.driver_steps(g, cfg, tracker=host.tracker)
    it1 = next(steps)                   # after extraction 1 and its leak
    out["muts"] = {n: c for n, c in it1.mutations}
    out["has_merged"] = it1.graph.has_merged.cpu().numpy()
    out["merged_state"] = it1.graph.merged_state.cpu().numpy()
    out["merged_cov"] = it1.graph.merged_cov.cpu().numpy()

    it2 = next(steps).staged            # stage 2, before extraction 2
    steps.close()
    out["has_updated"] = it2.has_updated.cpu().numpy()
    out["upd_sv"] = it2.upd_sv.cpu().numpy()
    out["upd_joint"] = it2.upd_joint.cpu().numpy()
    return out


def compare(digest: dict, fw: dict, log=print) -> dict:
    """Compare a reference digest against framework states; return match
    fractions (all in [0,1])."""
    remap, edge_index = fw["remap"], fw["edge_index"]
    res = {}

    # ---- seed states ----
    n_cmp = n_ok = n_cov_ok = 0
    for so, do, sv, cov in zip(digest["seed_src"], digest["seed_dst"],
                               digest["seed_sv"], digest["seed_cov"]):
        s, d = remap.get(int(so)), remap.get(int(do))
        if s is None or d is None:
            continue
        e = edge_index.get((s, d))
        if e is None:
            continue
        n_cmp += 1
        n_ok += np.allclose(fw["seed_sv"][e], sv, rtol=1e-8, atol=1e-12)
        n_cov_ok += np.allclose(fw["seed_cov"][e], cov, rtol=1e-7, atol=1e-12)
    res["seed_cmp"] = n_cmp
    res["seed_sv"] = n_ok / max(n_cmp, 1)
    res["seed_cov"] = n_cov_ok / max(n_cmp, 1)
    log(f"[seed] edges compared: {n_cmp}, state allclose: {n_ok} "
        f"({100.0 * res['seed_sv']:.3f}%), cov allclose: {n_cov_ok} "
        f"({100.0 * res['seed_cov']:.3f}%)")

    # ---- extraction coordinate leak ----
    ours = fw["muts"]
    ok_mut = 0
    for no, co in zip(digest["leak_node"], digest["leak_coords"]):
        d = remap.get(int(no))
        if d in ours and np.allclose(ours[d], co):
            ok_mut += 1
    n_leak = len(digest["leak_node"])
    res["leak"] = ok_mut / max(n_leak, 1)
    log(f"[leak] reference remaining has {n_leak} mutated nodes; predicted "
        f"{len(ours)} (incl. removed-candidate nodes); matching coords: "
        f"{ok_mut}/{n_leak}")

    # ---- clustering iteration 1 merged states ----
    hm, ms, mc = fw["has_merged"], fw["merged_state"], fw["merged_cov"]
    m_cmp = m_flag_ok = m_val_ok = 0
    mi = 0
    n_ref_merged = int(np.asarray(digest["clus_has_merged"]).sum())
    for no, has in zip(digest["clus_node"], digest["clus_has_merged"]):
        rsv = digest["clus_merged_sv"][mi] if has else None
        rcov = digest["clus_merged_cov"][mi] if has else None
        mi += bool(has)
        d = remap.get(int(no))
        if d is None:
            continue
        m_cmp += 1
        if bool(hm[d]) == bool(has):
            m_flag_ok += 1
            if has and np.allclose(ms[d], rsv, rtol=1e-7, atol=1e-12) \
                    and np.allclose(mc[d], rcov, rtol=1e-6, atol=1e-12):
                m_val_ok += 1
    res["clus_cmp"] = m_cmp
    res["clus_flag"] = m_flag_ok / max(m_cmp, 1)
    res["clus_val"] = m_val_ok / max(n_ref_merged, 1)
    log(f"[cluster1] nodes compared: {m_cmp}, merged-flag match: {m_flag_ok} "
        f"({100.0 * res['clus_flag']:.3f}%), merged values allclose: "
        f"{m_val_ok}/{n_ref_merged} ({100.0 * res['clus_val']:.3f}%)")

    # ---- extrapolation iteration 2 updated states ----
    # the reference writes iteration_2/network right after message passing
    # (extrapolate_merged_states.py:561-571), BEFORE extraction and the
    # even-iteration metadata pruning — the digest captures that boundary.
    has_u, usv, ujoint = fw["has_updated"], fw["upd_sv"], fw["upd_joint"]
    u_cmp = u_flag = u_val = u_joint = 0
    for so, do, sv, joint in zip(digest["upd_src"], digest["upd_dst"],
                                 digest["upd_sv"], digest["upd_joint"]):
        s, d = remap.get(int(so)), remap.get(int(do))
        if s is None or d is None:
            continue
        e = edge_index.get((s, d))
        if e is None:
            continue
        u_cmp += 1
        if has_u[e]:
            u_flag += 1
            u_val += np.allclose(usv[e], sv, rtol=1e-6, atol=1e-10)
            u_joint += np.allclose(ujoint[e], joint, rtol=1e-6, atol=1e-10)
    res["upd_cmp"] = u_cmp
    res["upd_flag"] = u_flag / max(u_cmp, 1)
    res["upd_val"] = u_val / max(u_cmp, 1)
    res["upd_joint"] = u_joint / max(u_cmp, 1)
    log(f"[extrap2] updated states compared: {u_cmp}, present here: {u_flag} "
        f"({100.0 * res['upd_flag']:.3f}%), values allclose: {u_val} "
        f"({100.0 * res['upd_val']:.3f}%), joint allclose: {u_joint} "
        f"({100.0 * res['upd_joint']:.3f}%)")
    return res


def load_digest(path: str = DIGEST_PATH) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    res = compare(load_digest(), compute_port_states(args.device))
    return 0 if all(v == 1.0 for k, v in res.items()
                    if not k.endswith("_cmp")) else 1


if __name__ == "__main__":
    sys.exit(main())
