"""Track reconstruction efficiency and purity.

Port of `gnn_track_finding_tpu.evaluation.efficiency` (efficiency.py:1-157),
a host-side re-statement of the reference's
src/extract/reconstruction_efficiency.py:

  * reference tracks: particles with pT >= 1 GeV (:42-47), hits restricted
    to the analysed volumes (:56-59), >= 4 distinct (volume, layer) pairs
    (:66-75), one hit per module (:78-86);
  * candidate matching: majority particle id over the candidate's
    constituent hits (:127-142), matched when n_good >= 0.5 x reference
    hits and both track purity (n_good / candidate hits) and particle
    purity (n_good / particle hits in region) reach 0.5, with a
    double-count guard (:155-187);
  * efficiency = reconstructed / reference x 100 (:213-218).

The CSV files are read with the `csv` module (the card's machine has no
dataframe library), with the JAX reader's cuts and group orders: a
particle's hits in file order, particles in order of first appearance.
"""

from __future__ import annotations

import csv
import dataclasses
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import HostEvent


@dataclasses.dataclass
class EfficiencyReport:
    num_reference: int
    num_reconstructed: int
    efficiency_pct: float
    track_purities: np.ndarray
    particle_purities: np.ndarray


def _read_columns(path: str, columns: Dict[str, type]) -> Dict[str, list]:
    """The named columns of a CSV file with a header row, converted."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = [h.strip() for h in next(reader)]
        idx = {name: header.index(name) for name in columns}
        out: Dict[str, list] = {name: [] for name in columns}
        for row in reader:
            if not row:
                continue
            for name, conv in columns.items():
                out[name].append(conv(row[idx[name]]))
    return out


def _hits_in_window(truth_csv: str, cfg: PipelineConfig) -> Dict[str, list]:
    cols = _read_columns(truth_csv, {"hit_id": int, "particle_id": int,
                                     "volume_id": int, "layer_id": int,
                                     "module_id": int})
    keep = [i for i, v in enumerate(cols["volume_id"])
            if cfg.min_volume <= v <= cfg.max_volume]
    return {k: [v[i] for i in keep] for k, v in cols.items()}


def reference_tracks(particles_csv: str, truth_csv: str,
                     cfg: PipelineConfig) -> Dict[int, List[int]]:
    particles = _read_columns(particles_csv, {"particle_id": int,
                                              "px": float, "py": float})
    pt = np.hypot(np.asarray(particles["px"], np.float64),
                  np.asarray(particles["py"], np.float64))
    good_pids = {pid for pid, ok in zip(particles["particle_id"],
                                        pt >= cfg.eval_pt_cut) if ok}

    hits = _hits_in_window(truth_csv, cfg)
    groups: Dict[int, list] = {}            # first-appearance order
    for i, pid in enumerate(hits["particle_id"]):
        if pid in good_pids:
            groups.setdefault(pid, []).append(i)

    out: Dict[int, List[int]] = {}
    for pid, rows in groups.items():
        layers = {(hits["volume_id"][i], hits["layer_id"][i]) for i in rows}
        if len(layers) < cfg.eval_min_layers:
            continue
        modules = Counter((hits["volume_id"][i], hits["layer_id"][i],
                           hits["module_id"][i]) for i in rows)
        if any(c > 1 for c in modules.values()):
            continue  # > 1 hit per module (ref :78-86)
        out[int(pid)] = [hits["hit_id"][i] for i in rows]
    return out


def hits_in_region(truth_csv: str, cfg: PipelineConfig) -> Dict[int, int]:
    return dict(Counter(_hits_in_window(truth_csv, cfg)["particle_id"]))


def evaluate_toy(candidate_node_lists: Sequence[Sequence[int]],
                 truth: np.ndarray, vivl: np.ndarray,
                 cfg: PipelineConfig) -> EfficiencyReport:
    """Reconstruction efficiency on a toy event (1 hit == 1 node).

    Same matching rules as the TrackML evaluator / the reference
    (reconstruction_efficiency.py:66,155-187,213-218): reference track =
    particle with >= eval_min_layers distinct layers; matched when the
    candidate's majority particle contributes >= 50% of that particle's
    hits and track & particle purity are >= eval_purity_cut, with the
    double-count guard.  The pT cut does not apply (toy tracks carry no
    momentum)."""
    truth = np.asarray(truth)
    vivl = np.asarray(vivl)
    refs: Dict[int, int] = {}
    for pid in np.unique(truth):
        if pid < 0:
            continue
        sel = truth == pid
        layers = {(int(v), int(l)) for v, l in vivl[sel]}
        if len(layers) >= cfg.eval_min_layers:
            refs[int(pid)] = int(sel.sum())

    reconstructed = set()
    track_pur, particle_pur = [], []
    for nodes in candidate_node_lists:
        pids = [int(truth[int(n)]) for n in nodes]
        if not pids:
            continue
        freq = Counter(pids)
        pid = max(freq, key=freq.get)
        n_good = freq[pid]
        if pid not in refs or n_good < 0.5 * refs[pid]:
            continue
        tp = n_good / len(pids)
        pp = n_good / refs[pid]
        if tp >= cfg.eval_purity_cut and pp >= cfg.eval_purity_cut:
            if pid not in reconstructed:
                reconstructed.add(pid)
                track_pur.append(tp)
                particle_pur.append(pp)
    return EfficiencyReport(
        num_reference=len(refs), num_reconstructed=len(reconstructed),
        efficiency_pct=100.0 * len(reconstructed) / max(len(refs), 1),
        track_purities=np.asarray(track_pur),
        particle_purities=np.asarray(particle_pur))


def pure_candidates(candidate_node_lists: Sequence[Sequence[int]],
                    truth: np.ndarray) -> int:
    """The candidates whose nodes all carry one truth label (the toy
    runner's purity count, JAX run.py:149-153)."""
    return sum(1 for nodes in candidate_node_lists
               if len({int(truth[int(n)]) for n in nodes}) == 1)


def evaluate(candidate_node_lists: Sequence[np.ndarray], host: HostEvent,
             particles_csv: str, truth_csv: str,
             cfg: PipelineConfig) -> EfficiencyReport:
    """Efficiency on a TrackML event: candidates' hits through
    `host.hit_particle_ids`, reference tracks from the particles and
    truth-mapping CSVs."""
    refs = reference_tracks(particles_csv, truth_csv, cfg)
    nhits_region = hits_in_region(truth_csv, cfg)

    reconstructed = set()
    track_pur, particle_pur = [], []
    for nodes in candidate_node_lists:
        pids: List[int] = []
        for n in nodes:
            hp = host.hit_particle_ids[int(n)]
            if hp is not None:
                pids.extend(int(p) for p in hp)
        if not pids:
            continue
        freq = Counter(pids)
        pid = max(freq, key=freq.get)
        n_good = freq[pid]
        if pid not in refs:
            continue
        if n_good < 0.5 * len(refs[pid]):
            continue
        track_purity = n_good / len(pids)
        particle_purity = n_good / nhits_region.get(pid, n_good)
        if track_purity >= cfg.eval_purity_cut and particle_purity >= cfg.eval_purity_cut:
            if pid not in reconstructed:
                reconstructed.add(pid)
                track_pur.append(track_purity)
                particle_pur.append(particle_purity)

    num_ref = len(refs)
    num_rec = len(reconstructed)
    return EfficiencyReport(
        num_reference=num_ref, num_reconstructed=num_rec,
        efficiency_pct=100.0 * num_rec / max(num_ref, 1),
        track_purities=np.asarray(track_pur),
        particle_purities=np.asarray(particle_pur))
