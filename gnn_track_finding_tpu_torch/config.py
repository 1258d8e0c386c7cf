"""Typed configuration for the whole pipeline.

Field-for-field copy of `gnn_track_finding_tpu.config.PipelineConfig`
(the reference's bash variables, CLI arguments and inline constants in one
frozen dataclass); the CPU tests pin that every field and default agrees.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # --- measurement errors (run_gnn_trackml_mod.sh:11-14) ---
    sigma0xy: float = 0.3     # xy-plane measurement rms
    sigma0rz: float = 0.4     # r error for barrel-located hit (z error in endcap)
    sigma0rz2: float = 0.6    # z error for barrel-located hit (r error in endcap)
    sigma_O: float = 4.0      # parabola origin error incl. beamspot (helper.py:243)

    # --- geometry (run_gnn_trackml_mod.sh:17-21) ---
    min_volume: int = 7
    max_volume: int = 7
    endcap_boundary: float = 550.0  # |z| >= boundary -> endcap layer orientation

    # --- multiple scattering, Highland/Moliere (helper.py:411) ---
    ms_factor: float = 13.6e-3      # 13.6 MeV in GeV
    ms_sqrt_xx0: float = 0.02 ** 0.5  # sqrt(x/X0) material budget
    ms_pt: float = 0.3              # GeV reference momentum scale

    # --- iteration schedule (run_gnn_trackml_mod.sh:7-8,71-148) ---
    num_iterations: int = 3

    # --- clustering / GMR (run_gnn_trackml_mod.sh:89,112; clustering.py:207) ---
    chi2_threshold_seed: float = 1.0     # iteration 1, track_state_estimates
    kl_threshold_seed: float = 2.0
    chi2_threshold_updated: float = 1000.0  # iteration 3, updated_track_states
    kl_threshold_updated: float = 100.0
    cluster_min_edges: int = 3           # gate: 2 < d < 16
    cluster_max_edges: int = 15

    # --- extrapolation (run_gnn_trackml_mod.sh:28) ---
    chi2_cut_factor: float = 2.0

    # --- reweight (helper.py:145) ---
    reweight_threshold: float = 0.1

    # --- extraction (run_gnn_trackml_mod.sh:31-35) ---
    track_acceptance_pval: float = 0.01   # p
    min_track_hits: int = 4               # n
    separation_3d_threshold: float = 10.0  # s, innermost-edge rotation fallback
    node_merge_distance: float = 8.0      # t, close-proximity node merging
    ou_alpha: float = 0.1                 # Ornstein-Uhlenbeck mean reversion
    ou_sigma: float = 1e-5                # OU process noise

    # --- evaluation (reconstruction_efficiency.py:45-47,66,170) ---
    eval_pt_cut: float = 1.0
    eval_min_layers: int = 4
    eval_purity_cut: float = 0.5

    # --- padding / device-shape policy ---
    # Per-node incoming-edge table width K; ingest doubles it until it
    # covers the true maximum degree.
    max_node_degree: int = 32
    # Fixed hit capacity per extracted candidate (KF fit trip count).
    max_track_hits: int = 32
    # Graph shapes are padded up to multiples of these bucket sizes.
    node_bucket: int = 4096
    edge_bucket: int = 16384

    # --- numerics ---
    # "bug-compatible" mode reproduces the reference's load-bearing quirks
    # (covariance aliasing, in-place cumulative var_ms, squared tau
    # variance, elementwise-product KL trace, the r/z rotation typo);
    # clean mode fixes them.
    bug_compat: bool = True

    def ms_coefficient(self) -> float:
        """Highland multiple-scattering prefactor (helper.py:411)."""
        return (self.ms_factor * self.ms_sqrt_xx0 / self.ms_pt) ** 2

    def cluster_thresholds(self, use_updated: bool) -> Tuple[float, float]:
        if use_updated:
            return self.chi2_threshold_updated, self.kl_threshold_updated
        return self.chi2_threshold_seed, self.kl_threshold_seed
