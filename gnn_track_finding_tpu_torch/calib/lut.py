"""Decision-boundary training and 2-D LUT artifacts.

Copy of `gnn_track_finding_tpu.calib.lut` (lut.py:1-149) in numpy
(sklearn is imported inside `fit_lut_svm`; the card's machine has none,
so the runner fits the quantile rule), plus `node_thresholds`, the
runner's per-node thresholds of one event as a tensor.  The LUT text file carries across:
a LUT saved by either package loads in the other and gives the same
`thresholds_for`, including the reference-side quirk that a NaN feature
value casts to the most negative integer and is clipped into bin 0.

Re-design of learn_KL_linear_model/SVM_training_predictions/train_svm.py
(:200-275) and create_lut/lut_generation.py (:30-121):

  * a class-balanced poly-3 SVC (C=0.1, gamma=0.1) on (kl_dist, feature),
    with the operating point chosen from the precision-recall curve at the
    highest threshold whose recall is <= 0.95 (train_svm.py:258-263);
  * alternatively a direct per-bin quantile rule (keep the KL range
    covering 95% of true pairs per feature bin) — simpler and
    dependency-light, same artifact shape;
  * the accepted region binned into text rows ``bin_x lower upper``
    matching the reference artifact format
    (learn_KL_linear_model/output/empvar/empvar.lut).

The reference plumbs its LUT path into clustering but never reads it
(SURVEY.md section 2.2, clustering.py:386); here `KLThresholdLUT.
thresholds_for` converts the accepted region into a per-node KL threshold
that ops/clustering.py consumes when `lut` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState
from gnn_track_finding_tpu_torch.models import pipeline


@dataclasses.dataclass
class KLThresholdLUT:
    """Accepted KL region per feature bin.

    feature: 'emp_var' (bin width feature_max/n_bins) or 'degree'
    (unit bins).  Row i covers feature bin i with KL values in
    [lower[i], upper[i]) * kl_bin_width accepted.
    """
    feature: str
    feature_bin_width: float
    kl_bin_width: float
    lower: np.ndarray       # (n_bins,) int
    upper: np.ndarray       # (n_bins,) int

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for i, (lo, hi) in enumerate(zip(self.lower, self.upper)):
                f.write(f"{i} {int(lo)} {int(hi)}\n")

    @classmethod
    def load(cls, path: str, feature: str = "emp_var",
             feature_bin_width: float = 0.05,
             kl_bin_width: float = 1.0) -> "KLThresholdLUT":
        rows = np.loadtxt(path)
        rows = np.atleast_2d(rows)
        return cls(feature=feature, feature_bin_width=feature_bin_width,
                   kl_bin_width=kl_bin_width,
                   lower=rows[:, 1].astype(int), upper=rows[:, 2].astype(int))

    def thresholds_for(self, feature_values: np.ndarray) -> np.ndarray:
        """Per-node KL acceptance threshold (upper edge of accepted band)."""
        bins = np.clip((feature_values / self.feature_bin_width).astype(int),
                       0, len(self.upper) - 1)
        return self.upper[bins] * self.kl_bin_width


def node_thresholds(table: KLThresholdLUT, g: GraphState,
                    cfg: PipelineConfig) -> torch.Tensor:
    """The runner's per-node KL thresholds for `run_pipeline(kl_thresholds=)`
    (JAX run.py:102-105): `table` read at each node's emp_var, the xy
    gradient variance of `prepare(g)`, on g's device at g's dtype.  A NaN
    emp_var lands in bin 0, as in the JAX package."""
    if table.feature != "emp_var":
        raise ValueError(f"node_thresholds reads emp_var, not {table.feature}")
    feat = pipeline.prepare(g, cfg).grad_stats[:, 1].cpu().numpy()
    with np.errstate(invalid="ignore"):
        thr = table.thresholds_for(feat)
    return torch.as_tensor(thr, dtype=g.dtype, device=g.device)


def fit_lut_quantile(rows: np.ndarray, feature: str = "emp_var",
                     n_feature_bins: int = 28, n_kl_bins: int = 100,
                     recall: float = 0.95,
                     feature_max: Optional[float] = None) -> KLThresholdLUT:
    """Per-bin KL quantile rule: in each feature bin, accept KL values up to
    the `recall` quantile of TRUE pairs (and down to their low quantile)."""
    kl, emp_var, degree, truth = rows.T
    feat = emp_var if feature == "emp_var" else degree
    if feature_max is None:
        feature_max = float(np.percentile(feat, 99)) or 1.0
    fbw = feature_max / n_feature_bins
    kl_max = float(np.percentile(kl[truth == 1], 99.5)) or 1.0
    kbw = kl_max / n_kl_bins

    lower = np.zeros(n_feature_bins, int)
    upper = np.zeros(n_feature_bins, int)
    bins = np.clip((feat / fbw).astype(int), 0, n_feature_bins - 1)
    for b in range(n_feature_bins):
        sel = (bins == b) & (truth == 1)
        if not np.any(sel):
            continue
        lo = np.quantile(kl[sel], 1.0 - recall)
        hi = np.quantile(kl[sel], recall)
        lower[b] = int(lo / kbw)
        upper[b] = int(np.ceil(hi / kbw))
    return KLThresholdLUT(feature=feature, feature_bin_width=fbw,
                          kl_bin_width=kbw, lower=lower, upper=upper)


def fit_lut_svm(rows: np.ndarray, feature: str = "emp_var",
                n_feature_bins: int = 28, n_kl_bins: int = 100,
                recall: float = 0.95,
                feature_max: Optional[float] = None) -> KLThresholdLUT:
    """SVC decision boundary at the recall<=0.95 operating point
    (train_svm.py:200-275), binned like lut_generation.py:30-121."""
    from sklearn.model_selection import train_test_split
    from sklearn.metrics import precision_recall_curve
    from sklearn.svm import SVC

    kl, emp_var, degree, truth = rows.T
    feat = emp_var if feature == "emp_var" else degree
    # scale + clip before the QP: unscaled KL values reach 1e6+ and make
    # the poly-kernel SVC pathologically slow (the reference trains on
    # already-small linear-model distances)
    kl_clip = float(np.percentile(kl[truth == 1], 99.5)) or 1.0
    f_clip = float(np.percentile(feat, 99)) or 1.0
    X = np.stack([np.minimum(kl, kl_clip) / kl_clip,
                  np.minimum(feat, f_clip) / f_clip], axis=1)
    y = truth.astype(int)
    if len(y) > 20000:
        rng = np.random.default_rng(0)
        sel = rng.choice(len(y), 20000, replace=False)
        X, y = X[sel], y[sel]
    X_tr, X_te, y_tr, y_te = train_test_split(X, y, test_size=0.3,
                                              random_state=0, stratify=y)
    clf = SVC(kernel="poly", degree=3, C=0.1, gamma=0.1,
              class_weight="balanced", max_iter=200000)
    clf.fit(X_tr, y_tr)
    scores = clf.decision_function(X_te)
    p, r, thresholds = precision_recall_curve(y_te, scores)
    order = np.argsort(-r[:-1])
    idx = next((i for i in order if r[i] <= recall), order[-1])
    thr = thresholds[idx]

    if feature_max is None:
        feature_max = float(np.percentile(feat, 99)) or 1.0
    fbw = feature_max / n_feature_bins
    kl_max = float(np.percentile(kl[y == 1], 99.5)) or 1.0
    kbw = kl_max / n_kl_bins

    lower = np.zeros(n_feature_bins, int)
    upper = np.zeros(n_feature_bins, int)
    kl_grid = (np.arange(n_kl_bins) + 0.5) * kbw
    for b in range(n_feature_bins):
        fv = (b + 0.5) * fbw
        grid = np.stack([np.minimum(kl_grid, kl_clip) / kl_clip,
                         np.full(n_kl_bins, min(fv, f_clip) / f_clip)], axis=1)
        acc = clf.decision_function(grid) >= thr
        nz = np.flatnonzero(acc)
        if nz.size:
            lower[b] = nz[0]
            upper[b] = nz[-1] + 1
    return KLThresholdLUT(feature=feature, feature_bin_width=fbw,
                          kl_bin_width=kbw, lower=lower, upper=upper)
