"""PyTorch + CUDA port of the Gaussian-mixture Kalman track-finding pipeline.

The JAX package `gnn_track_finding_tpu` is the reference; this package
mirrors its module paths (config, graph/, ops/, models/) so each module's
counterpart is easy to find.  It imports torch and numpy (and scipy for
the ingest's component labels), never JAX.  The two
hand-written Hopper kernels live in `csrc/` and are built with nvcc at
first use (`_build.py`); every kernel wrapper takes its plain PyTorch
version for CPU tensors.
"""

from gnn_track_finding_tpu_torch.config import PipelineConfig

__all__ = ["PipelineConfig"]
