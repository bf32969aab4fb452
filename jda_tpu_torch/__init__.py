"""jda_tpu_torch — the JDA face detector on PyTorch and CUDA.

A port of the `jda_tpu` package (JAX on a TPU) to PyTorch on an NVIDIA H100:
a boosted cascade of classification-regression trees that jointly
classifies face/non-face windows and regresses 2D landmark shapes.  The
module names mirror `jda_tpu`'s; the TPU's Pallas kernels become kernels
written by hand for Hopper (csrc/), each beside a plain PyTorch version.

This package never imports JAX or `jda_tpu`.  Entry points run on CUDA
unless the caller passes device="cpu".

Public surface mirrors the reference C API (c/jda.h:31-68): load a binary
model, detect -> bboxes + landmarks + scores.
"""

from jda_tpu_torch.params import (
    CascadeParams,
    load_model,
    save_model,
    synthetic_model,
    realistic_drop_profile,
)
from jda_tpu_torch.detect import Detector, DetectionResult, detect

__all__ = [
    "CascadeParams",
    "load_model",
    "save_model",
    "synthetic_model",
    "realistic_drop_profile",
    "Detector",
    "DetectionResult",
    "detect",
]
