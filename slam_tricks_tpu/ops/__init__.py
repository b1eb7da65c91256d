"""Kernel layer: XLA image ops, NMS, small-matrix Cholesky."""

from slam_tricks_tpu.ops import image, nms  # noqa: F401
from slam_tricks_tpu.ops.smallchol import cho_solve_small, cholesky_small  # noqa: F401
