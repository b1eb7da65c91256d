"""slam_tricks_tpu — a sparse nonlinear least-squares / SLAM framework.

Built from scratch in JAX/XLA/Pallas, covering the SLAM problem classes of the
reference catalog `Unsigned-Long/slam-tricks` (see SURVEY.md):

- ``manifolds``       Lie groups SO2/SE2/SO3/SE3 — vmappable, dtype-polymorphic
- ``residuals``       camera models, reprojection, ICP, calibration, pose-graph residuals
- ``problem``         declarative NLLS problem containers (parameter blocks, gauge masks)
- ``solvers``         vmapped Gauss-Newton / Levenberg-Marquardt, Schur-complement BA
- ``ops``             Pallas kernels + XLA image ops (NMS, conv likelihood, sampling)
- ``initialization``  direct solvers: 8-point, DLT, triangulation, Zhang, RANSAC
- ``parallel``        mesh/shard_map distributed solvers (ICI/DCN collectives)
- ``sim``             deterministic scene/trajectory/measurement simulators
- ``estimation``      ESKF and strapdown INS mechanization
- ``frontend``        image front-ends (undistortion, chessboard, optical flow)
- ``evaluation``      metrics: ATE, reprojection statistics
- ``utils``           logging, timing, config

Everything on the compute path is pure-functional JAX: static shapes,
`lax`-control-flow, vmap/shard_map-friendly, f32 (accelerator) and f64 (CPU verification)
capable.
"""

__version__ = "0.1.0"

from slam_tricks_tpu import manifolds  # noqa: F401
