"""direct_stereo_slam_tpu — a JAX/XLA direct stereo SLAM framework.

A from-scratch rebuild of the capabilities of IRVLab/direct_stereo_slam
(DSO-style direct sparse odometry + 1-DoF stereo scale optimization +
Scan-Context loop closure + SE(3) pose-graph optimization), re-designed
as accelerator array programs:

* fixed-shape array state (keyframe window, point budgets) with validity
  masks instead of pointer graphs,
* one fused residual/Jacobian/Hessian pass family (plain XLA) shared by
  the coarse tracker, the stereo scale optimizer and
  the loop-closure pose estimator,
* Levenberg-Marquardt loops as `lax.while_loop` inside single jitted
  programs, batched candidate tracking via `vmap`,
* dense masked Gauss-Newton with closed-form Schur complement over inverse
  depths for the windowed photometric bundle adjustment,
* a thin, functional host layer for keyframe scheduling, loop detection
  queueing and trajectory export.

Reference behavior is documented per-module with citations into the C++
reference (file:line under /root/reference).
"""

__version__ = "0.1.0"
