"""User-facing model families: block-matching disparity, visual odometry,
SLAM.

Importing this package raises the default matmul precision to "highest":
f32 matmuls may otherwise run in reduced precision (TF32 on a GPU), which
destabilizes the geometry solvers (PnP/BA Gauss-Newton normal equations) into NaNs.
The integer disparity kernels are unaffected, and the descriptor-matching
matmul is exact either way (+-1 inputs, f32 accumulation).
"""

import jax

jax.config.update("jax_default_matmul_precision", "highest")

from steroscopic_hardware_tpu.models.blockmatch import BlockMatcher  # noqa: E402

__all__ = ["BlockMatcher"]
