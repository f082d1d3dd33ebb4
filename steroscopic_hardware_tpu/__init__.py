"""steroscopic_hardware_tpu — a stereo depth + SLAM engine in JAX.

A framework (JAX/XLA/Pallas) with the full capabilities of the reference
project ``conneroisu/steroscopic-hardware`` (a Go + Zedboard-FPGA real-time
stereoscopic depth-mapping system), redesigned for an accelerator:

- ``ops``      — compute kernels: SAD cost-volume disparity (golden, XLA, and
                 a Pallas GPU kernel), grayscale conversion, left-right
                 consistency, features/matching.
- ``models``   — user-facing model families: block-matching disparity engine,
                 stereo visual odometry, SLAM.
- ``parallel`` — device-mesh sharding: spatially-tiled disparity via
                 ``shard_map``, distributed bundle adjustment collectives.
- ``runtime``  — streaming runtime replacing the reference's Go webserver:
                 frame sources, in-memory frame bus, camera manager, HTTP API.
- ``io``       — PNG/PGM codecs, LZMA frame compression.
- ``utils``    — parameter validation, backend choice, seeded fixtures,
                 timing, logging.

Reference parity anchors are cited throughout as ``file:line`` of the
reference repository (e.g. ``pkg/despair/sad.go:205-244``).
"""

from steroscopic_hardware_tpu.version import __version__

__all__ = ["__version__"]
