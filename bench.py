#!/usr/bin/env python
"""Headline benchmark: SAD disparity throughput at BASELINE config #1.

640x480 seeded stereo pair (``utils/fixtures.py``), block=7,
maxDisparity=64 — the reference's live compute loop
(pkg/camera/output.go:129-210) ran this on a 32-goroutine CPU pool; the
target is >30 fps sustained (BASELINE.md).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
``vs_baseline`` is fps / 30. ``detail`` names the device the number was
taken on (platform, device_kind, count): a CPU run measures XLA's CPU
backend, not the card.

Timing: the disparity path chosen by ``utils.device.sad_backend`` (the
Pallas kernel on a GPU, XLA on the CPU), host clock around
``block_until_ready``, after warmup, median of 50 runs. A bit-exactness
guard against the golden model runs first.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from steroscopic_hardware_tpu.utils.device import (  # noqa: E402
    enable_compile_cache,
    sad_backend,
)
from steroscopic_hardware_tpu.utils.fixtures import (  # noqa: E402
    VGA,
    stereo_pair,
)

BLOCK, MAXD = 7, 64
TARGET_FPS = 30.0
RUNS = 50
METRIC = "disparity_fps_640x480_b7_d64"


def main():
    enable_compile_cache()
    backend = sad_backend()
    if backend == "pallas":
        from steroscopic_hardware_tpu.ops.sad_pallas import (
            disparity_pallas as impl,
        )
    else:
        from steroscopic_hardware_tpu.ops.sad_xla import disparity_xla as impl

    def step(l, r):
        return impl(l, r, block_size=BLOCK, max_disparity=MAXD)

    left, right, _ = stereo_pair(VGA, seed=0)
    L, R = jax.device_put(left), jax.device_put(right)
    dev = jax.devices()[0]

    # Correctness guard: bit-match the golden-model contract on a crop
    # (full-frame equality is covered in tests/ and chip_smoke.py).
    from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy

    crop = np.s_[200:264, 200:328]
    want = disparity_numpy(left[crop], right[crop], BLOCK, MAXD)
    got = np.asarray(step(jax.device_put(left[crop]),
                          jax.device_put(right[crop])))
    if not np.array_equal(want, got):
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "fps",
                          "vs_baseline": 0.0,
                          "error": "bit-exactness check failed"}))
        return 1

    step(L, R).block_until_ready()  # compile + warm up
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        step(L, R).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    fps = 1.0 / dt
    print(json.dumps({
        "metric": METRIC,
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / TARGET_FPS,
        "detail": {
            "ms_per_frame": dt * 1000,
            "mpix_per_s": left.size / 1e6 / dt,
            "backend": backend,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "block_size": BLOCK,
            "max_disparity": MAXD,
            "runs": RUNS,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
