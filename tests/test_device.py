"""Backend choice, compile cache, seeded fixtures and the chip smoke's
refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from steroscopic_hardware_tpu.utils import device, fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [("gpu", "pallas"),
                                           ("cpu", "xla")])
def test_sad_backend_by_platform(platform, want):
    assert device.sad_backend(platform) == want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_sad_backend_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no disparity path"):
        device.sad_backend(platform)


def test_sad_backend_defaults_to_first_device():
    assert device.sad_backend() == "xla"  # the test suite runs on the CPU


def test_callers_follow_the_chooser(monkeypatch):
    """BlockMatcher("auto") asks the chooser; unknown backends fail."""
    from steroscopic_hardware_tpu.models import blockmatch

    assert blockmatch.BlockMatcher().backend == "xla"
    monkeypatch.setattr(blockmatch, "sad_backend", lambda: "pallas")
    assert blockmatch.BlockMatcher().backend == "pallas"
    with pytest.raises(ValueError):
        blockmatch.BlockMatcher(backend="mosaic")


def test_compile_cache_respects_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # untouched


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("size", [fixtures.VGA, (96, 200)])
def test_fixture_pair_has_known_disparity(size):
    left, right, disp = fixtures.stereo_pair(size, seed=3)
    H, W = size
    assert left.shape == right.shape == disp.shape == size
    assert left.dtype == right.dtype == np.uint8
    assert 0 < disp.min() and disp.max() < 64
    ys, xs = np.nonzero(np.arange(W)[None, :] >= disp)
    assert np.array_equal(left[ys, xs], right[ys, xs - disp[ys, xs]])
    assert left.std() > 20  # textured enough to match


def test_fixture_is_seeded():
    a = fixtures.stereo_pair((64, 96), seed=1)
    b = fixtures.stereo_pair((64, 96), seed=1)
    c = fixtures.stereo_pair((64, 96), seed=2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_fixture_sad_recovers_disparity():
    """The golden SAD matcher finds the generated disparity on the VGA
    pair away from occlusion borders (the pair is a usable test scene)."""
    from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy

    left, right, disp = fixtures.stereo_pair(fixtures.VGA, seed=0)
    got = disparity_numpy(left, right, 7, 64).astype(float) * 64 / 255
    inner = np.s_[8:-8, 64:-8]
    assert (np.abs(got - disp)[inner] <= 1.5).mean() > 0.95


def test_fixture_cli_writes_gray_pngs(tmp_path):
    from steroscopic_hardware_tpu.ops.gray import load_gray

    fixtures.main(["--size", "200x96", "--seed", "4",
                   "--out", str(tmp_path)])
    left, right, _ = fixtures.stereo_pair((96, 200), seed=4)
    assert np.array_equal(load_gray(str(tmp_path / "L.png")), left)
    assert np.array_equal(load_gray(str(tmp_path / "R.png")), right)
    assert fixtures.parse_size("1920x1080") == fixtures.FULL_HD


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """On a CPU-only JAX the smoke exits non-zero and prints no result;
    alone in a directory (no package beside it) it fails the same way."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), None)):
        if script is None:
            with open(os.path.join(ROOT, "chip_smoke.py")) as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
            script = "chip_smoke.py"
        p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0
        assert "needs a GPU" in p.stderr
        assert '"ok"' not in p.stdout
