"""KITTI loader (synthetic layout), multihost helper, batch kernel tests."""


import numpy as np

from steroscopic_hardware_tpu.io.kitti import KittiOdometry
from steroscopic_hardware_tpu.io.png import write_png
from steroscopic_hardware_tpu.parallel.multihost import (
    global_mesh,
    init_distributed,
)


def _make_kitti(tmp_path, rng, n_frames=3):
    seq = tmp_path / "sequences" / "04"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    fx, fy, cx, cy, b = 718.856, 718.856, 607.19, 185.21, 0.5371657
    with open(seq / "calib.txt", "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {cx} {-fx * b} 0 {fy} {cy} 0 0 0 1 0\n")
    poses = []
    for i in range(n_frames):
        img = rng.integers(0, 256, (32, 96), dtype=np.uint8)
        write_png(str(seq / "image_0" / f"{i:06d}.png"), img)
        write_png(str(seq / "image_1" / f"{i:06d}.png"),
                  np.roll(img, -4, axis=1))
        poses.append([1, 0, 0, 0.1 * i, 0, 1, 0, 0, 0, 0, 1, 0.5 * i])
    np.savetxt(str(tmp_path / "poses" / "04.txt"), np.array(poses))
    return str(tmp_path), (fx, fy, cx, cy, b)


def test_kitti_sequence_load(tmp_path, rng):
    root, (fx, fy, cx, cy, b) = _make_kitti(tmp_path, rng)
    seq = KittiOdometry(root, "04")
    assert len(seq) == 3
    assert np.isclose(seq.fx, fx) and np.isclose(seq.baseline, b)
    left, right = seq.pair(0)
    assert left.shape == (32, 96)
    cam = seq.stereo_camera()
    assert np.isclose(cam.baseline, b)
    gt = seq.gt_positions()
    assert gt.shape == (3, 3)
    assert np.allclose(gt[:, 0], [0.0, 0.1, 0.2])


def test_init_distributed_single_process():
    info = init_distributed()
    assert info["num_processes"] == 1
    assert info["global_devices"] == 8


def test_global_mesh_spans_local_devices():
    mesh = global_mesh()
    assert mesh.shape["rows"] * mesh.shape["batch"] == 8


def test_batch_kernel_bitexact(rng):
    from steroscopic_hardware_tpu.ops.sad_pallas import (
        disparity_pallas_batch,
    )
    from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy

    F = 3
    L = rng.integers(0, 256, (F, 40, 64), dtype=np.uint8)
    R = np.stack([np.roll(L[f], -2, axis=1) for f in range(F)])
    out = np.asarray(
        disparity_pallas_batch(
            L, R, block_size=7, max_disparity=16, interpret=True,
        )
    )
    for f in range(F):
        assert np.array_equal(out[f], disparity_numpy(L[f], R[f], 7, 16))
