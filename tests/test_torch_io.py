"""The port's I/O (io/trajectory.py, io/kitti.py, io/png.py) against the
JAX package's, on the same files and arrays.

tests/test_io.py's cases on both packages: the trajectory code is the same
host numpy, so its results are held equal (to 1e-12 where a metric is a
float); the datasets read the same KITTI-format files with
dataLoader=python on both sides, so images are held bitwise and depths to
the stereo tolerance of tests/test_torch_stereo.py (validity differs on at
most 0.5 % of the pixels, depths within 1e-3 relative where both accept:
a 5e-3 px disparity difference at the test's ~8-px disparities is
6e-4)."""

import os
import struct
import zlib

import numpy as np
import pytest

from photobundle_tpu.config import PBAConfig as JConfig
from photobundle_tpu.io import kitti as jkitti
from photobundle_tpu.io import trajectory as jtraj
from photobundle_torch import entry
from photobundle_torch.config import PBAConfig
from photobundle_torch.io import kitti, png
from photobundle_torch.io import trajectory as traj

from synthetic import write_kitti_dataset

VALIDITY_SHARE, DEPTH_RTOL = 0.005, 1e-3


def random_trajectory(rng, n=20):
    poses = [np.eye(4)]
    for _ in range(n - 1):
        xi = np.concatenate([rng.standard_normal(3) * 0.5,
                             rng.standard_normal(3) * 0.1]).astype(np.float32)
        poses.append(poses[-1] @ entry._se3_exp_np(xi).astype(np.float64))
    return np.stack(poses)


def both(poses):
    return traj.Trajectory(poses.copy()), jtraj.Trajectory(poses.copy())


def test_kitti_pose_roundtrip(tmp_path, rng):
    poses = random_trajectory(rng)
    t, _ = both(poses)
    path = str(tmp_path / "poses.txt")
    traj.write_poses_kitti(path, t)
    back, jback = traj.load_poses_kitti(path), jtraj.load_poses_kitti(path)
    np.testing.assert_allclose(back.poses, poses, atol=1e-7)
    np.testing.assert_array_equal(back.poses, jback.poses)
    jpath = str(tmp_path / "jax.txt")
    jtraj.write_poses_kitti(jpath, jback)
    assert open(path).read() == open(jpath).read()


def test_trajectory_update():
    for mod in (traj, jtraj):
        t = mod.Trajectory(np.stack([np.eye(4)] * 5))
        new = np.eye(4)
        new[0, 3] = 7.0
        t.update([2, 3], np.stack([new, new]))
        assert t.poses[2][0, 3] == 7.0 and t.poses[0][0, 3] == 0.0
        t.update([9], new[None])
        assert len(t) == 6 and t.frame_ids[-1] == 9


def test_ate_zero_for_identical(rng):
    t, j = both(random_trajectory(rng))
    assert traj.ate_rmse(t, t) == pytest.approx(0.0, abs=1e-9)
    assert traj.ate_rmse(t, t) == jtraj.ate_rmse(j, j)


def test_ate_alignment_removes_rigid_offset(rng):
    poses = random_trajectory(rng)
    g = entry._se3_exp_np(np.array([1.0, -2.0, 0.5, 0.2, -0.1, 0.3],
                                   np.float32)).astype(np.float64)
    moved = np.einsum("ij,njk->nik", g, poses)
    (t, j), (tm, jm) = both(poses), both(moved)
    assert traj.ate_rmse(tm, t, align=False) > 1.0
    assert traj.ate_rmse(tm, t, align=True) < 1e-6
    for align in (False, True):
        assert traj.ate_rmse(tm, t, align=align) == pytest.approx(
            jtraj.ate_rmse(jm, j, align=align), abs=1e-12)


def test_ate_sim3_removes_scale(rng):
    poses = random_trajectory(rng)
    scaled = poses.copy()
    scaled[:, :3, 3] *= 1.3
    (t, j), (ts, js) = both(poses), both(scaled)
    assert traj.ate_rmse(ts, t, align=True, with_scale=True) < 1e-6
    assert traj.ate_rmse(ts, t, align=True, with_scale=False) > 0.01
    for ws in (False, True):
        assert traj.ate_rmse(ts, t, with_scale=ws) == pytest.approx(
            jtraj.ate_rmse(js, j, with_scale=ws), abs=1e-12)


def test_rpe_and_kitti_errors_detect_relative_error(rng):
    poses = random_trajectory(rng, n=60)
    noisy = poses.copy()
    noisy[5:, :3, 3] += 0.1
    (t, j), (tn, jn) = both(poses), both(noisy)
    t_err, _ = traj.rpe(tn, t)
    assert t_err > 0.01
    assert traj.rpe(tn, t, delta=2) == jtraj.rpe(jn, j, delta=2)
    lengths = (1, 2, 5)
    for name in ("kitti_translation_error", "kitti_rotation_error"):
        got = getattr(traj, name)(tn, t, lengths=lengths)
        assert got == getattr(jtraj, name)(jn, j, lengths=lengths), name
    assert traj.kitti_translation_error(tn, t, lengths=lengths) > 0


def test_kitti_calib_parsing(tmp_path):
    calib = tmp_path / "calib.txt"
    fx, cx, cy, b = 718.856, 607.1928, 185.2157, 0.5371
    calib.write_text(f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n"
                     f"P1: {fx} 0 {cx} {-fx * b} 0 {fx} {cy} 0 0 0 1 0\n"
                     "Tr: 1 2 3\n")
    mats = kitti.parse_kitti_calib(str(calib))
    jmats = jkitti.parse_kitti_calib(str(calib))
    assert sorted(mats) == sorted(jmats) == ["P0", "P1"]
    for k in mats:
        np.testing.assert_array_equal(mats[k], jmats[k])
    cam = kitti.calibration_from_projections(mats["P0"], mats["P1"])
    jcam = jkitti.calibration_from_projections(jmats["P0"], jmats["P1"])
    np.testing.assert_array_equal([float(v) for v in cam],
                                  [float(v) for v in jcam])
    assert float(cam.baseline) == pytest.approx(b, rel=1e-5)


def assert_frames_match(f, jf):
    np.testing.assert_array_equal(f.image, jf.image)
    assert f.timestamp == jf.timestamp and f.index == jf.index
    differ = (f.depth_valid != jf.depth_valid).mean()
    assert differ <= VALIDITY_SHARE, differ
    ok = f.depth_valid & jf.depth_valid
    assert ok.any()
    np.testing.assert_allclose(f.depth[ok], jf.depth[ok], rtol=DEPTH_RTOL)


def datasets(cfg_kw):
    cfg = PBAConfig(dataLoader="python", **cfg_kw)
    jcfg = JConfig(dataLoader="python", **cfg_kw)
    return (kitti.create_dataset(cfg, device="cpu"),
            jkitti.create_dataset(jcfg))


def test_kitti_dataset_from_files(tmp_path, rng):
    """A uniform-disparity PNG pair on disk -> frames with depth, through
    both packages' datasets (stereo: BM)."""
    import cv2

    seq = tmp_path / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    h, w, d_true = 96, 160, 8
    base = cv2.GaussianBlur(rng.uniform(0, 255, size=(h, w + d_true)
                                        ).astype(np.uint8), (5, 5), 1.0)
    for i in range(2):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), base[:, :-d_true])
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), base[:, d_true:])
    fx, b = 100.0, 0.5
    (seq / "calib.txt").write_text(
        f"P0: {fx} 0 {w/2} 0 0 {fx} {h/2} 0 0 0 1 0\n"
        f"P1: {fx} 0 {w/2} {-fx*b} 0 {fx} {h/2} 0 0 0 1 0\n")
    (seq / "times.txt").write_text("0.0\n0.1\n")
    ds, jds = datasets(dict(dataDir=str(tmp_path), sequence=0,
                            numDisparities=16, minDepth=0.1, maxDepth=100.0))
    assert len(ds) == len(jds) == 2
    assert ds.image_shape == jds.image_shape == (h, w)
    frame = ds.get_frame(0)
    assert_frames_match(frame, jds.get_frame(0))
    valid_depths = frame.depth[frame.depth_valid]
    assert valid_depths.size > 100
    expected = fx * b / d_true
    assert abs(np.median(valid_depths) - expected) / expected < 0.05
    assert ds.pose_file() == jds.pose_file()


def test_kitti_dataset_sgbm(tmp_path, rng):
    write_kitti_dataset(str(tmp_path), 0, rng, n_frames=2, shape=(64, 96))
    ds, jds = datasets(dict(dataDir=str(tmp_path), sequence=0,
                            stereoAlgorithm="SGBM", numDisparities=32,
                            sadWindowSize=5, minDepth=0.5, maxDepth=60.0))
    f = ds.get_frame(0)
    assert f.depth_valid.any()
    d = f.depth[f.depth_valid]
    assert np.isfinite(d).all() and (d > 0.5).all() and (d < 60.0).all()
    assert_frames_match(f, jds.get_frame(0))


def test_kitti_dataset_opencv_bm(tmp_path, rng):
    """stereoAlgorithm=OPENCV_BM calls OpenCV's matcher on the host in both
    packages: the same depths, bitwise."""
    write_kitti_dataset(str(tmp_path), 0, rng, n_frames=2, shape=(64, 96))
    ds, jds = datasets(dict(dataDir=str(tmp_path), sequence=0,
                            stereoAlgorithm="OPENCV_BM", numDisparities=32,
                            sadWindowSize=9, minDepth=0.5, maxDepth=60.0))
    f, jf = ds.get_frame(0), jds.get_frame(0)
    assert f.depth_valid.any()
    np.testing.assert_array_equal(f.depth, jf.depth)
    np.testing.assert_array_equal(f.depth_valid, jf.depth_valid)


def test_depth_cache_roundtrip(tmp_path, rng):
    """depthCacheDir: a second dataset over the same sequence and stereo
    parameters loads identical depth without the matcher; other stereo
    parameters miss; the port's cache key names its own producer, so the
    two packages never serve each other's depths."""
    write_kitti_dataset(str(tmp_path), 0, rng, n_frames=2, shape=(64, 96))
    cache = str(tmp_path / "depth_cache")
    kw = dict(dataDir=str(tmp_path), sequence=0, numDisparities=32,
              sadWindowSize=5, minDepth=0.5, maxDepth=60.0,
              depthCacheDir=cache)
    ds1, jds = datasets(kw)
    assert not ds1._cache_all_hit
    frames1 = [ds1.get_frame(i) for i in range(2)]
    ds2 = kitti.create_dataset(PBAConfig(dataLoader="python", **kw),
                               device="cpu")
    assert ds2._cache_all_hit
    ds2._compute_depth = lambda *a: pytest.fail("the matcher ran")
    for i, f1 in enumerate(frames1):
        f2 = ds2.get_frame(i)
        np.testing.assert_array_equal(f1.depth, f2.depth)
        np.testing.assert_array_equal(f1.depth_valid, f2.depth_valid)
        np.testing.assert_array_equal(f1.image, f2.image)
    ds3 = kitti.create_dataset(PBAConfig(dataLoader="python",
                                         **dict(kw, numDisparities=16)),
                               device="cpu")
    assert not ds3._cache_all_hit
    jframes = [jds.get_frame(i) for i in range(2)]
    assert ds1._cache_dir.endswith(jds._cache_dir[-10:])    # same data id
    assert "_torch_" in ds1._cache_dir and "_torch_" not in jds._cache_dir
    assert ds1._cache_dir != jds._cache_dir
    for f1, jf in zip(frames1, jframes):
        assert_frames_match(f1, jf)


def test_native_data_loader_raises(tmp_path, rng, monkeypatch):
    """dataLoader=native where the native runtime does not build: a
    RuntimeError that names the build error (as the JAX package raises),
    never the torch matcher in its place."""
    from photobundle_torch import native

    write_kitti_dataset(str(tmp_path), 0, rng, n_frames=1, shape=(32, 48))
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "g++: not found")
    cfg = PBAConfig(dataDir=str(tmp_path), dataLoader="native")
    with pytest.raises(RuntimeError, match="dataLoader=native requested but "
                                           "the native runtime is "
                                           "unavailable: g\\+\\+: not found"):
        kitti.create_dataset(cfg, device="cpu")


def test_dataset_stereo_runs_on_the_card_by_default(tmp_path, rng,
                                                    monkeypatch):
    """Stereo runs on the dataset's device: the card unless the caller
    asks for the CPU; without a card it raises instead."""
    import torch

    write_kitti_dataset(str(tmp_path), 0, rng, n_frames=1, shape=(32, 48))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PBAConfig(dataDir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kitti.create_dataset(cfg)
    assert kitti.create_dataset(cfg, device="cpu").device.type == "cpu"


def png_filters(path):
    """The row-filter types of an 8-bit grayscale PNG file."""
    data = open(path, "rb").read()
    pos, idat, w = 8, b"", None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            w = struct.unpack(">I", body[:4])[0]
        if ctype == b"IDAT":
            idat += body
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(-1, w + 1)[:, 0].tolist())


def encode_png(path, img):
    """An 8-bit grayscale PNG whose rows cycle through the five filters
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), encoded as the PNG
    specification defines them."""
    h, w = img.shape
    rows, prev = [], np.zeros(w, int)
    for y in range(h):
        cur = img[y].astype(int)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = (0, left, prev, (left + prev) // 2, paeth)[y % 5]
        rows.append(bytes([y % 5]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def test_png_decoder_matches_pil(tmp_path, rng):
    """The stdlib decoder against PIL, bitwise: on a file using every row
    filter, on a file PIL wrote, and on the port's own writer's file."""
    import scipy.ndimage
    from PIL import Image

    img = np.clip(scipy.ndimage.gaussian_filter(
        rng.uniform(0, 255, (70, 133)), 2) * 3 - 200, 0, 255).astype(np.uint8)
    img[:4] = rng.integers(0, 256, (4, 133))
    every = str(tmp_path / "every.png")
    encode_png(every, img)
    assert png_filters(every) == {0, 1, 2, 3, 4}
    pil = str(tmp_path / "pil.png")
    Image.fromarray(img).save(pil)
    mine = str(tmp_path / "mine.png")
    png.write_png_gray(mine, img)
    for path in (every, pil, mine):
        got = png.read_png_gray(path)
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
        np.testing.assert_array_equal(got, img)


def test_png_decoder_refuses_other_kinds(tmp_path):
    from PIL import Image

    for name, arr in (("rgb", np.zeros((8, 9, 3), np.uint8)),
                      ("gray16", np.zeros((8, 9), np.uint16))):
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(arr).save(path)
        with pytest.raises(ValueError, match="8-bit grayscale"):
            png.read_png_gray(path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png_gray(str(bad))


def test_imread_order_and_reciprocal(tmp_path, monkeypatch):
    """_imread_gray multiplies by the f32 reciprocal of 255 (not /255), as
    the JAX package's does, and decodes with the stdlib PNG decoder where
    neither OpenCV nor PIL can be imported."""
    import builtins

    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    path = str(tmp_path / "g.png")
    png.write_png_gray(path, img)
    want = img.astype(np.float32) * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(kitti._imread_gray(path), want)
    np.testing.assert_array_equal(jkitti._imread_gray(path), want)
    real_import = builtins.__import__

    def no_cv2_no_pil(name, *args, **kw):
        if name in ("cv2", "PIL"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2_no_pil)
    np.testing.assert_array_equal(kitti._imread_gray(path), want)


def test_write_kitti_sequence_matches_synthetic_writer(tmp_path):
    """entry.write_kitti_sequence (jax-free, used on the card) writes the
    scene tests/synthetic.write_kitti_dataset writes: same calibration,
    poses and (8-bit) images, to one gray level."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    cam, poses = entry.write_kitti_sequence(
        a, np.random.default_rng(4), n_frames=3, shape=(40, 64), fx=100.0,
        baseline=0.2, motion_scale=0.05)
    jposes, _ = write_kitti_dataset(b, 0, np.random.default_rng(4),
                                    n_frames=3, shape=(40, 64))
    np.testing.assert_allclose(poses, jposes, atol=1e-6)
    for sub in ("image_0", "image_1"):
        for i in range(3):
            name = os.path.join("sequences", "00", sub, f"{i:06d}.png")
            pa = png.read_png_gray(os.path.join(a, name)).astype(int)
            pb = png.read_png_gray(os.path.join(b, name)).astype(int)
            assert np.abs(pa - pb).max() <= 1
    ca = kitti.parse_kitti_calib(os.path.join(a, "sequences/00/calib.txt"))
    cb = kitti.parse_kitti_calib(os.path.join(b, "sequences/00/calib.txt"))
    for k in ("P0", "P1"):
        np.testing.assert_allclose(ca[k], cb[k], rtol=1e-12)
    np.testing.assert_allclose(
        traj.load_poses_kitti(os.path.join(a, "poses/00.txt")).poses,
        traj.load_poses_kitti(os.path.join(b, "poses/00.txt")).poses,
        atol=1e-6)
