"""KITTI odometry sequences: images, calibration, stereo depth.

Twin of photobundle_tpu/io/kitti.py. Images are decoded on the host
(OpenCV, else PIL, else the port's own 8-bit grayscale PNG decoder,
`io/png.py`: the card's machine has neither library); stereo runs as the
port's torch matcher (`image/stereo.py`) on the dataset's device, and the
speckle filter on the host (`io/speckle.py`).

Directory layout (KITTI odometry):
    <root>/sequences/<NN>/image_0/??????.png   left gray
    <root>/sequences/<NN>/image_1/??????.png   right gray
    <root>/sequences/<NN>/calib.txt            P0..P3 projection rows
    <root>/sequences/<NN>/times.txt
    <root>/poses/<NN>.txt                      ground truth (if present)

cfg.dataLoader: 'auto' and 'python' run the torch matcher (what the JAX
package's 'auto' does where its native runtime is missing); 'native' (the
C++ decode + stereo + prefetch runtime) raises NotImplementedError.
"""

from __future__ import annotations

import glob
import hashlib
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PBAConfig
from ..core.engine import require_device
from ..geometry.camera import Camera
from ..image import stereo as stereo_mod
from . import png
from .speckle import speckle_filter_numpy


class StereoFrame(NamedTuple):
    image: np.ndarray       # (H, W) float32 in [0, 1], left gray
    depth: np.ndarray       # (H, W) float32 metric depth (0 = invalid)
    depth_valid: np.ndarray  # (H, W) bool
    timestamp: float
    index: int


def _imread_gray(path: str) -> np.ndarray:
    """(H, W) f32 in [0, 1] of an 8-bit grayscale image: OpenCV, else PIL,
    else `png.read_png_gray` (8-bit grayscale PNG only)."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"failed to read {path}")
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            img = png.read_png_gray(path)
        else:
            with Image.open(path) as im:
                img = np.asarray(im.convert("L"))
    # Multiply by the f32 reciprocal (not /255) so pixels match the
    # engine's uint8 dequantization bitwise.
    return img.astype(np.float32) * np.float32(1.0 / 255.0)


def parse_kitti_calib(path: str):
    """calib.txt -> dict of 3x4 projection matrices {P0: ..., P1: ...}."""
    mats = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, vals = line.partition(":")
            v = np.array(vals.split(), dtype=np.float64)
            if v.size == 12:
                mats[key.strip()] = v.reshape(3, 4)
    return mats


def calibration_from_projections(p0: np.ndarray, p1: np.ndarray) -> Camera:
    """fx, fy, cx, cy from P0; stereo baseline from P1 (b = -P1[0,3]/fx).
    A CPU Camera (the engine moves it to its device)."""
    fx = p0[0, 0]
    return Camera.create(fx=fx, fy=p0[1, 1], cx=p0[0, 2], cy=p0[1, 2],
                         baseline=-p1[0, 3] / fx)


@dataclass
class KittiStereoDataset:
    """Sequence reader + stereo-depth producer. `device` runs the matcher
    (the card unless the CPU is asked for; raises where there is none)."""

    root: str
    sequence: int
    cfg: PBAConfig
    first_frame: int = 0
    num_frames: int = -1
    device: str = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)
        if self.cfg.dataLoader == "native":
            raise NotImplementedError(
                "dataLoader=native (the C++ decode + stereo runtime) is not "
                "ported to photobundle_torch yet (ROADMAP.md queue 1 item "
                "10); use dataLoader=auto or python")
        seq = f"{self.sequence:02d}"
        self.seq_dir = os.path.join(self.root, "sequences", seq)
        self.left_files = sorted(glob.glob(os.path.join(self.seq_dir,
                                                        "image_0", "*.png")))
        self.right_files = sorted(glob.glob(os.path.join(self.seq_dir,
                                                         "image_1", "*.png")))
        if not self.left_files:
            raise FileNotFoundError(f"no images under {self.seq_dir}/image_0")
        calib = parse_kitti_calib(os.path.join(self.seq_dir, "calib.txt"))
        self.camera = calibration_from_projections(calib["P0"], calib["P1"])
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = (np.loadtxt(times_path) if os.path.exists(times_path)
                      else np.arange(len(self.left_files), dtype=np.float64))
        end = len(self.left_files) if self.num_frames < 0 else min(
            len(self.left_files), self.first_frame + self.num_frames)
        self.indices = list(range(self.first_frame, end))

        # Depth cache (cfg.depthCacheDir): depth depends only on the stereo
        # parameters, the calibration, the producer and the data, so
        # repeated runs over one sequence reuse it. The key names the
        # producer 'torch': the JAX package's depths (producer 'jax' or
        # 'native') are never served here, nor these there.
        self._cache_dir = None
        self._cache_all_hit = False
        cfg = self.cfg
        if cfg.depthCacheDir:
            # Dataset identity: the first image's path, size and mtime, so
            # two datasets sharing a cache directory never serve each
            # other's depths.
            probe = self.left_files[self.indices[0]]
            st = os.stat(probe)
            ident = hashlib.md5(
                f"{os.path.abspath(probe)}|{st.st_size}|{st.st_mtime_ns}"
                .encode()).hexdigest()[:10]
            key = "_".join(str(v) for v in (
                cfg.stereoAlgorithm.upper(), cfg.numDisparities,
                cfg.minDisparity, cfg.sadWindowSize, cfg.speckleWindowSize,
                cfg.speckleRange, cfg.minDepth, cfg.maxDepth,
                f"{float(self.camera.fx):.6g}",
                f"{float(self.camera.baseline):.6g}", "torch", ident))
            if cfg.preFilterCap > 0:
                key += f"_pfc{cfg.preFilterCap}"
            self._cache_dir = os.path.join(cfg.depthCacheDir,
                                           f"seq{self.sequence:02d}_{key}")
            os.makedirs(self._cache_dir, exist_ok=True)
            self._cache_all_hit = all(
                os.path.exists(self._cache_path(i)) for i in self.indices)

    def __len__(self):
        return len(self.indices)

    @property
    def image_shape(self):
        return _imread_gray(self.left_files[self.indices[0]]).shape

    def pose_file(self) -> str:
        return os.path.join(self.root, "poses", f"{self.sequence:02d}.txt")

    def _compute_depth(self, left: np.ndarray, right: np.ndarray):
        cfg = self.cfg
        algo = cfg.stereoAlgorithm.upper()
        if algo in ("BM", "SGBM"):
            match = (stereo_mod.semi_global_match if algo == "SGBM"
                     else stereo_mod.block_match)
            disp, valid = match(
                torch.as_tensor(left, device=self.device),
                torch.as_tensor(right, device=self.device),
                num_disparities=cfg.numDisparities,
                min_disparity=cfg.minDisparity,
                sad_radius=cfg.sadWindowSize // 2,
                prefilter_cap=cfg.preFilterCap)
            disp, valid = disp.cpu().numpy(), valid.cpu().numpy()
            if cfg.speckleWindowSize > 0:
                disp, valid = speckle_filter_numpy(
                    disp, valid, max_diff=cfg.speckleRange,
                    min_region=cfg.speckleWindowSize)
        elif algo == "OPENCV_BM":
            import cv2

            bm = cv2.StereoBM_create(numDisparities=cfg.numDisparities,
                                     blockSize=cfg.sadWindowSize)
            disp16 = bm.compute((left * 255).astype(np.uint8),
                                (right * 255).astype(np.uint8))
            disp = disp16.astype(np.float32) / 16.0
            valid = disp > cfg.minDisparity
        else:
            raise ValueError(f"unknown stereoAlgorithm {cfg.stereoAlgorithm}")
        fx = float(self.camera.fx)
        b = float(self.camera.baseline)
        with np.errstate(divide="ignore"):
            depth = np.where(valid & (disp > 0),
                             fx * b / np.maximum(disp, 1e-6), 0.0)
        ok = valid & (depth > cfg.minDepth) & (depth < cfg.maxDepth)
        return depth.astype(np.float32), ok

    def _cache_path(self, idx: int) -> str:
        return os.path.join(self._cache_dir, f"{idx:06d}.npz")

    def seek(self, i: int) -> None:
        """Resume support (the CLI calls it where it skips frames). Frames
        are produced on demand here, with no prefetch to redirect, so there
        is nothing to do."""

    def get_frame(self, i: int) -> StereoFrame:
        idx = self.indices[i]
        left = _imread_gray(self.left_files[idx])
        if self._cache_dir is not None and os.path.exists(
                self._cache_path(idx)):
            z = np.load(self._cache_path(idx))
            return StereoFrame(image=left, depth=z["depth"],
                               depth_valid=z["ok"],
                               timestamp=float(self.times[idx]), index=idx)
        right = _imread_gray(self.right_files[idx])
        depth, ok = self._compute_depth(left, right)
        if self._cache_dir is not None:
            # tmp + replace: a concurrent run over the same cache never
            # loads a half-written file.
            path = self._cache_path(idx)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez_compressed(f, depth=depth, ok=np.asarray(ok, bool))
            os.replace(tmp, path)
        return StereoFrame(image=left, depth=depth, depth_valid=ok,
                           timestamp=float(self.times[idx]), index=idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_frame(i)


@dataclass
class PrecomputedDepthDataset:
    """Frames from arrays already in memory (synthetic tests, custom data)."""

    images: list
    depths: list
    camera: Camera
    times: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.images)

    @property
    def image_shape(self):
        return np.asarray(self.images[0]).shape

    def get_frame(self, i: int) -> StereoFrame:
        img = np.asarray(self.images[i], np.float32)
        depth = np.asarray(self.depths[i], np.float32)
        t = float(self.times[i]) if self.times is not None else float(i)
        return StereoFrame(image=img, depth=depth, depth_valid=depth > 0,
                           timestamp=t, index=i)

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_frame(i)


def create_dataset(cfg: PBAConfig, device="cuda"):
    """Dataset factory mirroring `Dataset::Create(ConfigFile)`
    (pb:src/dataset.cc); stereo runs on `device`."""
    return KittiStereoDataset(root=cfg.dataDir, sequence=cfg.sequence,
                              cfg=cfg, first_frame=cfg.firstFrame,
                              num_frames=cfg.numFrames, device=device)
