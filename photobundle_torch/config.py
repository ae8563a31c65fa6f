"""Configuration system: frozen dataclasses + `key = value` .cfg files.

Twin of photobundle_tpu/config.py, without jax: the same `ConfigFile`
parser, the same `PBAConfig` fields and defaults, so every `.cfg` file
parses to the same values in both packages. What differs is the solver
backend: `solverBackend` takes 'auto' | 'cuda' | 'torch', and
`resolve_backend` takes the engine's device (see there).

`PBAConfig` is hashable and immutable; shapes derived from it (window
size, point capacity, patch size) are fixed for an engine's lifetime.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from .ops._common import RADII


class ConfigFile:
    """Parser for the reference's ``key = value`` config format.

    Supports ``#``, ``%`` and ``//`` comments, blank lines, and typed getters
    with defaults, mirroring `ConfigFile::get<T>` in pb:src/utils.h.
    """

    def __init__(self, path: Optional[str] = None, text: Optional[str] = None):
        self._kv: Dict[str, str] = {}
        if path is not None:
            with open(path, "r") as f:
                text = f.read()
        if text is not None:
            self._parse(text)

    def _parse(self, text: str) -> None:
        for raw in text.splitlines():
            line = raw.strip()
            for marker in ("#", "%", "//"):
                idx = line.find(marker)
                if idx >= 0:
                    line = line[:idx].strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            self._kv[key.strip()] = value.strip()

    def set(self, key: str, value: Any) -> None:
        self._kv[key] = str(value)

    def get(self, key: str, default: Any = None, type_: Optional[type] = None) -> Any:
        if key not in self._kv:
            if default is None and type_ is None:
                raise KeyError(f"config key '{key}' not found and no default given")
            return default
        raw = self._kv[key]
        t = type_ if type_ is not None else (type(default) if default is not None else str)
        if t is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        return t(raw)

    def keys(self):
        return self._kv.keys()

    def as_dict(self) -> Dict[str, str]:
        return dict(self._kv)


# Descriptor types (reference: pb:src/photobundle.cc DescriptorFrame::Create).
DESCRIPTOR_INTENSITY = "Intensity"
DESCRIPTOR_INTENSITY_AND_GRADIENT = "IntensityAndGradient"
DESCRIPTOR_BITPLANES = "BitPlanes"

_DESCRIPTOR_CHANNELS = {
    DESCRIPTOR_INTENSITY: 1,
    DESCRIPTOR_INTENSITY_AND_GRADIENT: 3,
    DESCRIPTOR_BITPLANES: 8,
}


@dataclass(frozen=True)
class PBAConfig:
    """All knobs of the engine. Field names mirror the reference options
    (SURVEY.md section 5.6); values here are the reference's defaults."""

    # --- descriptor / residual model ---
    descriptor: str = DESCRIPTOR_INTENSITY
    patchRadius: int = 2                  # patch side = 2r+1 (5x5)
    sigmaPriorToCensusTransform: float = 0.5   # BitPlanes pre-smoothing
    sigmaBitPlanes: float = 0.75               # BitPlanes channel smoothing
    gradientSigma: float = 0.0            # Gaussian sigma applied to the
                                          # GRADIENT planes only (gradient-
                                          # of-Gaussian; value channels stay
                                          # sharp). The Jacobian direction
                                          # field's smoothness was measured
                                          # as the decisive sampling-mode
                                          # variable (BASELINE.md
                                          # "Interpolation-order probe");
                                          # this makes the low-pass
                                          # explicit/tunable. 0 =
                                          # reference-exact central
                                          # differences.
    patchWarp: str = "none"               # per-observation patch-grid warp
                                          # from the CURRENT geometry
                                          # (self-consistent: identity in
                                          # each point's reference frame):
                                          #   none   — the reference's fixed
                                          #     fronto-parallel grid
                                          #     (pb:src/photobundle.cc),
                                          #   scale  — isotropic depth-ratio
                                          #     rho_f = z_ref(X)/z_f(X),
                                          #   affine — full projective 2x2
                                          #     warp (anisotropic scale,
                                          #     shear, rotation).
                                          # Addresses the measured patch-
                                          # model accuracy floor (~8%/frame
                                          # scale change under forward
                                          # motion — BASELINE.md "Texture-
                                          # sharpness probe"); scale clamped
                                          # to [0.5, 2]. 'scale' runs on
                                          # the warped-grid kernel on a
                                          # card (csrc/patch_scaled.cu);
                                          # 'affine' has no kernel and
                                          # runs on the gather path.
    patchScale: bool = False              # DEPRECATED alias for
                                          # patchWarp = scale. The round-4
                                          # frozen-seed variant this key
                                          # originally named was measured
                                          # DEGRADING ATE and replaced by
                                          # the self-consistent model
                                          # (BASELINE.md round-4 sharp
                                          # table).
    normalizePatches: bool = True              # per-patch mean removal
                                          # (reference's brightness
                                          # normalization). False compares
                                          # raw intensities — exposure
                                          # changes then leak into the
                                          # residual (see test_engine
                                          # exposure-robustness test).
                                          # False overrides
                                          # patchNormalization to 'off'.
    patchNormalization: str = "mean"      # per-patch descriptor/residual
                                          # normalization: 'mean'
                                          # (reference-exact offset
                                          # removal) | 'affine' (ZNCC-
                                          # style: mean removal + unit
                                          # centered norm — gain AND
                                          # offset invariant, gives plain
                                          # Intensity descriptors
                                          # BitPlanes-level exposure
                                          # robustness; residual norms
                                          # become angle-like, so size
                                          # robustThreshold accordingly)
                                          # | 'off'. See
                                          # core/residuals.py
                                          # _normalize_sampled for the
                                          # exact Jacobian propagation.

    # --- window / point lifecycle ---
    slidingWindowSize: int = 5
    maxNumPoints: int = 4096              # fixed point-table capacity N_max
    maxPointsPerFrame: int = 1024         # admission cap per new frame
    nonMaxSuppRadius: int = 1
    minSaliency: float = 0.01             # saliency floor (images are [0,1])
    maskBlockRadius: int = 1              # block masked around tracked points
    motionPriorWeight: float = 0.0        # relative-pose prior anchoring
                                          # consecutive window poses to the
                                          # VO initialization (1/sigma in
                                          # twist units; 0 = reference-exact)
    posePriorWeight: float = 0.0          # ABSOLUTE pose prior anchoring
                                          # each window pose to its RAW VO
                                          # input pose (window.t_vo). The
                                          # sliding chain otherwise discards
                                          # the input's absolute anchoring
                                          # and integrates photometric
                                          # relative noise into a walk; this
                                          # fuses the VO absolute estimate
                                          # back in (optimal when VO error
                                          # is frame-iid; under pure drift
                                          # it bounds refinement at the VO
                                          # drift level — keep it small).
                                          # 0 = reference-exact.
    posePriorRotWeight: float = -1.0      # separate ROTATION weight for the
                                          # absolute pose prior (the twist
                                          # residual [rho|omega] mixes
                                          # meters and radians; VO rotation
                                          # noise is usually relatively
                                          # tighter than translation).
                                          # -1 = use posePriorWeight for
                                          # both components; 0 = anchor
                                          # translation only.
    numThreads: int = 4                   # host worker threads (reference:
                                          # Options::numThreads for Ceres /
                                          # OpenMP; here: native data-loader
                                          # decode+stereo pool)
    minScore: float = 0.75                # ZNCC visibility gate
    maxFrameDistance: int = 1             # max age (frames) for re-tracking
    occlusionThreshold: float = 0.0       # geometric visibility gate: do not
                                          # record an observation when the
                                          # point's predicted depth exceeds
                                          # the frame's confident stereo
                                          # depth at its projection by this
                                          # relative margin (the point is
                                          # behind a nearer surface; ZNCC
                                          # alone misses occlusions on
                                          # smooth texture). 0 = off
                                          # (reference-exact default; enable
                                          # ~0.2 on occlusion-heavy scenes).
    minDepth: float = 0.1
    maxDepth: float = 80.0
    depthEdgeThreshold: float = 0.0       # reject selection candidates whose
                                          # valid-depth spread under the patch
                                          # support exceeds this fraction of
                                          # the center depth (occlusion-
                                          # boundary patches violate the
                                          # fronto-parallel point model and
                                          # bias poses). 0 = off
                                          # (reference-exact default; enable
                                          # ~0.1-0.2 on occlusion-heavy
                                          # scenes).

    # --- solver ---
    maxIterations: int = 50
    functionTolerance: float = 1e-6       # relative cost-decrease stop
    parameterTolerance: float = 1e-8      # step-norm stop
    gradientTolerance: float = 0.0        # stop when ||J^T r||_2 <= this
                                          # (0 = disabled; Ceres uses a
                                          # max-norm variant)
    robustThreshold: float = 0.05         # robust-loss delta on the patch
                                          # residual norm (Huber delta in the
                                          # reference: ceres::HuberLoss)
    robustLoss: str = "huber"             # robust loss family applied to the
                                          # per-observation squared residual
                                          # norm: huber (reference-exact,
                                          # ceres::HuberLoss) | cauchy |
                                          # tukey (hard redescending — gross
                                          # outliers get zero weight; useful
                                          # on occlusion/specular-heavy
                                          # scenes) | none (plain least
                                          # squares, ceres::TrivialLoss).
                                          # Same delta semantics across
                                          # kinds (see core/residuals.py
                                          # robust_weight).
    depthPriorWeight: float = 0.1         # inverse-depth prior strength on
                                          # r = w*fx*b*(1/z - 1/z_seed)
                                          # (disparity-pixel units): anchors
                                          # the monocular scale gauge to the
                                          # stereo seeds each window, so the
                                          # sliding chain cannot compound
                                          # scale drift. Keep small when
                                          # stereo is noisy and parallax is
                                          # strong (the photometric term then
                                          # carries the information); raise to
                                          # ~1 for weak-parallax sequences.
                                          # 0 = reference-exact (no prior).
    initialLambda: float = 1e-4           # LM damping init
    minLambda: float = 1e-10
    maxLambda: float = 1e8
    minObsPerFrame: int = 1               # freeze window poses with fewer
                                          # valid observations than this
                                          # during the solve. 1 = reference-
                                          # equivalent (a Ceres pose block
                                          # with zero residuals stays at its
                                          # init); raising it (~8-16) is an
                                          # observability gate — a handful
                                          # of patches cannot constrain 6
                                          # DOF and will steer the pose into
                                          # the weakly-observable valley,
                                          # injecting relative-pose noise
                                          # into the sliding chain.
    numFixedPoses: int = 2                # gauge fixing: freeze oldest poses.
                                          # (reference freezes 1; freezing 2
                                          # pins rotation+translation AND the
                                          # remaining scale DOF robustly)
    maxPoseCorrection: float = 1.0        # window trust gate (meters): if a
                                          # solve moves any pose farther than
                                          # this from its initialization the
                                          # WHOLE window result is rejected
                                          # (poses/points revert; VO init
                                          # kept). Photometric refinement
                                          # legitimately corrects cm-scale
                                          # error; meter-scale "corrections"
                                          # are a diverged window (occlusion
                                          # violations, degenerate geometry)
                                          # that would otherwise cascade
                                          # through the sliding chain.
                                          # 0 disables (reference-exact).
                                          # Interacts with coarseToFine: the
                                          # engine scales the gate by 2^k (k
                                          # = coarse levels actually run) so
                                          # the extended basin's larger legit
                                          # corrections are not reverted.
    solverVerbose: bool = False           # print the per-iteration table
                                          # (cost / lambda / |step| / accept)
                                          # after each window solve

    # --- pyramid ---
    pyramidLevels: int = 1                # refinement runs at level 0
    refinementLevel: int = 0
    coarseToFine: bool = False            # solve coarse pyramid levels
                                          # first (levels pyramidLevels-1
                                          # down to refinementLevel+1),
                                          # warm-starting poses+points at
                                          # each finer level. Extends the
                                          # convergence basin ~2^k x in
                                          # initial pose error; the FINAL
                                          # level solve is identical to the
                                          # single-level path (reference
                                          # parity preserved). Coarse-level
                                          # reference patches are
                                          # re-extracted from the downsampled
                                          # window at the point's current
                                          # ref-frame projection. Interacts
                                          # with maxPoseCorrection: the trust
                                          # gate is scaled by 2^k under this
                                          # schedule (see maxPoseCorrection).
    coarseIterations: int = 15            # LM iteration cap per coarse level

    # --- dataset / stereo (host side) ---
    dataDir: str = ""
    sequence: int = 0
    firstFrame: int = 0
    numFrames: int = -1                   # -1 = all
    stereoAlgorithm: str = "BM"           # BM | SGBM | precomputed
    sadWindowSize: int = 9
    numDisparities: int = 128
    minDisparity: int = 1
    speckleWindowSize: int = 0            # cv::filterSpeckles: invalidate
                                          # connected disparity components
                                          # smaller than this (0 = off)
    speckleRange: float = 1.0             # disparity similarity within a
                                          # component
    preFilterCap: float = 0.0             # X-Sobel prefilter clamp before
                                          # matching (cv::StereoBM
                                          # PREFILTER_XSOBEL; its 8-bit
                                          # default cap=31 is ~0.12 in the
                                          # [0,1] scale here). Makes the
                                          # matcher robust to left/right
                                          # illumination differences.
                                          # 0 = off (raw-intensity SAD,
                                          # the historical default).

    # --- additions of this implementation (no reference counterpart) ---
    dtype: str = "float32"
    gradientMode: str = "sampled"         # 'sampled' (smoothed central-diff
                                          # gradient images, DSO-style) or
                                          # 'exact' (bilinear-surface grad,
                                          # matches autograd exactly)
    interpolation: str = "bilinear"       # 'bilinear' (spec default, CUDA
                                          # kernel K1) or 'bicubic'
                                          # (Catmull-Rom, Ceres parity,
                                          # exact surface grads; CUDA
                                          # kernel K2)
    meshPoints: int = 1                   # chips along the point axis
    meshWindows: int = 1                  # data-parallel window/sequence axis
    meshFrames: int = 1                   # chips along the window-FRAME axis
                                          # (('frames','points') 2-D mesh):
                                          # the window ring's image leaves
                                          # rest sharded over 'frames' so
                                          # per-chip window memory is
                                          # W / meshFrames frames — the
                                          # large-window layout of SURVEY.md
                                          # 5.7 / BASELINE config 4. Requires
                                          # slidingWindowSize % meshFrames
                                          # == 0; composes with meshPoints.
    pipelineResults: bool = False         # fetch window results on a
                                          # background thread (results lag
                                          # one frame; hides the fetch
                                          # round-trip on remote backends)
    transportCompress: bool = True        # uint8 images on the host->device
                                          # path (lossless for 8-bit
                                          # sources; 4x less transfer)
    transportDepth16: bool = False        # float16 depth transport — lossy
                                          # (~5e-4 relative): fine for noisy
                                          # stereo depth, wrong for
                                          # millimeter-accurate seeds
    minKeyframeMotion: float = 0.0        # skip ingesting frames whose VO
                                          # translation since the last
                                          # ingested keyframe is below this
                                          # (meters). Skipped frames keep
                                          # their VO pose RELATIVE to the
                                          # last refined keyframe in the
                                          # output. 0 = reference-exact (the
                                          # reference ingests every frame —
                                          # see PARITY.md "Keyframe
                                          # selection").
    dataLoader: str = "auto"              # 'auto' | 'native' | 'python' —
                                          # native = C++ libpng decode +
                                          # OpenMP stereo BM + prefetch
                                          # pipeline (photobundle_tpu/native)
    solverBackend: str = "auto"           # 'auto' | 'cuda' | 'torch' — auto
                                          # uses the hand-written CUDA
                                          # kernels on a card when the
                                          # configuration has one, the
                                          # plain torch gather path
                                          # elsewhere (resolve_backend)
    checkpointDir: str = ""
    depthCacheDir: str = ""               # cache computed stereo depth maps
                                          # (npz per frame, keyed by the
                                          # stereo parameters) so repeated
                                          # runs over the same sequence skip
                                          # the host-side matcher entirely —
                                          # stereo at KITTI size costs
                                          # ~0.8 s/frame/core. "" = off.

    # ---- derived (static) quantities ----
    @property
    def patch_size(self) -> int:
        return 2 * self.patchRadius + 1

    @property
    def num_channels(self) -> int:
        return _DESCRIPTOR_CHANNELS[self.descriptor]

    @property
    def patch_dim(self) -> int:
        """Residual dimension per observation: |patch| * channels."""
        return self.patch_size * self.patch_size * self.num_channels

    def resolve_normalization(self) -> str:
        """The per-patch normalization mode actually applied:
        normalizePatches=False (the legacy bool) forces 'off', otherwise
        patchNormalization ('mean' | 'affine' | 'off')."""
        return self.patchNormalization if self.normalizePatches else "off"

    def resolve_gradient_mode(self) -> str:
        """The residual-path sampling mode: bicubic interpolation implies
        its own exact surface gradients (Ceres behavior)."""
        return "bicubic" if self.interpolation == "bicubic" else self.gradientMode

    def resolve_patch_warp(self) -> str | None:
        """The patch-grid warp mode actually applied: None (fixed grid) or
        'scale' | 'affine'. patchScale=True is the deprecated spelling of
        patchWarp='scale'."""
        if self.patchWarp != "none":
            return self.patchWarp
        return "scale" if self.patchScale else None

    def resolve_backend(self, device="cpu") -> str:
        """The residual backend an engine on `device` runs: 'cuda' (the
        hand-written kernels) or 'torch' (the gather path).

        'auto' -> 'cuda' when `device` is a card and the configuration has
        a kernel path, 'torch' otherwise. The kernel paths (every
        patchNormalization: off, mean or affine):
          - bilinear + gradientMode='sampled' (csrc/patch_warp.cu: K1,
            and K4 with affine normalization);
          - interpolation='bicubic' (csrc/patch_bicubic.cu: K2);
          - patchWarp='scale' with bilinear + 'sampled'
            (csrc/patch_scaled.cu: K3, and K5 with affine normalization).
        patchWarp='affine' has no kernel in either package: it resolves to
        'torch', as the JAX package runs it on XLA. The kernels are built
        for patchRadius in ops/_common.RADII; a kernel-path
        configuration outside that range raises ValueError rather than
        running the gather path instead."""
        if self.solverBackend == "torch":
            return "torch"
        on_card = torch.device(device).type == "cuda"
        if self.solverBackend == "auto" and not on_card:
            return "torch"
        pw = self.resolve_patch_warp()
        bilinear_sampled = (self.interpolation == "bilinear"
                            and self.gradientMode == "sampled")
        if pw is None:
            fast_path = bilinear_sampled or self.interpolation == "bicubic"
        else:
            fast_path = pw == "scale" and bilinear_sampled
        if not fast_path:
            if self.solverBackend == "cuda":
                raise ValueError("this sampling configuration has no kernel "
                                 "path (the cuda backend runs bilinear "
                                 "gradientMode='sampled', "
                                 "interpolation='bicubic' and "
                                 "patchWarp='scale'); set solverBackend to "
                                 "auto or torch")
            return "torch"
        if self.patchRadius not in RADII:
            raise ValueError(f"the cuda kernels are built for patchRadius "
                             f"in {RADII}, not {self.patchRadius}; set "
                             f"solverBackend=torch to run the gather path")
        return "cuda"

    def validate(self) -> "PBAConfig":
        if self.descriptor not in _DESCRIPTOR_CHANNELS:
            raise ValueError(f"unknown descriptor '{self.descriptor}'")
        if self.slidingWindowSize < 2:
            raise ValueError("slidingWindowSize must be >= 2")
        if not (0 <= self.numFixedPoses <= self.slidingWindowSize):
            raise ValueError("numFixedPoses out of range")
        if self.gradientMode not in ("sampled", "exact"):
            raise ValueError(f"unknown gradientMode '{self.gradientMode}'")
        if self.interpolation not in ("bilinear", "bicubic"):
            raise ValueError(f"unknown interpolation '{self.interpolation}'")
        if self.solverBackend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown solverBackend '{self.solverBackend}'")
        if self.dataLoader not in ("auto", "native", "python"):
            raise ValueError(f"unknown dataLoader '{self.dataLoader}'")
        if self.preFilterCap < 0:
            raise ValueError("preFilterCap must be >= 0 (0 = off)")
        if self.robustLoss not in ("huber", "cauchy", "tukey", "none"):
            raise ValueError(f"unknown robustLoss '{self.robustLoss}'")
        if self.patchNormalization not in ("mean", "affine", "off"):
            raise ValueError(
                f"unknown patchNormalization '{self.patchNormalization}'")
        if self.gradientSigma < 0:
            raise ValueError("gradientSigma must be >= 0 (0 = off)")
        if self.patchWarp not in ("none", "scale", "affine"):
            raise ValueError(f"unknown patchWarp '{self.patchWarp}'")
        pw = self.resolve_patch_warp()
        if (pw is not None and self.solverBackend == "cuda"
                and (pw != "scale" or self.interpolation != "bilinear"
                     or self.gradientMode != "sampled"
                     or self.patchRadius > 9)):
            raise ValueError("only patchWarp='scale' with bilinear/sampled "
                             "and patchRadius <= 9 has a kernel path; "
                             "patchWarp='affine' (or other sampling modes / "
                             "wider patches) requires the gather path — set "
                             "solverBackend to auto or torch")
        if self.refinementLevel >= self.pyramidLevels:
            raise ValueError("refinementLevel must be < pyramidLevels")
        if self.meshFrames > 1:
            if self.slidingWindowSize % self.meshFrames != 0:
                raise ValueError(
                    f"slidingWindowSize {self.slidingWindowSize} not "
                    f"divisible by meshFrames {self.meshFrames}")
        return self

    @staticmethod
    def from_config_file(cfg: "ConfigFile | str") -> "PBAConfig":
        """Build from a ConfigFile (or path), using dataclass defaults for
        missing keys. Unknown keys are ignored (reference behavior)."""
        if isinstance(cfg, str):
            cfg = ConfigFile(cfg)
        fields = {f.name: f for f in dataclasses.fields(PBAConfig)}
        kwargs = {}
        for key in cfg.keys():
            if key in fields:
                f = fields[key]
                kwargs[key] = cfg.get(key, type_=f.type if isinstance(f.type, type) else _field_pytype(f))
        return PBAConfig(**kwargs).validate()

    def replace(self, **kwargs) -> "PBAConfig":
        return dataclasses.replace(self, **kwargs).validate()


def _field_pytype(f: dataclasses.Field) -> type:
    # dataclass field types arrive as strings under `from __future__ import
    # annotations`; map them back to concrete types for the parser.
    mapping = {"int": int, "float": float, "str": str, "bool": bool}
    return mapping.get(str(f.type), str)
