"""The port's configuration (photobundle_torch/config.py) against the JAX
package's: every shipped .cfg parses to the same values, validation is
mirrored, and the solver backend resolves by device."""

import dataclasses
import pathlib

import pytest

from photobundle_tpu import config as jcfg
from photobundle_torch import config as tcfg

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.cfg"))

# The backend field is the one the port changes: its values name this
# package's backends ('auto' | 'cuda' | 'torch').
BACKEND_FIELD = "solverBackend"


def test_same_fields_and_defaults():
    j = {f.name: f.default for f in dataclasses.fields(jcfg.PBAConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tcfg.PBAConfig)}
    assert j.keys() == t.keys()
    assert {k: v for k, v in j.items() if k != BACKEND_FIELD} == \
        {k: v for k, v in t.items() if k != BACKEND_FIELD}
    assert t[BACKEND_FIELD] == "auto"


@pytest.mark.parametrize("name", CONFIGS)
def test_config_files_parse_to_the_same_values(name):
    path = str(REPO / "configs" / name)
    j = dataclasses.asdict(jcfg.PBAConfig.from_config_file(path))
    t = dataclasses.asdict(tcfg.PBAConfig.from_config_file(path))
    assert j == t
    assert (tcfg.ConfigFile(path).as_dict()
            == jcfg.ConfigFile(path).as_dict())


def test_configfile_parse_mirrors_reference():
    text = ("a = 1 # c\nb = x % d\n// gone = 2\nc=yes\n\nnot a pair\n"
            "d = 0.5")
    j, t = jcfg.ConfigFile(text=text), tcfg.ConfigFile(text=text)
    assert t.as_dict() == j.as_dict()
    for key, default in (("a", 0), ("b", ""), ("c", False), ("d", 1.0),
                         ("missing", 7)):
        assert t.get(key, default) == j.get(key, default)
    with pytest.raises(KeyError):
        t.get("missing")


BAD = [
    dict(descriptor="Nope"), dict(slidingWindowSize=1),
    dict(numFixedPoses=9), dict(gradientMode="bogus"),
    dict(interpolation="bogus"), dict(robustLoss="bogus"),
    dict(patchNormalization="bogus"), dict(patchWarp="bogus"),
    dict(gradientSigma=-1.0), dict(preFilterCap=-1.0),
    dict(dataLoader="bogus"), dict(pyramidLevels=1, refinementLevel=1),
    dict(meshFrames=2, slidingWindowSize=5),
]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: ",".join(kw))
def test_validation_errors_are_mirrored(kw):
    with pytest.raises(ValueError):
        jcfg.PBAConfig(**kw).validate()
    with pytest.raises(ValueError):
        tcfg.PBAConfig(**kw).validate()


def test_backend_names():
    for name in ("auto", "cuda", "torch"):
        tcfg.PBAConfig(solverBackend=name).validate()
    for name in ("pallas", "xla", "triton"):
        with pytest.raises(ValueError, match="solverBackend"):
            tcfg.PBAConfig(solverBackend=name).validate()
    # A kernel path forced on a warp that has none fails at load, as the
    # JAX package's pallas backend does.
    with pytest.raises(ValueError):
        tcfg.PBAConfig(patchWarp="affine", solverBackend="cuda").validate()


KERNEL_CONFIGS = {   # configuration -> backend 'auto' resolves to on a card
    "default (K1)": (dict(), "cuda"),
    "bicubic (K2)": (dict(interpolation="bicubic"), "cuda"),
    "bicubic exact (K2)": (dict(interpolation="bicubic",
                                gradientMode="exact"), "cuda"),
    "exact bilinear": (dict(gradientMode="exact"), "torch"),
    "affine warp": (dict(patchWarp="affine"), "torch"),
    "affine warp, affine": (dict(patchWarp="affine",
                                 patchNormalization="affine"), "torch"),
    "scale warp, bicubic": (dict(patchWarp="scale",
                                 interpolation="bicubic"), "torch"),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CONFIGS))
def test_auto_backend_by_device(case):
    kw, on_card = KERNEL_CONFIGS[case]
    cfg = tcfg.PBAConfig(**kw)
    assert cfg.resolve_backend("cpu") == "torch"
    assert cfg.resolve_backend("cuda") == on_card
    assert cfg.replace(solverBackend="torch").resolve_backend("cuda") == "torch"


UNPORTED = {   # configuration -> the kernel that runs it on a card
    "scale warp": (dict(patchWarp="scale"), "K3"),
    "patchScale alias": (dict(patchScale=True), "K3"),
    "affine normalization": (dict(patchNormalization="affine"), "K4"),
    "bicubic affine": (dict(patchNormalization="affine",
                            interpolation="bicubic"), "K2"),
    "scale warp, affine": (dict(patchWarp="scale",
                                patchNormalization="affine"), "K5"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_unported_kernel_raises_on_a_card(case, backend):
    """The configurations whose kernels K3, K4 and K5 were still to be
    ported resolve to the kernel path on a card now, at every patch radius
    their kernel takes (K4 and bicubic 1..19 and more, the warped grid
    1..9). What still raises there is a radius outside that range: a
    ValueError, never a quiet fall back to the gather path; except that
    'auto' runs a warped grid past R = 9 on the gather path, as the
    reference's 'auto' runs it on XLA."""
    kw, kernel = UNPORTED[case]
    cfg = tcfg.PBAConfig(solverBackend=backend, **kw)
    assert cfg.resolve_backend("cuda") == "cuda", kernel
    assert cfg.replace(patchRadius=5).resolve_backend("cuda") == "cuda"
    too_wide = 62 if kernel == "K2" else 20 if kernel == "K4" else 10
    if backend == "auto" and kernel in ("K3", "K5"):
        assert cfg.replace(patchRadius=too_wide).resolve_backend(
            "cuda") == "torch"
    else:
        with pytest.raises(ValueError, match="patchRadius"):
            cfg.replace(patchRadius=too_wide).resolve_backend("cuda")
    # Off the card, and with solverBackend=torch on it, the plain path runs.
    assert cfg.replace(solverBackend="torch").resolve_backend("cuda") == "torch"
    if backend == "auto":
        assert cfg.resolve_backend("cpu") == "torch"


WIDE_MODES = {   # sampling configuration at patchRadius 5..9: its kernel
    "bilinear mean (K1)": dict(),
    "bilinear off (K1)": dict(patchNormalization="off"),
    "bilinear affine (K4)": dict(patchNormalization="affine"),
    "bicubic (K2)": dict(interpolation="bicubic"),
    "bicubic affine (K2)": dict(interpolation="bicubic",
                                patchNormalization="affine"),
    "scale warp (K3)": dict(patchWarp="scale"),
    "scale warp affine (K5)": dict(patchWarp="scale",
                                   patchNormalization="affine"),
}


@pytest.mark.parametrize("radius", [5, 6, 7, 8, 9, 10, 19, 20])
@pytest.mark.parametrize("mode", sorted(WIDE_MODES))
def test_wide_patch_radius_resolves_by_kernel(mode, radius):
    """Wide patches on a card take the radii of the reference's
    accelerator path: the fixed bilinear grid (K1, K4) 1..19, bicubic (K2)
    1..61, the warped grid (K3, K5) 1..9, under 'auto' and 'cuda'. Past
    its kernel's range a configuration raises, naming the range, and never
    takes the gather path on a card; except a warped grid under 'auto',
    which takes the gather path there, as the reference's 'auto' takes
    XLA (photobundle_tpu/config.py, resolve_backend)."""
    kw = WIDE_MODES[mode]
    auto = tcfg.PBAConfig(patchRadius=radius, **kw)
    assert auto.resolve_backend("cpu") == "torch"
    kernel, radii = auto.kernel_radii()
    want = {"K1": tcfg.FIXED_RADII, "K4": tcfg.FIXED_RADII,
            "K2": tuple(range(1, tcfg.BICUBIC_MAX + 1)),
            "K3": tcfg.WARPED_RADII, "K5": tcfg.WARPED_RADII}[mode[-3:-1]]
    assert radii == want
    if radius in radii:
        assert auto.resolve_backend("cuda") == "cuda"
        assert auto.replace(solverBackend="cuda").resolve_backend(
            "cuda") == "cuda"
        return
    if kw.get("patchWarp") == "scale":
        assert auto.resolve_backend("cuda") == "torch"
    else:
        with pytest.raises(ValueError, match=f"takes patchRadius "
                                             f"1..{radii[-1]}, not {radius}"):
            auto.resolve_backend("cuda")
    # solverBackend=cuda: validate() refuses it already, naming the range.
    with pytest.raises(ValueError, match=f"patchRadius 1..{radii[-1]}"):
        auto.replace(solverBackend="cuda").resolve_backend("cuda")


def test_validate_names_the_warped_grid_radii():
    """validate() accepts solverBackend=cuda with patchWarp='scale' at
    every radius K3 takes and refuses a wider one; every radius the fixed
    grid's K1 takes validates, and bicubic past 19 too; each kernel's
    range is named where a radius is refused."""
    for radius in tcfg.WARPED_RADII:
        tcfg.PBAConfig(patchWarp="scale", solverBackend="cuda",
                       patchRadius=radius).validate()
    for radius in tcfg.FIXED_RADII:
        tcfg.PBAConfig(patchRadius=radius, solverBackend="cuda").validate()
    tcfg.PBAConfig(patchRadius=tcfg.BICUBIC_MAX, interpolation="bicubic",
                   solverBackend="cuda").validate()
    with pytest.raises(ValueError, match="patchRadius 1..9 has a kernel "
                                         "path"):
        tcfg.PBAConfig(patchWarp="scale", solverBackend="cuda",
                       patchRadius=10).validate()
    with pytest.raises(ValueError, match="K1 takes patchRadius 1..19, not "
                                         "20"):
        tcfg.PBAConfig(patchRadius=20, solverBackend="cuda").validate()
    with pytest.raises(ValueError, match="K2 takes patchRadius 1..61, not "
                                         "62"):
        tcfg.PBAConfig(patchRadius=62, interpolation="bicubic",
                       solverBackend="cuda").validate()


def test_cuda_backend_without_a_kernel_path_is_refused():
    cfg = tcfg.PBAConfig(solverBackend="cuda", gradientMode="exact")
    with pytest.raises(ValueError, match="kernel path"):
        cfg.resolve_backend("cuda")


def test_resolvers_mirror_reference():
    for kw in (dict(), dict(interpolation="bicubic"),
               dict(normalizePatches=False, patchNormalization="affine"),
               dict(patchScale=True), dict(patchWarp="affine"),
               dict(gradientMode="exact")):
        j, t = jcfg.PBAConfig(**kw), tcfg.PBAConfig(**kw)
        assert t.resolve_normalization() == j.resolve_normalization()
        assert t.resolve_gradient_mode() == j.resolve_gradient_mode()
        assert t.resolve_patch_warp() == j.resolve_patch_warp()
        assert (t.patch_size, t.num_channels, t.patch_dim) == \
            (j.patch_size, j.num_channels, j.patch_dim)
