"""Catmull-Rom sampling and kernel K2's module against the JAX package.

- `interp.bicubic_with_grad` against the JAX function (values, analytic
  gradients, validity), and against torch.autograd through its own value
  surface.
- The plain sampler `ops/patch_bicubic.bicubic_patches_reference` against
  `warp_patches_bicubic(interpret=True)`, the Pallas kernel K2 in
  interpret mode: the sampling alone.
- `evaluate_compressed(gradient_mode="bicubic")` on both port backends
  ('torch': the gather path; 'cuda': on the CPU the plain version of the
  fused statistics) against the JAX package's 'xla' and 'pallas'
  (interpret) paths, mirroring tests/test_patch_stats.py's
  test_bicubic_kernel_matches_xla_path and test_kernel_multichannel.

The CUDA kernel itself is held against its plain version on a card by
tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.image import interp as jinterp
from photobundle_tpu.ops import patch_warp as jpw
from photobundle_torch.core import residuals as tres
from photobundle_torch.image import interp as tinterp
from photobundle_torch.image import patches as tpatches
from photobundle_torch.ops import patch_bicubic as pb

from test_residuals import setup_problem
from test_torch_patch_warp import multichannel, variant
from torch_parity import assert_fields_close, port_problem, to_np

HUBER = 0.07


# ---------------------------------------------------------------------------
# bicubic_with_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [None, 3])
def test_bicubic_with_grad_matches_jax(channels):
    rng = np.random.default_rng(0)
    shape = (23, 31) if channels is None else (channels, 23, 31)
    img = rng.random(shape).astype(np.float32)
    # Interior points, points near and past every border, and integer
    # coordinates (phase 0).
    uv = np.concatenate([
        rng.uniform([-2, -2], [33, 25], size=(200, 2)),
        np.array([[1.0, 1.0], [28.0, 20.0], [27.99999, 19.99999],
                  [5.0, 7.0], [0.5, 12.0], [15.0, 20.5]]),
    ]).astype(np.float32)
    tv, tg, tok = tinterp.bicubic_with_grad(torch.as_tensor(img),
                                            torch.as_tensor(uv))
    jv, jg, jok = jinterp.bicubic_with_grad(jnp.asarray(img), jnp.asarray(uv))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # Same weights and tap order; f32 rounding of the sums only.
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)


def test_bicubic_gradient_is_the_surface_derivative():
    """The analytic gradient equals autograd's derivative of the value
    surface (f64, away from integer coordinates where the clamp and the
    floor are not differentiable)."""
    rng = np.random.default_rng(1)
    img = torch.as_tensor(rng.random((2, 20, 26)), dtype=torch.float64)
    uv = torch.as_tensor(rng.uniform(2.1, 16.9, size=(50, 2)),
                         dtype=torch.float64)
    uv = uv + 0.05 * (uv.frac() < 0.05)          # keep off the integers
    uv.requires_grad_(True)
    values, grad, valid = tinterp.bicubic_with_grad(img, uv)
    assert bool(valid.all())
    (auto,) = torch.autograd.grad(values.sum(), uv)
    np.testing.assert_allclose(auto.numpy(), grad.detach().sum(0).numpy(),
                               rtol=1e-10, atol=1e-10)


def test_catmull_rom_weights_partition_unity():
    t = torch.linspace(0.0, 0.999, 37, dtype=torch.float64)
    w = tinterp.catmull_rom_weights(t)
    d = tinterp.catmull_rom_dweights(t)
    np.testing.assert_allclose(sum(w).numpy(), 1.0, atol=1e-12)
    np.testing.assert_allclose(sum(d).numpy(), 0.0, atol=1e-12)


# ---------------------------------------------------------------------------
# The plain sampler against K2 in Pallas interpret mode
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("pr",))
def _pallas_bicubic(channels, uv, valid, pr):
    panels = jpw.build_value_panels(channels, pr)
    return jpw.warp_patches_bicubic(panels, uv, valid, pr, interpret=True)


@pytest.mark.parametrize("pr,channels", [(1, 1), (2, 3), (6, 1), (9, 2)])
def test_sampler_matches_pallas_interpret(pr, channels):
    rng = np.random.default_rng(pr)
    w, h, wi, n = 2, 24, 150, 24      # wider than one 128-lane panel
    img = rng.random((w, channels, h, wi)).astype(np.float32)
    lo, hi = pr + 1, 3 + pr           # the kernel path's margins
    uv = rng.uniform([lo, lo], [wi - hi, h - hi],
                     size=(n, w, 2)).astype(np.float32)
    uv[0, 0] = [lo, lo]                         # both corners of the range
    uv[1, 1] = [wi - hi, h - hi]
    uv[2, 0] = [123.5, 10.25]                   # across a panel seam
    valid = rng.random((n, w)) > 0.2
    valid[3, 1] = False
    uv[3, 1] = np.nan                           # invalid and NaN
    t = pb.bicubic_patches_reference(torch.as_tensor(img),
                                     torch.as_tensor(uv),
                                     torch.as_tensor(valid), pr)
    j = jax.device_get(_pallas_bicubic(jnp.asarray(img), jnp.asarray(uv),
                                       jnp.asarray(valid), pr))
    for name, a, b in zip(("s", "gx", "gy"), t, j):
        assert tuple(a.shape) == b.shape == (n, w, channels, (2 * pr + 1) ** 2)
        assert np.isfinite(a.numpy()).all(), name
        # Same window, weights and tap order: f32 rounding only, including
        # the invalid observations (sampled at the same substitute point).
        np.testing.assert_allclose(a.numpy(), b, atol=2e-6, err_msg=name)


# ---------------------------------------------------------------------------
# evaluate_compressed(gradient_mode="bicubic") against the JAX paths
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("backend",))
def _jax_eval(cam, t_wc, x, patch, ch, g, obs, off, backend):
    kw = dict(interpret=True) if backend == "pallas" else {}
    return jres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, "bicubic", backend=backend, **kw)


def jax_eval(problem, backend):
    return jax.device_get(_jax_eval(*problem, backend))


def port_eval(problem, backend):
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problem)
    return tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, "bicubic", backend=backend)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    return setup_problem(rng, n_pts=16, w=3)


def nm(x):
    """(W, ..., N) point-minor -> (N, W, ...) for mask indexing."""
    return np.moveaxis(to_np(x), -1, 0)


CASES = {"c1": 1, "c3": 3}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_evaluate_bicubic_matches_jax(problem, case, port_backend,
                                      jax_backend):
    """Tolerances of tests/test_patch_stats.py (1e-4 on the statistics,
    1e-5 on the A-chain, 1e-5 relative on the cost): f32 sums in another
    order."""
    prob = variant(problem, CASES[case], masked=(1, 2))
    out, ref = port_eval(prob, port_backend), jax_eval(prob, jax_backend)
    ov, rv = to_np(out.valid), np.asarray(ref.valid)
    both = ov & rv
    assert both.sum() >= 0.8 * rv.sum()
    for name in ("gtg", "gtr"):
        np.testing.assert_allclose(nm(getattr(out, name))[both],
                                   nm(getattr(ref, name))[both],
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(nm(out.a)[both], nm(ref.a)[both],
                               atol=1e-5, rtol=1e-5)
    if np.array_equal(ov, rv):
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-5)


def test_port_backends_agree_on_the_full_problem(problem):
    """The two port backends take the same observations and give the same
    statistics, cost and residual count."""
    prob = variant(multichannel(problem), masked=(2, 1))
    a, b = port_eval(prob, "torch"), port_eval(prob, "cuda")
    assert torch.equal(a.valid, b.valid)
    assert int(a.n_residuals) == int(b.n_residuals)
    assert_fields_close(a, b, ("gtg", "gtr"), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(a.cost), float(b.cost), rtol=1e-5)


def border_problem(pr=2):
    """Points seeded over the whole first image, borders included, so that
    many observations fall near the bicubic margins."""
    rng = np.random.default_rng(5)
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=4, w=3,
                                                         radius=pr)
    tcam, tt, _, _, tch, tg, _, toff = port_problem(
        (cam, t_wc, x, patch, ch, g, obs, off))
    h, wi = tch.shape[-2:]
    n = 400
    uv = torch.as_tensor(rng.uniform([-3, -3], [wi + 3, h + 3], size=(n, 2)),
                         dtype=torch.float32)
    # Depth of the sphere seen from frame 0 is ~4-7 m; a constant is
    # enough to put the points into every frame near the same pixels.
    z = torch.full((n,), 5.0)
    from photobundle_torch.geometry import camera as tcam_mod
    from photobundle_torch.geometry import se3 as tse3
    xw = tse3.transform_points(tt[0], tcam_mod.backproject(tcam, uv, z))
    tpatch = torch.as_tensor(rng.standard_normal((n, 1, (2 * pr + 1) ** 2)),
                             dtype=torch.float32)
    tpatch = tpatch - tpatch.mean(-1, keepdim=True)   # mean-normalized
    tobs = torch.ones((n, 3), dtype=torch.bool)
    return tcam, tt, xw, tpatch, tch, tg, tobs, toff


def test_port_backends_have_equal_valid_masks_at_the_margins():
    """The kernel path's whole-patch margins (pr+1 <= u <= W-3-pr) are the
    gather path's per-sample validity, so both backends accept the same
    observations; only a coordinate within 1e-4 px of a margin may round
    differently when the patch offsets are added."""
    pr = 2
    args = border_problem(pr)
    a = tres.evaluate_compressed(*args, HUBER, "bicubic", backend="torch")
    b = tres.evaluate_compressed(*args, HUBER, "bicubic", backend="cuda")
    _, uv, in_front, _, _ = tres._observation_geometry_pm(args[0], args[1],
                                                          args[2])
    h, wi = args[4].shape[-2:]
    x, y = uv[:, 0], uv[:, 1]
    near = torch.zeros_like(x, dtype=torch.bool)
    for coord, size in ((x, wi), (y, h)):
        for margin in (pr + 1, size - 3 - pr):
            near |= (coord - margin).abs() < 1e-4
    differ = (a.valid ^ b.valid).T
    assert not bool((differ & ~near).any())
    # The test covers both sides of every margin.
    v = b.valid.T
    assert 0.2 < float(v.float().mean()) < 0.95
    both = (a.valid & b.valid).T.float()
    np.testing.assert_allclose((a.gtr * both[:, None]).numpy(),
                               (b.gtr * both[:, None]).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_nan_points_give_exact_zeros(problem):
    """A point with NaN coordinates projects to NaN uv: its observations
    are invalid and their statistics exact zeros on both port backends,
    and the cost is the JAX package's (finite there because XLA selects
    the masked terms away)."""
    prob = variant(problem, nan_point=3)
    ref = jax_eval(prob, "xla")
    for backend in ("torch", "cuda"):
        out = port_eval(prob, backend)
        assert not to_np(out.valid)[3].any()
        for name in ("gtg", "gtr", "jp", "rp"):
            got = to_np(getattr(out, name))
            assert np.isfinite(got).all(), (backend, name)
            assert (got[..., 3] == 0).all(), (backend, name)
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-5)
    # The fused statistics themselves, fed NaN uv on invalid observations.
    planes = pb.build_value_planes(port_problem(prob)[4])
    uv = torch.full((2, 3, 2), float("nan"))
    uv[0, 1] = torch.tensor([20.5, 30.25])
    valid = torch.zeros((2, 3), dtype=torch.bool)
    valid[0, 1] = True
    stats = pb.bicubic_stats(planes, uv, valid, torch.zeros((2, 1, 25)), 2)
    assert torch.isfinite(stats).all()
    assert float(stats[:, 1, 0].abs().sum()) > 0
    stats[:, 1, 0] = 0.0
    assert float(stats.abs().sum()) == 0.0


@pytest.mark.parametrize("center", [True, False])
def test_fused_statistics_match_the_sampler(center):
    """bicubic_stats_reference (the kernel-order f32 sampler + the shared
    epilogue) agrees with statistics built independently: f64
    `bicubic_with_grad` at uv + offsets (every sample of a patch keeps the
    patch's phase, as offsets add exactly in f64) reduced by the
    statistics algebra written out here. The tolerance covers the f32
    sampling."""
    rng = np.random.default_rng(9)
    w, c, h, wi, n, pr = 2, 3, 30, 40, 17, 2
    planes = torch.as_tensor(rng.random((w, c, h, wi)), dtype=torch.float32)
    uv = torch.as_tensor(rng.uniform(pr + 1, [wi - 3 - pr, h - 3 - pr],
                                     size=(n, w, 2)), dtype=torch.float32)
    valid = torch.as_tensor(rng.random((n, w)) > 0.3)
    patch = torch.as_tensor(rng.standard_normal((n, c, 25)),
                            dtype=torch.float32)
    stats = pb.bicubic_stats(planes, uv, valid, patch, pr,
                             norm="mean" if center else "off")
    f64 = torch.float64
    pts = uv.to(f64)[:, :, None, :] + tpatches.patch_offsets(pr, dtype=f64)
    rows = []
    for f in range(w):
        s, g, _ = tinterp.bicubic_with_grad(planes[f].to(f64), pts[:, f])
        r = torch.movedim(s, 0, 1) - patch.to(f64)             # (N, C, P)
        gx = torch.movedim(g[..., 0], 0, 1)
        gy = torch.movedim(g[..., 1], 0, 1)
        if center:
            r, gx, gy = (a - a.mean(-1, keepdim=True) for a in (r, gx, gy))
        rows.append(torch.stack([gx * gx, gx * gy, gy * gy, gx * r, gy * r,
                                 r * r]).sum((-1, -2)))           # (6, N)
    want = torch.stack(rows, dim=1)                               # (6,W,N)
    want = torch.where(valid.T[None], want, 0.0).to(torch.float32)
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((stats - want).abs() <= 1e-5 * want.abs()
                 + 1e-6 * scale).all())


def test_cpu_tensors_run_the_plain_version():
    rng = np.random.default_rng(3)
    planes = torch.as_tensor(rng.random((2, 1, 20, 30)), dtype=torch.float32)
    uv = torch.as_tensor(rng.uniform(4.0, 15.0, size=(6, 2, 2)),
                         dtype=torch.float32)
    valid = torch.ones((6, 2), dtype=torch.bool)
    patch = torch.zeros((6, 1, 25))
    before = dict(pb.bicubic_stats.launches)
    out = pb.bicubic_stats(planes, uv, valid, patch, 2)
    assert torch.equal(out, pb.bicubic_stats_reference(planes, uv, valid,
                                                       patch, 2))
    assert out.shape == (6, 2, 6)
    assert pb.bicubic_stats.launches == before


def test_cuda_ctx_by_mode():
    ch = torch.zeros((2, 1, 12, 14))
    g = torch.zeros((2, 1, 12, 14, 2))
    mode, planes = tres.make_cuda_ctx(ch, g, "bicubic")
    assert mode == "bicubic" and planes.shape == (2, 1, 12, 14)
    mode, planes = tres.make_cuda_ctx(ch, g, "sampled")
    assert mode == "sampled" and planes.shape == (2, 1, 12, 14, 4)
    with pytest.raises(ValueError, match="gradient_mode"):
        tres.make_cuda_ctx(ch, g, "exact")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    planes = torch.zeros((2, 1, 16, 16))
    uv = torch.zeros((3, 2, 2))
    valid = torch.ones((3, 2), dtype=torch.bool)
    patch = torch.zeros((3, 1, 25))
    pb._check(planes, uv, valid, patch, 2)          # accepted as given
    pb._check(planes, uv, valid, torch.zeros((3, 1, 121)), 5)   # R 1..61
    pb._check(torch.zeros((2, 1, 24, 24)), uv, valid,
              torch.zeros((3, 1, 441)), 10)
    pb._check(torch.zeros((2, 1, 126, 126)), uv, valid,
              torch.zeros((3, 1, 123 * 123)), 61)
    with pytest.raises(ValueError, match="radius 1..61, not 62"):
        pb._check(torch.zeros((2, 1, 128, 128)), uv, valid,
                  torch.zeros((3, 1, 125 * 125)), 62)
    with pytest.raises(ValueError, match="uv"):
        pb._check(planes, uv.double(), valid, patch, 2)
    with pytest.raises(ValueError, match="patch"):
        pb._check(planes, uv, valid, torch.zeros((3, 2, 25)), 2)
    with pytest.raises(ValueError, match="smaller"):
        pb._check(torch.zeros((2, 1, 6, 16)), uv, valid, patch, 2)
    with pytest.raises(ValueError, match="meta"):
        pb.bicubic_stats(planes.to("meta"), uv, valid, patch, 2)


def test_loaded_library_is_not_hashed_again(monkeypatch):
    """A wrapper asks for its library at every launch: once loaded, that
    is a lookup, with no read and hash of the source (which cost ~0.25 ms
    per launch on the card's host)."""
    from photobundle_torch.ops import _build

    fake = _build.Built(lib=None, path=None, log="", seconds=0.0)
    monkeypatch.setitem(_build._LOADED, "patch_bicubic", fake)

    def no_hashing(name):
        raise AssertionError(f"{name} hashed again")

    monkeypatch.setattr(_build, "_library_path", no_hashing)
    assert _build.library("patch_bicubic") is fake
    assert _build.build_all(["patch_bicubic"]) == {"patch_bicubic": fake}


def test_failed_build_waits_for_every_compiler(monkeypatch, tmp_path):
    """When one of the parallel builds fails, the error is raised only
    after every other compiler process has exited."""
    import sys

    from photobundle_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "bad.cu").write_text("bad\n")
    (csrc / "slow.cu").write_text("slow\n")
    fake = tmp_path / "nvcc.py"
    fake.write_text(
        "import sys, time\n"
        "src, out = sys.argv[-1], sys.argv[sys.argv.index('-o') + 1]\n"
        "if src.endswith('bad.cu'):\n"
        "    print('error: bad'); sys.exit(1)\n"
        "time.sleep(0.5)\n"
        "open(out, 'w').close()\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (str(fake),))
    monkeypatch.setattr(_build, "nvcc", lambda: sys.executable)
    with pytest.raises(RuntimeError, match="error: bad"):
        _build.build_all(["bad", "slow"])
    # The slow build wrote its output before the error was raised.
    assert list((tmp_path / "build").glob("slow_*.tmp"))
    assert "bad" not in _build._LOADED and "slow" not in _build._LOADED
