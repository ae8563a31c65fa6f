"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and `nvcc` (the kernel has no CPU
mode): they carry the `gpu` marker and skip elsewhere. This file imports
neither jax nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from photobundle_torch import entry
from photobundle_torch.core import lm
from photobundle_torch.core import residuals as res_mod
from photobundle_torch.ops import _common
from photobundle_torch.ops import patch_bicubic as pb
from photobundle_torch.ops import patch_scaled as ps
from photobundle_torch.ops import patch_warp as pw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def within_f32_tolerance(got, want, scale):
    """|d| <= 1e-4 |plain| + 1e-6 scale: f32 sums of (2R+1)^2 products
    taken in another order (the samples themselves round alike: the
    kernels are built without multiply-add contraction). `scale` is the
    magnitude the rounding is relative to (near-zero sums, such as a
    residual in the frame a descriptor was extracted from, carry the
    rounding noise of their larger terms)."""
    return bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("norm", _common.NORMS)
def test_kernel_matches_plain_version(cuda_device, radius, channels, norm):
    rng = np.random.default_rng(radius * 10 + channels)
    w, h, wi, n = 3, 40, 70, 257
    planes = torch.as_tensor(rng.standard_normal((w, channels, h, wi, 4)),
                             dtype=torch.float32, device=cuda_device)
    uv = torch.as_tensor(rng.uniform(-3.0, 72.0, size=(n, w, 2)),
                         dtype=torch.float32, device=cuda_device)
    uv[5, 1] = float("nan")
    valid = torch.as_tensor(rng.uniform(size=(n, w)) > 0.2,
                            device=cuda_device)
    valid[5, 1] = False
    patch = torch.as_tensor(
        rng.standard_normal((n, channels, (2 * radius + 1) ** 2)),
        dtype=torch.float32, device=cuda_device)
    before = pw.patch_stats.launches[norm]
    got = pw.patch_stats(planes, uv, valid, patch, radius, norm)
    want = pw.patch_stats_reference(planes, uv, valid, patch, radius, norm)
    torch.cuda.synchronize()
    assert pw.patch_stats.launches[norm] == before + 1
    assert torch.isfinite(got).all()
    assert float(got[:, ~valid.T].abs().sum()) == 0.0
    row_max = want.abs().amax(dim=(1, 2), keepdim=True)   # per statistic
    assert within_f32_tolerance(got, want, row_max)


def test_kernel_rejects_unsupported_input(cuda_device):
    planes = torch.zeros((1, 1, 32, 32, 4), device=cuda_device)
    uv = torch.zeros((2, 1, 2), device=cuda_device)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="radius"):
        pw.patch_stats(planes, uv, valid,
                       torch.zeros((2, 1, 121), device=cuda_device), 5)
    with pytest.raises(ValueError, match="planes on"):
        pw.patch_stats(planes, uv.cpu(), valid,
                       torch.zeros((2, 1, 25), device=cuda_device), 2)


def test_evaluation_on_card_matches_cpu_and_gather_path(cuda_device):
    """One evaluation of the same problem: kernel on the card, its plain
    version on the CPU, and the gather path on the card."""
    cam, off, args = entry.make_problem(96, 3, 48, 80, 2, seed=2)
    t_wc, x, patch, ch, g, obs = args[:6]
    cpu = res_mod.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                      0.05, backend="cuda")
    dev_args = [a.to(cuda_device) for a in (t_wc, x, patch, ch, g, obs)]
    card = res_mod.evaluate_compressed(cam.to(cuda_device), *dev_args,
                                       off.to(cuda_device), 0.05,
                                       backend="cuda")
    gather = res_mod.evaluate_compressed(cam.to(cuda_device), *dev_args,
                                         off.to(cuda_device), 0.05,
                                         backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(card.valid.cpu(), cpu.valid)
    for name in ("gtg", "gtr"):
        want = getattr(cpu, name)
        assert within_f32_tolerance(getattr(card, name).cpu(), want,
                                    want.abs().max()), name
    np.testing.assert_allclose(float(card.cost), float(cpu.cost), rtol=1e-5)
    # The gather path accepts one more pixel at the far borders.
    both = (card.valid & gather.valid).T.float()
    np.testing.assert_allclose((card.gtr * both[:, None]).cpu().numpy(),
                               (gather.gtr * both[:, None]).cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


def test_solve_on_card_runs_through_the_kernel(cuda_device):
    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=2,
                                        device=cuda_device)
    before = pw.patch_stats.launches["mean"]
    _, _, stats = lm.lm_solve(cam, *args, off, huber_delta=0.05,
                              backend="cuda", max_iterations=4,
                              function_tolerance=0.0,
                              parameter_tolerance=0.0)
    torch.cuda.synchronize()
    assert int(stats.iterations) == 4
    launches = pw.patch_stats.launches["mean"] - before
    assert launches == int(stats.iterations) + 1
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert torch.isfinite(stats.cost_log).all()


# ---------------------------------------------------------------------------
# K2: the Catmull-Rom kernel (csrc/patch_bicubic.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("norm", _common.NORMS)
def test_bicubic_kernel_matches_plain_version(cuda_device, radius, channels,
                                             norm):
    rng = np.random.default_rng(100 + radius * 10 + channels)
    w, h, wi, n = 3, 40, 70, 257
    planes = torch.as_tensor(rng.standard_normal((w, channels, h, wi)),
                             dtype=torch.float32, device=cuda_device)
    # Valid observations inside the bicubic margins (the solve's own
    # validity); invalid ones anywhere, NaN included.
    lo, hi = radius + 1, 3 + radius
    uv = rng.uniform([lo, lo], [wi - hi, h - hi], size=(n, w, 2))
    valid = rng.uniform(size=(n, w)) > 0.2
    uv[~valid] = rng.uniform(-5.0, 75.0, size=(int((~valid).sum()), 2))
    valid[5, 1] = False
    uv[5, 1] = np.nan
    uv = torch.as_tensor(uv, dtype=torch.float32, device=cuda_device)
    valid = torch.as_tensor(valid, device=cuda_device)
    patch = torch.as_tensor(
        rng.standard_normal((n, channels, (2 * radius + 1) ** 2)),
        dtype=torch.float32, device=cuda_device)
    before = pb.bicubic_stats.launches[norm]
    got = pb.bicubic_stats(planes, uv, valid, patch, radius, norm)
    want = pb.bicubic_stats_reference(planes, uv, valid, patch, radius, norm)
    torch.cuda.synchronize()
    assert pb.bicubic_stats.launches[norm] == before + 1
    assert torch.isfinite(got).all()
    assert float(got[:, ~valid.T].abs().sum()) == 0.0
    row_max = want.abs().amax(dim=(1, 2), keepdim=True)   # per statistic
    assert within_f32_tolerance(got, want, row_max)


def test_bicubic_kernel_rejects_unsupported_input(cuda_device):
    planes = torch.zeros((1, 1, 32, 32), device=cuda_device)
    uv = torch.zeros((2, 1, 2), device=cuda_device)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="radius"):
        pb.bicubic_stats(planes, uv, valid,
                         torch.zeros((2, 1, 121), device=cuda_device), 5)
    with pytest.raises(ValueError, match="planes on"):
        pb.bicubic_stats(planes, uv.cpu(), valid,
                         torch.zeros((2, 1, 25), device=cuda_device), 2)


def test_bicubic_evaluation_on_card_matches_cpu_and_gather_path(cuda_device):
    """One bicubic evaluation of the same problem: K2 on the card, its
    plain version on the CPU, and the gather path on the card; the two
    backends take the same observations."""
    cam, off, args = entry.make_problem(96, 3, 48, 80, 2, seed=3)
    t_wc, x, patch, ch, g, obs = args[:6]
    kw = dict(huber_delta=0.05, gradient_mode="bicubic")
    cpu = res_mod.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                      backend="cuda", **kw)
    dev_args = [a.to(cuda_device) for a in (t_wc, x, patch, ch, g, obs)]
    card = res_mod.evaluate_compressed(cam.to(cuda_device), *dev_args,
                                       off.to(cuda_device), backend="cuda",
                                       **kw)
    gather = res_mod.evaluate_compressed(cam.to(cuda_device), *dev_args,
                                         off.to(cuda_device),
                                         backend="torch", **kw)
    torch.cuda.synchronize()
    assert torch.equal(card.valid.cpu(), cpu.valid)
    assert torch.equal(card.valid, gather.valid)
    # The plain version computes in f64 and the gather path takes each
    # sample's phase from its f32 coordinate uv + offset; the kernel's f32
    # residuals r = s - d cancel two values of order 1, so a sum over the
    # patch carries an absolute error of order 1e-5 of the statistic's
    # largest value (the residuals in a point's own reference frame are
    # that rounding noise).
    for name in ("gtg", "gtr"):
        got = getattr(card, name).cpu().numpy()
        for other in (cpu, gather):
            ref = getattr(other, name).cpu().numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=name)
    np.testing.assert_allclose(float(card.cost), float(cpu.cost), rtol=1e-5)
    np.testing.assert_allclose(float(card.cost), float(gather.cost),
                               rtol=1e-4)


ENGINE_CONFIGS = {   # configuration -> (the kernel its solves launch, mode)
    "bilinear": (dict(), pw.patch_stats, "mean"),
    "bicubic": (dict(interpolation="bicubic"), pb.bicubic_stats, "mean"),
    "affine": (dict(patchNormalization="affine"), pw.patch_stats, "affine"),
    "bicubic-affine": (dict(interpolation="bicubic",
                            patchNormalization="affine"), pb.bicubic_stats,
                       "affine"),
    "scale": (dict(patchWarp="scale"), ps.scaled_stats, "mean"),
    "scale-affine": (dict(patchWarp="scale", patchNormalization="affine"),
                     ps.scaled_stats, "affine"),
}
KERNELS = (pw.patch_stats, pb.bicubic_stats, ps.scaled_stats)


@pytest.mark.parametrize("config", sorted(ENGINE_CONFIGS))
def test_engine_on_card_runs_through_its_kernel(cuda_device, config):
    """The engine on a card: each window solve launches its configuration's
    kernel, in its normalization mode, once per LM iteration plus once for
    the initial point, and no other kernel or mode ever."""
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.engine import PhotometricBundleAdjustment

    kw, mine, norm = ENGINE_CONFIGS[config]
    cam, images, depths, poses = entry.make_sequence(
        np.random.default_rng(3), n_frames=7, shape=(96, 144))
    cfg = PBAConfig(maxNumPoints=512, maxPointsPerFrame=128,
                    maxIterations=10, minSaliency=0.005, minScore=0.6,
                    maxDepth=30.0, nonMaxSuppRadius=2, maskBlockRadius=2,
                    depthPriorWeight=1.0, **kw)
    pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
    assert pba.backend == "cuda" and pba.device.type == "cuda"
    for k in KERNELS:
        _common.reset_launches(k)
    expected = 0
    for img, depth, t in zip(images, depths, poses):
        res = pba.add_frame(img, depth, t)
        if res is not None:
            expected += res.iterations + 1
            assert res.final_cost <= res.initial_cost
            assert np.isfinite(res.poses).all()
    assert expected > 0
    for k in KERNELS:
        want = {m: (expected if (k is mine and m == norm) else 0)
                for m in _common.NORMS}
        assert k.launches == want, k.__name__


def test_entry_points_default_to_the_card(cuda_device):
    """Without a device argument the engine and entry() run on the card."""
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.engine import PhotometricBundleAdjustment

    cam, images, _, _ = entry.make_sequence(np.random.default_rng(3),
                                            n_frames=1, shape=(96, 144))
    pba = PhotometricBundleAdjustment(cam, images[0].shape, PBAConfig())
    assert pba.device.type == "cuda" and pba.points.x_world.is_cuda
    _, args = entry.entry()
    assert all(a.is_cuda for a in args)


# ---------------------------------------------------------------------------
# K3 / K5: the warped-grid kernel (csrc/patch_scaled.cu)
# ---------------------------------------------------------------------------

def scaled_inputs(rng, device, radius, channels, w=3, h=40, wi=70, n=257):
    """Random planes; rho over the clamp range and beyond; valid
    observations inside the kernel's margins (1 + rho R <= u <= Wi-2-rho R),
    invalid ones anywhere, NaN included."""
    planes = torch.as_tensor(rng.standard_normal((w, channels, h, wi, 4)),
                             dtype=torch.float32, device=device)
    rho = rng.uniform(0.45, 2.3, size=(n, w)).astype(np.float32)
    ext = np.clip(rho, 0.5, 2.0) * radius
    uv = np.stack([rng.uniform(1 + ext, wi - 2 - ext),
                   rng.uniform(1 + ext, h - 2 - ext)], axis=-1)
    valid = rng.uniform(size=(n, w)) > 0.2
    uv[~valid] = rng.uniform(-5.0, 75.0, size=(int((~valid).sum()), 2))
    valid[5, 1] = False
    uv[5, 1] = np.nan
    rho[5, 1] = np.nan
    patch = torch.as_tensor(
        rng.standard_normal((n, channels, (2 * radius + 1) ** 2)),
        dtype=torch.float32, device=device)
    return (planes, torch.as_tensor(uv, dtype=torch.float32, device=device),
            torch.as_tensor(rho, device=device),
            torch.as_tensor(valid, device=device), patch)


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("norm", _common.NORMS)
def test_scaled_kernel_matches_plain_version(cuda_device, radius, channels,
                                            norm):
    rng = np.random.default_rng(200 + radius * 10 + channels)
    planes, uv, rho, valid, patch = scaled_inputs(rng, cuda_device, radius,
                                                  channels)
    before = ps.scaled_stats.launches[norm]
    got = ps.scaled_stats(planes, uv, rho, valid, patch, radius, norm)
    want = ps.scaled_stats_reference(planes, uv, rho, valid, patch, radius,
                                     norm)
    torch.cuda.synchronize()
    assert ps.scaled_stats.launches[norm] == before + 1
    assert torch.isfinite(got).all()
    assert float(got[:, ~valid.T].abs().sum()) == 0.0
    row_max = want.abs().amax(dim=(1, 2), keepdim=True)
    assert within_f32_tolerance(got, want, row_max)


def test_scaled_kernel_at_the_image_edges(cuda_device):
    """Observations hugging every border of a KITTI-wide image (the right
    edge of tests/test_patch_stats.py's regression): the kernel's taps are
    the plain version's."""
    rng = np.random.default_rng(7)
    h, wi, n, pr = 48, 1226, 64, 2
    planes = torch.as_tensor(rng.standard_normal((1, 1, h, wi, 4)),
                             dtype=torch.float32, device=cuda_device)
    rho = np.linspace(0.5, 2.0, n).astype(np.float32)
    ext = rho * pr
    u = np.where(np.arange(n) % 2 == 0, wi - 2.0 - ext - 0.3, 1.0 + ext + 0.3)
    v = np.where(np.arange(n) % 4 < 2, h - 2.0 - ext - 0.2, 1.0 + ext + 0.2)
    uv = torch.as_tensor(np.stack([u, v], -1)[:, None], dtype=torch.float32,
                         device=cuda_device)
    rho_t = torch.as_tensor(rho[:, None], device=cuda_device)
    valid = torch.ones((n, 1), dtype=torch.bool, device=cuda_device)
    patch = torch.as_tensor(rng.standard_normal((n, 1, 25)),
                            dtype=torch.float32, device=cuda_device)
    for norm in _common.NORMS:
        got = ps.scaled_stats(planes, uv, rho_t, valid, patch, pr, norm)
        want = ps.scaled_stats_reference(planes, uv, rho_t, valid, patch, pr,
                                         norm)
        torch.cuda.synchronize()
        row_max = want.abs().amax(dim=(1, 2), keepdim=True)
        assert within_f32_tolerance(got, want, row_max), norm


def test_scaled_kernel_rejects_unsupported_input(cuda_device):
    planes = torch.zeros((1, 1, 32, 32, 4), device=cuda_device)
    uv = torch.zeros((2, 1, 2), device=cuda_device)
    rho = torch.ones((2, 1), device=cuda_device)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="radius"):
        ps.scaled_stats(planes, uv, rho, valid,
                        torch.zeros((2, 1, 121), device=cuda_device), 5)
    with pytest.raises(ValueError, match="rho"):
        ps.scaled_stats(planes, uv, rho.double(), valid,
                        torch.zeros((2, 1, 25), device=cuda_device), 2)
    with pytest.raises(ValueError, match="normalization"):
        ps.scaled_stats(planes, uv, rho, valid,
                        torch.zeros((2, 1, 25), device=cuda_device), 2,
                        "bogus")


@pytest.mark.parametrize("warp,normalize", [("scale", "mean"),
                                            ("scale", "affine"),
                                            (None, "affine")])
def test_warped_evaluation_on_card_matches_cpu(cuda_device, warp, normalize):
    """One warped or affine evaluation of the same problem: the kernel on
    the card and its plain version on the CPU take the same observations
    and give the same statistics and cost."""
    cam, off, args = entry.make_problem(96, 3, 48, 80, 2, seed=4)
    t_wc, x, patch, ch, g, obs = args[:6]
    from photobundle_torch.image import patches as patches_mod
    patch = patches_mod.normalize_patches(patch, normalize)
    slot = torch.zeros(96, dtype=torch.int32)

    def run(dev):
        a = [v.to(dev) for v in (t_wc, x, patch, ch, g, obs)]
        pwarp = None
        if warp is not None:
            z_ref, r_wc = res_mod.patch_warp_ref_geometry(a[0], a[1] * 1.02,
                                                          slot.to(dev))
            pwarp = (warp, z_ref, r_wc)
        return res_mod.evaluate_compressed(
            cam.to(dev), *a, off.to(dev), 0.05, backend="cuda",
            normalize=normalize, patch_warp=pwarp)

    cpu, card = run("cpu"), run(cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(card.valid.cpu(), cpu.valid)
    # In each point's reference frame r = s - d cancels two values of
    # order 1 (unit-norm ones under affine normalization), so those sums
    # are rounding noise of order 1e-6 of the statistic's largest value
    # (as in the bicubic evaluation test above).
    for name in ("gtg", "gtr"):
        got = getattr(card, name).cpu().numpy()
        want = getattr(cpu, name).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(float(card.cost), float(cpu.cost), rtol=1e-5)


# ---------------------------------------------------------------------------
# K1's sort-reuse variant (csrc/patch_warp.cu, pb_patch_stats_sorted)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("norm", _common.NORMS)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_sorted_kernel_is_bitwise_k1(cuda_device, radius, channels, norm,
                                     layout):
    """The sorted kernel's sums equal K1's bitwise, whether a block stages
    its windows in shared memory (points packed into a corner of the
    image: every block with a valid observation stages) or samples from
    global memory (points over the whole image: no block's box fits)."""
    rng = np.random.default_rng(300 + radius * 10 + channels)
    w, h, wi, n = 3, 40, 70, 257
    planes = torch.as_tensor(rng.standard_normal((w, channels, h, wi, 4)),
                             dtype=torch.float32, device=cuda_device)
    hi = (12.0, 14.0) if layout == "dense" else (wi + 3.0, h + 3.0)
    uv = torch.as_tensor(rng.uniform((-3.0, -3.0), hi, size=(n, w, 2)),
                         dtype=torch.float32, device=cuda_device)
    uv[5, 1] = float("nan")
    valid = torch.as_tensor(rng.uniform(size=(n, w)) > 0.2,
                            device=cuda_device)
    valid[5, 1] = False
    patch = torch.as_tensor(
        rng.standard_normal((n, channels, (2 * radius + 1) ** 2)),
        dtype=torch.float32, device=cuda_device)
    key = torch.as_tensor(rng.integers(0, 40, n), device=cuda_device)
    order = res_mod.sorted_dispatch_order(key)
    staged = torch.full((pw.sorted_blocks(n, w),), 7, dtype=torch.uint8,
                        device=cuda_device)
    before = pw.sorted_patch_stats.launches[norm]
    got = pw.sorted_patch_stats(planes, uv, valid, patch, radius, order,
                                norm, staged=staged)
    want = pw.patch_stats(planes, uv, valid, patch, radius, norm)
    torch.cuda.synchronize()
    assert pw.sorted_patch_stats.launches[norm] == before + 1
    assert torch.equal(got, want)
    assert set(staged.unique().tolist()) <= {0, 1}
    # Blocks (64 consecutive sorted ranks of one frame) with a valid
    # observation: all of them stage in the dense layout; in the sparse
    # one no full block does (the last block of each frame holds one
    # observation, whose own window fits).
    runs = -(-n // pw.SORTED_RUN)
    has = torch.zeros((w, runs * pw.SORTED_RUN), dtype=torch.bool,
                      device=cuda_device)
    has[:, :n] = valid[order[0]].T
    has = has.view(w, runs, pw.SORTED_RUN).any(dim=-1).flatten()
    if layout == "dense":
        assert torch.equal(staged.bool(), has)
    else:
        assert not staged.view(w, runs)[:, :-1].any()
    plain = pw.sorted_patch_stats_reference(planes, uv, valid, patch, radius,
                                            order, norm)
    row_max = plain.abs().amax(dim=(1, 2), keepdim=True)
    assert within_f32_tolerance(got, plain, row_max)


def test_sorted_kernel_rejects_unsupported_input(cuda_device):
    planes = torch.zeros((1, 1, 32, 32, 4), device=cuda_device)
    uv = torch.zeros((2, 1, 2), device=cuda_device)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    patch = torch.zeros((2, 1, 25), device=cuda_device)
    order = res_mod.sorted_dispatch_order(torch.zeros(2, dtype=torch.long,
                                                      device=cuda_device))
    with pytest.raises(ValueError, match="feed"):
        pw.sorted_patch_stats(planes, uv, valid, patch, 2,
                              (order[0].int(), order[1]))
    with pytest.raises(ValueError, match="staged"):
        pw.sorted_patch_stats(planes, uv, valid, patch, 2, order,
                              staged=torch.zeros(2, dtype=torch.uint8,
                                                 device=cuda_device))


def test_sorted_solve_on_card_is_bitwise_the_unsorted_one(cuda_device,
                                                          monkeypatch):
    """lm_solve with PB_SORTED_DISPATCH=1 launches the sorted kernel once
    per evaluation and returns the unsorted solve's result, bitwise."""
    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=2,
                                        device=cuda_device)
    kw = dict(huber_delta=0.05, backend="cuda", max_iterations=4,
              function_tolerance=0.0, parameter_tolerance=0.0)
    t_u, x_u, st_u = lm.lm_solve(cam, *args, off, **kw)
    monkeypatch.setenv("PB_SORTED_DISPATCH", "1")
    before = (pw.sorted_patch_stats.launches["mean"],
              pw.patch_stats.launches["mean"])
    t_s, x_s, st_s = lm.lm_solve(cam, *args, off, **kw)
    torch.cuda.synchronize()
    assert (pw.sorted_patch_stats.launches["mean"] - before[0],
            pw.patch_stats.launches["mean"] - before[1]) == (5, 0)
    assert torch.equal(t_s, t_u) and torch.equal(x_s, x_u)
    assert float(st_s.final_cost) == float(st_u.final_cost)


# ---------------------------------------------------------------------------
# Stereo on the card (image/stereo.py)
# ---------------------------------------------------------------------------

def test_argmin_takes_the_first_minimum_on_card(cuda_device):
    """jnp.argmin's tie rule, which the winner-take-all relies on, on the
    card as on the CPU (tests/test_torch_stereo.py)."""
    cost = torch.tensor([[3.0, 1.0], [1.0, 1.0], [1.0, 2.0]],
                        device=cuda_device)
    assert torch.argmin(cost, dim=0).tolist() == [1, 0]
    vol = torch.zeros((128, 64, 96), device=cuda_device)
    vol[7:] = -1.0                      # ties from plane 7 on
    assert bool((torch.argmin(vol, dim=0) == 7).all())
    inf = torch.full((4, 2), torch.inf, device=cuda_device)
    assert torch.argmin(inf, dim=0).tolist() == [0, 0]


@pytest.mark.parametrize("matcher", ["block_match", "semi_global_match"])
def test_stereo_on_card_matches_cpu(cuda_device, matcher):
    """The same pair matched on the card and on the CPU: the cumulative
    sums round in another order, so validity may differ on at most 0.5 %
    of the pixels and disparities by 5e-3 px where both accept (the
    tolerance tests/test_torch_stereo.py holds the port to the JAX
    package with)."""
    from photobundle_torch.image import stereo

    rng = np.random.default_rng(7)
    h, w, d = 64, 96, 7
    base = rng.uniform(0, 1, size=(h, w + 2 * d + 4)).astype(np.float32)
    for _ in range(2):                  # smooth it: a 3-tap box, twice
        base = (base[:, :-2] + base[:, 1:-1] + base[:, 2:]) / 3.0
    left = np.ascontiguousarray(base[:, d:d + w])        # left[x] = right[x - d]
    right = np.ascontiguousarray(base[:, 2 * d:2 * d + w])
    kw = dict(num_disparities=24, min_disparity=1,
              sad_radius=4 if matcher == "block_match" else 2)
    fn = getattr(stereo, matcher)
    d_cpu, v_cpu = fn(torch.as_tensor(left), torch.as_tensor(right), **kw)
    d_gpu, v_gpu = fn(torch.as_tensor(left, device=cuda_device),
                      torch.as_tensor(right, device=cuda_device), **kw)
    d_gpu, v_gpu = d_gpu.cpu(), v_gpu.cpu()
    assert float((v_cpu != v_gpu).float().mean()) <= 0.005
    both = v_cpu & v_gpu
    assert float(both.float().mean()) > 0.25
    assert float((d_cpu[both] - d_gpu[both]).abs().max()) <= 5e-3
