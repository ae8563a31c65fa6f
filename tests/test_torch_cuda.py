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
from photobundle_torch.ops import patch_bicubic as pb
from photobundle_torch.ops import patch_warp as pw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def within_f32_tolerance(got, want, scale):
    """|d| <= 1e-4 |plain| + 1e-6 scale: f32 sums of (2R+1)^2 products
    taken in another order, with fused multiply-adds. `scale` is the
    magnitude the rounding is relative to (near-zero sums, such as a
    residual in the frame a descriptor was extracted from, carry the
    rounding noise of their larger terms)."""
    return bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("center", [True, False])
def test_kernel_matches_plain_version(cuda_device, radius, channels, center):
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
    before = pw.patch_stats.launches
    got = pw.patch_stats(planes, uv, valid, patch, radius, center)
    want = pw.patch_stats_reference(planes, uv, valid, patch, radius, center)
    torch.cuda.synchronize()
    assert pw.patch_stats.launches == before + 1
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
    before = pw.patch_stats.launches
    _, _, stats = lm.lm_solve(cam, *args, off, huber_delta=0.05,
                              backend="cuda", max_iterations=4,
                              function_tolerance=0.0,
                              parameter_tolerance=0.0)
    torch.cuda.synchronize()
    assert int(stats.iterations) == 4
    assert pw.patch_stats.launches - before == int(stats.iterations) + 1
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert torch.isfinite(stats.cost_log).all()


# ---------------------------------------------------------------------------
# K2: the Catmull-Rom kernel (csrc/patch_bicubic.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("center", [True, False])
def test_bicubic_kernel_matches_plain_version(cuda_device, radius, channels,
                                             center):
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
    before = pb.bicubic_stats.launches
    got = pb.bicubic_stats(planes, uv, valid, patch, radius, center)
    want = pb.bicubic_stats_reference(planes, uv, valid, patch, radius,
                                      center)
    torch.cuda.synchronize()
    assert pb.bicubic_stats.launches == before + 1
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


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
def test_engine_on_card_runs_through_its_kernel(cuda_device, interpolation):
    """The engine on a card: each window solve launches its configuration's
    kernel once per LM iteration plus once for the initial point, and the
    other kernel never."""
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.engine import PhotometricBundleAdjustment

    cam, images, depths, poses = entry.make_sequence(
        np.random.default_rng(3), n_frames=7, shape=(96, 144))
    cfg = PBAConfig(maxNumPoints=512, maxPointsPerFrame=128,
                    maxIterations=10, minSaliency=0.005, minScore=0.6,
                    maxDepth=30.0, nonMaxSuppRadius=2, maskBlockRadius=2,
                    depthPriorWeight=1.0, interpolation=interpolation)
    pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg,
                                      device=cuda_device)
    assert pba.backend == "cuda"
    mine, other = ((pb.bicubic_stats, pw.patch_stats)
                   if interpolation == "bicubic"
                   else (pw.patch_stats, pb.bicubic_stats))
    before = (mine.launches, other.launches)
    expected = 0
    for img, depth, t in zip(images, depths, poses):
        res = pba.add_frame(img, depth, t)
        if res is not None:
            expected += res.iterations + 1
            assert res.final_cost <= res.initial_cost
            assert np.isfinite(res.poses).all()
    assert expected > 0
    assert (mine.launches - before[0], other.launches - before[1]) == \
        (expected, 0)
