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
from photobundle_torch.ops import patch_ablate as pa
from photobundle_torch.ops import patch_bicubic as pb
from photobundle_torch.ops import patch_samples as smp
from photobundle_torch.ops import patch_scaled as ps
from photobundle_torch.ops import patch_stats as k7
from photobundle_torch.ops import patch_warp as pw

pytestmark = pytest.mark.gpu

# The radii each solve kernel is held at: its compile-time instances
# (1..9) and, for K1 and K2, the runtime-radius instance above them (K1 to
# the fixed-grid limit 19, K2 past it).
K1_RADII = (*_common.WARPED_RADII, 10, _common.FIXED_RADII[-1])
K2_RADII = (*K1_RADII, 25)


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


@pytest.mark.parametrize("radius", K1_RADII)
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
    with pytest.raises(ValueError, match="radius 1..19, not 20"):
        pw.patch_stats(torch.zeros((1, 1, 42, 42, 4), device=cuda_device),
                       uv, valid,
                       torch.zeros((2, 1, 41 * 41), device=cuda_device), 20)
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


def warm_up_evaluations() -> int:
    """Kernel launches of the warm-ups lm_solve ran since lm.reset_runs():
    a cold graph key runs one start evaluation and one body before its
    capture (core/lm.py)."""
    return 2 * lm.runs["warm_ups"]


def evaluations(iterations) -> int:
    """Evaluations lm_solve ran since lm.reset_runs() over solves that ran
    `iterations` (a list): a start per solve and per warm-up, and a body
    per iteration, per warm-up, and per no-op body run past an early end
    before the next read of the termination code."""
    runs = lm.runs
    assert runs["starts"] == len(iterations) + runs["warm_ups"]
    assert runs["bodies"] >= sum(iterations) + runs["warm_ups"]
    return runs["starts"] + runs["bodies"]


def test_solve_on_card_runs_through_the_kernel(cuda_device):
    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=2,
                                        device=cuda_device)
    before = pw.patch_stats.launches["mean"]
    lm.reset_runs()
    _, _, stats = lm.lm_solve(cam, *args, off, huber_delta=0.05,
                              backend="cuda", max_iterations=4,
                              function_tolerance=0.0,
                              parameter_tolerance=0.0)
    torch.cuda.synchronize()
    assert int(stats.iterations) == 4
    launches = pw.patch_stats.launches["mean"] - before
    assert launches == int(stats.iterations) + 1 + warm_up_evaluations()
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert torch.isfinite(stats.cost_log).all()


# ---------------------------------------------------------------------------
# K2: the Catmull-Rom kernel (csrc/patch_bicubic.cu)
# ---------------------------------------------------------------------------

def bicubic_inputs(rng, device, radius, channels):
    """K2's test inputs: 3 frames of 257 points on a 40x70 image (larger
    where the (2R+4)-px window needs it), valid observations inside the
    bicubic margins (the solve's own validity), invalid ones anywhere, NaN
    included."""
    w, n = 3, 257
    h, wi = max(40, 2 * radius + 10), max(70, 2 * radius + 10)
    planes = torch.as_tensor(rng.standard_normal((w, channels, h, wi)),
                             dtype=torch.float32, device=device)
    lo, hi = radius + 1, 3 + radius
    uv = rng.uniform([lo, lo], [wi - hi, h - hi], size=(n, w, 2))
    valid = rng.uniform(size=(n, w)) > 0.2
    uv[~valid] = rng.uniform(-5.0, wi + 5.0, size=(int((~valid).sum()), 2))
    valid[5, 1] = False
    uv[5, 1] = np.nan
    patch = torch.as_tensor(
        rng.standard_normal((n, channels, (2 * radius + 1) ** 2)),
        dtype=torch.float32, device=device)
    return (planes, torch.as_tensor(uv, dtype=torch.float32, device=device),
            torch.as_tensor(valid, device=device), patch)


@pytest.mark.parametrize("radius", K2_RADII)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("norm", _common.NORMS)
def test_bicubic_kernel_matches_plain_version(cuda_device, radius, channels,
                                             norm):
    rng = np.random.default_rng(100 + radius * 10 + channels)
    planes, uv, valid, patch = bicubic_inputs(rng, cuda_device, radius,
                                              channels)
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
    with pytest.raises(ValueError, match="radius 1..61, not 62"):
        pb.bicubic_stats(torch.zeros((1, 1, 128, 128), device=cuda_device),
                         uv, valid,
                         torch.zeros((2, 1, 125 * 125), device=cuda_device),
                         62)
    with pytest.raises(ValueError, match="smaller"):
        pb.bicubic_stats(planes, uv, valid,
                         torch.zeros((2, 1, 31 * 31), device=cuda_device),
                         15)
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
    # A patch radius past 4, where the loops roll their rows.
    "bilinear-r5": (dict(patchRadius=5), pw.patch_stats, "mean"),
    "bicubic-r5": (dict(interpolation="bicubic", patchRadius=5),
                   pb.bicubic_stats, "mean"),
    "scale-r5": (dict(patchWarp="scale", patchRadius=5), ps.scaled_stats,
                 "mean"),
}
KERNELS = (pw.patch_stats, pb.bicubic_stats, ps.scaled_stats)


@pytest.mark.parametrize("config", sorted(ENGINE_CONFIGS))
def test_engine_on_card_runs_through_its_kernel(cuda_device, config):
    """The engine on a card: each window solve launches its configuration's
    kernel, in its normalization mode, once per evaluation (its body
    replays, no-op ones past an early end included, plus its start, and
    two for its graphs' warm-up when its key is cold), and no other
    kernel or mode ever."""
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
    lm.reset_runs()
    iterations = []
    for img, depth, t in zip(images, depths, poses):
        res = pba.add_frame(img, depth, t)
        if res is not None:
            iterations.append(res.iterations)
            assert res.final_cost <= res.initial_cost
            assert np.isfinite(res.poses).all()
    assert iterations
    expected = evaluations(iterations)
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


@pytest.mark.parametrize("radius", _common.WARPED_RADII)
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
                        torch.zeros((2, 1, 441), device=cuda_device), 10)
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

# The sorted kernel's branches, as its `staged` flags give them
# (SortedBranch in csrc/patch_warp.cu), and the radii whose blocks stage
# (pb::kMaxStagedRadius: K1's staged radii).
SORTED_GATHERED, SORTED_UNION_BOX, SORTED_OWN_WINDOWS = 0, 1, 2
SORTED_STAGED_RADIUS = 3


def sorted_branch(radius: int, channels: int, box_texels: int,
                  window_texels: int) -> int:
    """The branch a block of the sorted kernel takes: its union box holds
    `box_texels` texels a channel and its valid observations' windows
    `window_texels` summed (0 without a valid observation). To
    SORTED_STAGED_RADIUS, the box where its C channels fit the block's
    buffer (K1's staged tile of SORTED_RUN windows, two channel buffers at
    C > 1) and it holds no more texels than the windows, else the own
    windows; above, and without a valid observation, gathered."""
    if window_texels == 0 or radius > SORTED_STAGED_RADIUS:
        return SORTED_GATHERED
    stride = (2 * radius + 2) ** 2 | 1
    buffer = pw.SORTED_RUN * stride * (2 if channels > 1 else 1)
    if box_texels * channels <= buffer and box_texels <= window_texels:
        return SORTED_UNION_BOX
    return SORTED_OWN_WINDOWS


@pytest.mark.parametrize("radius", K1_RADII)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("norm", _common.NORMS)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_sorted_kernel_is_bitwise_k1(cuda_device, radius, channels, norm,
                                     layout):
    """The sorted kernel's sums equal K1's bitwise, whichever branch a
    block takes: its union box staged in shared memory (points packed
    into a corner of the image: overlapping windows), its observations'
    own windows staged (points over the whole image: no full block's box
    holds fewer texels than its windows), or, above the staged radii,
    each window gathered from global memory."""
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
    # Each block (64 consecutive sorted ranks of one frame) takes the
    # branch `sorted_branch` gives for its union box and its valid
    # windows: in the dense layout the box in every block with a valid
    # observation to the staged radii; in the sparse one the own windows
    # in every full block to R = 2 (the last block of each frame holds one
    # observation, whose box is its window; at R = 3 the whole 70x40
    # image, 2800 texels, is fewer than ~51 windows of 64); above the
    # staged radii every block gathers.
    win = 2 * radius + 2
    q = torch.where(valid[..., None], uv, 0.0)[order[0]]          # (N, W, 2)
    x0 = torch.clamp(torch.floor(q[..., 0]).long() - radius, 0, wi - win)
    y0 = torch.clamp(torch.floor(q[..., 1]).long() - radius, 0, h - win)
    runs = -(-n // pw.SORTED_RUN)
    expect = []
    for f in range(w):
        for j in range(runs):
            sel = slice(j * pw.SORTED_RUN, (j + 1) * pw.SORTED_RUN)
            ok = valid[order[0]][sel, f]
            bx, by = x0[sel, f][ok], y0[sel, f][ok]
            area = 0
            if bool(ok.any()):
                area = ((int(bx.max() - bx.min()) + win)
                        * (int(by.max() - by.min()) + win))
            expect.append(sorted_branch(radius, channels, area,
                                           int(ok.sum()) * win * win))
    assert staged.tolist() == expect
    full = [expect[f * runs + j] for f in range(w) for j in range(runs - 1)]
    if radius > SORTED_STAGED_RADIUS:
        assert set(expect) == {SORTED_GATHERED}
    elif layout == "dense" and radius <= SORTED_STAGED_RADIUS:
        assert set(full) == {SORTED_UNION_BOX}
    elif layout == "sparse" and radius <= 2:
        assert set(full) == {SORTED_OWN_WINDOWS}
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
    lm.reset_runs()
    t_s, x_s, st_s = lm.lm_solve(cam, *args, off, **kw)
    torch.cuda.synchronize()
    assert (pw.sorted_patch_stats.launches["mean"] - before[0],
            pw.patch_stats.launches["mean"] - before[1]) == (
        5 + warm_up_evaluations(), 0)
    assert torch.equal(t_s, t_u) and torch.equal(x_s, x_u)
    assert float(st_s.final_cost) == float(st_u.final_cost)


def full_size_instance(device, n_pts, radius, channels=1):
    """chip_smoke.py's phase-3 problem (370x1226, 5 frames, seed 1) at
    `n_pts` points: (planes, uv_nm, valid_nm, patch, order), observations
    inside K1's margins; with `channels` > 1, scaled copies of the image
    as bitplane-like channels."""
    h, wi, w = 370, 1226, 5
    cam, _, args = entry.make_problem(n_pts, w, h, wi, radius, seed=1,
                                      device=device)
    t_wc, x_world, patch, ch, g, obs = args[:6]
    if channels > 1:
        gain = torch.linspace(0.5, 1.5, channels, device=device)
        ch = (ch * gain[None, :, None, None]).contiguous()
        g = (g * gain[None, :, None, None, None]).contiguous()
        patch = patch.repeat(1, channels, 1).contiguous()
    _, uv, in_front, _, _ = res_mod._observation_geometry_pm(cam, t_wc,
                                                             x_world)
    inside = ((uv[:, 0] >= radius) & (uv[:, 0] <= wi - 2 - radius)
              & (uv[:, 1] >= radius) & (uv[:, 1] <= h - 2 - radius))
    valid = (obs.T & in_front & inside).T.contiguous()
    order = res_mod.sorted_dispatch_order(res_mod.dispatch_key(
        cam, t_wc, x_world, obs, (h, wi)))
    return (pw.build_planes(ch, g), uv.permute(2, 0, 1).contiguous(), valid,
            patch, order)


@pytest.mark.parametrize("radius", [2, 6, 9, 10, 19])
@pytest.mark.parametrize("n_pts", [4096, 65536])
def test_sorted_kernel_is_bitwise_k1_at_full_size(cuda_device, radius,
                                                  n_pts):
    """At the solver's full size (sparse windows at 4096 points, dense at
    65 536), every normalization: the sorted kernel equals K1 bitwise."""
    planes, uv, valid, patch, order = full_size_instance(cuda_device, n_pts,
                                                         radius)
    for norm in _common.NORMS:
        got = pw.sorted_patch_stats(planes, uv, valid, patch, radius, order,
                                    norm)
        want = pw.patch_stats(planes, uv, valid, patch, radius, norm)
        torch.cuda.synchronize()
        assert torch.equal(got, want), norm


@pytest.mark.parametrize("radius", K2_RADII)
@pytest.mark.parametrize("channels", [1, 3])
def test_bicubic_kernel_is_bitwise_its_one_thread_design(cuda_device, radius,
                                                        channels):
    """K2's sums at every radius, whichever design runs there (a register
    tile of samples, or sampling on every pass), equal bitwise those of
    its one-thread design with a run-time radius: the same samples,
    reduced in the same order."""
    rng = np.random.default_rng(400 + radius * 10 + channels)
    planes, uv, valid, patch = bicubic_inputs(rng, cuda_device, radius,
                                              channels)
    for norm in _common.NORMS:
        before = pb.bicubic_stats_one_thread.launches[norm]
        got = pb.bicubic_stats(planes, uv, valid, patch, radius, norm)
        want = pb.bicubic_stats_one_thread(planes, uv, valid, patch, radius,
                                           norm)
        torch.cuda.synchronize()
        assert pb.bicubic_stats_one_thread.launches[norm] == before + 1
        assert torch.equal(got, want), norm
        assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("radius", _common.WARPED_RADII)
@pytest.mark.parametrize("channels", [1, 3])
def test_scaled_kernel_is_bitwise_its_one_thread_design(cuda_device, radius,
                                                       channels):
    """K3's (and K5's) sums at every radius, whichever design runs there
    (a register tile, the tiled design, or sampling on every pass), equal
    bitwise those of its one-thread design with a run-time radius."""
    rng = np.random.default_rng(500 + radius * 10 + channels)
    planes, uv, rho, valid, patch = scaled_inputs(rng, cuda_device, radius,
                                                  channels)
    for norm in _common.NORMS:
        got = ps.scaled_stats(planes, uv, rho, valid, patch, radius, norm)
        want = ps.scaled_stats_one_thread(planes, uv, rho, valid, patch,
                                          radius, norm)
        torch.cuda.synchronize()
        assert torch.equal(got, want), norm
        assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("threads", pa.THREADS)
@pytest.mark.parametrize("n_pts", [4096, 65536])
def test_k1_is_bitwise_k8_full_own(cuda_device, n_pts, threads):
    """K8's full/own (csrc/patch_ablate.cu: K1's staged design with
    `threads` observations a block) is K1 bitwise at R = 2, at every
    thread count."""
    planes, uv, valid, patch, _ = full_size_instance(cuda_device, n_pts, 2)
    got = pw.patch_stats(planes, uv, valid, patch, 2)
    own = pa.ablate_stats(planes, uv, valid, patch, "full", "own", threads)
    torch.cuda.synchronize()
    assert torch.equal(got, own)
    assert float(got.abs().sum()) > 0


def test_k1_with_eight_channels(cuda_device):
    """C = 8 (the bitplanes descriptor's channel count) at R = 2: K1's
    C > 1 design (a thread per observation and channel). Every
    normalization within the kernel tolerance of the plain version; the
    mean mode bitwise K8's full/own (K1's staged design with its channels
    in turn, two channel buffers)."""
    planes, uv, valid, patch, _ = full_size_instance(cuda_device, 4096, 2,
                                                     channels=8)
    for norm in _common.NORMS:
        got = pw.patch_stats(planes, uv, valid, patch, 2, norm)
        want = pw.patch_stats_reference(planes, uv, valid, patch, 2, norm)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert float(got[:, ~valid.T].abs().sum()) == 0.0
        row_max = want.abs().amax(dim=(1, 2), keepdim=True)
        assert within_f32_tolerance(got, want, row_max), norm
    for threads in pa.THREADS:     # two channel buffers, and one at 256
        own = pa.ablate_stats(planes, uv, valid, patch, "full", "own",
                              threads)
        assert torch.equal(pw.patch_stats(planes, uv, valid, patch, 2), own)


def channel_ordered_sum(kernel, planes, uv, valid, patch, radius, norm):
    """The sum, from zeros in channel order, of one-channel launches of
    `kernel` on each channel's planes and descriptor slice."""
    out = 0
    for ch in range(planes.shape[1]):
        part = kernel(planes[:, ch:ch + 1].contiguous(), uv, valid,
                      patch[:, ch:ch + 1].contiguous(), radius, norm)
        out = torch.zeros_like(part) + part if ch == 0 else out + part
    return out


def bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("radius", K1_RADII)
@pytest.mark.parametrize("channels", [2, 3, 8])
def test_k1_is_the_channel_ordered_sum(cuda_device, radius, channels):
    """K1 at C > 1 (a thread per observation and channel, its partials
    added in channel order; staged windows to R = 4, gathered above)
    equals bitwise the sum, from zeros in channel order, of its C
    one-channel launches, in every normalization: each channel's sums
    come from the unchanged per-channel arithmetic."""
    rng = np.random.default_rng(600 + radius * 10 + channels)
    planes, uv, valid, patch = random_inputs(rng, cuda_device, radius,
                                             channels)
    for norm in _common.NORMS:
        before = pw.patch_stats.launches[norm]
        got = pw.patch_stats(planes, uv, valid, patch, radius, norm)
        assert pw.patch_stats.launches[norm] == before + 1
        want = channel_ordered_sum(pw.patch_stats, planes, uv, valid, patch,
                                   radius, norm)
        torch.cuda.synchronize()
        assert torch.equal(bits(got), bits(want)), norm
        assert float(got.abs().sum()) > 0
        assert float(got[:, ~valid.T].abs().sum()) == 0.0


@pytest.mark.parametrize("radius", K2_RADII)
@pytest.mark.parametrize("channels", [2, 3, 8])
def test_bicubic_kernel_is_the_channel_ordered_sum(cuda_device, radius,
                                                   channels):
    """K2 at C > 1 (a thread per observation and channel) equals bitwise
    the channel-ordered sum of its C one-channel launches and its
    one-thread design (the channels in turn in one thread), in every
    normalization."""
    rng = np.random.default_rng(700 + radius * 10 + channels)
    planes, uv, valid, patch = bicubic_inputs(rng, cuda_device, radius,
                                              channels)
    for norm in _common.NORMS:
        got = pb.bicubic_stats(planes, uv, valid, patch, radius, norm)
        want = channel_ordered_sum(pb.bicubic_stats, planes, uv, valid, patch,
                                   radius, norm)
        one = pb.bicubic_stats_one_thread(planes, uv, valid, patch, radius,
                                          norm)
        torch.cuda.synchronize()
        assert torch.equal(bits(got), bits(want)), norm
        assert torch.equal(bits(got), bits(one)), norm
        assert float(got.abs().sum()) > 0


def test_kernels_refuse_more_channels_than_a_block_holds(cuda_device):
    """K1, sorted K1 and K2 take 1..MAX_CHANNELS channels: a block of their
    C > 1 designs holds every channel of its observations."""
    rng = np.random.default_rng(8)
    c = _common.MAX_CHANNELS + 1
    planes, uv, valid, patch = random_inputs(rng, cuda_device, 1, c, n=9)
    with pytest.raises(ValueError, match="channels"):
        pw.patch_stats(planes, uv, valid, patch, 1)
    order = res_mod.sorted_dispatch_order(torch.arange(9, device=cuda_device))
    with pytest.raises(ValueError, match="channels"):
        pw.sorted_patch_stats(planes, uv, valid, patch, 1, order)
    with pytest.raises(ValueError, match="channels"):
        pb.bicubic_stats(planes[..., 0].contiguous(), uv, valid, patch, 1)


def test_ungrouped_solve_at_a_wide_patch_runs_k1(cuda_device, monkeypatch):
    """PB_GROUPED_STATS=0 at a wide patch (R = 6, where K1 rolls its rows):
    the unfused solve runs the row store, as at every radius K1 takes,
    once per evaluation, and neither K1 nor any other kernel."""
    cam, off, args = entry.make_problem(96, 4, 64, 96, 6, seed=2,
                                        device=cuda_device)
    monkeypatch.setenv("PB_GROUPED_STATS", "0")
    for k in (pw.patch_stats, smp.warp_patches):
        _common.reset_launches(k)
    lm.reset_runs()
    _, _, st = lm.lm_solve(cam, *args, off, huber_delta=0.05,
                           backend="cuda", max_iterations=3,
                           function_tolerance=0.0, parameter_tolerance=0.0)
    torch.cuda.synchronize()
    assert smp.warp_patches.launches == {
        "rows": int(st.iterations) + 1 + warm_up_evaluations(), "block": 0,
        "raw": 0}
    assert sum(pw.patch_stats.launches.values()) == 0


# ---------------------------------------------------------------------------
# K4's sample store and K6 (csrc/patch_samples.cu), K7 (csrc/patch_stats.cu)
# and K8 (csrc/patch_ablate.cu)
# ---------------------------------------------------------------------------

def random_inputs(rng, device, radius, channels, w=3, h=40, wi=70, n=257):
    """Random planes and descriptors; coordinates anywhere around the image
    (clamped windows included), about a fifth invalid, one NaN."""
    planes = torch.as_tensor(rng.standard_normal((w, channels, h, wi, 4)),
                             dtype=torch.float32, device=device)
    uv = torch.as_tensor(rng.uniform(-3.0, wi + 2.0, size=(n, w, 2)),
                         dtype=torch.float32, device=device)
    valid = torch.as_tensor(rng.uniform(size=(n, w)) > 0.2, device=device)
    uv[5, 1] = float("nan")
    valid[5, 1] = False
    patch = torch.as_tensor(
        rng.standard_normal((n, channels, (2 * radius + 1) ** 2)),
        dtype=torch.float32, device=device)
    return planes, uv, valid, patch


# The store's radii held on the card: every compile-time instance (1..9),
# the runtime-radius instance (10, and 19, the fixed-grid limit).
STORE_RADII = (*range(1, 11), _common.FIXED_RADII[-1])


@pytest.mark.parametrize("radius", STORE_RADII)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("layout", smp.LAYOUTS)
def test_sample_store_is_its_plain_version_bitwise(cuda_device, radius,
                                                   channels, layout):
    rng = np.random.default_rng(400 + radius * 10 + channels)
    planes, uv, valid, _ = random_inputs(rng, cuda_device, radius, channels)
    before = smp.warp_patches.launches[layout]
    got = smp.store(planes, uv, valid, radius, layout)
    want = smp.store_reference(planes, uv, valid, radius, layout)
    torch.cuda.synchronize()
    assert smp.warp_patches.launches[layout] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("radius", [2, 9, 19])
def test_sample_store_at_full_size(cuda_device, radius):
    """chip_smoke.py's phase-3 problem (4096 points x 5 frames, 370x1226):
    every layout bitwise the plain version."""
    planes, uv, valid, _, _ = full_size_instance(cuda_device, 4096, radius)
    for layout in smp.LAYOUTS:
        got = smp.store(planes, uv, valid, radius, layout)
        want = smp.store_reference(planes, uv, valid, radius, layout)
        torch.cuda.synchronize()
        assert torch.equal(got, want), layout


def test_warp_patches_variants_on_card_are_bitwise_alike(cuda_device):
    rng = np.random.default_rng(7)
    planes, uv, valid, _ = random_inputs(rng, cuda_device, 2, 2)
    cpu = smp.warp_patches(planes.cpu(), uv.cpu(), valid.cpu(), 2)
    for variant in smp.VARIANTS:
        got = smp.warp_patches(planes, uv, valid, 2, variant)
        for a, b in zip(got, cpu):
            assert torch.equal(a.cpu(), b), variant


def test_sample_store_rejects_unsupported_input(cuda_device):
    planes = torch.zeros((1, 1, 32, 32, 4), device=cuda_device)
    uv = torch.zeros((2, 1, 2), device=cuda_device)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="radius"):
        smp.warp_patches(planes, uv, valid, _common.FIXED_RADII[-1] + 1)
    with pytest.raises(ValueError, match="uv"):
        smp.warp_patches(planes, uv.double(), valid, 2)
    with pytest.raises(ValueError, match="planes"):
        smp.warp_patches(planes[..., 0], uv, valid, 2)


def test_ungrouped_solve_on_card_runs_the_row_store(cuda_device,
                                                    monkeypatch):
    """lm_solve with PB_GROUPED_STATS=0 launches the row-store kernel once
    per evaluation and no other kernel; on a damped start its costs follow
    the fused solve's."""
    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=2,
                                        device=cuda_device)
    kw = dict(huber_delta=0.05, backend="cuda", max_iterations=4,
              initial_lambda=1.0, function_tolerance=0.0,
              parameter_tolerance=0.0)
    _, _, fused = lm.lm_solve(cam, *args, off, **kw)
    monkeypatch.setenv("PB_GROUPED_STATS", "0")
    kernels = (pw.patch_stats, pw.sorted_patch_stats, pb.bicubic_stats,
               ps.scaled_stats, smp.warp_patches)
    for k in kernels:
        _common.reset_launches(k)
    lm.reset_runs()
    _, _, st = lm.lm_solve(cam, *args, off, **kw)
    torch.cuda.synchronize()
    assert int(st.iterations) == 4
    assert smp.warp_patches.launches == {
        "rows": 5 + warm_up_evaluations(), "block": 0, "raw": 0}
    assert all(not any(k.launches.values()) for k in kernels[:4])
    assert torch.equal(st.accept_log, fused.accept_log)
    np.testing.assert_allclose(st.cost_log.cpu().numpy(),
                               fused.cost_log.cpu().numpy(), rtol=1e-4)


# K7's radii held on the card: every compile-time instance (1-9: each
# design and both sides of every change of design), the runtime-radius
# instance (10, 19).
K7_RADII = (*range(1, 11), 19)


def k7_inputs(rng, device, radius, channels, **size):
    """random_inputs with mean-normalized (N, C, ps, ps) descriptors."""
    planes, uv, valid, patch = random_inputs(rng, device, radius, channels,
                                             **size)
    ps_ = 2 * radius + 1
    desc = patch.reshape(-1, channels, ps_, ps_)
    return planes, uv, valid, (desc - desc.mean(dim=(2, 3),
                                                keepdim=True)).contiguous()


@pytest.mark.parametrize("radius", K7_RADII)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("cost_only", [False, True])
def test_k7_matches_plain_version(cuda_device, radius, channels, cost_only):
    rng = np.random.default_rng(500 + radius * 10 + channels)
    planes, uv, valid, desc = k7_inputs(rng, cuda_device, radius, channels)
    src = planes[..., 0].contiguous() if cost_only else planes
    mode = "cost_only" if cost_only else "full"
    before = k7.patch_stats.launches[mode]
    got = k7.stats_rows(src, uv, valid, desc, radius, cost_only)
    want = k7.patch_stats_reference(src, uv, valid, desc, radius, cost_only)
    torch.cuda.synchronize()
    assert k7.patch_stats.launches[mode] == before + 1
    assert torch.isfinite(got).all()
    assert float(got.reshape(3, -1, 8)[~valid.T].abs().sum()) == 0.0
    col_max = want.abs().amax(dim=0, keepdim=True)          # per statistic
    assert within_f32_tolerance(got, want, col_max)
    if cost_only:
        full = k7.stats_rows(planes, uv, valid, desc, radius)
        assert torch.equal(got[:, 5], full[:, 5])
        assert float(got[:, :5].abs().sum()) == 0.0


@pytest.mark.parametrize("radius", (*K7_RADII, _common.STATS_MAX))
@pytest.mark.parametrize("channels", [1, 3])
def test_k7_is_bitwise_its_one_thread_design(cuda_device, radius, channels):
    """K7's rows at every radius, whichever design runs there (a register
    tile, staged windows, the tiled design, or sampling on both passes),
    equal bitwise those of its first design with a run-time radius: the
    same samples, reduced in the same order; cost_only's Σr² is the full
    mode's."""
    rng = np.random.default_rng(700 + radius * 10 + channels)
    size = dict(h=130, wi=140, n=65) if radius > 19 else {}
    planes, uv, valid, desc = k7_inputs(rng, cuda_device, radius, channels,
                                        **size)
    rows = {}
    for cost_only in (False, True):
        src = planes[..., 0].contiguous() if cost_only else planes
        mode = k7.MODES[int(cost_only)]
        before = k7.stats_rows_one_thread.launches[mode]
        got = k7.stats_rows(src, uv, valid, desc, radius, cost_only)
        want = k7.stats_rows_one_thread(src, uv, valid, desc, radius,
                                        cost_only)
        torch.cuda.synchronize()
        assert k7.stats_rows_one_thread.launches[mode] == before + 1
        assert torch.equal(got, want), (mode, k7.design(radius, cost_only))
        assert float(got[:, 5].sum()) > 0
        rows[mode] = got
    assert torch.equal(rows["cost_only"][:, 5], rows["full"][:, 5])


def test_k7_rejects_unsupported_input(cuda_device):
    """The kernel takes the reference's radii 1..STATS_MAX and raises
    outside them, before any launch."""
    planes = torch.zeros((1, 1, 32, 32, 4), device=cuda_device)
    uv = torch.zeros((2, 1, 2), device=cuda_device)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    desc = torch.zeros((2, 1, 5, 5), device=cuda_device)
    before = dict(k7.patch_stats.launches)
    for radius in (0, _common.STATS_MAX + 1):
        with pytest.raises(ValueError, match="radius 1..62"):
            k7.patch_stats(planes, uv, valid, desc, radius)
        with pytest.raises(ValueError, match="radius 1..62"):
            k7.patch_stats(planes[..., 0].contiguous(), uv, valid, desc,
                           radius, cost_only=True)
    assert k7.patch_stats.launches == before
    with pytest.raises(ValueError, match="planes"):
        k7.patch_stats(planes, uv, valid, desc, 2, cost_only=True)
    with pytest.raises(ValueError, match="descriptors"):
        k7.patch_stats(planes, uv, valid, desc.reshape(2, 1, 25), 2)


@pytest.mark.parametrize("stage", pa.STAGES)
@pytest.mark.parametrize("window", pa.WINDOWS)
@pytest.mark.parametrize("threads", pa.THREADS)
def test_ablation_matches_plain_version(cuda_device, stage, window, threads):
    """Partial stages: bitwise their plain version (both round every
    operation once, in one order); full: K1's tolerance, and full/own is
    K1 bitwise."""
    rng = np.random.default_rng(600 + threads)
    planes, uv, valid, patch = random_inputs(rng, cuda_device, 2, 2)
    mode = f"{stage}/{window}"
    before = pa.ablate_stats.launches[mode]
    got = pa.ablate_stats(planes, uv, valid, patch, stage, window, threads)
    want = pa.ablate_reference(planes, uv, valid, patch, stage, window,
                               threads)
    torch.cuda.synchronize()
    assert pa.ablate_stats.launches[mode] == before + 1
    assert torch.isfinite(got).all()
    if stage != "full":
        assert torch.equal(got, want)
        return
    row_max = want.abs().amax(dim=(1, 2), keepdim=True)
    assert within_f32_tolerance(got, want, row_max)
    if window == "own":
        assert torch.equal(got, pw.patch_stats(planes, uv, valid, patch, 2))


def test_ablation_rejects_unsupported_input(cuda_device):
    planes = torch.zeros((1, 1, 32, 32, 4), device=cuda_device)
    uv = torch.zeros((2, 1, 2), device=cuda_device)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="patch"):
        pa.ablate_stats(planes, uv, valid,
                        torch.zeros((2, 1, 9), device=cuda_device))
    with pytest.raises(ValueError, match="threads"):
        pa.ablate_stats(planes, uv, valid,
                        torch.zeros((2, 1, 25), device=cuda_device),
                        threads=512)


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


# ---------------------------------------------------------------------------
# The window solve as CUDA graph replays (core/lm.py)
# ---------------------------------------------------------------------------

GRAPH_KW = dict(huber_delta=0.05, backend="cuda", max_iterations=6,
                function_tolerance=0.0, parameter_tolerance=0.0)


@pytest.mark.parametrize("function_tolerance", [0.0, 0.05])
def test_captured_solve_matches_the_eager_loop(cuda_device,
                                               function_tolerance):
    """The default (graph replays) against capture=False (the same body
    in a host loop): the same iterations, accepted steps and termination,
    costs within 1e-6; with a function tolerance the solve ends early."""
    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=2,
                                        device=cuda_device)
    kw = dict(GRAPH_KW, function_tolerance=function_tolerance,
              max_iterations=12)
    t_g, x_g, st_g = lm.lm_solve(cam, *args, off, **kw)
    t_e, x_e, st_e = lm.lm_solve(cam, *args, off, capture=False, **kw)
    torch.cuda.synchronize()
    it = int(st_e.iterations)
    assert int(st_g.iterations) == it
    if function_tolerance:
        assert it < 12 and int(st_e.termination) == 2
    assert torch.equal(st_g.accept_log, st_e.accept_log)
    assert int(st_g.termination) == int(st_e.termination)
    np.testing.assert_allclose(st_g.cost_log[:it].cpu().numpy(),
                               st_e.cost_log[:it].cpu().numpy(), rtol=1e-6)
    assert torch.isnan(st_g.cost_log[it:]).all()
    np.testing.assert_allclose(t_g.cpu().numpy(), t_e.cpu().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(x_g.cpu().numpy(), x_e.cpu().numpy(),
                               atol=1e-6)


def test_graph_launches_are_counted_per_replay(cuda_device):
    """Two calls on one key: the cold one warms up (one start and one
    body), captures twice and replays; the warm one only replays. Each
    counts K1 once per replay, as a profiler trace of the warm call
    shows it launched."""
    from torch.autograd import DeviceType

    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=3,
                                        device=cuda_device)
    t_wc, x_world, *rest = args
    lm.clear_graph_cache()
    counts = []
    for x0 in (x_world, x_world + 1e-4):
        _common.reset_launches(pw.patch_stats)
        lm.reset_runs()
        _, _, st = lm.lm_solve(cam, t_wc, x0, *rest, off, **GRAPH_KW)
        torch.cuda.synchronize()
        counts.append((pw.patch_stats.launches["mean"], dict(lm.runs),
                       int(st.iterations)))
    (cold, cold_runs, it), (warm, warm_runs, it2) = counts
    assert it == it2 == GRAPH_KW["max_iterations"]
    assert (cold_runs["warm_ups"], cold_runs["captures"]) == (1, 2)
    assert (warm_runs["warm_ups"], warm_runs["captures"]) == (0, 0)
    assert cold == it + 1 + 2 == cold_runs["starts"] + cold_runs["bodies"]
    assert warm == it + 1 == warm_runs["starts"] + warm_runs["bodies"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        lm.lm_solve(cam, t_wc, x_world + 2e-4, *rest, off, **GRAPH_KW)
        torch.cuda.synchronize()
    traced = sum(e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and "patch_stats_kernel" in e.key)
    assert traced == it + 1


def test_replays_and_the_body_make_no_host_sync(cuda_device, monkeypatch):
    """A warm fixed-length solve whose readback interval covers it, and
    one eager body, under set_sync_debug_mode('error'): no operation waits
    for the card."""
    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=2,
                                        device=cuda_device)
    monkeypatch.setattr(lm, "LM_READBACK", GRAPH_KW["max_iterations"])
    lm.lm_solve(cam, *args, off, **GRAPH_KW)              # capture
    start, body = lm.program(*lm.setup(cam, *args, off, **GRAPH_KW))
    state, _ = start()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, st = lm.lm_solve(cam, *args, off, **GRAPH_KW)
        body(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(st.iterations) == GRAPH_KW["max_iterations"]


# ---------------------------------------------------------------------------
# Batched windows: K1's batch axis and the batched solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", (2, 9, 19))
@pytest.mark.parametrize("norm", _common.NORMS)
def test_k1_batch_axis_is_bitwise_single_launches(cuda_device, radius, norm):
    """B = 3 windows in one launch: each window's sums bitwise its own
    launch's, within the kernel tolerance of the batched plain version;
    one launch counted."""
    rng = np.random.default_rng(radius)
    b, w, c, h, wi, n = 3, 3, 2, 40, 70, 129
    planes = torch.as_tensor(rng.standard_normal((b, w, c, h, wi, 4)),
                             dtype=torch.float32, device=cuda_device)
    uv = torch.as_tensor(rng.uniform(-3.0, 72.0, size=(b, n, w, 2)),
                         dtype=torch.float32, device=cuda_device)
    valid = torch.as_tensor(rng.uniform(size=(b, n, w)) > 0.2,
                            device=cuda_device)
    patch = torch.as_tensor(
        rng.standard_normal((b, n, c, (2 * radius + 1) ** 2)),
        dtype=torch.float32, device=cuda_device)
    before = pw.patch_stats.launches[norm]
    got = pw.patch_stats(planes, uv, valid, patch, radius, norm)
    assert pw.patch_stats.launches[norm] == before + 1
    singles = torch.stack([pw.patch_stats(planes[k], uv[k], valid[k],
                                          patch[k], radius, norm)
                           for k in range(b)])
    want = pw.patch_stats_reference(planes, uv, valid, patch, radius, norm)
    torch.cuda.synchronize()
    assert got.shape == (b, 6, w, n)
    assert torch.equal(got, singles)
    assert within_f32_tolerance(got, want, want.abs().amax())


def test_batched_solve_is_bitwise_each_window(cuda_device):
    """Three windows as one captured batched solve: each window's poses,
    points and stats bitwise its own captured solve's; K1 launched once
    per evaluation for all three (replays + 1, + 2 for the cold key)."""
    cam, off, args = entry.make_problem(96, 4, 48, 80, 2, seed=2,
                                        device=cuda_device)
    t_wc, x_world, *rest = args
    kw = dict(GRAPH_KW, function_tolerance=0.05, max_iterations=12)
    requests = [((cam, t_wc, x_world + d, *rest, off), kw)
                for d in (0.0, 1e-3, 2e-3)]
    singles = [lm.lm_solve(*a, **o) for a, o in requests]
    lm.clear_graph_cache()
    _common.reset_launches(pw.patch_stats)
    lm.reset_runs()
    t_b, x_b, st_b = lm.lm_solve_batched(requests)
    torch.cuda.synchronize()
    for k, (t_s, x_s, st_s) in enumerate(singles):
        assert torch.equal(t_b[k], t_s) and torch.equal(x_b[k], x_s)
        for a, b in zip(st_b, st_s):                  # NaN-aware, bitwise
            np.testing.assert_array_equal(a[k].cpu().numpy(),
                                          b.cpu().numpy())
    runs = lm.runs
    assert (runs["warm_ups"], runs["captures"]) == (1, 2)
    assert pw.patch_stats.launches["mean"] == runs["starts"] + runs["bodies"]
    assert runs["bodies"] >= max(int(s.iterations) for _, _, s in singles)


@pytest.mark.parametrize("w", [1, 5, 6, 10, 32, 45])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_solve_kernel_matches_plain_version(cuda_device, w, dtype):
    """The batched Cholesky kernel on both sides of its paths (a warp per
    system to n = 32, W <= 5; panels of 32 columns above, in shared
    memory to W = 40 in f32, 28 in f64; global scratch above) against
    cholesky_ex + cholesky_solve on well-conditioned systems, bitwise its
    single launches, NaN in the non-SPD window alone."""
    from photobundle_torch.ops import chol_solve as cs

    n, b = 6 * w, 4
    g = torch.Generator().manual_seed(w)
    m = torch.randn((b, n, n), generator=g, dtype=torch.float64)
    s = (m @ m.transpose(-1, -2) / n + torch.eye(n, dtype=torch.float64))
    s = s.to(dtype)
    s[1, 3, 3] = -1.0
    rhs = torch.randn((b, n), generator=g, dtype=torch.float64).to(dtype)
    s, rhs = s.to(cuda_device), rhs.to(cuda_device)
    got = cs.chol_solve(s, rhs)
    want = cs.chol_solve_reference(s, rhs)
    bad = torch.tensor([False, True, False, False], device=cuda_device)
    assert torch.equal(torch.isnan(got).all(-1), bad)
    assert torch.equal(torch.isnan(got).any(-1), bad)
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((got - want)[~bad].abs().max()) <= rtol * float(
        want[~bad].abs().max())
    singles = torch.cat([cs.chol_solve(s[k:k + 1], rhs[k:k + 1])
                         for k in range(b)])
    assert torch.equal(torch.nan_to_num(got, 7.0),
                       torch.nan_to_num(singles, 7.0))


# Lengths on both sides of the ordered sums' paths (a thread per output to
# 64 terms) and of their chunks (1024 terms): one chunk, one and a bit,
# several.
ROW_DOT_K = (5, 64, 65, 1023, 1024, 1025, 3 * 1024 + 7, 12288)


def bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


@pytest.mark.parametrize("k", ROW_DOT_K)
@pytest.mark.parametrize("dot", [False, True])
def test_row_dot_kernel_matches_plain_version(cuda_device, k, dot):
    """The ordered sums through a transposed view within 1e-5 of each
    output's sum of |terms|, bitwise their kernel-order twin and the same
    rows summed alone."""
    from photobundle_torch.ops import ordered_sum as osm

    g = torch.Generator().manual_seed(k)
    a = torch.randn((3, 4, k, 7), generator=g).to(cuda_device)
    a = a.transpose(-1, -2)                       # (3, 4, 7, k), strided
    c = (torch.randn((3, 4, 5, k), generator=g).to(cuda_device) if dot
         else None)
    got = osm.row_dot(a, c)
    want = osm.row_dot_reference(a, c)
    mag = osm.row_dot_reference(a.abs(), None if c is None else c.abs())
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all())
    assert torch.equal(bits(got), bits(osm.row_dot_ordered(a, c)))
    alone = osm.row_dot(a[1:2], None if c is None else c[1:2])
    assert torch.equal(alone[0], got[1])
    if c is None:
        one, want_one = osm.row_dot(a[2:3, 1:2, 6:7]), got[2, 1, 6]
    else:
        one = osm.row_dot(a[2:3, 1:2, 6:7], c[2:3, 1:2, 4:5])
        want_one = got[2, 1, 6, 4]
    assert torch.equal(bits(one.reshape(1)), bits(want_one.reshape(1)))


@pytest.mark.parametrize("case", ["s_off", "one_output", "batch", "rhs_off",
                                  "one_row", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_dot_kernel_at_body_shapes(cuda_device, case, dtype):
    """The body's shapes: s_off's (6W, 3N) rows at W = 32 on few points
    (contiguous rows: the 16-byte copies; 3 chunks, tiles of 32 x 16 split
    over blocks), one sum of 3 x 65 536 terms (192 chunks over blocks),
    hcc-sized products on a batch of 4 windows (2 x 4 warp tiles), and
    the other warp tiles: rhs_off's (6W, 3N) rows against one (8 x 1), one
    row against 100 (8 x 8, one row used), the sums of 100 rows (8 x 1).
    Within 1e-5 of
    the sums of |terms|; every output of a tile bitwise its row pair
    summed alone; window b bitwise its own call; bitwise the kernel-order
    twin."""
    from photobundle_torch.ops import ordered_sum as osm

    g = torch.Generator().manual_seed(7)
    shapes = {"s_off": ((1, 1, 192, 2100), (1, 1, 192, 2100)),
              "one_output": ((1, 3 * 65536), None),
              "batch": ((4, 5, 6, 3 * 700), (4, 5, 6, 3 * 700)),
              "rhs_off": ((1, 1, 192, 2100), (1, 1, 1, 2100)),
              "one_row": ((1, 1, 1, 2100), (1, 1, 100, 2100)),
              "rows": ((2, 100, 2100), None)}[case]
    a = torch.randn(shapes[0], generator=g, dtype=dtype).to(cuda_device)
    c = (None if shapes[1] is None else
         torch.randn(shapes[1], generator=g, dtype=dtype).to(cuda_device))
    got = osm.row_dot(a, c)
    want = osm.row_dot_reference(a, c)
    mag = osm.row_dot_reference(a.abs(), None if c is None else c.abs())
    rtol = 1e-5 if dtype == torch.float32 else 1e-13
    assert bool(((got - want).abs() <= rtol * mag + 1e-300).all())
    assert torch.equal(bits(got), bits(osm.row_dot_ordered(a, c)))
    if case == "s_off":
        for p, q in ((0, 0), (29, 30), (31, 16), (100, 177), (191, 191)):
            one = osm.row_dot(a[..., p:p + 1, :], c[..., q:q + 1, :])
            assert torch.equal(bits(one[0, 0, 0, 0]),
                               bits(got[0, 0, p, q]))
    if case == "batch":
        for b in range(4):
            assert torch.equal(bits(osm.row_dot(a[b], c[b])), bits(got[b]))


@pytest.mark.parametrize("w", [5, 32])
def test_sum_over_kernel_at_the_solve_layout(cuda_device, w):
    """solve_reduced's rhs_p: the (W, 3, 6, N) products summed over the
    window and pose axes (a copy of 6W-term rows, one sum per point and
    axis) within 1e-5 of the sums of |terms|, bitwise the kernel-order
    twin and each point's sums alone."""
    from photobundle_torch.ops import ordered_sum as osm

    g = torch.Generator().manual_seed(w)
    x = torch.randn((1, w, 3, 6, 700), generator=g).to(cuda_device)
    got = osm.sum_over(x, (-4, -2))                       # (1, 3, 700)
    want = x.sum((-4, -2))
    mag = x.abs().sum((-4, -2))
    assert bool(((got - want).abs() <= 1e-5 * mag).all())
    moved = x.movedim((-4, -2), (-2, -1)).flatten(-2)
    assert torch.equal(bits(got), bits(osm.row_dot_ordered(moved)))
    one = osm.sum_over(x[..., 17:18], (-4, -2))
    assert torch.equal(bits(one[..., 0]), bits(got[..., 17]))



def test_se3_on_card_matches_cpu_at_small_angles(cuda_device):
    """se3_exp and se3_log on the card over twists at rotation angles 1e-5
    to 1e-2 rad (se3_log's NaN band, 1e-4 to 2.44e-4, and the cancelling
    range above it): sin and cos are taken in f64 and rounded to f32 on
    both devices, so the card's NaN rows are the CPU's and its values
    within 1e-6 (se3_exp) and 1e-4 (se3_log, translations of scale 0.5)."""
    from photobundle_torch.geometry import se3

    rng = np.random.default_rng(21)
    n = 4096
    angle = np.exp(rng.uniform(np.log(1e-5), np.log(1e-2), n))
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi = torch.as_tensor(np.concatenate(
        [rng.standard_normal((n, 3)) * 0.5, axis * angle[:, None]],
        axis=1).astype(np.float32))
    t_cpu = se3.se3_exp(xi)
    t_card = se3.se3_exp(xi.to(cuda_device)).cpu()
    assert float((t_card - t_cpu).abs().max()) <= 1e-6
    log_cpu = se3.se3_log(t_cpu)
    log_card = se3.se3_log(t_cpu.to(cuda_device)).cpu()
    nan_cpu = torch.isnan(log_cpu).any(dim=1)
    assert torch.equal(torch.isnan(log_card).any(dim=1), nan_cpu)
    assert 0 < int(nan_cpu.sum()) < n
    assert float((log_card - log_cpu)[~nan_cpu].abs().max()) <= 1e-4
