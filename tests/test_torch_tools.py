"""The port's tools and K8, the ablation of K1 (ops/patch_ablate).

K8's plain version is held to K1's plain version (its 'full'/'own'
output, bitwise) and to what each partial stage sums; the JAX ablation
script has no function a test can call (it runs its problem at import).
Both tools run end to end with --device cpu at a tiny size. The CUDA
kernel itself is held against its plain version on a card by
tests/test_torch_cuda.py."""

import json

import numpy as np
import pytest
import torch

from photobundle_torch import entry
from photobundle_torch.core import residuals as res_mod
from photobundle_torch.ops import patch_ablate as pa
from photobundle_torch.ops import patch_samples as smp
from photobundle_torch.ops import patch_warp as pw
from photobundle_torch.tools import ablate_patch_stats, bench_warp_kernel

from torch_parity import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def problem():
    """entry.make_problem's window at a small size, valid observations
    inside K1's margins, one point's observations invalid with NaN
    coordinates."""
    cam, _, args = entry.make_problem(150, 3, 48, 96, 2, seed=1)
    t_wc, x_world, patch, channels, grads, obs = args[:6]
    _, uv, in_front, _, _ = res_mod._observation_geometry_pm(cam, t_wc,
                                                             x_world)
    in_bounds = ((uv[:, 0] >= 2) & (uv[:, 0] <= 96 - 4)
                 & (uv[:, 1] >= 2) & (uv[:, 1] <= 48 - 4))
    valid = (obs.T & in_front & in_bounds).T.contiguous()
    uv = uv.permute(2, 0, 1).contiguous()
    valid[7] = False
    uv[7] = float("nan")
    return pw.build_planes(channels, grads), uv, valid, patch


def test_full_own_is_k1_bitwise(problem):
    planes, uv, valid, patch = problem
    k1 = pw.patch_stats_reference(planes, uv, valid, patch, 2)
    for threads in pa.THREADS:
        assert torch.equal(pa.ablate_stats(planes, uv, valid, patch, "full",
                                           "own", threads), k1)


def sequential_sum(terms):
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


@pytest.mark.parametrize("stage", ["loads", "combine", "subtract"])
def test_partial_stages_sum_what_they_name(problem, stage):
    """Row 0 of a partial stage is its sum over the stored samples (or, for
    'loads', the raw window) in the kernel's order; rows 1-5 are zeros."""
    planes, uv, valid, patch = problem
    n, w = valid.shape
    out = pa.ablate_stats(planes, uv, valid, patch, stage)
    assert out.shape == (6, w, n) and float(out[1:].abs().sum()) == 0.0
    layout = "raw" if stage == "loads" else "block"
    k = 6 if stage == "loads" else 5
    t = smp.store_reference(planes, uv, valid, 2, layout)[0]
    t = t.reshape(w, n, k, k, 3)
    d = patch[:, 0].reshape(n, 5, 5).permute(1, 2, 0)      # (5, 5, N)
    terms = []
    for ky in range(k):
        for kx in range(k):
            v = t[:, :, ky, kx]                              # (W, N, 3)
            s = v[..., 0] - d[ky, kx] if stage == "subtract" else v[..., 0]
            terms.append((s + v[..., 1]) + v[..., 2])
    assert torch.equal(out[0], torch.where(valid.T, sequential_sum(terms),
                                           0.0))


def test_center_stage_and_shared_windows(problem):
    """'center' sums centred terms (near zero); 'shared' reads the block's
    first observation's window, so with one frame and one coordinate for
    every point it equals 'own' at every stage."""
    planes, uv, valid, patch = problem
    center = pa.ablate_stats(planes, uv, valid, patch, "center")
    combine = pa.ablate_stats(planes, uv, valid, patch, "combine")
    assert float(center[0].abs().max()) < 1e-4 * float(combine[0].abs().max())
    n = valid.shape[0]
    one_uv = uv[:1, :1].expand(n, 1, 2).contiguous()
    ones = torch.ones((n, 1), dtype=torch.bool)
    planes1 = planes[:1].contiguous()
    for stage in pa.STAGES:
        own = pa.ablate_stats(planes1, one_uv, ones, patch, stage, "own")
        for threads in pa.THREADS:
            assert torch.equal(pa.ablate_stats(planes1, one_uv, ones, patch,
                                               stage, "shared", threads),
                               own), (stage, threads)
    src_p, src_f = pa.window_sources(valid, "shared", 64)
    first = (src_f * n + src_p)
    assert bool((first % 64 == 0).all())
    assert bool((first <= torch.arange(valid.shape[1])[None] * n
                 + torch.arange(n)[:, None]).all())


def test_ablate_switches_and_cpu_launches(problem):
    planes, uv, valid, patch = problem
    before = dict(pa.ablate_stats.launches)
    pa.ablate_stats(planes, uv, valid, patch, "loads", "shared", 128)
    assert pa.ablate_stats.launches == before
    assert set(before) == {f"{s}/{w}" for s in pa.STAGES for w in pa.WINDOWS}
    for bad in (dict(stage="stats"), dict(window="static"),
                dict(threads=32)):
        with pytest.raises(ValueError, match="ablate_stats"):
            pa.ablate_stats(planes, uv, valid, patch, **bad)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_warp_kernel_runs_on_the_cpu(capsys):
    res = bench_warp_kernel.main(["16", "2", "--calls", "2", "--device",
                                  "cpu"])
    line = last_json(capsys)
    assert line["tool"] == "bench_warp_kernel" and line["device"] == "cpu"
    assert list(res) == list(smp.VARIANTS) == list(line["variants"])
    sums = {v: r["checksum"] for v, r in res.items()}
    assert len(set(sums.values())) == 1 and np.isfinite(sums["rows"])
    assert all(r["ms"] > 0 for r in res.values())


def test_ablate_patch_stats_runs_on_the_cpu(capsys):
    res = ablate_patch_stats.main(["32", "2", "2", "--threads", "64",
                                   "--device", "cpu"])
    line = last_json(capsys)
    assert line["tool"] == "ablate_patch_stats" and line["device"] == "cpu"
    assert res["full_own_bitwise_k1"] and line["full_own_bitwise_k1"]
    assert sorted(res["variants"]) == sorted(
        f"{s}/{w}/64" for s in pa.STAGES for w in pa.WINDOWS)


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    for tool in (bench_warp_kernel, ablate_patch_stats):
        with pytest.raises(RuntimeError, match="CUDA card"):
            tool.main(["16", "2"])
