"""The port's tools and K8, the ablation of K1 (ops/patch_ablate).

K8's plain version is held to K1's plain version (its 'full'/'own'
output, bitwise) and to what each partial stage sums; the JAX ablation
script has no function a test can call (it runs its problem at import).
Both tools run end to end with --device cpu at a tiny size. The CUDA
kernel itself is held against its plain version on a card by
tests/test_torch_cuda.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photobundle_torch import entry
from photobundle_torch.core import residuals as res_mod
from photobundle_torch.io import png
from photobundle_torch.ops import patch_ablate as pa
from photobundle_torch.ops import patch_samples as smp
from photobundle_torch.ops import patch_warp as pw
from photobundle_torch.tools import (ablate_patch_stats, bench_keyframes,
                                     bench_lm_breakdown, bench_sampling,
                                     bench_scaling, bench_warp_kernel,
                                     diagnose_w5, eval_traj, golden_kitti,
                                     plot_traj, probe_eval65k, verify_e2e)

from test_tools import _make_traj_files
from torch_parity import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_tools_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    for tool in (bench_warp_kernel, ablate_patch_stats, bench_lm_breakdown,
                 probe_eval65k):
        with pytest.raises(RuntimeError, match="CUDA card"):
            tool.main(["16", "2"])
    root = str(tmp_path / "nothing")
    for tool, argv in ((bench_keyframes, []), (bench_sampling, []),
                       (bench_scaling, []), (verify_e2e, ["--root", root]),
                       (golden_kitti, ["--root", root]),
                       (diagnose_w5, ["--root", root])):
        with pytest.raises(RuntimeError, match="CUDA card"):
            tool.main(argv)
    assert not os.path.exists(root)


# -- the solve's and the engine's tools at a tiny size on the CPU --------

TINY = ["--height", "40", "--width", "64", "--device", "cpu"]


def test_bench_lm_breakdown_times_the_bodys_work(capsys):
    """Each timed phase, run first on the inputs one capture=False body
    gave that phase, returns bitwise the body's outputs; every row and
    every phase of the body's table is printed."""
    rec = bench_lm_breakdown.main(["48", "3", "2", *TINY])
    out = capsys.readouterr().out
    assert last_json_of(out) == json.loads(json.dumps(rec))
    assert list(rec["phases"]) == ["evaluate", "build_normal_equations",
                                   "schur reduce+solve", "full LM iteration"]
    for key, row in rec["phases"].items():
        assert row["bitwise"] is True, key
        assert row["ms"] > 0 and row["bytes"] > 0, key
    for label in ("evaluate_compressed (cuda)", "build_normal_equations",
                  "schur reduce+solve", "full LM iteration (1-iter solve)"):
        assert f"{label:34s}: " in out
    assert list(rec["body"]) == list(bench_lm_breakdown.PHASES)
    for phase in ("evaluate", "assemble", "reduce", "solve", "retract",
                  "bookkeeping"):
        assert rec["body"][phase]["kernels"] > 0, phase
        assert f"  {phase:12s} " in out
    assert rec["replayed_body_ms"] is None      # no graphs on the CPU
    # The wrappers are taken off again.
    from photobundle_torch.core import lm, schur
    assert lm.evaluate_compressed is res_mod.evaluate_compressed
    assert schur.solve_reduced.__module__ == schur.__name__


def test_bench_lm_breakdown_counts_a_trace_whole_only_with_every_launch():
    """A body's traces are whole when each holds one device activity per
    launch of the body and they agree phase by phase."""
    phases = bench_lm_breakdown.PHASES

    def table(kernels, launches):
        t = {p: {"kernels": k} for p, k in zip(phases, kernels)}
        t["_launches"] = launches
        return t

    counts = [122, 24, 86, 26, 49, 1, 212]
    whole = bench_lm_breakdown.whole
    assert whole([table(counts, 520), table(counts, 520)])
    short = [122, 8, 86, 26, 49, 1, 212]           # the assembly's lost
    assert not whole([table(counts, 520), table(short, 520)])
    assert not whole([table(short, 520), table(short, 520)])
    moved = [123, 23, 86, 26, 49, 1, 212]          # same total, other phases
    assert not whole([table(counts, 520), table(moved, 520)])


def last_json_of(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_probe_eval65k_runs_on_the_cpu(capsys):
    rec = probe_eval65k.main(["48", "3", "2", *TINY])
    out = capsys.readouterr().out
    assert last_json_of(out)["stages"].keys() == rec["stages"].keys()
    assert len(rec["stages"]) == 5
    for label, row in rec["stages"].items():
        assert row["ms"] > 0 and f"{label:36s}: " in out


def test_bench_sampling_and_scaling_run_on_the_cpu(capsys):
    rec = bench_sampling.main(["--points", "24", "--frames", "3",
                               "--chain", "1", *TINY])
    out = capsys.readouterr().out
    assert list(rec["paths"]) == [p[0] for p in bench_sampling.PATHS]
    for label, row in rec["paths"].items():
        assert row["lm_iterations_per_s"] > 0 and f"{label:44s}: " in out
    recs = bench_scaling.main(["--sizes", "24x3,32x4", "--chain", "1",
                               *TINY])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["points"], r["window"]) for r in lines] == [(24, 3), (32, 4)]
    assert lines == json.loads(json.dumps(recs))
    assert all(r["lm_iterations_per_s"] > 0 for r in recs)


def test_bench_keyframes_runs_on_the_cpu(capsys):
    rec = bench_keyframes.main(["--frames", "8", "--height", "48",
                                "--width", "96", "--device", "cpu"])
    assert last_json_of(capsys.readouterr().out) == rec
    assert rec["metric"] == "keyframes_per_s_end_to_end"
    assert rec["value"] > 0 and rec["steps_timed"] == 2


# -- the host tools -------------------------------------------------------

def test_eval_traj_prints_what_the_jax_script_prints(tmp_path, capsys):
    """tests/test_tools.py's pose files: the same JSON lines within 1e-9."""
    p = _make_traj_files(str(tmp_path))
    args = [p["est"], p["gt"], p["init"]]
    eval_traj.main(args)
    port = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    ref = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "eval_traj.py"),
                          *args], env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = [json.loads(x) for x in ref.stdout.splitlines()]
    assert [r["trajectory"] for r in port] == ["initialization", "refined"]
    assert [sorted(r) for r in port] == [sorted(r) for r in want]
    for got, exp in zip(port, want):
        for key, value in exp.items():
            if key == "trajectory":
                assert got[key] == value
            else:
                assert abs(got[key] - value) <= 1e-9, (key, got, exp)
    assert port[1]["ate_rmse_m"] < port[0]["ate_rmse_m"]


def test_plot_traj_writes_a_png(tmp_path):
    p = _make_traj_files(str(tmp_path))
    jsonl = str(tmp_path / "solve.jsonl")
    with open(jsonl, "w") as f:
        for i in (5, 6, 7):
            f.write(json.dumps({
                "frame": i, "initial_cost": 10.0 / i, "final_cost": 5.0 / i,
                "trans_correction": [0.01 * i, 0.02 * i]}) + "\n")
    out = str(tmp_path / "traj.png")
    assert plot_traj.main([p["est"], p["gt"], p["init"], "--jsonl", jsonl,
                           "--out", out]) == 0
    assert os.path.getsize(out) > 10_000
    out2 = str(tmp_path / "traj2.png")
    assert plot_traj.main([p["est"], p["gt"], "--out", out2]) == 0
    assert os.path.getsize(out2) > 10_000


def test_verify_e2e_sequence_is_the_jax_scripts(tmp_path):
    """verify_e2e's sequence and VO input are tools/verify_e2e.py's draws
    (numpy seed 3, tests/synthetic.py's renderer, the JAX se3_exp)."""
    import jax.numpy as jnp
    import synthetic as jsyn
    from photobundle_tpu.geometry import se3 as jse3
    from photobundle_tpu.geometry.camera import Camera

    root = str(tmp_path / "seq")
    poses, vo = verify_e2e.write_sequence(root)
    rng = np.random.default_rng(3)
    h, w, fx, base = verify_e2e.H, verify_e2e.W, verify_e2e.FX, verify_e2e.BASE
    cam = Camera.create(fx=fx, fy=fx, cx=w / 2 - 0.5, cy=h / 2 - 0.5,
                        baseline=base)
    tex = jsyn.make_texture(rng)
    want = []
    t_wc = np.eye(4, dtype=np.float32)
    for _ in range(verify_e2e.NF):
        want.append(t_wc.copy())
        xi = np.concatenate([
            rng.standard_normal(3) * 0.05 + np.array([0.05, 0, 0]),
            rng.standard_normal(3) * 0.002]).astype(np.float32)
        t_wc = (t_wc @ np.asarray(jse3.se3_exp(jnp.asarray(xi)))).astype(
            np.float32)
    want = np.stack(want)
    np.testing.assert_allclose(poses, want, atol=1e-6)
    for i in (0, verify_e2e.NF - 1):
        pr = want[i].copy()
        pr[:3, 3] = want[i][:3, 3] + want[i][:3, :3] @ np.array([base, 0, 0])
        for sub, pose in (("image_0", want[i]), ("image_1", pr)):
            img, _ = jsyn.render_view(tex, cam, pose, (h, w))
            got = png.read_png_gray(os.path.join(
                root, "sequences", "00", sub, f"{i:06d}.png"))
            diff = np.abs(got.astype(int) - np.clip(img * 255, 0, 255)
                          .astype(np.uint8).astype(int))
            assert diff.max() <= 1 and np.mean(diff > 0) < 1e-3, (i, sub)
    np.testing.assert_allclose(
        vo, jsyn.drift_poses(rng, want, trans_sigma=0.004,
                             rot_sigma=0.0008), atol=1e-5)
    with open(os.path.join(root, "run.cfg")) as f:
        cfg = f.read()
    assert f"dataDir = {root}\n" in cfg and "maxIterations = 25\n" in cfg


def test_verify_e2e_check(tmp_path):
    """The script's assertions on a finished run: a refined ATE below the
    input's and non-increasing window costs pass; a window whose cost
    rose fails."""
    root = str(tmp_path)
    poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    poses[:, 0, 3] = np.arange(6) * 0.1
    vo = poses.copy()
    vo[2:, 1, 3] += 0.02
    entry.write_poses(os.path.join(root, "refined.txt"), poses)

    def log(costs):
        with open(os.path.join(root, "solve.jsonl"), "w") as f:
            for c0, c1 in costs:
                f.write(json.dumps({"initial_cost": c0, "final_cost": c1})
                        + "\n")

    log([(2.0, 1.0), (1.5, 1.5)])
    rec = verify_e2e.check(root, poses, vo)
    assert rec["ate_refined"] < rec["ate_init"] and rec["windows"] == 2
    log([(2.0, 1.0), (1.5, 1.6)])
    with pytest.raises(AssertionError, match="verification failed"):
        verify_e2e.check(root, poses, vo)


def test_kernel_times_imports_each_tree(tmp_path):
    """kernel_times.py times the checkout each TREE names: `use_tree`
    imports that tree's `photobundle_torch`, not the package chip_smoke.py
    imported at its top (which every tree timed before the repair)."""
    saved_path = list(sys.path)
    saved = {k: v for k, v in sys.modules.items()
             if k == "photobundle_torch" or k.startswith("photobundle_torch.")}
    tree = tmp_path / "tree"
    (tree / "photobundle_torch").mkdir(parents=True)
    (tree / "photobundle_torch" / "__init__.py").write_text("TREE = 1\n")
    try:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import kernel_times

        package = kernel_times.use_tree(str(tree))
        assert package.TREE == 1
        assert package.__file__ == str(tree / "photobundle_torch" /
                                       "__init__.py")
        with pytest.raises(RuntimeError, match="imported photobundle_torch"):
            kernel_times.use_tree(str(tmp_path / "empty"))
    finally:
        for name in [m for m in sys.modules if m == "photobundle_torch"
                     or m.startswith("photobundle_torch.")]:
            del sys.modules[name]
        sys.modules.update(saved)
        sys.path[:] = saved_path
