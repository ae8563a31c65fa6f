"""photobundle_torch stands alone: importing it loads neither jax nor the
JAX package, and no module of it imports them."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "photobundle_torch"
# The twins of the repository's tools/ scripts and tests/synthetic.py's
# golden half.
NEW_TOOLS = ("bench_lm_breakdown", "probe_eval65k", "eval_traj",
             "verify_e2e", "synthetic", "golden_kitti", "golden_aggregate",
             "diagnose_rpe", "diagnose_w5", "bench_keyframes",
             "bench_sampling", "bench_scaling", "plot_traj")


def test_import_loads_no_jax():
    code = ("import sys, photobundle_torch, photobundle_torch.entry, "
            "photobundle_torch.convert, photobundle_torch.ops._build, "
            "photobundle_torch.bench, "
            "photobundle_torch.config, photobundle_torch.core.engine, "
            "photobundle_torch.cli, photobundle_torch.io.kitti, "
            "photobundle_torch.io.png, photobundle_torch.io.speckle, "
            "photobundle_torch.io.trajectory, photobundle_torch.image.stereo, "
            "photobundle_torch.utils.logging, photobundle_torch.utils.timer, "
            "photobundle_torch.core.batched, photobundle_torch.multi, "
            "photobundle_torch.parallel, "
            "photobundle_torch.parallel.mesh, "
            "photobundle_torch.parallel.sharded, "
            "photobundle_torch.tools.bench_batched, "
            "photobundle_torch.tools.comm_model, "
            "photobundle_torch.tools.demo_multiprocess, "
            "photobundle_torch.tools.bench_multihost, "
            "photobundle_torch.tools.validate_frames_sharding, "
            + ", ".join(f"photobundle_torch.tools.{m}" for m in NEW_TOOLS)
            + "; bad = [m for m in sys.modules if m in ('jax', 'synthetic', "
            "'tools') or m.startswith(('jax.', 'jaxlib', 'photobundle_tpu', "
            "'tools.'))]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_source_names_no_jax(path):
    """No module imports jax, the JAX package, the repository's tools/
    scripts or tests/synthetic.py, nor puts either directory on the
    import path."""
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|photobundle_tpu"
                         r"|tools|synthetic|tests|conftest)\b", text,
                         re.M), path
    assert not re.search(r"sys\.path\.(insert|append)", text), path


def test_every_tool_twin_is_scanned():
    scanned = {p.stem for p in (PKG / "tools").glob("*.py")}
    assert set(NEW_TOOLS) <= scanned


def test_import_sets_full_f32_matmul():
    import torch

    import photobundle_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
