"""photobundle_torch stands alone: importing it loads neither jax nor the
JAX package, and no module of it imports them."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "photobundle_torch"


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
            "photobundle_torch.tools.validate_frames_sharding; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'photobundle_tpu'))]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_source_names_no_jax(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|photobundle_tpu)\b",
                         text, re.M), path


def test_import_sets_full_f32_matmul():
    import torch

    import photobundle_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
