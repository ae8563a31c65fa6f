"""photobundle_torch.bench, the port's twin of bench.py, on the CPU at a
tiny shape: one JSON line with bench.py's keys."""

import json

import pytest
import torch

from photobundle_torch import bench
from torch_parity import few_threads  # noqa: F401  (autouse fixture)

TINY = ["--device", "cpu", "--points", "24", "--frames", "3", "--height",
        "40", "--width", "64", "--chain", "2"]


def test_bench_prints_one_json_line_on_the_cpu(capsys):
    bench.main(TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= record.keys()
    assert record["metric"] == "BA_iterations_per_s_kitti_scale_window"
    assert record["value"] > 0 and record["vs_baseline"] > 0
    assert record["unit"].startswith("LM iterations/s (24 pts x 3 frames "
                                     "x 5x5 patches, 40x64)")
    assert record["device"] == "cpu"


def test_bench_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no"):
        bench.main(TINY[2:])
