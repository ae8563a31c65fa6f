"""What the LM body's own kernels' wrappers decide in Python, on the CPU
(ops/ordered_sum, ops/chol_solve; the kernels themselves run on a card
alone, tests/test_torch_cuda.py):

- the order of an ordered sum is a function of its length alone, and the
  wrapper's scratch a function of the length and the number of outputs;
- the Cholesky kernel's path is a function of n and the dtype alone;
- the constants the wrappers plan with are the CUDA sources' own;
- the ordered sums' kernel-order twin (`row_dot_ordered`) within 1e-5 of
  the plain version's sums of |terms|, each output its rows' alone, each
  window of a batch its own call.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from photobundle_torch.ops import chol_solve as cs
from photobundle_torch.ops import ordered_sum as osm

from torch_parity import few_threads  # noqa: F401  (module fixture)

CSRC = Path(osm.__file__).resolve().parents[1] / "csrc"
ORDERED_RTOL = 1e-5


def constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / source).read_text()).group(1))


def test_wrapper_constants_are_the_kernels():
    assert constant("ordered_sum.cu", "kThreadRow") == osm.THREAD_ROW
    assert constant("ordered_sum.cu", "kChunk") == osm.CHUNK
    assert constant("chol_solve.cu", "kWarpN") == cs.WARP_N
    shared = re.search(r"kMaxShared = sizeof\(T\) == 4 \? (\d+) : (\d+);",
                       (CSRC / "chol_solve.cu").read_text())
    assert (int(shared.group(1)), int(shared.group(2))) == (
        cs.MAX_SHARED[torch.float32], cs.MAX_SHARED[torch.float64])


@pytest.mark.parametrize("k, want", [
    (1, ("thread", 1)), (64, ("thread", 64)), (65, ("chunks", 1)),
    (1023, ("chunks", 1)), (1024, ("chunks", 1)), (1025, ("chunks", 2)),
    (12288, ("chunks", 12)), (3 * 65536, ("chunks", 192))])
def test_ordered_sum_order_depends_on_k_alone(k, want):
    """The order and, per output, the scratch: the same for any count of
    outputs (a batch, a tile, one row pair)."""
    assert osm.order(k) == want
    per_output = want[1] if want[0] == "chunks" and want[1] > 1 else 0
    for outputs in (1, 36, 900, 4 * 900):
        assert osm.scratch_elements(k, outputs) == per_output * outputs


def test_chol_path_depends_on_n_alone():
    for dtype in cs.DTYPES:
        paths = [cs.mode(n, dtype) for n in range(1, 400)]
        limit = cs.MAX_SHARED[dtype]
        assert paths == (["warp"] * cs.WARP_N
                         + ["shared"] * (limit - cs.WARP_N)
                         + ["global"] * (399 - limit))
    assert [cs.mode(6 * w, torch.float32) for w in (1, 5, 6, 40, 41)] == [
        "warp", "warp", "shared", "shared", "global"]


@pytest.mark.parametrize("k", [5, 64, 65, 1023, 1024, 1025, 2100])
@pytest.mark.parametrize("dot", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_twin_matches_plain_version(few_threads, k, dot, dtype):
    rng = np.random.default_rng(k)
    a = torch.as_tensor(rng.standard_normal((3, 4, k)), dtype=dtype)
    c = (torch.as_tensor(rng.standard_normal((3, 2, k)), dtype=dtype)
         if dot else None)
    got = osm.row_dot_ordered(a, c)
    want = osm.row_dot_reference(a, c)
    mag = osm.row_dot_reference(a.abs(), None if c is None else c.abs())
    assert got.shape == want.shape
    rtol = ORDERED_RTOL if dtype == torch.float32 else 1e-13
    assert bool(((got - want).abs() <= rtol * mag).all())
    # Window 1 alone, and one of its outputs alone.
    assert torch.equal(osm.row_dot_ordered(a[1], None if c is None
                                           else c[1]), got[1])
    if c is None:
        assert torch.equal(osm.row_dot_ordered(a[1, 2:3]), got[1, 2:3])
    else:
        assert torch.equal(osm.row_dot_ordered(a[1, 2:3], c[1, 1:2]),
                           got[1, 2:3, 1:2])
