"""Batched Cholesky factor-and-solve of the reduced camera systems
(csrc/chol_solve.cu): core/schur.py `solve_reduced`.

    chol_solve(s (..., n, n), b (..., n)) -> x (..., n),  s x = b

s is symmetric positive definite with its jitter already added (the
solve adds 1e-8 I). A system whose factorization fails gets NaN in all of
its x, as cho_factor's NaN does in the JAX package, so its LM step is
rejected; no other system is touched and nothing is read back.

No TPU kernel stands behind it: the JAX package solves with XLA's
cho_factor / cho_solve (photobundle_tpu/core/schur.py:282-283). It was
added because torch's batched cholesky_solve on a card goes through
MAGMA, which allocates and so cannot be captured in a CUDA graph, and
because cuSOLVER's batched and single-matrix code differ: every sum in a
fixed order makes each system's x independent of the batch.

`chol_solve` launches the kernel for tensors on a card and runs
`chol_solve_reference` (torch.linalg.cholesky_ex and cholesky_solve) for
tensors on the CPU; a CUDA tensor gets the kernel or an exception.
`chol_solve.launches` counts launches by mode (`mode(n, dtype)`: 'warp'
for n <= WARP_N, a warp per system; 'shared' for n <= MAX_SHARED of the
dtype, a block per system in shared memory; 'global' above, the same in
a global scratch). The mode depends on n and the dtype alone, and every
mode gives each system the same operations in the same order.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import count_launch, reset_launches

MODES = ("warp", "shared", "global")
# csrc/chol_solve.cu kWarpN: the largest n a warp solves (6W for W <= 5);
# kMaxShared: the largest n solved in shared memory (f32: 6W for W <= 40;
# f64: W <= 28).
WARP_N = 32
MAX_SHARED = {torch.float32: 240, torch.float64: 168}
DTYPES = (torch.float32, torch.float64)


def mode(n: int, dtype: torch.dtype) -> str:
    """The kernel's path for systems of n unknowns: a function of n and
    the dtype alone, never of the batch."""
    if n <= WARP_N:
        return "warp"
    return "shared" if n <= MAX_SHARED[dtype] else "global"


def chol_solve_reference(s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: cholesky_ex, NaN where the factor failed,
    cholesky_solve."""
    chol, info = torch.linalg.cholesky_ex(s)
    chol = torch.where((info == 0)[..., None, None], chol, torch.nan)
    return torch.cholesky_solve(b[..., None], chol)[..., 0]


def _kernel():
    built = _build.library("chol_solve")
    fn = built.lib.pb_chol_solve            # ctypes caches the attribute
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = built.lib.pb_chol_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def chol_solve(s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = s^{-1} b for each system of the leading axes: the kernel for f32
    or f64 tensors on a card (on the current stream, without
    synchronising; raises if it cannot launch), `chol_solve_reference` on
    the CPU."""
    n = s.shape[-1]
    if s.shape[-2] != n or b.shape != s.shape[:-1]:
        raise ValueError(f"chol_solve takes (..., n, n) and (..., n), not "
                         f"{tuple(s.shape)} and {tuple(b.shape)}")
    if s.device.type == "cpu":
        return chol_solve_reference(s, b)
    if s.device.type != "cuda":
        raise ValueError(f"chol_solve runs on cpu or cuda tensors, not "
                         f"{s.device}")
    if s.dtype not in DTYPES or b.dtype != s.dtype or b.device != s.device:
        raise ValueError(f"chol_solve takes f32 or f64 on one card, not "
                         f"{s.dtype} on {s.device} and {b.dtype} on "
                         f"{b.device}")
    lead = s.shape[:-2]
    s3 = s.reshape(-1, n, n).contiguous()
    b2 = b.reshape(-1, n).contiguous()
    g = s3.shape[0]
    x = torch.empty((g, n), dtype=s.dtype, device=s.device)
    path = mode(n, s.dtype)
    scratch = torch.empty_like(s3) if path == "global" else None
    lib = _kernel()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.pb_chol_solve(s3.data_ptr(), b2.data_ptr(), x.data_ptr(),
                                0 if scratch is None else scratch.data_ptr(),
                                g, n, DTYPES.index(s.dtype), stream)
    if err != 0:
        msg = lib.pb_chol_error_string(err).decode()
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    count_launch(chol_solve, path)
    return x.reshape(*lead, n)


reset_launches(chol_solve, MODES)
