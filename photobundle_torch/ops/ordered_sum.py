"""Sums and dot products along the last axis whose order depends on the
length alone: the reductions of the LM body (csrc/ordered_sum.cu).

    row_dot(a, c)   (..., P, K), (..., Q, K) -> (..., P, Q)
                    out[..., p, q] = sum_k a[..., p, k] * c[..., q, k]
    row_dot(a)      (..., P, K) -> (..., P), the sums of a's rows

A batched window solve runs one LM body over a leading batch axis, and
each window must round as its own solve does (core/lm.py). torch's
reductions on a card choose their split over threads and blocks by the
number of outputs, and cuBLAS its kernel by the batch count, so their
results for window b change with B. The kernel sums every output in an
order fixed by K (`order(k)`): up to THREAD_ROW terms in turn; above, in
chunks of CHUNK terms, each chunk as 32 lane sums (lane s the terms s, s
+ 32, ... in turn) added as a warp's xor butterfly, the chunk sums then
in chunk order. So each output depends on its own row alone, whatever the
batch, the tile it falls in or the blocks a chunk range is split over.
`row_dot_ordered` writes that order out in torch operations (the kernel's
twin: bitwise its results, in f32 and f64; no main path runs it). Sums
are taken in the operands' type, f32 or f64, as XLA takes the JAX
package's. No TPU kernel stands behind it: the JAX package leaves these
sums to XLA (photobundle_tpu/core/schur.py:134, 246).

`row_dot` launches the kernel for f32 or f64 tensors on a card and runs
`row_dot_reference` for tensors on the CPU; a CUDA tensor gets the kernel
or an exception. The plain version is the products, then torch's sum
over the last axis: on the CPU each row's result depends on the row
alone, but for a single row of 2^15 or more terms, which torch's sum
splits over threads. `contract` is `row_dot` for the contractions the
single window wrote as einsums (the Schur terms, the pose blocks): the
same kernel on a card, and on the CPU a matrix product (MKL) window by
window (`row_dot_matmul`), so the CPU rounds them as that window did.
`row_dot.launches` counts launches by mode ('sum', 'dot').
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import count_launch, reset_launches

MODES = ("sum", "dot")
# csrc/ordered_sum.cu kThreadRow and kChunk: the order's constants.
THREAD_ROW = 64
CHUNK = 1024
LANES = 32


def order(k: int) -> tuple:
    """The order of a sum of k terms, a function of k alone: ('thread',
    k) for k <= THREAD_ROW (the terms in turn), else ('chunks', n) for n
    chunks of CHUNK terms (the last one shorter), each summed by LANES
    lanes and a butterfly, then added in chunk order."""
    if k <= THREAD_ROW:
        return ("thread", k)
    return ("chunks", -(-k // CHUNK))


def scratch_elements(k: int, outputs: int) -> int:
    """Elements of the chunk sums' scratch the kernel may write for
    `outputs` sums of k terms (0 where a sum is one chunk or fewer)."""
    how, n = order(k)
    return n * outputs if how == "chunks" and n > 1 else 0


def row_dot_reference(a: torch.Tensor, c: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain PyTorch version: the products, then torch's sum over the
    last axis."""
    if c is None:
        return a.sum(-1)
    return (a[..., :, None, :] * c[..., None, :, :]).sum(-1)


def row_dot_ordered(a: torch.Tensor, c: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """The kernel's order written out in torch operations, each product and
    each sum one rounding: bitwise the kernel where those operations round
    as the card's (any device; the products' (..., P, Q, K) tensor is
    formed whole, so small shapes or the card)."""
    t = a if c is None else a[..., :, None, :] * c[..., None, :, :]
    k = t.shape[-1]
    how, n = order(k)
    if how == "thread":
        out = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for i in range(k):
            out = out + t[..., i]
        return out
    t = torch.nn.functional.pad(t, (0, n * CHUNK - k))
    t = t.unflatten(-1, (n, CHUNK // LANES, LANES))    # chunk, step, lane
    lanes = torch.zeros((*t.shape[:-3], n, LANES), dtype=t.dtype,
                        device=t.device)
    for j in range(CHUNK // LANES):
        lanes = lanes + t[..., j, :]
    while lanes.shape[-1] > 1:                          # 16 apart, 8, ...
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    out = lanes[..., 0, 0]
    for i in range(1, n):
        out = out + lanes[..., i, 0]
    return out


def _matmul(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a @ c^T over a's and c's matrices ((H, P, K) or (P, K)), c^T laid
    out contiguous as the single window's einsums laid out the operand."""
    return torch.matmul(a, c.transpose(-1, -2).clone(
        memory_format=torch.contiguous_format))


@torch.library.custom_op("photobundle::row_dot_matmul", mutates_args=(),
                         device_types="cpu")
def row_dot_matmul(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`contract`'s plain version: (..., P, K) x (..., Q, K) ->
    (..., P, Q) by torch.matmul (MKL). The last leading axis (if any)
    stays the product's batch, as in the single window's call, and the
    product runs once per entry of the axes before it: on more than one
    thread, MKL rounds a product of one matrix otherwise than the same
    matrix in a batch of several, so one product over B windows would
    not round each window as its own call does. Registered as one
    operator, as its kernel is one launch on a card."""
    if a.dim() <= 3:
        return _matmul(a, c)
    a3 = a.reshape(-1, *a.shape[-3:])
    c3 = c.reshape(-1, *c.shape[-3:])
    out = torch.stack([_matmul(x, y) for x, y in zip(a3, c3)])
    return out.reshape(*a.shape[:-1], c.shape[-2])


def _kernel():
    built = _build.library("ordered_sum")
    fn = built.lib.pb_row_dot               # ctypes caches the attribute
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.POINTER(ctypes.c_longlong)] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.pb_row_dot_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def _as4(t: torch.Tensor) -> torch.Tensor:
    """(..., R, K) -> (G, H, R, K): the first leading axis (the batch) kept,
    the others merged (a view where they merge: whether they do depends on
    them alone, not on the batch, so the operations run do not either)."""
    lead = t.shape[:-2]
    if not lead:
        return t[None, None]
    if len(lead) == 1:
        return t[:, None]
    return t.reshape(lead[0], -1, *t.shape[-2:])


def row_dot(a: torch.Tensor, c: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Sums along the last axis in a fixed order: (..., P) for c None, else
    (..., P, Q) dot products of a's and c's rows (equal leading axes). f32
    or f64 on a card (on the current stream, without synchronising; raises
    if it cannot launch); `row_dot_reference` on the CPU."""
    if c is not None and a.shape[:-2] != c.shape[:-2]:
        raise ValueError(f"row_dot: leading axes {tuple(a.shape[:-2])} and "
                         f"{tuple(c.shape[:-2])} differ")
    if c is not None and a.shape[-1] != c.shape[-1]:
        raise ValueError(f"row_dot: rows of {a.shape[-1]} and "
                         f"{c.shape[-1]} terms")
    if a.device.type == "cpu":
        return row_dot_reference(a, c)
    if a.device.type != "cuda":
        raise ValueError(f"row_dot runs on cpu or cuda tensors, not "
                         f"{a.device}")
    dtypes = (torch.float32, torch.float64)
    for name, t in (("a", a), ("c", c)):
        if t is not None and (t.dtype not in dtypes or t.dtype != a.dtype
                              or t.device != a.device):
            raise ValueError(f"row_dot: {name} must be f32 or f64 like a, "
                             f"on {a.device}; got {t.dtype} on {t.device}")
    lead, (p, k) = a.shape[:-2], a.shape[-2:]
    q = 1 if c is None else c.shape[-2]
    a4 = _as4(a)
    c4 = None if c is None else _as4(c)
    g, h = a4.shape[:2]
    out = torch.empty((g, h, p, q), dtype=a.dtype, device=a.device)
    if out.numel() and k == 0:
        return out.zero_().reshape(*lead, p, *(() if c is None else (q,)))
    n_part = scratch_elements(k, out.numel())
    part = (torch.empty(n_part, dtype=a.dtype, device=a.device) if n_part
            else None)
    lib = _kernel()
    dims = (ctypes.c_int * 5)(g, h, p, q, k)
    sa = (ctypes.c_longlong * 4)(*a4.stride())
    sc = (ctypes.c_longlong * 4)(*((0,) * 4 if c4 is None else c4.stride()))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.pb_row_dot(a4.data_ptr(), 0 if c4 is None else
                             c4.data_ptr(), out.data_ptr(),
                             0 if part is None else part.data_ptr(), dims,
                             sa, sc, dtypes.index(a.dtype), stream)
    if err != 0:
        msg = lib.pb_row_dot_error_string(err).decode()
        raise RuntimeError(f"row_dot kernel launch failed: CUDA error {err} "
                           f"({msg})")
    count_launch(row_dot, MODES[c is not None])
    return out.reshape(*lead, p, *(() if c is None else (q,)))


def contract(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., P, K) x (..., Q, K) -> (..., P, Q): `row_dot(a, c)` on a card,
    `row_dot_matmul` on the CPU."""
    if a.device.type == "cpu":
        return row_dot_matmul(a, c)
    return row_dot(a, c)


def sum_over(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """x summed over the axes `dims` (negative): on a card in `row_dot`'s
    order, those axes moved last in the order given; on the CPU torch's
    sum over them, whose order per output depends on the axes' sizes and
    strides alone."""
    if x.device.type == "cpu":
        return x.sum(dims)
    moved = x.movedim(dims, tuple(range(-len(dims), 0)))
    return row_dot(moved.flatten(-len(dims))[..., None, :])[..., 0]


def row_sum(x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """The sum over the last `dims` axes of x, in `row_dot`'s order
    (those axes flattened, in memory order of a contiguous tensor)."""
    lead = x.shape[:x.dim() - dims]
    return row_dot(x.reshape(*lead, 1, -1))[..., 0]


reset_launches(row_dot, MODES)
