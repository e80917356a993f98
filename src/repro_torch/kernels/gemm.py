"""C = A @ B on the hand-written Hopper kernel (``csrc/gemm.cu``).

The counterpart of ``repro/kernels/gemm.py`` (the Pallas ``gemm``).  A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, :func:`gemm_plain`, which the CPU tests use and the chip check
compares the kernel with.  The kernel masks ragged edges itself, so the
wrapper neither pads nor crops.

Each operand is a 2-D matrix or a 3-D batch of them, row-major or a
transposed view (:func:`layout`), with any row stride: ``table.mT`` and
views of a larger matrix go in uncopied.  :func:`plan` picks the kernel's
path from the dtype, M and the operands' alignment (see ``csrc/gemm.cu``)
and, for path 2, how many ways K is split.

:func:`gemm_grad` is the product inside autograd, for training: a
``torch.library`` custom op whose backward runs the kernel twice more,
``dA = dC B^T`` and ``dB = A^T dC``, on transposed views of the saved
operands (per-operand transpose flags, no copies; only an incoming
gradient whose rows path 1 cannot read is copied, :func:`_matrix`).
The JAX package writes no backward kernel (no ``custom_vjp`` under
``repro/kernels``): ``jax.grad`` derives one from the ``pallas_call``.
Here both backward products are this kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import compat, ref

#: products launched on the card since the last reset (one per call)
launches = 0
#: second launches that sum path 2's split-K partials
reduce_launches = 0

#: dtype codes of csrc/gemm.cu (also csrc/trsm.cu for the first two)
CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
         torch.float16: 3}
#: output dtypes the kernel writes for each input dtype
OUT_DTYPES = {torch.float32: (torch.float32,),
              torch.float64: (torch.float64,),
              torch.bfloat16: (torch.bfloat16, torch.float32),
              torch.float16: (torch.float16, torch.float32)}

#: the kernel's paths (csrc/gemm.cu)
TC, SKINNY, DMMA, SIMT = 1, 2, 3, 4
#: tile edges each tiled path compiles, default first: path 1's is the N
#: edge of its 128-row tile, paths 3 and 4 tile squares.  A nonzero
#: ``block`` (OffloadConfig.kernel_block) picks one of EDGES.
EDGES = (64, 128)
DEFAULT_TILE = {TC: 256, DMMA: 128, SIMT: 128}
#: path 2: columns a block covers (row-major B: 128-column strips;
#: K-contiguous B: 8 warps x 4 columns), and the blocks it aims for before
#: splitting K (4 per SM of 132), each split keeping at least 128 of K
SKINNY_COLS = {False: 128, True: 32}
SKINNY_TARGET_BLOCKS = 4 * 132
SKINNY_MIN_K = 128

_c_ll = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _c_ll, _c_ll, _c_ll, ctypes.c_int, _c_ll, _c_ll, _c_ll,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


class Plan(NamedTuple):
    path: int
    tile: int       # tile edge of paths 1, 3, 4 (0 for path 2)
    splits: int     # path 2's K split (1 elsewhere)


def reset_launches() -> None:
    global launches, reduce_launches
    launches = 0
    reduce_launches = 0


_ENTRY = []


def _entry():
    """The C entry, bound once: a decode step calls it 295 times."""
    if not _ENTRY:
        fn = compat.library("gemm").repro_gemm
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same product with the
    same accumulation rule (f32 for bf16/f16/f32, f64 for f64)."""
    return ref.matmul(a, b, out_dtype)


def layout(x: torch.Tensor) -> Optional[Tuple[bool, int]]:
    """``(trans, ld)`` of a matrix (the last two dims) the kernel reads
    uncopied, or None.  ``trans`` False: row-major, element (i, j) at
    ``i * ld + j``; True: a transposed view, at ``j * ld + i``.  Rows (or
    columns) may be any distance apart, as long as they do not overlap; a
    stack of matrices must not overlap either.  ``ld`` of a single row
    (column) is its length rounded up to 8, which no load reads but the
    tensor-core path's descriptors need aligned."""
    r, c = x.shape[-2], x.shape[-1]
    sr, sc = x.stride(-2), x.stride(-1)
    out = None
    if (c <= 1 or sc == 1) and (r <= 1 or sr >= c):
        out = (False, sr if r > 1 else -(-c // 8) * 8)
    elif (r <= 1 or sr == 1) and (c <= 1 or sc >= r):
        out = (True, sc if c > 1 else -(-r // 8) * 8)
    if out is not None and x.dim() == 3 and x.shape[0] > 1 \
            and x.stride(0) < r * c:
        return None
    return out


def row_major(x: torch.Tensor) -> bool:
    """The layout the trsm and syrk kernels read: a unit column stride and
    rows that do not overlap (any row stride)."""
    return ((x.shape[-1] <= 1 or x.stride(-1) == 1)
            and (x.shape[-2] <= 1 or x.stride(-2) >= x.shape[-1]))


def _check_block(block: int) -> int:
    if block and block not in EDGES:
        raise ValueError(f"gemm: kernel_block {block} is not a tile edge the "
                         f"kernel compiles; choose 0 (each path's default) "
                         f"or one of {EDGES}")
    return int(block)


def _tma_ok(x: torch.Tensor, ld: int) -> bool:
    """Whether path 1's TMA can describe a 16-bit operand: 16-byte aligned
    base, row stride and batch stride."""
    if x.data_ptr() % 16 or ld % 8:
        return False
    return not (x.dim() == 3 and x.shape[0] > 1 and x.stride(0) % 8)


def plan(a: torch.Tensor, b: torch.Tensor, block: int = 0) -> Plan:
    """The path csrc/gemm.cu takes for ``a @ b`` (layouts from
    :func:`layout`, which must not be None), its tile edge and path 2's K
    split.  Pure arithmetic on shapes, strides and addresses, so the CPU
    tests reach it."""
    return _plan(a, b, layout(a), layout(b), _check_block(block))


def _plan(a, b, lay_a, lay_b, block: int) -> Plan:
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if a.dtype == torch.float64:
        return Plan(DMMA, block or DEFAULT_TILE[DMMA], 1)
    if a.dtype == torch.float32:
        return Plan(SIMT, block or DEFAULT_TILE[SIMT], 1)
    (_, lda), (tb, ldb) = lay_a, lay_b
    if m >= 64 and k >= 1 and _tma_ok(a, lda) and _tma_ok(b, ldb):
        return Plan(TC, block or DEFAULT_TILE[TC], 1)
    # groups of 1, 2, 4 or 8 rows run side by side, beside the K split
    rows = 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8
    batch = a.shape[0] if a.dim() == 3 else 1
    blocks = -(-n // SKINNY_COLS[tb]) * batch * -(-m // rows)
    splits = 1
    if blocks < SKINNY_TARGET_BLOCKS // 2:
        splits = max(1, min(-(-SKINNY_TARGET_BLOCKS // blocks),
                            k // SKINNY_MIN_K))
    return Plan(SKINNY, 0, splits)


def _check_matrix(x: torch.Tensor, name: str) -> Tuple[bool, int]:
    if x.dim() not in (2, 3):
        raise ValueError(f"gemm: {name} must be 2-D or 3-D (batched), "
                         f"got shape {tuple(x.shape)}")
    lay = layout(x)
    if lay is None:
        raise ValueError(f"gemm: {name} is neither row-major nor a "
                         f"transposed view with non-overlapping rows "
                         f"(strides {x.stride()}); pass .contiguous()")
    return lay


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: Optional[torch.dtype] = None,
         block: int = 0) -> torch.Tensor:
    """C = A @ B.  ``a`` is [M, K] or [batch, M, K], ``b`` [K, N] or
    [batch, K, N] (both 2-D or both 3-D), each row-major or a transposed
    view with any row stride (:func:`layout`).  ``out_dtype`` defaults to
    the input dtype.  ``block`` (OffloadConfig.kernel_block) picks the
    tile edge of paths 1, 3 and 4 from :data:`EDGES`; a value the kernel
    does not compile raises ``ValueError``.  It changes no result, and on
    CPU tensors it is inert.  Where an operand takes a gradient, the call
    goes through :func:`gemm_grad`; elsewhere it is the launch alone: the
    operator's dispatch adds 23-41 us of host time a call on the H100
    (``PERF.md``), which a decode step would pay on each product."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        if out_dtype not in (None, a.dtype):
            raise TypeError(f"gemm: out_dtype {out_dtype} has no gradient; "
                            f"the product's output takes the inputs' dtype")
        return gemm_grad(a, b, block)
    return _gemm(a, b, out_dtype=out_dtype, block=block)


def _gemm(a: torch.Tensor, b: torch.Tensor, *,
          out_dtype: Optional[torch.dtype] = None,
          block: int = 0) -> torch.Tensor:
    """The kernel's launch (CUDA tensors) or its plain version (CPU)."""
    block = _check_block(block)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_plain(a, b, out_dtype=out_dtype)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"gemm: operands on {a.device} and {b.device}; "
                         f"both must be on one CUDA device")
    if a.dtype != b.dtype or a.dtype not in CODES:
        raise TypeError(f"gemm: kernel takes matching float32, float64, "
                        f"bfloat16 or float16 operands, got {a.dtype} and "
                        f"{b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in OUT_DTYPES[a.dtype]:
        raise TypeError(f"gemm: {a.dtype} inputs cannot write {out_dtype}")
    ta, lda = _check_matrix(a, "A")
    tb, ldb = _check_matrix(b, "B")
    if a.dim() != b.dim() or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    batched = a.dim() == 3
    if batched and a.shape[0] != b.shape[0]:
        raise ValueError(f"gemm: batch sizes {a.shape[0]} and {b.shape[0]}")
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    batch = a.shape[0] if batched else 1
    out = torch.empty((batch, m, n) if batched else (m, n),
                      dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    p = _plan(a, b, (ta, lda), (tb, ldb), block)
    work = None
    if p.splits > 1:
        work = torch.empty(p.splits * batch * m * n, dtype=torch.float32,
                           device=a.device)
    compat.count(globals(), launches=1, reduce_launches=int(p.splits > 1))
    sa = a.stride(0) if batched else 0
    sb = b.stride(0) if batched else 0
    sc = out.stride(0) if batched else 0
    rc = _entry()(CODES[a.dtype], CODES[out_dtype], p.path, p.tile, p.splits,
                  a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  work.data_ptr() if work is not None else None, m, n, k,
                  lda, ldb, out.stride(-2), batch, sa, sb, sc, int(ta),
                  int(tb), torch.cuda.current_stream(a.device).cuda_stream)
    compat.check(rc, "gemm")
    return out


# ---------------------------------------------------------------------------
# the product inside autograd
# ---------------------------------------------------------------------------
def _matrix(x: torch.Tensor) -> torch.Tensor:
    """An incoming gradient as the backward products read it: ``x``
    itself where the kernel reads its layout (and, in 16 bits, path 1's
    TMA can describe it), else a copy into rows padded to a multiple of
    8 elements.  The odd vocab head's dC (whisper-tiny's row stride
    51865) would put dA and dB on path 2; the copy puts both on path 1
    (28.9 ms against 1.24 ms with the copy on the H100: ``PERF.md``)."""
    lay = layout(x)
    if lay is not None and (x.element_size() != 2 or _tma_ok(x, lay[1])):
        return x
    n = x.shape[-1]
    out = x.new_empty(x.shape[:-1] + (-(-n // 8) * 8,))[..., :n]
    return out.copy_(x)


@torch.library.custom_op("repro_torch::gemm", mutates_args=())
def gemm_grad(a: torch.Tensor, b: torch.Tensor, block: int) -> torch.Tensor:
    """:func:`gemm` as an operator autograd differentiates (and selective
    activation checkpointing can name: ``train.loop``'s ``remat="dots"``
    saves its outputs)."""
    return _gemm(a, b, block=block)


def _gemm_setup(ctx, inputs, output) -> None:
    a, b, block = inputs
    ctx.save_for_backward(a, b)
    ctx.block = block


def _gemm_backward(ctx, grad: torch.Tensor):
    """One kernel launch per operand that takes a gradient."""
    a, b = ctx.saved_tensors
    grad = _matrix(grad)
    da = db = None
    if ctx.needs_input_grad[0]:
        da = _gemm(grad, b.mT, block=ctx.block)
    if ctx.needs_input_grad[1]:
        db = _gemm(a.mT, grad, block=ctx.block)
    return da, db, None


gemm_grad.register_autograd(_gemm_backward, setup_context=_gemm_setup)


@gemm_grad.register_fake
def _gemm_fake(a: torch.Tensor, b: torch.Tensor, block: int) -> torch.Tensor:
    """The product's shape and dtype without computing it (fake and meta
    tensors: the dry run's sharding propagation)."""
    return a.new_empty(a.shape[:-1] + b.shape[-1:])
