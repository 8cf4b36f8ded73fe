"""K1: int8 GEMM with the exact requantize epilogue, and K4's GEMM mode: the
same GEMM storing the int32 accumulator (port of
`tachikoma_tpu/ops/pallas/matmul_int8.py`, `_mm_kernel` and `_mm_kernel_raw`).

`qgemm_rq` and `qgemm_raw` are the kernels' wrappers: on a CUDA tensor they
launch `csrc/qgemm_rq.cu` / `csrc/qgemm_raw.cu` (or raise), on a CPU tensor
they run `qgemm_rq_plain` / `qgemm_raw_plain`, the plain PyTorch versions of
the same integers.  `qmatmul_int8` is the entry with the JAX package's
signature; it takes `blocks` (a compiled tile, `_lib.TILES`) or "xla", and
without them reads the tuning database's best record for the workload
(`matmul_workload`, the JAX package's key).  The record `{"impl": "xla"}`
keeps its JAX name: in the port it selects `qgemm_library`, the library
route (`torch._int_mm` on the card, then the exact epilogue in plain torch),
chosen only by a record or by the caller, never as a fallback.  K4 (no
multiplier) keeps its 64 x 64 tile and reads no record.

Zero points: the quantizer always produces wzp = 0; a nonzero input zero point
folds into the bias (acc(x - izp, w) = x.w - izp * colsum(w), exact in int32
wraparound arithmetic), so the kernel is a pure int8 GEMM.
"""

from __future__ import annotations

import torch

from ...tune.database import lookup_config
from ._lib import LAUNCHES, check_cuda_operands, compiled_blocks, launch, tile_params
from .requantize import channel_vector, epilogue_plain

_TONEAREST = {"UPWARD": 0, "TONEAREST": 1}


def matmul_workload(M: int, K: int, N: int, fused: bool) -> str:
    """Tuning-database key of a GEMM (`tachikoma_tpu/tune/tuner.py:28`)."""
    return f"qmatmul_int8/M{M}_K{K}_N{N}/{'fused' if fused else 'raw'}"


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> the int32 accumulator, through float64:
    every partial sum is an integer of magnitude <= K * 2^14 < 2^53, so the
    float64 product is exact in any summation order (torch has no integer
    matmul on CUDA, and on the CPU an int8 matmul wraps in int8)."""
    if a.shape[-1] >= 1 << 39:
        raise ValueError("reduction too deep for an exact float64 accumulator")
    acc = a.to(torch.float64) @ b.to(torch.float64)
    return acc.to(torch.int64).to(torch.int32)


def qgemm_rq_plain(x, w, bias, mult, shift, *, rq_izp=0, out_zp=0,
                   rounding="UPWARD", qmin=-128, qmax=127, blocks=None) -> torch.Tensor:
    """Plain PyTorch version of K1 (`blocks` is the kernel's tile: no effect)."""
    return epilogue_plain(exact_int_matmul(x, w), bias, mult, shift, rq_izp,
                          out_zp, rounding, qmin, qmax)


def qgemm_rq(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             mult: torch.Tensor, shift: torch.Tensor, *, rq_izp: int = 0,
             out_zp: int = 0, rounding: str = "UPWARD", qmin: int = -128,
             qmax: int = 127, blocks=None) -> torch.Tensor:
    """K1: clip(q_multiply_shift(x @ w + bias - rq_izp, mult, shift) + out_zp,
    qmin, qmax) -> int8 (M, N).  x int8 (M, K), w int8 (K, N), bias / mult /
    shift int32 (N,); blocks (BM, BN, 64) a compiled tile, default 64 x 64."""
    kw = dict(rq_izp=rq_izp, out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax)
    tile = tile_params(blocks)
    if x.device.type == "cpu":
        return qgemm_rq_plain(x, w, bias, mult, shift, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm_rq: no kernel for device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    i32 = torch.int32
    check_cuda_operands("qgemm_rq", x.device, x=(x, torch.int8, (m, k)),
                        w=(w, torch.int8, (k, n)), bias=(bias, i32, (n,)),
                        mult=(mult, i32, (n,)), shift=(shift, i32, (n,)))
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    launch("tk_qgemm_rq", [x, w, out, bias, mult, shift], dict(
        n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=n, oh=1, ow=1, sh=1, sw=1,
        rq_izp=rq_izp, out_zp=out_zp, qmin=qmin, qmax=qmax,
        tonearest=_TONEAREST[rounding],
        a_vec=k % 16 == 0 and x.data_ptr() % 16 == 0,
        b_vec=n % 4 == 0 and w.data_ptr() % 4 == 0, **tile))
    LAUNCHES["qgemm_rq"] += 1
    return out


def qgemm_library(x, w, bias, mult, shift, *, rq_izp=0, out_zp=0, rounding="UPWARD",
                  qmin=-128, qmax=127) -> torch.Tensor:
    """K1's function through the library route of the record `{"impl":
    "xla"}`: the int32 product by `torch._int_mm` on the card (cuBLASLt; it
    refuses M <= 16, K or N not a multiple of 8, and some other shapes with a
    RuntimeError), the exact epilogue in plain torch.  On the CPU the product
    is `exact_int_matmul`."""
    acc = torch._int_mm(x, w) if x.device.type == "cuda" else exact_int_matmul(x, w)
    return epilogue_plain(acc, bias, mult, shift, rq_izp, out_zp, rounding, qmin, qmax)


def qgemm_rq_tuned(x, w, bias, mult, shift, *, rq_izp=0, out_zp=0, rounding="UPWARD",
                   qmin=-128, qmax=127, blocks=None) -> torch.Tensor:
    """K1 at `blocks`, or the library route for blocks == "xla"; with blocks
    None, what the active database's best record for the workload names (a
    record whose blocks are not a compiled tile is ignored: 64 x 64)."""
    if blocks is None:
        cfg = lookup_config(matmul_workload(x.shape[0], x.shape[1], w.shape[1], True))
        if cfg and "blocks" in cfg and compiled_blocks(cfg["blocks"]):
            blocks = tuple(cfg["blocks"])
        elif cfg and cfg.get("impl") == "xla":
            blocks = "xla"
    kw = dict(rq_izp=rq_izp, out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax)
    if isinstance(blocks, str):
        if blocks != "xla":
            raise ValueError(f"blocks {blocks!r}: a compiled tile or 'xla'")
        return qgemm_library(x, w, bias, mult, shift, **kw)
    return qgemm_rq(x, w, bias, mult, shift, blocks=blocks, **kw)


def qgemm_raw_plain(x, w, bias) -> torch.Tensor:
    """Plain PyTorch version of K4's GEMM mode."""
    return (exact_int_matmul(x, w).to(torch.int64) + bias.to(torch.int64)).to(torch.int32)


def qgemm_raw(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K4, GEMM mode: x @ w + bias in int32 wraparound -> int32 (M, N).
    x int8 (M, K), w int8 (K, N), bias int32 (N,)."""
    if x.device.type == "cpu":
        return qgemm_raw_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm_raw: no kernel for device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    check_cuda_operands("qgemm_raw", x.device, x=(x, torch.int8, (m, k)),
                        w=(w, torch.int8, (k, n)), bias=(bias, torch.int32, (n,)))
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    launch("tk_qgemm_raw", [x, w, out, bias], dict(
        n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=n, oh=1, ow=1, sh=1, sw=1,
        a_vec=k % 16 == 0 and x.data_ptr() % 16 == 0,
        b_vec=n % 4 == 0 and w.data_ptr() % 4 == 0))
    LAUNCHES["qgemm_raw"] += 1
    return out


def fold_input_zero_point(bias: torch.Tensor, w: torch.Tensor, izp: int) -> torch.Tensor:
    """bias - izp * colsum(w) over all but the last axis, in int32 wraparound."""
    if not izp:
        return bias
    colsum = w.to(torch.int64).reshape(-1, w.shape[-1]).sum(dim=0)
    return (bias.to(torch.int64) - int(izp) * colsum).to(torch.int32)


def as_int32_vector(v, n: int, device) -> torch.Tensor:
    """A bias argument (None, numpy or tensor) as an int32 (n,) tensor."""
    if v is None:
        return torch.zeros(n, dtype=torch.int32, device=device)
    return torch.as_tensor(v).to(device=device, dtype=torch.int32).reshape(n)


def as_int8(v, device) -> torch.Tensor:
    """A weight argument (numpy or tensor) as a contiguous int8 tensor."""
    return torch.as_tensor(v).to(device=device, dtype=torch.int8).contiguous()


def qmatmul_int8(x, w, bias=None, multiplier=None, shift=None, out_zp: int = 0,
                 rounding: str = "UPWARD", out_dtype: str = "int8",
                 qmin: int = -128, qmax: int = 127, blocks=None, *,
                 input_zero_point: int = 0, rq_input_zero_point: int = 0):
    """x (M, K) int8 @ w (K, N) int8 -> requantized int8 (M, N),
    bit-identical to the unfused qnn.dense + bias_add + qnn.requantize chain
    (the JAX package's entry of the same name).  multiplier / shift: scalars
    or per-column (N,) arrays; blocks: a compiled tile (BM, BN, 64), "xla"
    (the library route) or None (the tuning database, else 64 x 64); bad
    blocks raise ValueError.  Without a multiplier: the int32 accumulator of
    (x - input_zero_point) @ w, plus bias (K4; `blocks` is not read)."""
    if multiplier is not None and out_dtype != "int8":
        raise NotImplementedError(f"qmatmul_int8: out_dtype {out_dtype} is not ported yet")
    n = w.shape[1]
    dev = x.device
    w = as_int8(w, dev)
    b = fold_input_zero_point(as_int32_vector(bias, n, dev), w, input_zero_point)
    if multiplier is None:
        return qgemm_raw(x.contiguous(), w, b.contiguous())
    return qgemm_rq_tuned(x.contiguous(), w, b.contiguous(), channel_vector(multiplier, n, dev),
                          channel_vector(shift, n, dev), rq_izp=rq_input_zero_point,
                          out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax,
                          blocks=blocks)
