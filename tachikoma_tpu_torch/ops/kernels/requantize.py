"""The exact requantize epilogue shared by the port's int8 kernels.

Replaces `tachikoma_tpu/ops/pallas/qms32.py`: `plan_requantize` (host side,
numpy) turns scale ratios into int32 (multiplier, shift) pairs, and the
epilogue itself is the `__device__` code in `csrc/requantize.cuh`.  Hopper has
native 64-bit integers, so the 32-bit emulation and the clamp16/clamp11 plans
of the TPU epilogue have no counterpart: the kernels compute the int64 product
directly.  This module also holds the epilogue's plain PyTorch version, which
the kernels' plain versions end with, the host plan of the fused residual
`qnn.add` of K3, and the two forms K3's kernel computes them in: the
product as one widening multiply then the left shift
(`q_multiply_shift_wide_np`), and the add as two 256-entry tables
(`res_add_tables`, `res_add_table_plain`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fixed_point import (TONEAREST, UPWARD, _qms_torch, fixed_point_multiplier_shift,
                           requantize)


def plan_requantize(input_scale, output_scale: float):
    """(multiplier, shift) int32 arrays (or scalars) for scale ratios."""
    scales = np.asarray(input_scale, dtype=np.float64) / float(output_scale)
    if scales.ndim == 0:
        return fixed_point_multiplier_shift(float(scales))
    ms, ss = zip(*(fixed_point_multiplier_shift(float(s)) for s in scales.ravel()))
    return (
        np.array(ms, dtype=np.int32).reshape(scales.shape),
        np.array(ss, dtype=np.int32).reshape(scales.shape),
    )


@functools.lru_cache(maxsize=4096)
def _cached_vector(values: tuple, n: int, device: str) -> torch.Tensor:
    arr = np.broadcast_to(np.asarray(values, np.int32).reshape(-1), (n,))
    return torch.tensor(np.ascontiguousarray(arr), dtype=torch.int32, device=device)


def channel_vector(values, n: int, device) -> torch.Tensor:
    """Per-channel int32 vector on `device` from a scalar or a list (scalars
    broadcast).  Cached: the executor calls this every run, and building the
    tensor anew would copy host memory to the card before every launch."""
    key = tuple(int(v) for v in np.atleast_1d(np.asarray(values, np.int64)))
    return _cached_vector(key, int(n), str(torch.device(device)))


OUT_DTYPES = {"int8": torch.int8, "uint8": torch.uint8}  # the fused outputs the kernels store


def out_torch_dtype(out_dtype: str) -> torch.dtype:
    """The torch dtype of a fused output (`OUT_DTYPES`); NotImplementedError
    for another (ROADMAP Queue 1 item 2: fused outputs other than int8 and
    uint8)."""
    if out_dtype not in OUT_DTYPES:
        raise NotImplementedError(f"out_dtype {out_dtype} is not ported yet (ROADMAP Queue 1 "
                                  "item 2: fused outputs other than int8 and uint8)")
    return OUT_DTYPES[out_dtype]


def epilogue_plain(acc: torch.Tensor, bias, mult: torch.Tensor, shift: torch.Tensor,
                   rq_izp: int, out_zp: int, rounding: str,
                   qmin: int, qmax: int, out_dtype: str = "int8") -> torch.Tensor:
    """clip(q_multiply_shift(acc + bias[c] - rq_izp, m[c], s[c]) + out_zp,
    qmin, qmax) per output channel c (the last axis), with the oracle's int32
    wraparound; acc int32 -> int8 (or uint8)."""
    v = acc.to(torch.int64)
    if bias is not None:
        v = v + bias.to(torch.int64)
    v = (v - int(rq_izp)).to(torch.int32)
    v = _qms_torch(v, mult.to(torch.int64), shift.to(torch.int64), rounding)
    v = (v.to(torch.int64) + int(out_zp)).to(torch.int32)
    return v.clamp(int(qmin), int(qmax)).to(out_torch_dtype(out_dtype))


def plan_res_add(ra: dict) -> dict:
    """Host plan of the fused residual qnn.add (`runtime/fuse.py _res_add`):
    each side requantized to (output_scale, output_zero_point) with its own
    (multiplier, shift) — skipped when its qparams already equal the output's
    — then added, the output zero point subtracted once, and clipped."""
    so = float(ra["output_scale"])
    zo = int(ra.get("output_zero_point", 0))
    plan = {"zo": zo,
            "lo": max(int(ra.get("a_min", -128)), -128),
            "hi": min(int(ra.get("a_max", 127)), 127),
            "rounding": ra.get("rounding", UPWARD)}
    for side in ("lhs", "rhs"):
        sc = float(ra[f"{side}_scale"])
        zc = int(ra.get(f"{side}_zero_point", 0))
        skip = sc == so and zc == zo
        # equal scales give (2^30, 1): an exact identity multiply, as
        # requantize_np's skipped multiply
        m, s = (0, 0) if skip else fixed_point_multiplier_shift(sc / so)
        plan[side] = (skip, int(m), int(s), zc)
    return plan


def res_add_plain(cur: torch.Tensor, residual: torch.Tensor, ra: dict) -> torch.Tensor:
    """Plain PyTorch version of the residual epilogue: the JAX package's
    `_res_add_np`, through the port's torch `requantize`."""
    so = float(ra["output_scale"])
    zo = int(ra.get("output_zero_point", 0))

    def req(v, sc, zc):
        if float(sc) == so and int(zc) == zo:
            return v.to(torch.int32)
        return requantize(v.to(torch.int32), float(sc), int(zc), so, zo,
                          rounding=ra.get("rounding", UPWARD), out_dtype="int32")

    ql = req(cur, ra["lhs_scale"], ra.get("lhs_zero_point", 0))
    qr = req(residual, ra["rhs_scale"], ra.get("rhs_zero_point", 0))
    lo = max(int(ra.get("a_min", -128)), -128)
    hi = min(int(ra.get("a_max", 127)), 127)
    out = (ql.to(torch.int64) + qr.to(torch.int64) - zo).to(torch.int32)
    return out.clamp(lo, hi).to(torch.int8)


def q_multiply_shift_wide_np(x, m, shift, rounding: str = UPWARD) -> np.ndarray:
    """q_multiply_shift as K3's epilogue computes it (csrc/qconv_igemm_hopper.cu
    requant_wide): the exact int64 product of the int32s x and m (one
    mul.wide.s32), then the left shift max(shift, 0) in 64-bit wraparound,
    (x 2^l) m == (x m) 2^l mod 2^64, then the oracle's rounding and right
    shift.  Elementwise over broadcast int arrays."""
    x, m, shift = np.broadcast_arrays(np.asarray(x, np.int64), np.asarray(m, np.int64),
                                      np.asarray(shift, np.int64))
    left = np.maximum(shift, 0).astype(np.uint64)
    right = (31 + np.maximum(-shift, 0)).astype(np.uint64)
    p = (x * m).view(np.uint64) << left
    rnd = np.uint64(1) << (right - np.uint64(1))
    if rounding == TONEAREST:
        rnd = rnd - (p.view(np.int64) < 0).astype(np.uint64)
    elif rounding != UPWARD:
        raise ValueError(f"unknown rounding {rounding!r}")
    return ((p + rnd).view(np.int64) >> right.astype(np.int64)).astype(np.int32)


def res_add_tables(plan: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's residual add as two 256-entry int32 tables, as each block of
    csrc/qconv_igemm_hopper.cu builds them from `plan` (`plan_res_add`):
    entry i is for the int8 value whose bits are i; TL[v] is the lhs side
    requantized to the add's output (v itself when skipped), TR[r] the rhs
    side minus the output zero point.  Each side reads one int8, so
    clip(TL[v] + TR[r], lo, hi) is the add (`res_add_table_plain`)."""
    v = torch.arange(256, dtype=torch.int64).to(torch.uint8).view(torch.int8).to(torch.int64)
    zo = int(plan["zo"])

    def side(skip, m, s, zp):
        if skip:
            return v
        q = _qms_torch((v - zp).to(torch.int32), torch.tensor(m), torch.tensor(s),
                       plan["rounding"])
        return q.to(torch.int64) + zo

    tl = side(*plan["lhs"]).to(torch.int32)
    tr = (side(*plan["rhs"]) - zo).to(torch.int32)
    return tl, tr


def res_add_table_plain(cur: torch.Tensor, residual: torch.Tensor, ra: dict) -> torch.Tensor:
    """The fused residual add by `res_add_tables`: clip(TL[cur] + TR[residual],
    lo, hi) with int32 wraparound, cur and residual int8 -> int8; equals
    `res_add_plain`."""
    plan = plan_res_add(ra)
    tl, tr = res_add_tables(plan)
    idx = lambda t: t.to(torch.int64) & 255  # noqa: E731
    out = (tl[idx(cur)].to(torch.int64) + tr[idx(residual)].to(torch.int64)).to(torch.int32)
    return out.clamp(plan["lo"], plan["hi"]).to(torch.int8)
