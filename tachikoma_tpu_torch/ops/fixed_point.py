"""Exact fixed-point arithmetic (port of `tachikoma_tpu/ops/fixed_point.py`).

  * `fixed_point_multiplier_shift`: a positive double multiplier -> (int32
    significand with the binary point between bits 31/30, int exponent).
  * UPWARD rounding fixed-point multiply: 64-bit product, add 2^(n-1),
    arithmetic shift right n.
  * TONEAREST rounding: like UPWARD but the rounding addend is 2^(n-1)-1 when
    the 64-bit product is negative (round half away from zero).

  * The wide multiply of int64 (W8A16) accumulators: (acc << left) * m
    overflows int64, so the product is built exactly in two limbs of base
    2^32, the rounding bias is added into the limbs and the shift reads the
    result out of the pair.

Each function exists twice: over numpy (the oracle, copied from the JAX
package) and over torch int64 tensors on any device.  Both rely on two's
complement wraparound and arithmetic right shifts, which numpy and torch
share; the left shift comes before the multiply, as in the oracle.  torch has
no uint64, so the low limb is an int64 masked to 32 bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

UPWARD = "UPWARD"
TONEAREST = "TONEAREST"


def fixed_point_multiplier_shift(double_multiplier: float) -> tuple[int, int]:
    """float multiplier -> (int32 significand, exponent)."""
    if double_multiplier == 0.0:
        return 0, 0
    significand_d, exponent = math.frexp(double_multiplier)
    significand = int(round(significand_d * (1 << 31)))
    assert significand <= (1 << 31)
    if significand == (1 << 31):
        significand //= 2
        exponent += 1
    assert significand <= np.iinfo(np.int32).max
    return significand, exponent


def _shifts(shift: int) -> tuple[int, int]:
    left = shift if shift > 0 else 0
    right = -shift if shift < 0 else 0
    return left, right


def _check_rounding(rounding: str) -> None:
    if rounding not in (UPWARD, TONEAREST):
        raise ValueError(f"unknown rounding {rounding!r}")


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def q_multiply_shift_np(x: np.ndarray, m: int, shift: int, rounding: str = UPWARD) -> np.ndarray:
    """Exact numpy fixed-point multiply: int32 tensor x by multiplier m*2^shift."""
    _check_rounding(rounding)
    left, right = _shifts(int(shift))
    v = x.astype(np.int64)
    if left:
        v = v << np.int64(left)
    v = v * np.int64(m)
    total_right = right + 31
    pos_round = np.int64(1) << np.int64(total_right - 1)
    if rounding == UPWARD:
        v = v + pos_round
    else:
        v = v + np.where(v >= 0, pos_round, pos_round - 1)
    v = v >> np.int64(total_right)
    return v.astype(np.int32)


def q_multiply_shift_per_axis_np(
    x: np.ndarray, ms: np.ndarray, shifts: np.ndarray, axis: int, rounding: str = UPWARD
) -> np.ndarray:
    """Per-channel variant of `q_multiply_shift_np`."""
    _check_rounding(rounding)
    ms = np.asarray(ms, dtype=np.int64)
    shifts = np.asarray(shifts, dtype=np.int64)
    bshape = [1] * x.ndim
    bshape[axis] = -1
    m_b = ms.reshape(bshape)
    left = np.where(shifts > 0, shifts, 0).reshape(bshape)
    right = np.where(shifts < 0, -shifts, 0).reshape(bshape)
    v = x.astype(np.int64)
    v = np.where(left > 0, v << left, v)
    v = v * m_b
    total_right = right + 31
    pos_round = np.int64(1) << (total_right - 1)
    if rounding == UPWARD:
        v = v + pos_round
    else:
        v = v + np.where(v >= 0, pos_round, pos_round - 1)
    v = v >> total_right
    return v.astype(np.int32)


def requantize_np(
    x: np.ndarray,
    input_scale,
    input_zero_point: int,
    output_scale: float,
    output_zero_point: int,
    axis: int = -1,
    rounding: str = UPWARD,
    out_dtype: str = "int8",
) -> np.ndarray:
    """Exact integer requantize: subtract the input zero point (int32, or
    int64 for the W8A16 accumulators, which take the wide multiply),
    fixed-point multiply by input_scale/output_scale, add the output zero
    point, clip to out_dtype."""
    wide = str(x.dtype) == "int64"
    v = x.astype(np.int64 if wide else np.int32)
    if input_zero_point != 0:
        v = v - (np.int64 if wide else np.int32)(input_zero_point)
    in_scale = np.asarray(input_scale, dtype=np.float64)
    if in_scale.ndim == 0:
        if float(in_scale) != float(output_scale):
            m, s = fixed_point_multiplier_shift(float(in_scale) / float(output_scale))
            v = (q_multiply_shift_wide_np(v, m, s, rounding) if wide
                 else q_multiply_shift_np(v, m, s, rounding))
    else:
        mult = in_scale / float(output_scale)
        ms, ss = zip(*(fixed_point_multiplier_shift(float(d)) for d in mult))
        ax = axis if axis >= 0 else v.ndim + axis
        v = (q_multiply_shift_wide_per_axis_np(v, np.array(ms), np.array(ss), ax, rounding)
             if wide else
             q_multiply_shift_per_axis_np(v, np.array(ms), np.array(ss), ax, rounding))
    if output_zero_point != 0:
        v = v + np.int32(output_zero_point)
    lo, hi = np.iinfo(np.dtype(out_dtype)).min, np.iinfo(np.dtype(out_dtype)).max
    return np.clip(v, lo, hi).astype(out_dtype)


# ---------------------------------------------------------------------------
# the wide (int64-accumulator) multiply, numpy oracle
# ---------------------------------------------------------------------------
# int16 activations x int8 weights accumulate past int32, and (acc * m)
# overflows int64 outright: exact floor semantics for any int64 input.

_MASK32 = 0xFFFFFFFF


def _wide_mul_limbs_np(v: np.ndarray, m) -> tuple[np.ndarray, np.ndarray]:
    """v (int64) * m (positive, below 2^31) -> (hi, lo): the exact product
    is hi * 2^32 + lo with 0 <= lo < 2^32."""
    x_hi = v >> np.int64(32)                  # arithmetic: carries the sign
    x_lo = v & np.int64(_MASK32)
    p_lo = x_lo * m                           # below 2^63, non-negative
    return x_hi * m + (p_lo >> np.int64(32)), p_lo & np.int64(_MASK32)


def _wide_round_shift_np(hi, lo, t: np.ndarray, rounding: str, neg) -> np.ndarray:
    """floor((hi * 2^32 + lo + R) / 2^t), R = 2^(t-1) (TONEAREST: minus 1
    where the product is negative)."""
    bias_lo = np.where(t - 1 < 32, np.int64(1) << np.minimum(np.maximum(t - 1, 0), 31),
                       np.int64(0))
    bias_hi = np.where(t - 1 >= 32, np.int64(1) << np.maximum(t - 33, 0), np.int64(0))
    if rounding == TONEAREST:
        bias_lo = np.where(neg & (t - 1 < 32), bias_lo - 1, bias_lo)
        sub1 = neg & (t - 1 >= 32)  # 2^(t-1) - 1: a borrow-aware subtract from lo
    else:
        sub1 = np.zeros(np.shape(hi), dtype=bool)
    lo = lo + bias_lo
    hi = hi + bias_hi + (lo >> np.int64(32))
    lo = lo & np.int64(_MASK32)
    lo = lo - np.where(sub1, np.int64(1), np.int64(0))
    hi = hi + (lo >> np.int64(32))            # the borrow, if lo went negative
    lo = lo & np.int64(_MASK32)
    out_hi = hi >> np.minimum(np.maximum(t - 32, 0), 63)
    out_lt = (hi << np.minimum(np.maximum(32 - t, 0), 63)) | (lo >> np.minimum(t, 63))
    return np.where(t >= 32, out_hi, out_lt)


def q_multiply_shift_wide_np(x: np.ndarray, m: int, shift: int,
                             rounding: str = UPWARD) -> np.ndarray:
    """Exact (x * m * 2^shift) >> 31, rounded, for int64 x -> int64."""
    _check_rounding(rounding)
    left, right = _shifts(int(shift))
    v = x.astype(np.int64)
    if left:
        v = v << np.int64(left)
    hi, lo = _wide_mul_limbs_np(v, np.int64(int(m)))
    t = np.broadcast_to(np.int64(right + 31), hi.shape).copy()
    return _wide_round_shift_np(hi, lo, t, rounding, v < 0)


def q_multiply_shift_wide_per_axis_np(x: np.ndarray, ms, shifts, axis: int,
                                      rounding: str = UPWARD) -> np.ndarray:
    """Per-channel variant of `q_multiply_shift_wide_np`."""
    _check_rounding(rounding)
    ms = np.asarray(ms, np.int64)
    shifts = np.asarray(shifts, np.int64)
    bshape = [1] * x.ndim
    bshape[axis] = -1
    m_b = np.broadcast_to(ms.reshape(bshape), x.shape)
    left = np.maximum(shifts, 0).reshape(bshape)
    right = np.maximum(-shifts, 0).reshape(bshape)
    v = x.astype(np.int64) << np.broadcast_to(left, x.shape)
    hi, lo = _wide_mul_limbs_np(v, m_b)
    t = np.broadcast_to(right + 31, x.shape).astype(np.int64).copy()
    return _wide_round_shift_np(hi, lo, t, rounding, v < 0)


# ---------------------------------------------------------------------------
# torch (any device): int64 arithmetic, the same sequence of operations
# ---------------------------------------------------------------------------

def _qms_torch(x: torch.Tensor, m, s, rounding: str) -> torch.Tensor:
    """(x << max(s,0)) * m, rounded, >> (31 + max(-s,0)); m, s int64 tensors
    broadcastable against x."""
    _check_rounding(rounding)
    left = s.clamp(min=0)
    total_right = (-s).clamp(min=0) + 31
    v = (x.to(torch.int64) << left) * m
    pos_round = torch.ones_like(total_right) << (total_right - 1)
    if rounding == UPWARD:
        v = v + pos_round
    else:
        v = v + pos_round - (v < 0).to(torch.int64)
    return (v >> total_right).to(torch.int32)


def q_multiply_shift(x: torch.Tensor, m: int, shift: int,
                     rounding: str = UPWARD) -> torch.Tensor:
    """Torch twin of `q_multiply_shift_np`: int32 x -> int32.  The scalars
    stay Python ints (integer ops with a host scalar are exact, and no
    host-to-device copy is made)."""
    _check_rounding(rounding)
    left, right = _shifts(int(shift))
    total_right = right + 31
    v = (x.to(torch.int64) << left) * int(m)
    pos_round = 1 << (total_right - 1)
    if rounding == UPWARD:
        v = v + pos_round
    else:
        v = v + pos_round - (v < 0).to(torch.int64)
    return (v >> total_right).to(torch.int32)


@functools.lru_cache(maxsize=1024)
def _axis_tensors(ms: tuple, shifts: tuple, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-channel (multiplier, shift) int64 tensors on `device`, made
    once: the executor requantizes every run, and would otherwise copy the
    same plan to the card before each launch."""
    return (torch.tensor(ms, dtype=torch.int64, device=device),
            torch.tensor(shifts, dtype=torch.int64, device=device))


def _axis_plan(x: torch.Tensor, ms, shifts, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (multiplier, shift) device tensors, shaped to broadcast along `axis`."""
    bshape = [1] * x.ndim
    bshape[axis] = -1
    m, s = _axis_tensors(tuple(np.asarray(ms, np.int64).reshape(-1).tolist()),
                         tuple(np.asarray(shifts, np.int64).reshape(-1).tolist()), str(x.device))
    return m.reshape(bshape), s.reshape(bshape)


def q_multiply_shift_per_axis(x: torch.Tensor, ms, shifts, axis: int,
                              rounding: str = UPWARD) -> torch.Tensor:
    """Torch twin of `q_multiply_shift_per_axis_np`."""
    return _qms_torch(x, *_axis_plan(x, ms, shifts, axis), rounding)


def _qms_wide_torch(x: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                    rounding: str) -> torch.Tensor:
    """The wide multiply of int64 x in limbs (`_wide_mul_limbs_np`,
    `_wide_round_shift_np`); m, s int64 tensors broadcastable against x."""
    _check_rounding(rounding)
    v = x.to(torch.int64) << s.clamp(min=0)
    t = (-s).clamp(min=0) + 31
    p_lo = (v & _MASK32) * m
    hi = (v >> 32) * m + (p_lo >> 32)
    lo = p_lo & _MASK32
    one = torch.ones_like(t)
    low = t - 1 < 32
    bias_lo = torch.where(low, one << (t - 1).clamp(0, 31), 0)
    bias_hi = torch.where(low, 0, one << (t - 33).clamp(min=0))
    if rounding == TONEAREST:
        neg = v < 0
        bias_lo = bias_lo - (neg & low).to(torch.int64)
        sub1 = (neg & ~low).to(torch.int64)
    else:
        sub1 = 0
    lo = lo + bias_lo
    hi = hi + bias_hi + (lo >> 32)
    lo = (lo & _MASK32) - sub1
    hi = hi + (lo >> 32)
    lo = lo & _MASK32
    out_hi = hi >> (t - 32).clamp(0, 63)
    out_lt = (hi << (32 - t).clamp(0, 63)) | (lo >> t.clamp(max=63))
    return torch.where(t >= 32, out_hi, out_lt)


def q_multiply_shift_wide(x: torch.Tensor, m: int, shift: int,
                          rounding: str = UPWARD) -> torch.Tensor:
    """Torch twin of `q_multiply_shift_wide_np`: int64 x -> int64."""
    mt, st = _axis_tensors((int(m),), (int(shift),), str(x.device))
    return _qms_wide_torch(x, mt.reshape(()), st.reshape(()), rounding)


def q_multiply_shift_wide_per_axis(x: torch.Tensor, ms, shifts, axis: int,
                                   rounding: str = UPWARD) -> torch.Tensor:
    """Torch twin of `q_multiply_shift_wide_per_axis_np`."""
    return _qms_wide_torch(x, *_axis_plan(x, ms, shifts, axis), rounding)


_TORCH_DTYPES = {
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float32": torch.float32,
    "float64": torch.float64, "bool": torch.bool,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise NotImplementedError(f"dtype {name} is not supported by the port") from None


@functools.lru_cache(maxsize=1024)
def _channel_plan(input_scales: tuple, output_scale: float) -> tuple[tuple, tuple]:
    """Per-channel (multipliers, shifts) of input_scale / output_scale,
    planned once per scales: the loop over every channel costs tens of
    milliseconds per ResNet-50 forward on the host."""
    mult = np.asarray(input_scales, dtype=np.float64) / output_scale
    ms, ss = zip(*(fixed_point_multiplier_shift(float(d)) for d in mult))
    return ms, ss


def requantize(
    x: torch.Tensor,
    input_scale,
    input_zero_point: int,
    output_scale: float,
    output_zero_point: int,
    axis: int = -1,
    rounding: str = UPWARD,
    out_dtype: str = "int8",
) -> torch.Tensor:
    """Torch twin of `requantize_np`: int32 (or narrower) inputs in int32,
    int64 (W8A16) accumulators through the wide multiply in int64."""
    wide = x.dtype == torch.int64
    # narrower inputs: the int32 wraparound of (x - izp), as the oracle computes it
    v = x.to(torch.int64) - int(input_zero_point)
    if not wide:
        v = v.to(torch.int32)
    in_scale = np.asarray(input_scale, dtype=np.float64)
    if in_scale.ndim == 0:
        if float(in_scale) != float(output_scale):
            m, s = fixed_point_multiplier_shift(float(in_scale) / float(output_scale))
            v = (q_multiply_shift_wide if wide else q_multiply_shift)(v, m, s, rounding)
    else:
        ms, ss = _channel_plan(tuple(in_scale.tolist()), float(output_scale))
        v = (q_multiply_shift_wide_per_axis if wide else q_multiply_shift_per_axis)(
            v, ms, ss, axis, rounding)
    v = v.to(torch.int64) + int(output_zero_point)
    if not wide:
        v = v.to(torch.int32)
    info = np.iinfo(np.dtype(out_dtype))
    return v.clamp(int(info.min), int(info.max)).to(torch_dtype(out_dtype))
