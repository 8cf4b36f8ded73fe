"""Ring attention — sequence-parallel exact integer attention over 'sp'
(port of `tachikoma_tpu/parallel/ring_attention.py`).

Long sequences shard over an 'sp' line; each rank holds its Q chunk while
the K and V chunks rotate around the ring (`Collective.ring_shift`,
batch_isend_irecv).  qnn.attention's semantics are integer (running max,
int32 wraparound sums, exact integer normalization), so the decomposition
is bit-identical to the single-device op for every ring size and rotation
order.  The three ring phases of the JAX package:

  A: rotate K      -> global row max   m_i
  B: rotate K      -> global sum_i of p_ij = table[clip(m_i - s_ij)]
  C: rotate K, V   -> ctx_i += ((p*256 + sum//2)//sum) @ V_chunk

The products run on K1's batched raw mode (`qbmm_int8`), as the port's
qnn.attention does (`ops/qnn.py _qattn_torch`): u in [0, 256] is not int8,
so u @ v is the `lo` plane (min(u, 255) - 128, zero point -128) @ v plus the
(u == 256) plane @ v, summed in int32 wraparound.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fixed_point import requantize
from ..ops.kernels.matmul_int8 import qbmm_int8
from ..ops.qnn import LUT_SIZE, _exp_table_torch
from .mesh import Collective, Mesh


def ring_attention_int8_local(q, k, v, *, scores_scale: float, v_scale: float,
                              output_scale: float, line: Collective,
                              rounding: str = "UPWARD") -> torch.Tensor:
    """Per-rank body: q, k, v are this rank's (..., S_local, D) int8 chunks
    of the sequence on the ring `line`.  Returns the int8 context chunk,
    bit-identical to qnn.attention's rows of the gathered sequence."""
    table = _exp_table_torch(scores_scale, q.device)

    def scores(k_blk):
        return qbmm_int8(q, k_blk, transpose_b=True).to(torch.int64)

    # phase A: global row max
    m = torch.full((*q.shape[:-1], 1), np.iinfo(np.int32).min, dtype=torch.int64,
                   device=q.device)
    for _ in range(line.size):
        m = torch.maximum(m, scores(k).amax(dim=-1, keepdim=True))
        (k,) = line.ring_shift([k])

    # phase B: global sum of Q15 exp values
    ssum = torch.zeros_like(m)
    for _ in range(line.size):
        ssum += table[(m - scores(k)).clamp(0, LUT_SIZE - 1)].sum(dim=-1, keepdim=True)
        (k,) = line.ring_shift([k])

    # phase C: normalized integer weights @ V, int32 wraparound accumulation
    ctx = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for _ in range(line.size):
        p = table[(m - scores(k)).clamp(0, LUT_SIZE - 1)]
        u = torch.div(p * 256 + torch.div(ssum, 2, rounding_mode="floor"), ssum,
                      rounding_mode="floor")
        lo = (u.clamp(max=255) - 128).to(torch.int8)
        ctx += qbmm_int8(lo, v, lhs_zero_point=-128).to(torch.int64)
        ctx += qbmm_int8((u == 256).to(torch.int8), v).to(torch.int64)
        k, v = line.ring_shift([k, v])
    return requantize(ctx.to(torch.int32), v_scale / 256.0, 0, output_scale, 0,
                      rounding=rounding, out_dtype="int8")


def ring_attention_int8(q, k, v, mesh: Mesh, *, scores_scale: float, v_scale: float,
                        output_scale: float, axis: str = "sp",
                        rounding: str = "UPWARD") -> torch.Tensor:
    """Sequence-parallel integer attention over `mesh` axis `axis`.

    q/k/v: global (B, H, S, D) int8 arrays, the same on every rank; S shards
    over `axis`.  Returns the global (B, H, S, D) int8 context on the mesh's
    device, on every rank."""
    line = mesh.collective(axis)
    s = q.shape[-2]
    if s % line.size:
        raise ValueError(f"sequence {s} over {line.size} ranks")
    n = s // line.size
    lo = mesh.index(axis) * n

    def chunk(a):
        return torch.as_tensor(a, device=mesh.device)[..., lo:lo + n, :].contiguous()

    ctx = ring_attention_int8_local(chunk(q), chunk(k), chunk(v), scores_scale=scores_scale,
                                    v_scale=v_scale, output_scale=output_scale, line=line,
                                    rounding=rounding)
    return line.all_gather(ctx, -2)
