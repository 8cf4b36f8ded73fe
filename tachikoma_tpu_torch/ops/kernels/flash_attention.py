"""K6: float32 attention with an online softmax (port of
`tachikoma_tpu/ops/pallas/flash_attention.py` `_fa_kernel`, entry
`flash_attention`).

  * `flash_attention` wraps `csrc/flash_attn.cu tk_flash_attn`: q, k, v
    (B, H, S, D) float32 -> (B, H, S, D) float32, with the reference's
    signature and defaults (scale 1/sqrt(D), causal False), any D >= 1.
    Views whose last dimension is contiguous (the graph's head split, a
    (B, S, H, D) tensor viewed as (B, H, S, D)) are read in place, through
    their strides; a view of any other layout is copied first, and `COPIES`
    counts those copies.
  * `fa_plan` picks the launch: warps a block (16 query rows each), the
    depth of Q.K^T, output columns a block and the column blocks that split
    D, keys a tile and stages, so that the card holds the grid in the fewest
    waves and the block's tiles fit in shared memory.
  * `flash_attention_plain` computes what `ops/attention.py _attn_np`
    computes: scores from float32 products, then the scale, the causal mask,
    the softmax and P.V in float64, then a cast to float32; so a check of K6
    against it measures K6's own error.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches K6 or raises.  The reference's block sizes and 128-lane padding are
TPU tactics and have no counterpart: K6 masks the ragged key tile itself.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from ._lib import LAUNCHES, check_cuda_operands, float32_bits, launch

_NEG_INF = -1e30
_INT32_MAX = 2 ** 31 - 1
# csrc/flash_attn.cu's tiles (launch_staged): the depth of Q.K^T (D rounded
# up), output columns a block and keys a tile, staged by 2 or 4 warps; with
# Q and K read from global memory (D above 256), one warp and DV 32, 64 or
# 128.  227 KB of shared memory a block and 228 KB an SM; registers (168 a
# thread at D 64) allow about 12 warps an SM.
TILES = ((32, 32, 64), (64, 32, 64), (64, 64, 64), (64, 64, 32), (128, 64, 64),
         (128, 128, 64), (256, 64, 32), (256, 128, 32))
WARPS = (4, 2)
KG_DVS = (32, 64, 128)
_MAX_SMEM = 227 * 1024
_SM_SMEM = 228 * 1024
_SM_WARPS = 12
# q, k, v copied by the wrapper because their last dimension was strided
COPIES: Counter = Counter()


def _default_scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def fa_smem_bytes(w: int, dq: int, dv: int, bk: int, kg: bool = False, stages: int = 1) -> int:
    """Shared memory of one block (csrc/flash_attn.cu fa_smem_floats): Q's hi
    and lo planes; `stages` raw tiles of K and V and a lo plane of each; V
    alone with kg."""
    floats = ((stages + 1) * bk * (dv + 4) if kg
              else 2 * 16 * w * (dq + 4) + (stages + 1) * bk * (dq + 4 + dv + 4))
    return 4 * floats


def fa_plan(g: int, s: int, d: int, sms: int = 132) -> dict:
    """The launch of K6 for G = B*H heads of S rows and D columns on a card
    of `sms` SMs: {"w": warps a block, "dq": the depth of Q.K^T, "dv":
    output columns a block, "bk": keys a tile, "cs": column blocks
    (cs * dv >= D), "kg": Q and K read from global memory, "stages": K and V
    tiles in flight, "blocks": the grid, "waves": the grid over the blocks
    the card holds at once}.  The fewest waves first; then the most warps a
    block (the block splits its tiles once for all its warps); then the
    most blocks (columns split across blocks, each recomputing the scores,
    where that spreads a small grid); then the least work, cs * (DQ + dv);
    then the longer key tile, and two stages (the next tile copied while
    this one is computed) over one.  D above 256: one warp a block, Q and K
    read from global memory."""
    dp = -(-d // 8) * 8
    if dp > 256:
        cands = [(1, 0, dv, 64, True) for dv in KG_DVS]
    else:
        dq = max(32, 1 << (dp - 1).bit_length())
        cands = [(w, dq, dv, bk, False) for dq_, dv, bk in TILES if dq_ == dq for w in WARPS]
    best = None
    for w, dq, dv, bk, kg in cands:
        for stages in ((1, 2) if s > bk else (1,)):
            smem = fa_smem_bytes(w, dq, dv, bk, kg, stages)
            if smem > _MAX_SMEM:
                continue
            cs = -(-d // dv)
            blocks = -(-s // (16 * w)) * g * cs
            resident = max(1, min(_SM_SMEM // (smem + 1024), _SM_WARPS // w))
            waves = -(-blocks // (sms * resident))
            key = (waves, -w, -blocks, cs * ((dq or dp) + dv), -bk, -stages)
            if best is None or key < best[0]:
                best = (key, dict(w=w, dq=dq, dv=dv, bk=bk, cs=cs, kg=kg, stages=stages,
                                  blocks=blocks, waves=waves))
    return best[1]


def flash_attention_plain(q, k, v, *, scale: float | None = None,
                          causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K6, on any device."""
    if scale is None:
        scale = _default_scale(q.shape[-1])
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    s = s.to(torch.float64) * scale
    if causal:
        n = q.shape[-2]
        above = torch.ones((n, n), dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.to(torch.float64)).to(torch.float32)


def _in_place(t: torch.Tensor) -> torch.Tensor:
    """t as K6 reads it: its last dimension contiguous and its strides within
    int32, else a contiguous copy (counted in COPIES)."""
    if (t.shape[-1] > 1 and t.stride(-1) != 1) or max(t.stride()[:3]) > _INT32_MAX:
        COPIES["flash_attn"] += 1
        return t.contiguous()
    return t


def _vec(ts) -> bool:
    """Whether every row of q, k and v starts 16-byte aligned (K6's 16-byte
    copies): D and each stride a multiple of 4 floats, each base 16-byte
    aligned."""
    return all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
               and all(st % 4 == 0 for st in t.stride()[:3]) for t in ts)


def flash_attention(q, k, v, *, scale: float | None = None, causal: bool = False) -> torch.Tensor:
    """K6: softmax(scale * q k^T + mask) v over (B, H, S, D) float32, the
    mask causal when `causal`."""
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be (B, H, S, D), got {tuple(q.shape)}")
    b, h, s, d = q.shape
    if scale is None:
        scale = _default_scale(d)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    shape = (b, h, s, d)
    check_cuda_operands("flash_attn", q.device, contiguous=False, q=(q, torch.float32, shape),
                        k=(k, torch.float32, shape), v=(v, torch.float32, shape))
    q, k, v = _in_place(q), _in_place(k), _in_place(v)
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    from .conv import sm_count

    plan = fa_plan(b * h, s, d, sm_count(q.device.index))
    strides = {f"{key}_s{x}": t.stride(i) for key, t in (("q", q), ("k", k), ("v", v))
               for i, x in enumerate("bhs")}
    launch("tk_flash_attn", [q, k, v, out], dict(
        n=b, heads=h, s=s, d=d, causal=int(bool(causal)), scale_bits=float32_bits(scale),
        fa_w=plan["w"], fa_dq=plan["dq"], fa_dv=plan["dv"], fa_cs=plan["cs"],
        fa_kg=int(plan["kg"]), fa_stages=plan["stages"], fa_bk=plan["bk"],
        fa_vec=int(_vec((q, k, v))), **strides))
    LAUNCHES["flash_attn"] += 1
    return out
