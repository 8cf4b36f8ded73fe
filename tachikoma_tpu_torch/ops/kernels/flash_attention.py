"""K6: float32 attention with an online softmax (port of
`tachikoma_tpu/ops/pallas/flash_attention.py` `_fa_kernel`, entry
`flash_attention`).

  * `flash_attention` wraps `csrc/flash_attn.cu tk_flash_attn`: q, k, v
    (B, H, S, D) float32 -> (B, H, S, D) float32, with the reference's
    signature and defaults (scale 1/sqrt(D), causal False); D up to 128.
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

import torch

from ._lib import LAUNCHES, check_cuda_operands, float32_bits, launch

MAX_D = 128  # csrc/flash_attn.cu FA_MAX_D
_NEG_INF = -1e30


def _default_scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


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
    if d > MAX_D:
        raise ValueError(f"flash_attention: D = {d} is above K6's {MAX_D}")
    # The graph's head split is a transpose, which hands over permuted views;
    # K6 reads contiguous (G, S, D) rows, so such a view is copied here (a
    # contiguous tensor is passed as it is).
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    shape = (b, h, s, d)
    check_cuda_operands("flash_attn", q.device, q=(q, torch.float32, shape),
                        k=(k, torch.float32, shape), v=(v, torch.float32, shape))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch("tk_flash_attn", [q, k, v, out], dict(
        g=b * h, s=s, d=d, causal=int(bool(causal)), scale_bits=float32_bits(scale)))
    LAUNCHES["flash_attn"] += 1
    return out
