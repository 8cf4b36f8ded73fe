"""tk.attention: the fused float attention op (port of
`tachikoma_tpu/ops/attention.py`).

`ir/transforms.py fuse_attention` rewrites the zoo's attention subgraph
(batch_matmul(transpose_b) -> scale multiply -> [causal mask add] -> softmax
-> batch_matmul) into this one op.  Its torch impl is K6
(`ops/kernels/flash_attention.py`): on the card the (S, S) score matrix never
reaches device memory; on the CPU it is K6's plain version.  The numpy
oracle is the naive computation, copied.

causal=True realizes the mask as a hard -1e30 block structure; graphs that
used an additive -30 mask (models/transformer.py _causal_attention) differ by
exp(-30) ~ 1e-13 relative, inside every float tolerance used here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import infer_rule, np_impl, register_op, torch_impl
from .kernels.flash_attention import flash_attention


def _scale(node: Node, d: int) -> float:
    return float(node.attrs.get("scale", 1.0 / np.sqrt(d)))


@infer_rule("tk.attention")
def _attn_rel(node: Node, ins):
    (qs, qdt) = ins[0]
    return tuple(qs), "float32"


@np_impl("tk.attention")
def _attn_np(q, k, v, *, node: Node):
    scale = _scale(node, q.shape[-1])
    causal = bool(node.attrs.get("causal", False))
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float32),
                  k.astype(np.float32)).astype(np.float64) * scale
    if causal:
        S = q.shape[2]
        s = np.where(np.triu(np.ones((S, S), bool), 1), -1e30, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bhkd->bhqd", p, v.astype(np.float64))
    return out.astype(np.float32)


@torch_impl("tk.attention")
def _attn_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, node: Node) -> torch.Tensor:
    return flash_attention(q.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
                           scale=_scale(node, q.shape[-1]),
                           causal=bool(node.attrs.get("causal", False)))


register_op("tk.attention",
            flops=lambda node, ins: 4 * int(np.prod(ins[0][0][:3]))
            * ins[1][0][2] * ins[0][0][3])
