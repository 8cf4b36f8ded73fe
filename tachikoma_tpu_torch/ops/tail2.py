"""Ops of the JAX package's second long-tail file (port of part of
`tachikoma_tpu/ops/tail2.py`): `nn.upsampling`, the nearest-neighbour
upsampling the torch.fx importer emits for `nn.Upsample` /
`nn.UpsamplingNearest2d` (frontend/torch_fx.py; nearest is the only mode it
imports).  The rest of that file waits for ROADMAP Queue 1 item 9.4.

NHWC data; output row i reads input row min(floor(i / scale), H - 1), and
the same for columns.  The torch impl gathers with `index_select` on index
vectors built on the data's device, so it moves values only and is exact
on every dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import infer_rule, np_impl, torch_impl


def _upsample_idx(scale, size, out_size):
    return np.minimum((np.arange(out_size) / scale).astype(np.int64), size - 1)


def _out_hw(node: Node, h: int, w: int) -> tuple[float, float, int, int]:
    sh = float(node.attrs.get("scale_h", 1.0))
    sw = float(node.attrs.get("scale_w", 1.0))
    return sh, sw, int(round(h * sh)), int(round(w * sw))


@infer_rule("nn.upsampling")
def _ups_rel(node: Node, ins):
    (s, dtp) = ins[0]
    n, h, w, c = s
    _, _, oh, ow = _out_hw(node, h, w)
    return (n, oh, ow, c), dtp


@np_impl("nn.upsampling")
def _ups_np(a, *, node: Node):
    n, h, w, c = a.shape
    sh, sw, oh, ow = _out_hw(node, h, w)
    return a[:, _upsample_idx(sh, h, oh)][:, :, _upsample_idx(sw, w, ow)]


@torch_impl("nn.upsampling")
def _ups_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    n, h, w, c = a.shape
    sh, sw, oh, ow = _out_hw(node, h, w)
    # the oracle's indices (host arithmetic on the static shape), moved once
    ys = torch.from_numpy(_upsample_idx(sh, h, oh)).to(a.device)
    xs = torch.from_numpy(_upsample_idx(sw, w, ow)).to(a.device)
    return a.index_select(1, ys).index_select(2, xs)
