"""Two ops of the JAX package's operator long tail that the vision zoo needs
(port of part of `tachikoma_tpu/ops/tail.py`): `nn.conv3d` (the 3D ResNet's
float convolutions, NDHWC data, DHWIO weights) and
`vision.non_max_suppression` (SSD-lite's per-image greedy NMS).  The rest of
that file waits for ROADMAP Queue 1 item 9.4.

Neither has a Pallas kernel in the JAX package (XLA's conv and a
`lax.fori_loop`), so their torch impls are a library conv and plain torch:
- nn.conv3d is torch.nn.functional.conv3d in float32 (TF32 off under
  ops/nn.py float32_products), summed in cuDNN's order, not the oracle's;
- the NMS computes the IoU matrix of the score-sorted boxes once and then
  finds the greedy keep set as the fixed point of "kept = above the score
  threshold and not suppressed by a kept box before it", one matrix-vector
  step an iteration, with one host read of a flag every few steps and none
  per box.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import infer_rule, np_impl, register_op, torch_impl
from ..utils import dtypes as dt
from .nn import _float_only, _to_out_dtype, float32_products


# ---------------------------------------------------------------------------
# conv3d
# ---------------------------------------------------------------------------

def _triple(v):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return (int(v[0]),) * 3
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def _pad6(v):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    if len(v) == 1:
        return [int(v[0])] * 6
    if len(v) == 3:
        return [int(v[0]), int(v[1]), int(v[2])] * 2
    return [int(x) for x in v]


def _conv3d_rel(node: Node, ins):
    (ds, ddt), (ws, wdt) = ins[0], ins[1]
    n, d_, h, w, cin = ds
    kd, kh, kw, wcin, cout = ws
    sd, sh, sw = _triple(node.attrs.get("strides", (1, 1, 1)))
    pads = _pad6(node.attrs.get("padding", (0,) * 6))
    dd, dh, dw = _triple(node.attrs.get("dilation", (1, 1, 1)))
    od = (d_ + pads[0] + pads[3] - ((kd - 1) * dd + 1)) // sd + 1
    oh = (h + pads[1] + pads[4] - ((kh - 1) * dh + 1)) // sh + 1
    ow = (w + pads[2] + pads[5] - ((kw - 1) * dw + 1)) // sw + 1
    return (n, od, oh, ow, cout), node.attrs.get("out_dtype") or dt.promote(ddt, wdt)


@np_impl("nn.conv3d")
def _conv3d_np(x, w, *, node: Node):
    """Int64 (integers) or float64 (floats) sums of exact products, cast to
    the output dtype, as the JAX package's oracle; summed tap by tap (one
    (pixels, CIN) x (CIN, COUT) product a tap) instead of its einsum over a
    materialised window view, which at a video's size (16 x 112^2 x 64,
    27 taps) would take 11 GB.  The integer sums are the same in any order;
    a float64 sum of float32 products rounds to the same float32 but at the
    rarest ties."""
    sd, sh, sw = _triple(node.attrs.get("strides", (1, 1, 1)))
    pads = _pad6(node.attrs.get("padding", (0,) * 6))
    dd, dh, dw = _triple(node.attrs.get("dilation", (1, 1, 1)))
    assert (dd, dh, dw) == (1, 1, 1), "conv3d oracle: dilation unsupported"
    acc = np.int64 if x.dtype.kind in "iu" else np.float64
    xp = np.pad(x, ((0, 0), (pads[0], pads[3]), (pads[1], pads[4]),
                    (pads[2], pads[5]), (0, 0))).astype(acc)
    kd, kh, kw, cin, cout = w.shape
    (n, od, oh, ow, _), _ = _conv3d_rel(node, [(x.shape, str(x.dtype)), (w.shape, str(w.dtype))])
    wa = w.astype(acc)
    out = np.zeros((n * od * oh * ow, cout), acc)
    for a in range(kd):
        for b in range(kh):
            for c in range(kw):
                tap = xp[:, a:a + sd * (od - 1) + 1:sd, b:b + sh * (oh - 1) + 1:sh,
                         c:c + sw * (ow - 1) + 1:sw]
                out += tap.reshape(-1, cin) @ wa[a, b, c]
    out = out.reshape(n, od, oh, ow, cout)
    odt = node.attrs.get("out_dtype")
    if odt:
        return out.astype(odt)
    return out.astype(np.int32 if x.dtype.kind in "iu" else dt.promote(str(x.dtype), str(w.dtype)))


@torch_impl("nn.conv3d")
def _conv3d_torch(x: torch.Tensor, w: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Float 3D conv: NDHWC / DHWIO seen as NCDHW / OIDHW by
    torch.nn.functional.conv3d, asymmetric padding applied first."""
    _float_only(x, node)
    pads = _pad6(node.attrs.get("padding", (0,) * 6))
    xt = x.to(torch.float32).permute(0, 4, 1, 2, 3)
    front, back = pads[:3], pads[3:]
    if front != back:
        xt = torch.nn.functional.pad(xt, (pads[2], pads[5], pads[1], pads[4], pads[0], pads[3]))
        front = [0, 0, 0]
    with float32_products():
        out = torch.nn.functional.conv3d(
            xt, w.to(torch.float32).permute(4, 3, 0, 1, 2),
            stride=_triple(node.attrs.get("strides", (1, 1, 1))), padding=tuple(front),
            dilation=_triple(node.attrs.get("dilation", (1, 1, 1))))
    return _to_out_dtype(out.permute(0, 2, 3, 4, 1), node, x)


register_op("nn.conv3d", infer=_conv3d_rel)


# ---------------------------------------------------------------------------
# vision.non_max_suppression
# ---------------------------------------------------------------------------

@infer_rule("vision.non_max_suppression")
def _nms_rel(node: Node, ins):
    (bs, _) = ins[0]  # (batch, num_boxes, 4)
    k = int(node.attrs.get("max_output_size", bs[1]))
    return (bs[0], k), "int32"


def _iou(box, boxes):
    # corner format (y1, x1, y2, x2)
    y1 = np.maximum(box[0], boxes[:, 0])
    x1 = np.maximum(box[1], boxes[:, 1])
    y2 = np.minimum(box[2], boxes[:, 2])
    x2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    a0 = (box[2] - box[0]) * (box[3] - box[1])
    a1 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a0 + a1 - inter, 1e-9)


@np_impl("vision.non_max_suppression")
def _nms_np(boxes, scores, *, node: Node):
    """Per-batch greedy NMS -> top-k selected indices padded with -1
    (static-shape realization of `vision.non_max_suppression`)."""
    bsz, nbox = scores.shape
    k = int(node.attrs.get("max_output_size", nbox))
    iou_thr = float(node.attrs.get("iou_threshold", 0.5))
    score_thr = float(node.attrs.get("score_threshold", -np.inf))
    out = np.full((bsz, k), -1, np.int32)
    for b in range(bsz):
        order = np.argsort(-scores[b], kind="stable")
        kept = []
        for i in order:
            if len(kept) >= k or scores[b, i] <= score_thr:
                break
            if all(_iou(boxes[b, i], boxes[b, np.array(kept)]).max() <= iou_thr
                   for _ in [0]) if kept else True:
                kept.append(i)
        out[b, : len(kept)] = kept
    return out


NMS_CHECK_EVERY = 4  # fixed-point steps between two host reads of "changed"


@torch_impl("vision.non_max_suppression")
def _nms_torch(boxes: torch.Tensor, scores: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Greedy NMS with `_nms_jax`'s semantics, every image at once.  Box i of
    the sorted order is kept iff its score passes the threshold and no kept
    box j < i overlaps it by more than the IoU threshold.  Starting from
    "every box that passes the threshold", the step keep <- ok & ~any_j(keep_j
    & suppress_ji, j < i) makes box i right once boxes 0..i-1 are, so it
    reaches the greedy set in at most one step a box, and that set is its
    only fixed point: the loop stops at the first step that changes nothing.
    The j-th kept box (original index) goes to output slot j, the rest -1."""
    bsz, nbox = scores.shape
    k = int(node.attrs.get("max_output_size", nbox))
    iou_thr = float(np.float32(node.attrs.get("iou_threshold", 0.5)))
    score_thr = float(np.float32(node.attrs.get("score_threshold", -np.inf)))
    boxes, scores = boxes.to(torch.float32), scores.to(torch.float32)
    # the stable descending sort and the IoU of every pair of sorted boxes,
    # with the JAX package's arithmetic (`tail.py` _nms_jax) in float32
    order = torch.sort(-scores, dim=1, stable=True).indices
    sb = torch.gather(boxes, 1, order.unsqueeze(-1).expand(-1, -1, 4))
    ss = torch.gather(scores, 1, order)
    y1, x1, y2, x2 = sb.unbind(-1)
    area = (y2 - y1) * (x2 - x1)
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
    inter = torch.maximum(iy2 - iy1, zero) * torch.maximum(ix2 - ix1, zero)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = inter / torch.clamp_min(union, float(np.float32(1e-9)))
    ok = ss > score_thr
    earlier = torch.ones((nbox, nbox), dtype=torch.bool, device=boxes.device).triu(1)
    suppress = ((iou > iou_thr) & earlier).to(torch.float32)  # [b, j, i]: j < i overlaps i
    keep = ok
    for step in range(nbox):
        hit = torch.bmm(keep.to(torch.float32).unsqueeze(1), suppress).squeeze(1)
        new = ok & (hit == 0)
        changed = (new != keep).any()
        keep = new
        if step % NMS_CHECK_EVERY == NMS_CHECK_EVERY - 1 and not bool(changed):
            break
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep & (rank < k), rank, torch.full_like(rank, k))
    out = torch.full((bsz, k + 1), -1, dtype=torch.int32, device=boxes.device)
    out.scatter_(1, slot, order.to(torch.int32))
    return out[:, :k]
