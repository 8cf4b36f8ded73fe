"""Ops of the JAX package's operator long tail (port of part of
`tachikoma_tpu/ops/tail.py`): the two the vision zoo needs, `nn.conv3d`
(the 3D ResNet's float convolutions, NDHWC data, DHWIO weights) and
`vision.non_max_suppression` (SSD-lite's per-image greedy NMS), the five
the ONNX importer emits: `scatter_elements`, `scatter_nd`, `gather_nd`,
`einsum` and `trilu`, and the static twins that the `dyn.*` folds emit
(ops/dyn.py): `full`, `ones`, `zeros`, `sparse_to_dense`, with `shape_of`,
where a shape-feeding subgraph starts.  The rest of that file waits for
ROADMAP Queue 1 item 9.4.

None has a Pallas kernel in the JAX package (XLA's conv, scatter, gather and
dot, and a `lax.fori_loop`), so their torch impls are a library call or
plain torch:
- nn.conv3d is torch.nn.functional.conv3d in float32 (TF32 off under
  ops/nn.py float32_products), summed in cuDNN's order, not the oracle's;
- the NMS computes the IoU matrix of the score-sorted boxes once and then
  finds the greedy keep set as the fixed point of "kept = above the score
  threshold and not suppressed by a kept box before it", one matrix-vector
  step an iteration, with one host read of a flag every few steps and none
  per box;
- an integer einsum is a broadcast product summed in int64 (CUDA has no
  integer matmul), a float one torch.einsum in float32;
- `full` / `ones` / `zeros` have no tensor input and make their output on
  the device of the graph walk (ops/nn.py `walk_device`);
- `sparse_to_dense` writes each index's value with the oracle's last write
  winning among repeated indices, chosen by a scatter of positions (amax),
  so that no host read and no nondeterministic scatter is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import infer_rule, np_impl, register_op, torch_impl
from ..utils import dtypes as dt
from .fixed_point import torch_dtype
from .nn import _float_only, _to_out_dtype, float32_products, index_in_range, walk_device


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


# ---------------------------------------------------------------------------
# the ONNX importer's scatter / gather family, einsum and trilu.  Negative
# indices count from the end and an index out of range raises, as numpy's
# indexing in the oracles does (ops/nn.py index_in_range); a destination
# written twice keeps the last write in the oracle's order (torch's scatter
# leaves that order unspecified on CUDA); accumulations into one
# destination add in the oracle's order on the CPU and in CUDA's atomic
# order on the card (integers are exact in every order).
# ---------------------------------------------------------------------------

def _last_writes(dest: torch.Tensor, size: int) -> torch.Tensor:
    """For each write i to dest[i] (in order), the slot it should land in:
    dest[i] if no later write hits the same slot, else `size`, a spare slot
    past the end; so a scatter of unique slots keeps the last write."""
    pos = torch.arange(dest.numel(), device=dest.device)
    last = torch.full((size,), -1, dtype=torch.int64, device=dest.device)
    last.scatter_reduce_(0, dest, pos, reduce="amax")
    return torch.where(last[dest] == pos, dest, torch.full_like(dest, size))


def _write_rows(out: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
                add: bool) -> torch.Tensor:
    """out (P, R) with values (M, R) written to rows (M,), in order: a sum
    (index_add_) or the last write of each row."""
    if add:
        return out.index_add_(0, rows, values.to(out.dtype))
    spare = torch.cat([out, out[:1]])
    spare.index_copy_(0, _last_writes(rows, out.shape[0]), values.to(out.dtype))
    return spare[:-1]


@infer_rule("scatter_elements")
def _scatter_rel(node: Node, ins):
    return ins[0]


def _scatter_np_core(data, indices, updates, axis, reduce_):
    out = data.copy()
    idx = indices.astype(np.int64)
    idx = np.where(idx < 0, idx + data.shape[axis], idx)
    if reduce_ == "update":
        np.put_along_axis(out, idx, updates, axis=axis)
    elif reduce_ == "add":
        grid = list(np.meshgrid(*[np.arange(s) for s in idx.shape], indexing="ij"))
        grid[axis] = idx
        np.add.at(out, tuple(grid), updates)
    else:
        raise NotImplementedError(reduce_)
    return out


@np_impl("scatter_elements")
def _scatter_np(data, indices, updates, *, node: Node):
    axis = int(node.attrs.get("axis", 0)) % data.ndim
    return _scatter_np_core(data, indices, updates, axis,
                            node.attrs.get("reduction", "update"))


@torch_impl("scatter_elements")
def _scatter_torch(data: torch.Tensor, indices: torch.Tensor, updates: torch.Tensor, *,
                   node: Node) -> torch.Tensor:
    """The oracle: a negative index gets the axis' size added once (then
    numpy's own indexing wraps a second time), each element of `updates`
    goes to its place in C order, "update" keeping the last write and
    "add" summing."""
    red = node.attrs.get("reduction", "update")
    if red not in ("update", "add"):
        raise NotImplementedError(red)
    axis = int(node.attrs.get("axis", 0)) % data.ndim
    n = data.shape[axis]
    idx = indices.to(torch.int64)
    idx = index_in_range(torch.where(idx < 0, idx + n, idx), n, node.name)
    # each element's coordinates: idx on `axis`, elsewhere an arange over the
    # data's axis (np.put_along_axis, which broadcasts them) or over the
    # indices' (the oracle's meshgrid for "add")
    base = data.shape if red == "update" else idx.shape
    coords = [idx if d == axis else
              torch.arange(base[d], device=data.device).reshape(
                  [base[d] if e == d else 1 for e in range(data.ndim)])
              for d in range(data.ndim)]
    coords = torch.broadcast_tensors(*coords)
    dest = torch.zeros_like(coords[0])
    for d in range(data.ndim):
        dest = dest * data.shape[d] + coords[d]
    upd = updates.expand(dest.shape)
    out = _write_rows(data.reshape(-1, 1).clone(), dest.reshape(-1), upd.reshape(-1, 1),
                      red == "add")
    return out.reshape(data.shape)


def _nd_rows(data: torch.Tensor, indices: torch.Tensor, what: str) -> torch.Tensor:
    """The row of data viewed as (prod(shape[:K]), rest) that each index
    tuple of indices (..., K) names, wrapped and checked as numpy's
    indexing does."""
    k = indices.shape[-1]
    flat = indices.reshape(-1, k).to(torch.int64)
    rows = torch.zeros(flat.shape[0], dtype=torch.int64, device=data.device)
    for j in range(k):
        rows = rows * data.shape[j] + index_in_range(flat[:, j], data.shape[j], what)
    return rows


@infer_rule("scatter_nd")
def _scatter_nd_rel(node: Node, ins):
    return ins[0]


@np_impl("scatter_nd")
def _scatter_nd_np(data, indices, updates, *, node: Node):
    # indices (..., K) index the first K dims of data; updates (..., rest)
    out = data.copy()
    k = indices.shape[-1]
    flat_idx = indices.reshape(-1, k).astype(np.int64)
    flat_upd = updates.reshape(-1, *data.shape[k:])
    mode = node.attrs.get("mode", "update")
    for i, ix in enumerate(map(tuple, flat_idx)):
        if mode == "add":
            out[ix] = out[ix] + flat_upd[i]
        else:
            out[ix] = flat_upd[i]
    return out


@torch_impl("scatter_nd")
def _scatter_nd_torch(data: torch.Tensor, indices: torch.Tensor, updates: torch.Tensor, *,
                      node: Node) -> torch.Tensor:
    """The oracle's loop: each index tuple's slice written in order ("add"
    under the attr `mode`, which the oracle reads; ONNX's `reduction` attr
    does not reach it)."""
    k = indices.shape[-1]
    rows = _nd_rows(data, indices, node.name)
    rest = int(np.prod(data.shape[k:]))
    out = _write_rows(data.reshape(-1, rest).clone(), rows, updates.reshape(-1, rest),
                      node.attrs.get("mode", "update") == "add")
    return out.reshape(data.shape)


@infer_rule("gather_nd")
def _gather_nd_rel(node: Node, ins):
    (ds, ddt), (isx, _) = ins[0], ins[1]
    k = isx[-1]
    return tuple(isx[:-1]) + tuple(ds[k:]), ddt


@np_impl("gather_nd")
def _gather_nd_np(data, indices, *, node: Node):
    k = indices.shape[-1]
    flat = indices.reshape(-1, k).astype(np.int64)
    out = np.stack([data[tuple(ix)] for ix in flat])
    return out.reshape(*indices.shape[:-1], *data.shape[k:])


@torch_impl("gather_nd")
def _gather_nd_torch(data: torch.Tensor, indices: torch.Tensor, *, node: Node) -> torch.Tensor:
    k = indices.shape[-1]
    rest = int(np.prod(data.shape[k:]))
    out = data.reshape(-1, rest).index_select(0, _nd_rows(data, indices, node.name))
    return out.reshape(*indices.shape[:-1], *data.shape[k:])


@infer_rule("einsum")
def _einsum_rel(node: Node, ins):
    eq = node.attrs["equation"]
    shapes = [s for (s, _) in ins]
    out = np.einsum(eq, *[np.zeros(s, np.int8) for s in shapes])
    return tuple(out.shape), ins[0][1]


@np_impl("einsum")
def _einsum_np(*args, node: Node):
    acc = np.int64 if args[0].dtype.kind in "iu" else None
    out = np.einsum(node.attrs["equation"],
                    *[a.astype(acc) if acc else a for a in args])
    return out.astype(args[0].dtype if acc is None else
                      node.attrs.get("out_dtype", "int32"))


def _einsum_terms(eq: str, ndims) -> tuple[list[str], str]:
    """The input terms and the output term of `eq` with each ellipsis spelt
    out in letters the equation does not use (right-aligned, as numpy
    broadcasts them), and numpy's implicit output where `->` is absent: the
    ellipsis, then the letters seen once, sorted."""
    eq = eq.replace(" ", "")
    lhs, _, rhs = eq.partition("->")
    terms = lhs.split(",")
    free = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n_ell = max([nd - (len(t) - 3) for t, nd in zip(terms, ndims) if "..." in t] or [0])
    ell = "".join(free[:n_ell])
    terms = [t.replace("...", ell[n_ell - (nd - (len(t) - 3)):]) for t, nd in zip(terms, ndims)]
    if "->" not in eq:
        seen = "".join(terms)
        rhs = ell + "".join(sorted(c for c in set(seen) if seen.count(c) == 1 and c not in ell))
    return terms, rhs.replace("...", ell)


def _einsum_int64(eq: str, args) -> torch.Tensor:
    """An integer einsum in int64, exact (a product and a sum wrap modulo
    2^64 in every order, as numpy's int64 einsum does): each operand's
    repeated letters taken as diagonals, the operands broadcast over every
    letter and multiplied, the letters not in the output summed.  CUDA has
    no integer matmul, so torch.einsum cannot run it there."""
    terms, out = _einsum_terms(eq, [a.ndim for a in args])
    letters = list(out) + sorted({c for t in terms for c in t} - set(out))
    total = None
    for t, a in zip(terms, args):
        t = list(t)
        while len(set(t)) < len(t):  # "ii": the diagonal, its letter moved last
            c = next(c for c in t if t.count(c) > 1)
            i = t.index(c)
            j = t.index(c, i + 1)
            a = torch.diagonal(a, dim1=i, dim2=j)
            t = [x for m, x in enumerate(t) if m not in (i, j)] + [c]
        a = a.permute([t.index(c) for c in letters if c in t])
        a = a.reshape([a.shape[[c for c in letters if c in t].index(c)] if c in t else 1
                       for c in letters])
        total = a if total is None else total * a
    summed = tuple(range(len(out), len(letters)))
    return total.sum(dim=summed) if summed else total


@torch_impl("einsum")
def _einsum_torch(*args: torch.Tensor, node: Node) -> torch.Tensor:
    """Integers (the first operand's kind decides, as in the oracle): every
    operand in int64, summed exactly, the result in `out_dtype` (int32 by
    default).  Floats: torch.einsum in float32 (TF32 off), in cuBLAS's
    order, not numpy's."""
    eq = node.attrs["equation"]
    if not args[0].dtype.is_floating_point:
        out = _einsum_int64(eq, [a.to(torch.int64) for a in args])
        return out.to(torch_dtype(node.attrs.get("out_dtype", "int32")))
    dtype = dt.promote(*[str(a.dtype).removeprefix("torch.") for a in args[:2]])
    for a in args[2:]:
        dtype = dt.promote(dtype, str(a.dtype).removeprefix("torch."))
    with float32_products():
        out = torch.einsum(eq, *[a.to(torch_dtype(dtype)) for a in args])
    return out.to(args[0].dtype)


@infer_rule("trilu")
def _trilu_rel(node: Node, ins):
    return ins[0]


@np_impl("trilu")
def _trilu_np(a, *, node: Node):
    k = int(node.attrs.get("k", 0))
    return np.triu(a, k) if node.attrs.get("upper", True) else np.tril(a, k)


@torch_impl("trilu")
def _trilu_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    k = int(node.attrs.get("k", 0))
    return torch.triu(a, k) if node.attrs.get("upper", True) else torch.tril(a, k)


# ---------------------------------------------------------------------------
# creation ops, sparse_to_dense and shape_of: the static twins of the dyn.*
# folds (ops/dyn.py) and where a shape-feeding subgraph starts
# ---------------------------------------------------------------------------

def _creation(name, fill):
    def rel(node, ins):
        return tuple(node.attrs["shape"]), node.attrs.get("dtype", "float32")

    def fill_value(node):
        return node.attrs.get("fill_value", fill) if fill is None else fill

    def np_i(*args, node):
        return np.full(tuple(node.attrs["shape"]), fill_value(node),
                       node.attrs.get("dtype", "float32"))

    def torch_i(*args, node):
        dtype = node.attrs.get("dtype", "float32")
        # the fill converted to the dtype as numpy converts it (a float fill
        # of an integer tensor truncates)
        value = np.full((), fill_value(node), dtype).item()
        return torch.full(tuple(node.attrs["shape"]), value, dtype=torch_dtype(dtype),
                          device=walk_device())

    register_op(name, infer=rel, np_impl=np_i, torch_impl=torch_i)


_creation("zeros", 0)
_creation("ones", 1)
_creation("full", None)


@infer_rule("sparse_to_dense")
def _std_rel(node: Node, ins):
    return tuple(node.attrs["output_shape"]), ins[1][1]


def _std_index(indices):
    """The oracle's (n, c) index rows: one row per sparse entry, c leading
    dimensions of the output (a row shorter than the output's rank sets
    a slice)."""
    return indices.reshape(-1, indices.shape[-1]) if indices.ndim > 1 else indices.reshape(-1, 1)


@np_impl("sparse_to_dense")
def _std_np(indices, values, default, *, node: Node):
    shape = tuple(node.attrs["output_shape"])
    out = np.full(shape, default if np.ndim(default) == 0 else default.item(),
                  values.dtype)
    idx = _std_index(indices)
    for i, ix in enumerate(map(tuple, idx.astype(np.int64))):
        out[ix] = values.reshape(-1)[i] if values.ndim else values
    return out


@torch_impl("sparse_to_dense")
def _std_torch(indices: torch.Tensor, values: torch.Tensor, default: torch.Tensor, *,
               node: Node) -> torch.Tensor:
    """Row r of the output's leading c dimensions takes the value of the
    last sparse entry that names it, as the oracle's loop leaves it; the
    others keep the default."""
    shape = tuple(node.attrs["output_shape"])
    idx = _std_index(indices).to(torch.int64)
    n, c = idx.shape
    lead = shape[:c]
    rows = int(np.prod(lead, dtype=np.int64))
    dims = torch.tensor(lead, dtype=torch.int64, device=idx.device)
    idx = torch.where(idx < 0, idx + dims, idx)  # numpy's negative indices
    lin = torch.zeros(n, dtype=torch.int64, device=idx.device)
    for j in range(c):
        lin = lin * lead[j] + idx[:, j]
    pos = torch.full((rows,), -1, dtype=torch.int64, device=idx.device)
    pos = pos.scatter_reduce(0, lin, torch.arange(n, device=idx.device), "amax")
    vals = values.reshape(-1) if values.ndim else values.reshape(1).expand(n)
    base = default.reshape(()).to(values.dtype).expand(
        rows, int(np.prod(shape[c:], dtype=np.int64)))
    picked = vals[pos.clamp(min=0)].unsqueeze(-1)
    return torch.where((pos >= 0).unsqueeze(-1), picked, base).reshape(shape)


@infer_rule("shape_of")
def _shapeof_rel(node: Node, ins):
    return (len(ins[0][0]),), node.attrs.get("dtype", "int32")


@np_impl("shape_of")
def _shapeof_np(a, *, node: Node):
    return np.asarray(a.shape, node.attrs.get("dtype", "int32"))


@torch_impl("shape_of")
def _shapeof_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.tensor(tuple(a.shape), dtype=torch_dtype(node.attrs.get("dtype", "int32")),
                        device=a.device)
