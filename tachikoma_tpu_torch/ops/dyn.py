"""Data-dependent-shape ops, the `dyn.*` dialect (port of
`tachikoma_tpu/ops/dyn.py`).

Two kinds, as in the JAX package:

  * the bounded op `dyn.nonzero`: its output is padded to a static
    `max_count` with -1 and paired with the valid count, so it runs (and
    traces) like any static op.  The torch impl finds every entry's place
    among the nonzeros with a cumulative sum and writes the first
    `max_count` of them, in row-major order, with no host read;
  * sixteen shape-from-tensor ops, whose output SHAPE depends on a tensor
    VALUE.  Each has a fold (`DYN_FOLDERS`) that rewrites it, given the
    values of its shape inputs, into its static twin (`reshape`, `tile`,
    `full`, `topk`, ...).  The numpy oracle, the torch impl and the
    dispatch-time specializer (runtime/dynshape.py) all run the SAME fold,
    so the three agree by construction.  The torch impl reads the shape
    inputs to the host and calls the twin's torch impl; the specializer
    folds once per distinct shape and caches an executor of the static
    graph, so a request whose shapes were seen reads nothing.

The folds are the JAX package's, `dyn.image.resize2d`'s included: it drops
the optional `roi` input, as the reference's does (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import get_op, infer_rule, np_impl, register_op, torch_impl

# ---------------------------------------------------------------------------
# dyn.nonzero: bounded, (indices (max_count, ndim) int32 padded with -1,
#                         count (1,) int32)
# ---------------------------------------------------------------------------


@infer_rule("dyn.nonzero")
def _nonzero_rel(node: Node, ins):
    (s, _) = ins[0]
    mc = int(node.attrs["max_count"])
    return [((mc, max(len(s), 1)), "int32"), ((1,), "int32")]


@np_impl("dyn.nonzero")
def _nonzero_np(a, *, node: Node):
    mc = int(node.attrs["max_count"])
    nd = max(a.ndim, 1)
    idx = np.argwhere(a)  # (k, ndim), row-major (C) order
    k = min(len(idx), mc)
    out = np.full((mc, nd), -1, np.int32)
    if k:
        out[:k] = idx[:k]
    return [out, np.array([k], np.int32)]


@torch_impl("dyn.nonzero")
def _nonzero_torch(a: torch.Tensor, *, node: Node):
    """Entry e of the flattened input, when nonzero, is the r-th nonzero
    (r from a cumulative sum); the first max_count of them write their
    coordinates to row r, every other entry to a spare row that is dropped."""
    mc = int(node.attrs["max_count"])
    shape = tuple(a.shape) or (1,)
    nz = (a != 0).reshape(-1)
    rank = torch.cumsum(nz.to(torch.int64), 0) - 1
    slot = torch.where(nz & (rank < mc), rank, mc)
    coords = torch.stack(torch.unravel_index(torch.arange(nz.numel(), device=a.device), shape),
                         dim=-1).to(torch.int32)
    out = torch.full((mc + 1, len(shape)), -1, dtype=torch.int32, device=a.device)
    out.index_copy_(0, slot, coords)
    count = torch.clamp(nz.sum(), max=mc).to(torch.int32).reshape(1)
    return [out[:mc], count]


register_op("dyn.nonzero",
            flops=lambda node, ins: int(np.prod(ins[0][0] or (1,))))


# ---------------------------------------------------------------------------
# shape-from-tensor ops: one fold registry shared by the oracle impl, the
# torch impl and runtime/dynshape.py's dispatch-time specializer
# ---------------------------------------------------------------------------

# op -> (fold_positions, fold_fn(node, folded_vals) -> (static_op,
#        kept_input_positions, static_attrs))
DYN_FOLDERS: dict = {}


def dyn_fold(opname: str, positions: tuple):
    def deco(fn):
        DYN_FOLDERS[opname] = (positions, fn)
        return fn
    return deco


def fold_to_static(node: Node, vals) -> tuple[Node, tuple]:
    """(static twin node, kept original input positions) given the folded
    VALUES of the dyn node's shape inputs (in fold-position order)."""
    positions, fn = DYN_FOLDERS[node.op]
    op2, keep, attrs = fn(node, [np.asarray(v) for v in vals])
    n2 = node.with_(op=op2, inputs=tuple(node.inputs[i] for i in keep),
                    attrs=attrs)
    return n2, keep


def _ints(v) -> list:
    return [int(x) for x in np.asarray(v).ravel()]


@dyn_fold("dyn.reshape", (1,))
def _fold_reshape(node, vals):
    return "reshape", (0,), {"newshape": tuple(_ints(vals[0]))}


@dyn_fold("dyn.tile", (1,))
def _fold_tile(node, vals):
    return "tile", (0,), {"reps": tuple(_ints(vals[0]))}


@dyn_fold("dyn.broadcast_to", (1,))
def _fold_broadcast_to(node, vals):
    return "broadcast_to", (0,), {"shape": tuple(_ints(vals[0]))}


@dyn_fold("dyn.full", (0, 1))
def _fold_full(node, vals):
    fill, shp = vals
    dtype = node.attrs.get("dtype") or str(fill.dtype)
    return "full", (), {"shape": tuple(_ints(shp)),
                        "fill_value": fill.ravel()[0].item(),
                        "dtype": dtype}


@dyn_fold("dyn.one_hot", (1,))
def _fold_one_hot(node, vals):
    attrs = dict(node.attrs)
    attrs["depth"] = int(np.asarray(vals[0]).ravel()[0])
    return "one_hot", (0,), attrs


@dyn_fold("dyn.strided_slice", (1, 2, 3))
def _fold_strided_slice(node, vals):
    begin, end, strides = (_ints(v) for v in vals)
    attrs = {"begin": begin, "end": end, "strides": strides}
    if node.attrs.get("axes") is not None:
        attrs["axes"] = list(node.attrs["axes"])
    return "strided_slice", (0,), attrs


@dyn_fold("dyn.topk", (1,))
def _fold_topk(node, vals):
    attrs = dict(node.attrs)
    attrs["k"] = int(np.asarray(vals[0]).ravel()[0])
    return "topk", (0,), attrs


@dyn_fold("dyn.ones", (0,))
def _fold_ones(node, vals):
    return "ones", (), {"shape": tuple(_ints(vals[0])),
                        "dtype": node.attrs.get("dtype", "float32")}


@dyn_fold("dyn.zeros", (0,))
def _fold_zeros(node, vals):
    return "zeros", (), {"shape": tuple(_ints(vals[0])),
                         "dtype": node.attrs.get("dtype", "float32")}


@dyn_fold("dyn.expand_dims", (1,))
def _fold_expand_dims(node, vals):
    return "expand_dims", (0,), {
        "axis": int(np.asarray(vals[0]).ravel()[0]),
        "num_newaxis": int(node.attrs.get("num_newaxis", 1))}


@dyn_fold("dyn.squeeze", (1,))
def _fold_squeeze(node, vals):
    return "squeeze", (0,), {"axis": _ints(vals[0])}


@dyn_fold("dyn.sparse_to_dense", (3,))
def _fold_sparse_to_dense(node, vals):
    # inputs: (sparse_indices, sparse_values, default_value, output_shape)
    return "sparse_to_dense", (0, 1, 2), {
        "output_shape": tuple(_ints(vals[0]))}


@dyn_fold("dyn.nn.pad", (1, 2))
def _fold_nn_pad(node, vals):
    pw, pv = vals
    pw = np.asarray(pw).reshape(-1, 2)
    return "nn.pad", (0,), {
        "pad_width": [(int(b), int(e)) for b, e in pw],
        "pad_value": pv.ravel()[0].item(),
        "pad_mode": node.attrs.get("pad_mode", "constant")}


@dyn_fold("dyn.nn.upsampling", (1, 2))
def _fold_nn_upsampling(node, vals):
    attrs = dict(node.attrs)
    attrs["scale_h"] = float(np.asarray(vals[0]).ravel()[0])
    attrs["scale_w"] = float(np.asarray(vals[1]).ravel()[0])
    return "nn.upsampling", (0,), attrs


@dyn_fold("dyn.nn.upsampling3d", (1, 2, 3))
def _fold_nn_upsampling3d(node, vals):
    attrs = dict(node.attrs)
    attrs["scale_d"] = float(np.asarray(vals[0]).ravel()[0])
    attrs["scale_h"] = float(np.asarray(vals[1]).ravel()[0])
    attrs["scale_w"] = float(np.asarray(vals[2]).ravel()[0])
    return "nn.upsampling3d", (0,), attrs


@dyn_fold("dyn.image.resize2d", (1,))
def _fold_image_resize2d(node, vals):
    # the reference's fold: roi (an optional third input) is dropped
    attrs = dict(node.attrs)
    attrs["size"] = tuple(_ints(vals[0]))
    return "image.resize2d", (0,), attrs


def _delegate_np(*args, node: Node):
    positions, _ = DYN_FOLDERS[node.op]
    n2, keep = fold_to_static(node, [args[p] for p in positions])
    return get_op(n2.op).np_impl(*[args[i] for i in keep], node=n2)


def to_host(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _delegate_torch(*args, node: Node):
    """The shape inputs read to the host (the one host read of an
    unspecialized dyn op), folded, and the static twin's torch impl run."""
    positions, _ = DYN_FOLDERS[node.op]
    n2, keep = fold_to_static(node, [to_host(args[p]) for p in positions])
    return get_op(n2.op).torch_impl(*[args[i] for i in keep], node=n2)


def _dyn_data_rel(node: Node, ins):
    # output shape depends on a tensor VALUE: statically unknown until the
    # dispatch-time specializer (runtime/dynshape.py) folds it
    return (None, ins[0][1])


@infer_rule("dyn.full")
def _dyn_full_rel(node: Node, ins):
    return (None, node.attrs.get("dtype") or ins[0][1])


@infer_rule("dyn.one_hot")
def _dyn_one_hot_rel(node: Node, ins):
    return (None, node.attrs.get("dtype", "float32"))


@infer_rule("dyn.topk")
def _dyn_topk_rel(node: Node, ins):
    vdt = ins[0][1]
    idt = node.attrs.get("dtype", "int32")
    ret = node.attrs.get("ret_type", "both")
    if ret == "both":
        return [(None, vdt), (None, idt)]
    return (None, vdt if ret == "values" else idt)


@infer_rule("dyn.ones")
def _dyn_ones_rel(node: Node, ins):
    return (None, node.attrs.get("dtype", "float32"))


@infer_rule("dyn.zeros")
def _dyn_zeros_rel(node: Node, ins):
    return (None, node.attrs.get("dtype", "float32"))


@infer_rule("dyn.sparse_to_dense")
def _dyn_std_rel(node: Node, ins):
    return (None, ins[1][1])


for _name in ("dyn.reshape", "dyn.tile", "dyn.broadcast_to", "dyn.strided_slice",
              "dyn.expand_dims", "dyn.squeeze", "dyn.nn.pad", "dyn.nn.upsampling",
              "dyn.nn.upsampling3d", "dyn.image.resize2d"):
    infer_rule(_name)(_dyn_data_rel)

for _name in DYN_FOLDERS:
    register_op(_name, np_impl=_delegate_np, torch_impl=_delegate_torch,
                flops=lambda node, ins: 0)
