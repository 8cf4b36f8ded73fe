"""Pre-quantization graph cleanups (port of `tachikoma_tpu/ir/transforms.py`).

The port carries the passes of the JAX package's `DEFAULT_SIMPLIFY` that can
fire on a graph built from the port's op set, in the same order.  The others
(`remove_identity`, `fold_scale_axis`, `fuse_pad_into_conv`,
`combine_parallel_dense`) rewrite ops the port does not register yet (copy,
cast, reshape, multiply, nn.pad, a merged dense needs strided_slice), so on
every graph the port can hold they are the identity, and the simplified graph
equals the JAX package's.

All passes are pure functions Graph -> Graph.
"""

from __future__ import annotations

import json

import numpy as np

from .graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph, GraphBuilder
from .infer import infer_types
from .registry import get_op


def fold_constant(graph: Graph) -> Graph:
    """Evaluate ops whose inputs are all constants, using the numpy oracle."""
    g = infer_types(graph)
    const_vals: dict[str, np.ndarray] = dict(g.params)
    b = GraphBuilder(g.name)
    mapping: dict[str, str] = {}
    for n in g.nodes:
        new_inputs = tuple(mapping[i] for i in n.inputs)
        if n.op == VAR:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
            continue
        if n.op == CONST:
            mapping[n.name] = b.const(g.params[n.name], name=n.name)
            continue
        if (
            n.op not in (TUPLE, TUPLE_GET_ITEM)
            and all(i in const_vals for i in n.inputs)
        ):
            op = get_op(n.op)
            if op.np_impl is not None:
                out = op.np_impl(*[const_vals[i] for i in n.inputs], node=n)
                if isinstance(out, np.ndarray):
                    const_vals[n.name] = out
                    mapping[n.name] = b.const(out, name=n.name)
                    continue
        mapping[n.name] = b.call(n.op, *new_inputs, name=n.name, **dict(n.attrs))
    return b.build([mapping[o] for o in g.outputs])


def eliminate_common_subexpr(graph: Graph) -> Graph:
    """Dedupe structurally identical nodes."""
    g = graph
    b = GraphBuilder(g.name)
    mapping: dict[str, str] = {}
    seen: dict[tuple, str] = {}
    for n in g.nodes:
        new_inputs = tuple(mapping[i] for i in n.inputs)
        if n.op == VAR:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
            continue
        if n.op == CONST:
            arr = g.params[n.name]
            key = (CONST, str(arr.dtype), arr.shape, arr.tobytes())
            if key in seen:
                mapping[n.name] = seen[key]
            else:
                new = b.const(arr, name=n.name)
                seen[key] = new
                mapping[n.name] = new
            continue
        key = (n.op, new_inputs, json.dumps(dict(n.attrs), sort_keys=True, default=str))
        if key in seen:
            mapping[n.name] = seen[key]
        else:
            new = b.call(n.op, *new_inputs, name=n.name, **dict(n.attrs))
            seen[key] = new
            mapping[n.name] = new
    return b.build([mapping[o] for o in g.outputs])


def fold_batch_norm(graph: Graph) -> Graph:
    """Fold inference-mode batch_norm into a preceding conv2d/dense.

    conv -> bn   becomes   conv(w * g', b') with
        g' = gamma / sqrt(var + eps),  b' = beta - mean * g'
    Applies only when conv output feeds the bn directly and the conv has a
    single consumer.
    """
    g = infer_types(graph)
    users = g.users()

    # bn node -> conv node to fold into
    foldable: dict[str, str] = {}
    for n in g.nodes:
        if n.op != "nn.batch_norm":
            continue
        src = g[n.inputs[0]]
        if src.op in ("nn.conv2d", "nn.dense") and len(users[src.name]) == 1:
            if all(g[i].is_const for i in n.inputs[1:]):
                foldable[n.name] = src.name

    if not foldable:
        return graph

    conv_to_bn = {v: k for k, v in foldable.items()}
    b = GraphBuilder(g.name)
    mapping: dict[str, str] = {}
    for n in g.nodes:
        if n.name in conv_to_bn:
            bn = g[conv_to_bn[n.name]]
            gamma, beta, mean, var = (g.params[i] for i in bn.inputs[1:])
            eps = np.float32(bn.attrs.get("epsilon", 1e-5))
            scale = (gamma / np.sqrt(var + eps)).astype(np.float32)
            shift = (beta - mean * scale).astype(np.float32)
            w = g.params[n.inputs[1]]
            # conv weight HWIO / dense weight (K, N): output channel is last
            w_new = (w * scale.reshape((1,) * (w.ndim - 1) + (-1,))).astype(w.dtype)
            new_inputs = [mapping[n.inputs[0]], b.const(w_new, name=n.inputs[1] + "_bnfold")]
            conv_new = b.call(n.op, *new_inputs, name=n.name, **dict(n.attrs))
            bias = b.const(shift, name=bn.name + "_bias")
            out = b.call("nn.bias_add", conv_new, bias, name=bn.name, axis=-1)
            mapping[n.name] = conv_new
            mapping[bn.name] = out
            continue
        if n.name in foldable:
            continue  # handled above
        if n.op == VAR:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
        elif n.op == CONST:
            if n.name in g.params:
                mapping[n.name] = b.const(g.params[n.name], name=n.name)
        else:
            new_inputs = tuple(mapping[i] for i in n.inputs)
            mapping[n.name] = b.call(n.op, *new_inputs, name=n.name, **dict(n.attrs))
    return b.build([mapping[o] for o in g.outputs])


def _compose_perm(p1, p2):
    """transpose(transpose(x, p1), p2) == transpose(x, [p1[i] for i in p2])."""
    return tuple(p1[i] for i in p2)


def _node_perm(g: Graph, n) -> tuple:
    ndim = len(g[n.inputs[0]].shape)
    axes = n.attrs.get("axes")
    return tuple(range(ndim))[::-1] if axes is None else tuple(a % ndim for a in axes)


def simplify_transposes(graph: Graph) -> Graph:
    """Collapse transpose chains and cancel identity transposes (frontends
    that bridge NCHW and NHWC leave back-to-back transposes)."""
    g = infer_types(graph)
    changed = True
    while changed:
        changed = False
        b = GraphBuilder(g.name)
        mapping: dict[str, str] = {}
        for n in g.nodes:
            if n.op == VAR:
                mapping[n.name] = b.var(n.name, n.shape, n.dtype)
                continue
            if n.op == CONST:
                mapping[n.name] = b.const(g.params[n.name], name=n.name)
                continue
            if n.op == "transpose":
                perm = _node_perm(g, n)
                src = g[n.inputs[0]]
                if src.op == "transpose":
                    perm = _compose_perm(_node_perm(g, src), perm)
                    changed = True
                    if perm == tuple(range(len(perm))):
                        mapping[n.name] = mapping[src.inputs[0]]
                    else:
                        mapping[n.name] = b.call("transpose", mapping[src.inputs[0]],
                                                 name=n.name, axes=list(perm))
                    continue
                if perm == tuple(range(len(perm))):
                    mapping[n.name] = mapping[n.inputs[0]]
                    changed = True
                    continue
            mapping[n.name] = b.call(n.op, *[mapping[i] for i in n.inputs],
                                     name=n.name, **dict(n.attrs))
        g = b.build([mapping[o] for o in g.outputs]).dead_code_eliminate()
    return g


DEFAULT_SIMPLIFY = (fold_constant, simplify_transposes, fold_batch_norm,
                    eliminate_common_subexpr)


def simplify(graph: Graph) -> Graph:
    """Standard pre-quantization cleanup pipeline."""
    g = graph
    for p in DEFAULT_SIMPLIFY:
        g = p(g)
    return infer_types(g)
