"""Pre-quantization graph cleanups (port of `tachikoma_tpu/ir/transforms.py`).

The port carries four passes of the JAX package's `DEFAULT_SIMPLIFY`, in the
same order.  The other four are not ported yet: `fuse_pad_into_conv` (nn.pad
is not registered), `remove_identity` (same-shape reshape / broadcast_to,
copy, cast), `fold_scale_axis` (multiply by a per-channel constant after or
before a conv / dense) and `combine_parallel_dense` (sibling denses on one
input, such as BERT's Q/K/V, into one dense and strided slices).  None fires
on the int8 CNN graphs (ResNet, MobileNetV2, the trained fixture), so their
simplified graph equals the JAX package's.  On the transformer graphs
`combine_parallel_dense` fires in the JAX package, so `simplify` differs
there; the transformer path runs its float graphs unsimplified, through
`fuse_attention` alone, and the missing passes come with the quantizer's
transformer handlers.

`fuse_attention` is opt-in, as in the JAX package: not part of `simplify`.

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


def fuse_attention(graph: Graph) -> Graph:
    """Fuse the float attention subgraph into tk.attention (K6 on the card;
    ops/attention.py):

        bmm(q, k, transpose_b=True) -> multiply(scalar const)
          -> [add(causal mask const)] -> nn.softmax(axis=-1) -> bmm(., v)

    The mask branch fuses only when the constant is the additive causal
    triangle the zoo's decoder builds (upper triangle == constant negative,
    lower == 0); its -C value is approximated by the hard causal mask
    (difference exp(-C), ~1e-13 for C=30).  Opt-in (float/serving path) --
    not part of DEFAULT_SIMPLIFY."""
    g = infer_types(graph) if any(
        n.shape is None and n.dtype != "tuple" for n in graph.nodes) else graph
    users = g.users()
    outs = set(g.outputs)

    def single_user(name):
        if name in outs:
            return None
        u = users.get(name, ())
        return g[u[0]] if len(u) == 1 else None

    def scalar_const(name):
        nd = g[name] if name in g else None
        if nd is not None and nd.is_const and g.params[name].size == 1:
            return float(g.params[name].reshape(()))
        return None

    def causal_mask_const(name):
        nd = g[name] if name in g else None
        if nd is None or not nd.is_const:
            return False
        arr = np.asarray(g.params[name])
        if arr.ndim < 2 or arr.shape[-1] != arr.shape[-2]:
            return False
        m = arr.reshape(arr.shape[-2], arr.shape[-1])
        low = np.tril(np.ones_like(m, bool))
        return bool((m[low] == 0).all() and (m[~low] < -10).all())

    fused = {}      # final bmm name -> (q, k, v, scale, causal)
    consumed = set()
    for n in g.nodes:
        if n.op != "nn.batch_matmul" or not n.attrs.get("transpose_b"):
            continue
        mul = single_user(n.name)
        if mul is None or mul.op != "multiply":
            continue
        sc = scalar_const(mul.inputs[1]) or scalar_const(mul.inputs[0])
        if sc is None:
            continue
        cur = single_user(mul.name)
        causal = False
        mask = None
        if cur is not None and cur.op == "add":
            other = cur.inputs[1] if cur.inputs[0] == mul.name else cur.inputs[0]
            if not causal_mask_const(other):
                continue
            causal, mask = True, cur
            cur = single_user(cur.name)
        if cur is None or cur.op != "nn.softmax" or int(
                cur.attrs.get("axis", -1)) not in (-1, 3):
            continue
        sm = cur
        bmm2 = single_user(sm.name)
        if bmm2 is None or bmm2.op != "nn.batch_matmul" \
                or bmm2.inputs[0] != sm.name \
                or bmm2.attrs.get("transpose_a") or bmm2.attrs.get("transpose_b"):
            continue
        fused[bmm2.name] = (n.inputs[0], n.inputs[1], bmm2.inputs[1],
                            sc, causal)
        for m in (n, mul, sm, mask):
            if m is not None:
                consumed.add(m.name)

    if not fused:
        return g

    b = GraphBuilder(g.name)
    mapping = {}
    for n in g.nodes:
        if n.is_var:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
        elif n.is_const:
            mapping[n.name] = b.const(g.params[n.name], name=n.name)
    for n in g.nodes:
        if n.name in mapping or n.name in consumed:
            continue
        if n.name in fused:
            q, k, v, sc, causal = fused[n.name]
            mapping[n.name] = b.call(
                "tk.attention", mapping[q], mapping[k], mapping[v],
                name=n.name, scale=sc, causal=causal)
            continue
        ins = [mapping[i] for i in n.inputs]
        mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
    return infer_types(b.build([mapping[o] for o in g.outputs])
                       .dead_code_eliminate())
