"""Pre-quantization graph cleanups (port of `tachikoma_tpu/ir/transforms.py`).

The port carries the eight passes of the JAX package's `DEFAULT_SIMPLIFY`,
copied, in the same order: fold_constant, simplify_transposes,
remove_identity, fold_batch_norm, fold_scale_axis, fuse_pad_into_conv,
combine_parallel_dense, eliminate_common_subexpr.  Node names, their order
and the folded parameters' bytes come out equal to the JAX package's (the
trace records and the structural hash depend on them): on BERT,
`combine_parallel_dense` merges Q/K/V into `<input>__qkv` and three strided
slices, and `fold_scale_axis` folds the attention's scalar multiplies where
they follow a dense.

`fuse_attention` is opt-in, as in the JAX package: not part of `simplify`.

All passes are pure functions Graph -> Graph.
"""

from __future__ import annotations

import json

import numpy as np

from .graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph, GraphBuilder, Node
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


def fuse_pad_into_conv(graph: Graph) -> Graph:
    """Merge a zero-constant nn.pad feeding conv2d/pool into the op's own
    padding attr."""
    g = infer_types(graph)
    users = g.users()
    b = GraphBuilder(g.name)
    mapping: dict[str, str] = {}
    absorbed: set[str] = set()
    for n in g.nodes:
        if (
            n.op == "nn.pad"
            and n.attrs.get("pad_mode", "constant") == "constant"
            and float(n.attrs.get("pad_value", 0)) == 0.0
            and len(n.attrs["pad_width"]) == 4
            and tuple(n.attrs["pad_width"][0]) == (0, 0)
            and tuple(n.attrs["pad_width"][3]) == (0, 0)
            and all(g[u].op == "nn.conv2d" for u in users[n.name])
            and users[n.name]
        ):
            absorbed.add(n.name)
            mapping[n.name] = mapping[n.inputs[0]]
            continue
        if n.op == VAR:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
        elif n.op == CONST:
            mapping[n.name] = b.const(g.params[n.name], name=n.name)
        else:
            attrs = dict(n.attrs)
            if n.op == "nn.conv2d" and n.inputs[0] in absorbed:
                pad = g[n.inputs[0]].attrs["pad_width"]
                (pt, pb), (pl, pr) = pad[1], pad[2]
                from ..ops.nn import _pad4

                opt, opl, opb, opr = _pad4(attrs.get("padding", (0, 0, 0, 0)))
                attrs["padding"] = (opt + pt, opl + pl, opb + pb, opr + pr)
            new_inputs = tuple(mapping[i] for i in n.inputs)
            mapping[n.name] = b.call(n.op, *new_inputs, name=n.name, **attrs)
    return b.build([mapping[o] for o in g.outputs])


def combine_parallel_dense(graph: Graph) -> Graph:
    """Merge sibling nn.dense ops sharing the same input into ONE matmul
    with concatenated weight columns + a split.  BERT's Q/K/V projections become one GEMM; per-channel quantization
    scales survive the concat unchanged."""
    g = infer_types(graph)
    users = g.users()
    # group dense users of each producer by (weight K dim)
    groups: dict[str, list[Node]] = {}
    for n in g.nodes:
        if (n.op == "nn.dense" and len(n.inputs) == 2
                and g[n.inputs[1]].is_const
                and not n.attrs.get("out_dtype")):
            groups.setdefault(n.inputs[0], []).append(n)

    merge: dict[str, tuple] = {}   # dense node name -> (group key, col slice)
    merged_groups = {}
    for src, nodes in groups.items():
        if len(nodes) < 2:
            continue
        # every member's FULL user set must be the dense itself (simple case)
        ws = [g.params[n.inputs[1]] for n in nodes]
        if any(w.ndim != 2 for w in ws):
            continue
        key = f"{src}__qkv"
        off = 0
        slices = []
        for n, w in zip(nodes, ws):
            slices.append((off, off + w.shape[1]))
            off += w.shape[1]
        merged_groups[key] = (src, nodes, ws, slices)
        for n, sl in zip(nodes, slices):
            merge[n.name] = (key, sl)

    if not merged_groups:
        return g

    b = GraphBuilder(g.name)
    mapping: dict[str, str] = {}
    emitted: dict[str, str] = {}
    for n in g.nodes:
        if n.op == VAR:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
        elif n.op == CONST:
            mapping[n.name] = b.const(g.params[n.name], name=n.name)
        elif n.name in merge:
            key, (lo, hi) = merge[n.name]
            if key not in emitted:
                src, nodes, ws, slices = merged_groups[key]
                wcat = np.concatenate(ws, axis=1)
                wname = b.const(wcat, name=key + "_w")
                emitted[key] = b.call("nn.dense", mapping[src], wname,
                                      name=key)
            ndim = len(n.shape)
            mapping[n.name] = b.call(
                "strided_slice", emitted[key],
                begin=[0] * (ndim - 1) + [lo],
                end=list(n.shape[:-1]) + [hi],
                strides=[1] * ndim, name=n.name)
        else:
            mapping[n.name] = b.call(
                n.op, *[mapping[i] for i in n.inputs], name=n.name,
                **dict(n.attrs))
    return infer_types(b.build([mapping[o] for o in g.outputs]))


def _channel_scale(g: Graph, name: str, channels: int) -> np.ndarray | None:
    """A const usable as a per-output-channel scale: scalar or (C,) (possibly
    wrapped in leading 1s, e.g. (1,1,1,C))."""
    n = g[name]
    if not n.is_const:
        return None
    v = g.params[name]
    if v.size == 1:
        return np.full((channels,), v.reshape(()), v.dtype)
    squeezed = v.reshape(-1) if v.ndim and v.size == v.shape[-1] else None
    if squeezed is not None and squeezed.shape == (channels,):
        return squeezed
    return None


def fold_scale_axis(graph: Graph) -> Graph:
    """Fold per-channel multiplies into adjacent conv2d/dense weights.

    Backward: ``multiply(conv(x, w), s)`` -> ``conv(x, w * s[cout])``
    Forward:  ``conv(multiply(x, s), w)`` -> ``conv(x, w * s[cin])``
    (dense analogously on its K/N axes).  Applies when the scale is a const
    scalar or per-channel vector and the producer has a single consumer.
    """
    g = infer_types(graph)
    users = g.users()

    # ---- backward: multiply-after --------------------------------------
    fold_after: dict[str, str] = {}  # mul node -> producer conv/dense
    for n in g.nodes:
        if n.op != "multiply" or len(n.inputs) != 2:
            continue
        for xi, si in ((0, 1), (1, 0)):
            src = g[n.inputs[xi]]
            if (src.op in ("nn.conv2d", "nn.dense")
                    and len(users[src.name]) == 1
                    and g[src.inputs[1]].is_const
                    and src.name not in fold_after.values()):
                cout = src.shape[-1]
                s = _channel_scale(g, n.inputs[si], cout)
                if s is not None:
                    fold_after[n.name] = src.name
                    break

    # ---- forward: multiply-before --------------------------------------
    fold_before: dict[str, str] = {}  # conv/dense node -> mul producer
    for n in g.nodes:
        if n.op not in ("nn.conv2d", "nn.dense"):
            continue
        if n.op == "nn.conv2d" and int(n.attrs.get("groups", 1)) != 1:
            continue
        src = g[n.inputs[0]]
        if (src.op == "multiply" and len(src.inputs) == 2
                and len(users[src.name]) == 1
                and g[n.inputs[1]].is_const
                and src.name not in fold_after):
            cin = g[src.name].shape[-1]
            for xi, si in ((0, 1), (1, 0)):
                s = _channel_scale(g, src.inputs[si], cin)
                if s is not None and not g[src.inputs[xi]].is_const:
                    fold_before[n.name] = (src.name, src.inputs[xi], s)
                    break

    if not fold_after and not fold_before:
        return graph

    after_by_src = {v: k for k, v in fold_after.items()}
    skip_muls = set(fold_after) | {v[0] for v in fold_before.values()}
    b = GraphBuilder(g.name)
    mapping: dict[str, str] = {}
    for n in g.nodes:
        if n.op == VAR:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
            continue
        if n.op == CONST:
            mapping[n.name] = b.const(g.params[n.name], name=n.name)
            continue
        if n.name in skip_muls and n.name not in fold_after:
            # forward-folded multiply: forward its data input
            xin = next(v[1] for v in fold_before.values() if v[0] == n.name)
            mapping[n.name] = mapping[xin]
            continue
        if n.name in fold_after:
            mapping[n.name] = mapping[fold_after[n.name]]
            continue
        if n.op in ("nn.conv2d", "nn.dense"):
            w = g.params[n.inputs[1]]
            wname = n.inputs[1]
            suffix = ""
            if n.name in fold_before:
                _, _, s = fold_before[n.name]
                # scale the INPUT-channel axis: conv HWIO axis -2, dense K axis 0
                axis = -2 if n.op == "nn.conv2d" else 0
                shape = [1] * w.ndim
                shape[axis] = w.shape[axis]
                w = (w.astype(np.float64)
                     * s.astype(np.float64).reshape(shape)).astype(w.dtype)
                suffix += "_fsf"
            if n.name in after_by_src:
                mul = g[after_by_src[n.name]]
                si = mul.inputs[1] if mul.inputs[0] == n.name else mul.inputs[0]
                s = _channel_scale(g, si, n.shape[-1])
                w = (w.astype(np.float64)
                     * s.astype(np.float64).reshape((1,) * (w.ndim - 1) + (-1,))
                     ).astype(w.dtype)
                suffix += "_fsb"
            new_inputs = [mapping[n.inputs[0]]]
            if suffix:
                new_inputs.append(b.const(w, name=wname + suffix))
            else:
                new_inputs.append(mapping[n.inputs[1]])
            new_inputs += [mapping[i] for i in n.inputs[2:]]
            mapping[n.name] = b.call(n.op, *new_inputs, name=n.name,
                                     **dict(n.attrs))
            continue
        mapping[n.name] = b.call(n.op, *[mapping[i] for i in n.inputs],
                                 name=n.name, **dict(n.attrs))
    return b.build([mapping[o] for o in g.outputs]).dead_code_eliminate()


def remove_identity(graph: Graph) -> Graph:
    """Strip no-op nodes: copy, same-dtype cast, same-shape reshape /
    broadcast_to."""
    g = infer_types(graph)

    def rewrite(b: GraphBuilder, n: Node, new_inputs):
        src = g[n.inputs[0]] if n.inputs else None
        if n.op == "copy":
            return new_inputs[0]
        if n.op == "cast" and src is not None and src.dtype == n.dtype:
            return new_inputs[0]
        if (n.op in ("reshape", "broadcast_to") and src is not None
                and tuple(src.shape) == tuple(n.shape)):
            return new_inputs[0]
        return None

    return g.transform(rewrite).dead_code_eliminate()


DEFAULT_SIMPLIFY = (fold_constant, simplify_transposes, remove_identity,
                    fold_batch_norm, fold_scale_axis, fuse_pad_into_conv,
                    combine_parallel_dense, eliminate_common_subexpr)


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
