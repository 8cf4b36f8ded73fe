"""Operator fusion for the integer inference path (port of
`tachikoma_tpu/runtime/fuse.py`).

Rewrites qnn op chains into fused ops so the int32 accumulator never goes to
memory:

  qnn.conv2d -> [nn.bias_add(const)] -> [clip] -> qnn.requantize -> [clip]  => tk.conv2d_rq
  qnn.dense  -> [nn.bias_add(const)] -> [clip] -> qnn.requantize -> [clip]  => tk.dense_rq
  qnn.batch_matmul -> [nn.bias_add(const)] -> [clip] -> qnn.requantize -> [clip]  => tk.bmm_rq
  runs of stride-1 tk.conv2d_rq with a spatial kernel                    => tk.conv2d_chain
  tk.conv2d_chain -> qnn.add -> [clip]                                   => chain with res_add
  runs of identity-residual chains                                       => tk.conv2d_block_stack

The graph rewrites are the JAX package's, copied, with one difference: the JAX
package keeps a chain unfused when its TPU frame does not fit VMEM at any
sub-batch (`chain_batch_split`); the port runs a chain stage by stage, so it
fuses every run that contains a spatial kernel.

multiplier/shift are precomputed at fusion time (integers in attrs), so the
fused ops are float-free.  Each fused op has the JAX package's numpy oracle
and a torch implementation that runs the port's kernels: K1 (1x1 convs, the
dense; its batched mode the attention products of tk.bmm_rq), K2 (other
convs) and K3 (the last stage of each residual block).
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, GraphBuilder, Node
from ..ir.infer import infer_types
from ..ir.registry import get_op, infer_rule, np_impl, register_op, torch_impl
from ..ops import nn as _nn
from ..ops.fixed_point import q_multiply_shift_np, q_multiply_shift_per_axis_np, requantize_np
from ..ops.kernels.conv import qconv2d_flat, qconv2d_flat_block_stack, qconv2d_flat_chain
from ..ops.kernels.matmul_int8 import qbmm_int8, qmatmul_int8
from ..ops.kernels.requantize import plan_requantize

_FUSABLE_HEAD = {"qnn.conv2d": "tk.conv2d_rq", "qnn.dense": "tk.dense_rq",
                 "qnn.batch_matmul": "tk.bmm_rq"}


def _needs_types(graph: Graph) -> bool:
    return any(n.shape is None and n.dtype != "tuple" for n in graph.nodes)


def _single_user(g: Graph, users: dict, outs: set):
    def single_user(name):
        # a graph output is observable: fusing past it would rewire the
        # output to the fused tail's value (Graph.users() does not count
        # graph outputs as users) — treat it as multi-user
        if name in outs:
            return None
        u = users.get(name, ())
        return g[u[0]] if len(u) == 1 else None

    return single_user


def _rebuild_start(g: Graph) -> tuple[GraphBuilder, dict]:
    """A GraphBuilder holding g's vars and consts (emitted first, so fused nodes
    can reference constants that appear later in topological order)."""
    b = GraphBuilder(g.name)
    mapping: dict[str, str] = {}
    for n in g.nodes:
        if n.is_var:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
        elif n.is_const:
            mapping[n.name] = b.const(g.params[n.name], name=n.name)
    return b, mapping


def fuse_qnn(graph: Graph, disabled_chains=frozenset()) -> Graph:
    """The fused integer graph.  `disabled_chains` names tk.conv2d_chain
    runs (as a previous fusion named them) to split back into their member
    tk.conv2d_rq ops: the graph tuner's decisions (`tune/graph_tuner.py`)."""
    g = infer_types(graph) if _needs_types(graph) else graph
    single_user = _single_user(g, g.users(), set(g.outputs))

    # head -> (bias|None, mid_clip|None, requant, clip|None)
    chains: dict[str, tuple] = {}
    consumed: set[str] = set()
    for n in g.nodes:
        if n.op not in _FUSABLE_HEAD:
            continue
        # the fused epilogues are 32-bit fixed-point; int64 accumulators stay unfused
        if n.attrs.get("out_dtype", "int32") != "int32":
            continue
        cur = single_user(n.name)
        bias = None
        if cur is not None and cur.op == "nn.bias_add" and g[cur.inputs[1]].is_const:
            bias = cur
            cur = single_user(cur.name)
        mid_clip = None
        if cur is not None and cur.op == "clip":
            # accumulator-domain clip (e.g. relu on int32); requantize is
            # monotone, so the bounds transform exactly to the output domain
            mid_clip = cur
            cur = single_user(cur.name)
        if cur is None or cur.op != "qnn.requantize":
            continue
        rq = cur
        cur = single_user(cur.name)
        clip = None
        if cur is not None and cur.op == "clip":
            clip = cur
        chains[n.name] = (bias, mid_clip, rq, clip)
        consumed.add(n.name)
        for t in (bias, mid_clip, rq, clip):
            if t is not None:
                consumed.add(t.name)

    if not chains:
        return _fuse_runs(g, disabled_chains)

    b, mapping = _rebuild_start(g)
    for n in g.nodes:
        if n.name in mapping:
            continue
        if n.name in chains:
            bias, mid_clip, rq, clip = chains[n.name]
            rqa = dict(rq.attrs)
            mult, shift = plan_requantize(rqa["input_scale"], float(rqa["output_scale"]))
            rounding = rqa.get("rounding", "UPWARD")
            ozp = int(rqa.get("output_zero_point", 0))
            out_dtype = rqa.get("out_dtype", "int8")
            info = np.iinfo(np.dtype(out_dtype))
            lo, hi = info.min, info.max

            if mid_clip is not None:
                # transform accumulator-domain bounds through the (monotone)
                # requantize: f(clip(x, a, b)) == clip(f(x), f(a), f(b))
                rq_izp = int(rqa.get("input_zero_point", 0))

                def f_bound(v):
                    vv = np.asarray(np.clip(v, np.iinfo(np.int32).min,
                                            np.iinfo(np.int32).max), np.int32)
                    vv = vv - np.int32(rq_izp)
                    outs = [
                        int(q_multiply_shift_np(np.asarray([vv]), int(m), int(s), rounding)[0])
                        for m, s in zip(np.atleast_1d(mult), np.atleast_1d(shift))
                    ]
                    # clamp into the out_dtype range first: channel bounds
                    # that all saturate are uniform after clamping
                    return [int(np.clip(o + ozp, info.min, info.max)) for o in outs]

                los = f_bound(int(mid_clip.attrs["a_min"]))
                his = f_bound(int(mid_clip.attrs["a_max"]))
                if len(set(los)) == 1 and len(set(his)) == 1:
                    lo = max(lo, los[0])
                    hi = min(hi, his[0])
                else:
                    # non-uniform per-channel bounds: skip fusing this chain
                    ins = [mapping[i] for i in n.inputs]
                    mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
                    for t in (bias, mid_clip, rq, clip):
                        if t is not None:
                            consumed.discard(t.name)
                    continue
            if clip is not None:
                lo = max(lo, int(clip.attrs["a_min"]))
                hi = min(hi, int(clip.attrs["a_max"]))

            tail = clip or rq
            per_axis = np.ndim(mult) > 0
            attrs = {k: v for k, v in n.attrs.items() if k not in ("out_dtype",)}
            attrs.update(
                multiplier=[int(v) for v in np.atleast_1d(mult)] if per_axis else int(mult),
                shift=[int(v) for v in np.atleast_1d(shift)] if per_axis else int(shift),
                rq_input_zero_point=int(rqa.get("input_zero_point", 0)),
                output_zero_point=ozp,
                rounding=rounding,
                out_dtype=out_dtype,
            )
            if lo > info.min:
                attrs["a_min"] = lo
            if hi < info.max:
                attrs["a_max"] = hi
            ins = [mapping[i] for i in n.inputs]
            if bias is not None:
                ins.append(mapping[bias.inputs[1]])
                attrs["has_bias"] = True
            out = b.call(_FUSABLE_HEAD[n.op], *ins, name=tail.name, **attrs)
            for t in (n, bias, mid_clip, rq, clip):
                if t is not None:
                    mapping[t.name] = out
            continue
        if n.name in consumed:
            # tail members handled with the head; map resolved when head seen
            continue
        ins = [mapping[i] for i in n.inputs]
        mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
    return _fuse_runs(infer_types(b.build([mapping[o] for o in g.outputs])), disabled_chains)


def _fuse_runs(g: Graph, disabled_chains) -> Graph:
    """Chains, the chains' residual adds, block stacks; the chains named in
    `disabled_chains` are split back first."""
    chained = fuse_conv_chains(g)
    if disabled_chains:
        chained = split_chains(chained, set(disabled_chains))
    return fuse_block_stacks(fuse_chain_residual(chained))


def split_chains(full: Graph, disabled: set) -> Graph:
    """`full` with each tk.conv2d_chain named in `disabled` (and without a
    fused residual add) split back into its sequential tk.conv2d_rq stages:
    stage i is named <chain>_u<i>, the last stage keeps the chain's name
    (the JAX package's `tune/graph_tuner.py apply_variant` split)."""
    b = GraphBuilder(full.name)
    mapping = {}
    for n in full.nodes:
        if n.is_var:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
        elif n.is_const:
            mapping[n.name] = b.const(full.params[n.name], name=n.name)
        elif (n.op == "tk.conv2d_chain" and n.name in disabled
              and not n.attrs.get("res_add")):
            cur = mapping[n.inputs[0]]
            arg = 1
            for si, st in enumerate(n.attrs["stages"]):
                ins = [cur, mapping[n.inputs[arg]]]
                arg += 1
                attrs = {
                    "strides": (1, 1), "padding": tuple(st["padding"]),
                    "multiplier": st["multiplier"], "shift": st["shift"],
                    "input_zero_point": st.get("input_zero_point", 0),
                    "output_zero_point": st.get("output_zero_point", 0),
                    "rounding": st.get("rounding", "UPWARD"),
                    "out_dtype": "int8",
                }
                for k in ("a_min", "a_max"):
                    if k in st:
                        attrs[k] = st[k]
                if st.get("has_bias"):
                    ins.append(mapping[n.inputs[arg]])
                    arg += 1
                    attrs["has_bias"] = True
                nm = n.name if si == len(n.attrs["stages"]) - 1 else f"{n.name}_u{si}"
                cur = b.call("tk.conv2d_rq", *ins, name=nm, **attrs)
            mapping[n.name] = cur
        else:
            mapping[n.name] = b.call(n.op, *[mapping[i] for i in n.inputs], name=n.name,
                                     **dict(n.attrs))
    return infer_types(b.build([mapping[o] for o in full.outputs]))


# ---------------------------------------------------------------------------
# fused op definitions
# ---------------------------------------------------------------------------

def _fused_epilogue_np(acc: np.ndarray, node: Node, bias: np.ndarray | None) -> np.ndarray:
    a = dict(node.attrs)
    if bias is not None:
        shape = [1] * acc.ndim
        shape[-1] = -1
        acc = acc + bias.reshape(shape).astype(np.int32)
    izp = int(a.get("rq_input_zero_point", 0))
    if izp:
        acc = acc - np.int32(izp)
    mult, shift = a["multiplier"], a["shift"]
    rounding = a.get("rounding", "UPWARD")
    if np.ndim(mult) > 0:
        v = q_multiply_shift_per_axis_np(
            acc, np.asarray(mult, np.int64), np.asarray(shift, np.int64),
            acc.ndim - 1, rounding,
        )
    else:
        v = q_multiply_shift_np(acc, int(mult), int(shift), rounding)
    ozp = int(a.get("output_zero_point", 0))
    if ozp:
        v = v + np.int32(ozp)
    lo, hi = _bounds(a)
    return np.clip(v, lo, hi).astype(a.get("out_dtype", "int8"))


def _bounds(a) -> tuple[int, int]:
    info = np.iinfo(np.dtype(a.get("out_dtype", "int8")))
    return (max(int(a.get("a_min", info.min)), info.min),
            min(int(a.get("a_max", info.max)), info.max))


def _split_bias(node: Node, args):
    if node.attrs.get("has_bias"):
        return args[:-1], args[-1]
    return args, None


def _head_shadow(node: Node) -> Node:
    keep = {k: v for k, v in node.attrs.items()
            if k in ("strides", "padding", "dilation", "groups",
                     "input_zero_point", "kernel_zero_point",
                     "lhs_zero_point", "rhs_zero_point",
                     "transpose_a", "transpose_b")}
    keep["out_dtype"] = "int32"
    return node.with_(attrs=keep)


def _kernel_args(a) -> dict:
    """The requantize keyword arguments of the kernel entries (a weight zero
    point and a uint8 output: legacy uint8 TFLite models, on K1, K2 and
    K5)."""
    lo, hi = _bounds(a)
    return dict(multiplier=a["multiplier"], shift=a["shift"],
                kernel_zero_point=a.get("kernel_zero_point", 0),
                input_zero_point=int(a.get("input_zero_point", 0)),
                rq_input_zero_point=int(a.get("rq_input_zero_point", 0)),
                out_zp=int(a.get("output_zero_point", 0)),
                rounding=a.get("rounding", "UPWARD"),
                out_dtype=a.get("out_dtype", "int8"), qmin=lo, qmax=hi)


@infer_rule("tk.conv2d_rq")
def _conv_rq_rel(node, ins):
    shape, _ = _nn._conv2d_rel(node, ins[:2])
    return shape, node.attrs.get("out_dtype", "int8")


@np_impl("tk.conv2d_rq")
def _conv_rq_np(*args, node: Node):
    (data, weight), bias = _split_bias(node, args)
    acc = get_op("qnn.conv2d").np_impl(data, weight, node=_head_shadow(node))
    return _fused_epilogue_np(acc, node, bias)


@torch_impl("tk.conv2d_rq")
def _conv_rq_torch(*args, node: Node):
    (data, weight), bias = _split_bias(node, args)
    a = dict(node.attrs)
    return qconv2d_flat(
        data, weight, bias, strides=_nn._pair(a.get("strides", (1, 1))),
        padding=_nn._pad4(a.get("padding", (0, 0, 0, 0))),
        groups=int(a.get("groups", 1)), dilation=_nn._pair(a.get("dilation", (1, 1))),
        **_kernel_args(a))


@infer_rule("tk.dense_rq")
def _dense_rq_rel(node, ins):
    shape, _ = _nn._dense_rel(node, ins[:2])
    return shape, node.attrs.get("out_dtype", "int8")


@np_impl("tk.dense_rq")
def _dense_rq_np(*args, node: Node):
    (data, weight), bias = _split_bias(node, args)
    acc = get_op("qnn.dense").np_impl(data, weight, node=_head_shadow(node))
    return _fused_epilogue_np(acc, node, bias)


@torch_impl("tk.dense_rq")
def _dense_rq_torch(*args, node: Node):
    (data, weight), bias = _split_bias(node, args)
    out = qmatmul_int8(data.reshape(-1, data.shape[-1]), weight, bias,
                       **_kernel_args(dict(node.attrs)))
    return out.reshape(*data.shape[:-1], out.shape[-1])


@infer_rule("tk.bmm_rq")
def _bmm_rq_rel(node, ins):
    shape, _ = _nn._bmm_rel(node, ins[:2])
    return shape, node.attrs.get("out_dtype", "int8")


@np_impl("tk.bmm_rq")
def _bmm_rq_np(*args, node: Node):
    (a, c), bias = _split_bias(node, args)
    acc = get_op("qnn.batch_matmul").np_impl(a, c, node=_head_shadow(node))
    return _fused_epilogue_np(acc, node, bias)


@torch_impl("tk.bmm_rq")
def _bmm_rq_torch(*args, node: Node):
    """K1's batched mode (`qbmm_rq`), the operands read in place."""
    (a, c), bias = _split_bias(node, args)
    at = dict(node.attrs)
    if at.get("out_dtype", "int8") != "int8":
        raise NotImplementedError(f"{node.name} (tk.bmm_rq): out_dtype {at['out_dtype']} is "
                                  "not ported yet (ROADMAP Queue 1 item 2: fused outputs "
                                  "other than int8)")
    lo, hi = _bounds(at)
    return qbmm_int8(a, c, bias, at["multiplier"], at["shift"],
                     lhs_zero_point=int(at.get("lhs_zero_point", 0)),
                     rhs_zero_point=int(at.get("rhs_zero_point", 0)),
                     transpose_a=bool(at.get("transpose_a", False)),
                     transpose_b=bool(at.get("transpose_b", False)),
                     rq_input_zero_point=int(at.get("rq_input_zero_point", 0)),
                     out_zp=int(at.get("output_zero_point", 0)),
                     rounding=at.get("rounding", "UPWARD"), qmin=lo, qmax=hi)


# the flops rules reuse the head ops' counts (profiler rooflines)
register_op("tk.conv2d_rq", flops=_nn._conv2d_flops)
register_op("tk.dense_rq", flops=_nn._dense_flops)
register_op("tk.bmm_rq", flops=_nn._bmm_flops)


# ---------------------------------------------------------------------------
# conv chains: runs of stride-1 spatial-preserving convs
# ---------------------------------------------------------------------------

def _chain_eligible(g: Graph, n: Node) -> bool:
    if n.op != "tk.conv2d_rq":
        return False
    a = n.attrs
    if _nn._pair(a.get("strides", (1, 1))) != (1, 1):
        return False
    if _nn._pair(a.get("dilation", (1, 1))) != (1, 1):
        return False
    if int(a.get("groups", 1)) != 1:
        return False
    # kernel_zero_point may be a per-channel vector (all zero when symmetric)
    if np.any(np.asarray(a.get("kernel_zero_point", 0))):
        return False
    if int(a.get("rq_input_zero_point", 0)):
        return False
    if a.get("out_dtype", "int8") != "int8":
        return False
    data = g[n.inputs[0]]
    if data.shape is None or n.shape is None:
        return False
    return tuple(data.shape[1:3]) == tuple(n.shape[1:3])


def fuse_conv_chains(graph: Graph) -> Graph:
    """Fuse linear runs of stride-1 spatial-preserving tk.conv2d_rq nodes
    into tk.conv2d_chain nodes.  A pure 1x1 run stays unfused (it is already
    a GEMM each); a run with a spatial kernel fuses."""
    g = infer_types(graph) if _needs_types(graph) else graph
    single_user = _single_user(g, g.users(), set(g.outputs))

    def spatial(m):
        ws = g[m.inputs[1]].shape
        return ws is not None and (ws[0] > 1 or ws[1] > 1)

    # greedy maximal runs
    in_chain: set[str] = set()
    chains: list[list[Node]] = []
    for n in g.nodes:
        if n.name in in_chain or not _chain_eligible(g, n):
            continue
        # only start a chain at a node whose producer is NOT chainable into it
        prod = g[n.inputs[0]]
        if (prod.name not in in_chain and _chain_eligible(g, prod)
                and single_user(prod.name) is not None
                and single_user(prod.name).name == n.name
                and int(n.attrs.get("input_zero_point", 0))
                == int(prod.attrs.get("output_zero_point", 0))):
            continue  # will be picked up when the run head is visited
        run = [n]
        cur = n
        while True:
            nxt = single_user(cur.name)
            if (nxt is None or not _chain_eligible(g, nxt)
                    or nxt.inputs[0] != cur.name
                    or int(nxt.attrs.get("input_zero_point", 0))
                    != int(cur.attrs.get("output_zero_point", 0))):
                break
            run.append(nxt)
            cur = nxt
        if len(run) >= 2 and any(spatial(m) for m in run):
            chains.append(run)
            in_chain.update(x.name for x in run)

    if not chains:
        return g

    member = {x.name: run for run in chains for x in run}
    b, mapping = _rebuild_start(g)
    for n in g.nodes:
        if n.name in mapping:
            continue
        run = member.get(n.name)
        if run is not None:
            if n.name != run[0].name:
                continue  # emitted with the head
            ins = [mapping[run[0].inputs[0]]]
            stages = []
            for m in run:
                a = dict(m.attrs)
                ins.append(mapping[m.inputs[1]])
                st = {
                    "padding": tuple(a.get("padding", (0, 0, 0, 0))),
                    "multiplier": a["multiplier"],
                    "shift": a["shift"],
                    "input_zero_point": int(a.get("input_zero_point", 0)),
                    "output_zero_point": int(a.get("output_zero_point", 0)),
                    "rounding": a.get("rounding", "UPWARD"),
                    "has_bias": bool(a.get("has_bias")),
                }
                if "a_min" in a:
                    st["a_min"] = int(a["a_min"])
                if "a_max" in a:
                    st["a_max"] = int(a["a_max"])
                if st["has_bias"]:
                    ins.append(mapping[m.inputs[2]])
                stages.append(st)
            out = b.call("tk.conv2d_chain", *ins, name=run[-1].name,
                         stages=stages, out_dtype="int8")
            for m in run:
                mapping[m.name] = out
            continue
        ins = [mapping[i] for i in n.inputs]
        mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
    return infer_types(b.build([mapping[o] for o in g.outputs]))


def fuse_chain_residual(graph: Graph) -> Graph:
    """Fold a residual qnn.add (+ optional clip) into the preceding
    tk.conv2d_chain's last-stage epilogue (`res_add`)."""
    g = graph
    single_user = _single_user(g, g.users(), set(g.outputs))

    # keyed by the ADD node (the fusion emits there: the residual operand
    # can be topologically AFTER the chain, so the fused node must sit at
    # the add's position, where both are available)
    fused: dict[str, tuple] = {}
    consumed: set[str] = set()
    for n in g.nodes:
        if n.op != "tk.conv2d_chain" or n.attrs.get("res_add"):
            continue
        add = single_user(n.name)
        if add is None or add.op != "qnn.add":
            continue
        if add.attrs.get("out_dtype", "int8") != "int8":
            continue
        if add.inputs[0] == n.name:
            res, lhs_keys = add.inputs[1], ("lhs", "rhs")
        else:
            res, lhs_keys = add.inputs[0], ("rhs", "lhs")
        if res == n.name:
            continue  # self-add
        clip = single_user(add.name)
        clip = clip if clip is not None and clip.op == "clip" else None
        fused[add.name] = (n, clip, res, lhs_keys)
        consumed.add(n.name)
        if clip is not None:
            consumed.add(clip.name)

    if not fused:
        return g

    b, mapping = _rebuild_start(g)
    for n in g.nodes:
        if n.name in mapping or n.name in consumed:
            continue
        if n.name in fused:
            chain, clip, res, (ck, rk) = fused[n.name]
            add = n
            aa = dict(add.attrs)
            ra = {
                "lhs_scale": float(aa[f"{ck}_scale"]),
                "lhs_zero_point": int(aa.get(f"{ck}_zero_point", 0)),
                "rhs_scale": float(aa[f"{rk}_scale"]),
                "rhs_zero_point": int(aa.get(f"{rk}_zero_point", 0)),
                "output_scale": float(aa["output_scale"]),
                "output_zero_point": int(aa.get("output_zero_point", 0)),
                "rounding": aa.get("rounding", "UPWARD"),
            }
            if clip is not None:
                ra["a_min"] = int(clip.attrs["a_min"])
                ra["a_max"] = int(clip.attrs["a_max"])
            tail = clip or add
            ins = [mapping[i] for i in chain.inputs] + [mapping[res]]
            attrs = dict(chain.attrs)
            attrs["res_add"] = ra
            out = b.call("tk.conv2d_chain", *ins, name=tail.name, **attrs)
            for t in (chain, add, clip):
                if t is not None:
                    mapping[t.name] = out
            continue
        ins = [mapping[i] for i in n.inputs]
        mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
    return infer_types(b.build([mapping[o] for o in g.outputs]))


def _chain_split_args(node: Node, args):
    """args -> (data, [(w, bias|None) per stage], residual|None)."""
    data = args[0]
    rest = list(args[1:])
    out = []
    for st in node.attrs["stages"]:
        w = rest.pop(0)
        bias = rest.pop(0) if st.get("has_bias") else None
        out.append((w, bias))
    residual = rest.pop(0) if node.attrs.get("res_add") else None
    return data, out, residual


def _chain_stage_node(st: dict, name: str) -> Node:
    attrs = {
        "strides": (1, 1), "padding": st["padding"],
        "multiplier": st["multiplier"], "shift": st["shift"],
        "input_zero_point": st.get("input_zero_point", 0),
        "output_zero_point": st.get("output_zero_point", 0),
        "rounding": st.get("rounding", "UPWARD"),
        "out_dtype": "int8",
    }
    for k in ("a_min", "a_max"):
        if k in st:
            attrs[k] = st[k]
    if st.get("has_bias"):
        attrs["has_bias"] = True
    return Node(name, "tk.conv2d_rq", ("d", "w"), attrs)


def _kernel_stages(stage_attrs, wb) -> list[dict]:
    """Chain stages in the form of the conv entries (ops/kernels/conv.py)."""
    stages = []
    for st, (w, bias) in zip(stage_attrs, wb):
        lo, hi = _bounds(st)
        stages.append(dict(
            w=w, bias=bias, multiplier=st["multiplier"], shift=st["shift"],
            izp=int(st.get("input_zero_point", 0)),
            out_zp=int(st.get("output_zero_point", 0)),
            rounding=st.get("rounding", "UPWARD"), qmin=lo, qmax=hi,
            padding=tuple(st["padding"])))
    return stages


@infer_rule("tk.conv2d_chain")
def _chain_rel(node, ins):
    (ds, _) = ins[0]
    # weights appear in order; last stage's cout is the output channel
    # count; an optional trailing residual input (res_add attr) must match
    arg = 1
    cout = None
    for st in node.attrs["stages"]:
        cout = ins[arg][0][3]
        arg += 2 if st.get("has_bias") else 1
    if node.attrs.get("res_add"):
        (rs, rdt) = ins[arg]
        assert tuple(rs) == (ds[0], ds[1], ds[2], cout), f"residual shape {rs} != chain output"
    return (ds[0], ds[1], ds[2], cout), "int8"


def _res_add_np(cur, residual, ra: dict):
    """Exact qnn.add epilogue (ops/qnn.py qnn.add semantics)."""
    so = float(ra["output_scale"])
    zo = int(ra.get("output_zero_point", 0))

    def req(v, sc, zc):
        if float(sc) == so and int(zc) == zo:
            return v.astype(np.int32)
        return requantize_np(v.astype(np.int32), float(sc), int(zc), so, zo,
                             rounding=ra.get("rounding", "UPWARD"),
                             out_dtype="int32")

    ql = req(cur, ra["lhs_scale"], ra.get("lhs_zero_point", 0))
    qr = req(residual, ra["rhs_scale"], ra.get("rhs_zero_point", 0))
    lo = max(int(ra.get("a_min", -128)), -128)
    hi = min(int(ra.get("a_max", 127)), 127)
    return np.clip(ql + qr - np.int32(zo), lo, hi).astype(np.int8)


def _stages_np(cur, stage_attrs, wb, name):
    for st, (w, bias) in zip(stage_attrs, wb):
        shadow = _chain_stage_node(st, name + "_st")
        sargs = (cur, w) if bias is None else (cur, w, bias)
        cur = get_op("tk.conv2d_rq").np_impl(*sargs, node=shadow)
    return cur


@np_impl("tk.conv2d_chain")
def _chain_np(*args, node: Node):
    data, stages, residual = _chain_split_args(node, args)
    cur = _stages_np(data, node.attrs["stages"], stages, node.name)
    if residual is not None:
        cur = _res_add_np(np.asarray(cur), np.asarray(residual),
                          dict(node.attrs["res_add"]))
    return cur


@torch_impl("tk.conv2d_chain")
def _chain_torch(*args, node: Node):
    data, wb, residual = _chain_split_args(node, args)
    ra = dict(node.attrs["res_add"]) if node.attrs.get("res_add") else None
    return qconv2d_flat_chain(data, _kernel_stages(node.attrs["stages"], wb),
                              residual=residual, res_params=ra)


def _chain_flops(node: Node, ins):
    (ds, _) = ins[0]
    total, arg = 0, 1
    for st in node.attrs["stages"]:
        kh, kw, ci, co = ins[arg][0]
        total += 2 * ds[0] * ds[1] * ds[2] * co * kh * kw * ci
        arg += 2 if st.get("has_bias") else 1
    return total


register_op("tk.conv2d_chain", flops=_chain_flops)


# ---------------------------------------------------------------------------
# residual-block stacks: consecutive identity-residual chains
# ---------------------------------------------------------------------------

def fuse_block_stacks(graph: Graph) -> Graph:
    """Fuse runs of IDENTITY-residual tk.conv2d_chain nodes (res_add whose
    residual operand is the chain's own input) into tk.conv2d_block_stack
    nodes."""
    g = graph
    users = g.users()
    outs = set(g.outputs)

    def identity_block(n) -> bool:
        return (n.op == "tk.conv2d_chain" and bool(n.attrs.get("res_add"))
                and n.inputs[-1] == n.inputs[0])

    def sole_consumer(name):
        """The unique consuming NODE (an identity block uses its input
        twice — data + residual — which is still one consumer)."""
        if name in outs:
            return None
        u = set(users.get(name, ()))
        return g[next(iter(u))] if len(u) == 1 else None

    in_stack: set[str] = set()
    stacks: list[list[Node]] = []
    for n in g.nodes:
        if n.name in in_stack or not identity_block(n):
            continue
        prod = g[n.inputs[0]]
        if (identity_block(prod) and prod.name not in in_stack
                and sole_consumer(prod.name) is not None
                and sole_consumer(prod.name).name == n.name):
            continue  # picked up from the run head
        run = [n]
        cur = n
        while True:
            nxt = sole_consumer(cur.name)
            if (nxt is None or not identity_block(nxt)
                    or nxt.inputs[0] != cur.name):
                break
            # zero points must chain: next block's first-stage izp is the
            # producer's res_add output zp
            if int(nxt.attrs["stages"][0].get("input_zero_point", 0)) != \
                    int(cur.attrs["res_add"].get("output_zero_point", 0)):
                break
            run.append(nxt)
            cur = nxt
        if len(run) >= 2:
            stacks.append(run)
            in_stack.update(x.name for x in run)

    if not stacks:
        return g

    member = {x.name: run for run in stacks for x in run}
    b, mapping = _rebuild_start(g)
    for n in g.nodes:
        if n.name in mapping:
            continue
        run = member.get(n.name)
        if run is not None:
            if n.name != run[0].name:
                continue  # emitted with the head
            ins = [mapping[run[0].inputs[0]]]
            blocks = []
            for m in run:
                # chain inputs: data, then (w [, bias]) per stage, then the
                # residual (== data, dropped: the stack implies it)
                for wb in m.inputs[1:-1]:
                    ins.append(mapping[wb])
                blocks.append({"stages": list(m.attrs["stages"]),
                               "res_add": dict(m.attrs["res_add"])})
            out = b.call("tk.conv2d_block_stack", *ins, name=run[-1].name,
                         blocks=blocks, out_dtype="int8")
            for m in run:
                mapping[m.name] = out
            continue
        ins = [mapping[i] for i in n.inputs]
        mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
    return infer_types(b.build([mapping[o] for o in g.outputs]))


def _stack_split_args(node: Node, args):
    """args -> (data, [[(w, bias|None) per stage] per block])."""
    data = args[0]
    rest = list(args[1:])
    out = []
    for blk in node.attrs["blocks"]:
        stages = []
        for st in blk["stages"]:
            w = rest.pop(0)
            bias = rest.pop(0) if st.get("has_bias") else None
            stages.append((w, bias))
        out.append(stages)
    return data, out


@infer_rule("tk.conv2d_block_stack")
def _stack_rel(node, ins):
    (ds, _) = ins[0]
    arg = 1
    cout = None
    for blk in node.attrs["blocks"]:
        for st in blk["stages"]:
            cout = ins[arg][0][3]
            arg += 2 if st.get("has_bias") else 1
    return (ds[0], ds[1], ds[2], cout), "int8"


def _stack_flops(node: Node, ins):
    (ds, _) = ins[0]
    total, arg = 0, 1
    for blk in node.attrs["blocks"]:
        for st in blk["stages"]:
            kh, kw, ci, co = ins[arg][0]
            total += 2 * ds[0] * ds[1] * ds[2] * co * kh * kw * ci
            arg += 2 if st.get("has_bias") else 1
    return total


register_op("tk.conv2d_block_stack", flops=_stack_flops)


@np_impl("tk.conv2d_block_stack")
def _stack_np(*args, node: Node):
    data, blocks_wb = _stack_split_args(node, args)
    cur = np.asarray(data)
    for blk, wb in zip(node.attrs["blocks"], blocks_wb):
        block_in = cur
        cur = _stages_np(cur, blk["stages"], wb, node.name)
        if blk.get("res_add"):
            cur = _res_add_np(np.asarray(cur), block_in, dict(blk["res_add"]))
    return cur


@torch_impl("tk.conv2d_block_stack")
def _stack_torch(*args, node: Node):
    data, blocks_wb = _stack_split_args(node, args)
    blocks = [(_kernel_stages(blk["stages"], wb),
               dict(blk["res_add"]) if blk.get("res_add") else None)
              for blk, wb in zip(node.attrs["blocks"], blocks_wb)]
    return qconv2d_flat_block_stack(data, blocks)
