"""Sharded graph execution — dp (batch) x tp (channel) partitioning over
torch.distributed (port of `tachikoma_tpu/parallel/shard.py`).

The JAX package runs the unfused integer graph as one GSPMD program over a
`Mesh`: sharding annotations on inputs and params make XLA's partitioner
insert the collectives.  There is no partitioner here, so the executor plans
them itself, once, at construction (`plan_counts`, `describe`), and every rank walks
the same plan on its own slices (SPMD):

  graph inputs  : batch axis split over 'dp' where it divides
                  (`default_input_spec`)
  weights       : ndim >= 2 with a last axis that divides by tp split over
                  'tp' (`default_param_spec`)
  column-parallel: a qnn.conv2d / qnn.dense whose input is whole runs on its
                  weight's output-channel slice (K4 on the slice); its output
                  is channel-split
  row-parallel  : a conv / dense whose input arrives channel-split contracts
                  its K slice (the weight's input-channel slice, all output
                  channels), then the int32 accumulators all-reduce over
                  'tp' — the JAX package's int32 psum.  A raw call's zero-point
                  fold (`ops/kernels/conv.py qconv_raw`) of each rank's slice
                  sums to the whole fold; the unfused graph adds its bias in
                  nn.bias_add, after the reduction
  channel-local : bias_add, clip, requantize, pooling and the elementwise qnn
                  ops keep a channel split, their per-channel vectors (bias,
                  requantize scales) sliced with it; a whole operand of such
                  an op is sliced locally, which moves nothing
  everything else gathers a channel-split input first (all-gather over
                  'tp'): reshape / flatten, softmax over channels, a conv
                  whose weight is not split; batch-split values are gathered
                  (all-gather over 'dp') where an op is not per sample, and
                  every output and captured value is returned global.

Weight slices are made once per rank, at construction; K-major packing
follows them through `pack_once`, so a request packs nothing.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph, Node
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..ops.nn import walking_on
from ..runtime.executor import check_torch_impls, graph_feeds, to_device
from .mesh import Mesh

PRODUCTS = ("qnn.conv2d", "qnn.dense")
# ops computed sample by sample: a batch split passes through them
BATCH_LOCAL = frozenset({
    "qnn.quantize", "qnn.dequantize", "qnn.requantize", "qnn.conv2d", "qnn.dense",
    "nn.bias_add", "clip", "nn.relu", "cast", "qnn.add", "qnn.subtract", "qnn.mul",
    "add", "subtract", "multiply", "nn.max_pool2d", "nn.avg_pool2d", "qnn.avg_pool2d",
    "nn.global_avg_pool2d", "nn.softmax", "nn.log_softmax", "qnn.softmax", "qnn.lut",
    "nn.batch_flatten", "nn.conv2d", "nn.dense"})
# ops computed channel by channel on the last axis: a channel split passes
POOLS = frozenset({"nn.max_pool2d", "nn.avg_pool2d", "qnn.avg_pool2d",
                   "nn.global_avg_pool2d"})
ELEMENTWISE = frozenset({"clip", "nn.relu", "cast", "qnn.add", "qnn.subtract", "qnn.mul",
                         "add", "subtract", "multiply"})
PER_CHANNEL = frozenset({"nn.bias_add", "qnn.requantize", "qnn.quantize", "qnn.dequantize"})
QPARAMS = ("scale", "zero_point", "input_scale", "input_zero_point", "output_scale",
           "output_zero_point", "lhs_scale", "lhs_zero_point", "rhs_scale", "rhs_zero_point")

WHOLE = (False, False)  # (batch split over dp, channels split over tp)


def default_param_spec(name: str, arr: np.ndarray, mesh: Mesh) -> tuple:
    """A parameter's spec, one axis name or None per dimension (the JAX
    package's PartitionSpec): channel-split over 'tp' where it divides."""
    tp = mesh.size("tp")
    # only true weight matrices: splitting 1-D scale/bias/norm vectors buys
    # nothing (they follow the split of the values they meet)
    if tp > 1 and arr.ndim >= 2 and arr.shape[-1] % tp == 0 and arr.shape[-1] >= tp:
        return (None,) * (arr.ndim - 1) + ("tp",)
    return ()


def default_input_spec(shape, mesh: Mesh) -> tuple:
    dp = mesh.size("dp")
    if dp > 1 and len(shape) >= 1 and shape[0] % dp == 0:
        return ("dp",) + (None,) * (len(shape) - 1)
    return ()


@dataclass
class Step:
    """One node as every rank runs it: the node with its attrs sliced and its
    local shape, its arguments (("value", name, layout) or ("param", key)),
    its output layout, how it is split ("col", "row", "channel", "whole")
    and whether its int32 output all-reduces over 'tp'."""

    node: Node
    args: list
    layout: tuple
    kind: str
    reduce: bool = False


class ShardedExecutor:
    """Run a Graph over a mesh's 'dp' and 'tp' axes: every rank of the mesh
    constructs it and calls `run` with the same global inputs; every rank
    gets the global outputs."""

    def __init__(
        self,
        graph: Graph,
        mesh: Mesh,
        param_specs: Mapping[str, tuple] | None = None,
        input_specs: Mapping[str, tuple] | None = None,
        capture=None,
    ):
        g = graph
        if any(n.shape is None and n.dtype != "tuple" for n in g.nodes):
            g = infer_types(g)
        check_torch_impls(g)
        if not mesh.member:
            raise ValueError("ShardedExecutor: this rank is not a member of the mesh")
        self.graph, self.mesh, self.device = g, mesh, mesh.device
        self.capture = list(capture) if capture is not None else list(g.outputs)
        self._var_names = [n.name for n in g.inputs]
        self.dp, self.tp = mesh.size("dp"), mesh.size("tp")
        self._explicit = dict(param_specs or {})
        self._pspecs = {name: self._explicit.get(name, default_param_spec(name, arr, mesh))
                        for name, arr in g.params.items()}
        ispecs = dict(input_specs or {})
        self._layout = {n.name: (bool(ispecs.get(n.name, default_input_spec(n.shape, mesh))[:1]
                                      == ("dp",)), False) for n in g.inputs}
        self.steps = [self._plan_node(n) for n in g.nodes if n.op not in (VAR, CONST)]
        self._params = {}
        for st in self.steps:
            for a in st.args:
                if a[0] == "param" and a[1] not in self._params:
                    self._params[a[1]] = self._make_param(*a[1])

    # -- the plan ---------------------------------------------------------

    def _local_shape(self, shape, layout):
        shape = list(shape)
        if layout[0]:
            shape[0] //= self.dp
        if layout[1]:
            shape[-1] //= self.tp
        return tuple(shape)

    def _batch_local(self, node: Node, vals) -> bool:
        """Whether the node runs on a batch split: an op computed sample by
        sample, fed a batch-split value, whose output keeps the batch."""
        split = [i for i in vals if self._layout[i][0]]
        if not split or node.op not in BATCH_LOCAL or node.shape is None:
            return False
        batch = self.graph[split[0]].shape[0]
        if not node.shape or node.shape[0] != batch:
            return False
        return "axis" not in node.attrs or int(node.attrs["axis"]) not in (0, -len(node.shape))

    def _channel_local(self, node: Node, vals) -> bool:
        """Whether the node keeps a channel split on its last axis."""
        g = self.graph
        if not any(self._layout[i][1] for i in vals) or node.dtype == "tuple":
            return False
        c = node.shape[-1] if node.shape else 0
        if c % self.tp or any(self._layout[i][1] and g[i].shape[-1] != c for i in vals):
            return False
        if node.op in POOLS:
            return node.attrs.get("layout", "NHWC") == "NHWC"
        if node.op in PER_CHANNEL:
            return int(node.attrs.get("axis", -1)) in (-1, len(node.shape) - 1)
        if node.op in ELEMENTWISE:
            return all(g[i].shape and g[i].shape[-1] in (1, c) for i in node.inputs)
        return False

    def _param_arg(self, name: str, batch: bool, axis: int | None, node: Node):
        """The ("param", key) argument of const `name`: sliced on axis 0 over
        'dp' where the node runs on a batch split and the const has the
        batch, on `axis` over 'tp' (None: whole)."""
        arr = self.graph.params[name]
        bslice = batch and node.op in ELEMENTWISE and arr.ndim == len(node.shape) \
            and arr.shape[0] == node.shape[0]
        return ("param", (name, bool(bslice), axis))

    def _plan_node(self, node: Node) -> Step:
        g = self.graph
        vals = [i for i in node.inputs if not g[i].is_const]
        batch = self._batch_local(node, vals) if node.op not in (TUPLE, TUPLE_GET_ITEM) else False
        kind, reduce, chan, wants = "whole", False, False, {}
        # a product splits over 'tp' when its weight is a constant, its
        # groups 1 and its accumulator int32 (what the all-reduce sums)
        if node.op in PRODUCTS and int(node.attrs.get("groups", 1)) == 1 \
                and node.attrs.get("out_dtype", "int32") == "int32" \
                and g[node.inputs[1]].is_const and self.tp > 1:
            w = node.inputs[1]
            spec = self._pspecs[w]
            kaxis = g.params[w].ndim - 2
            explicit_whole = w in self._explicit and not any(spec)
            if not explicit_whole and (self._layout[node.inputs[0]][1]
                                       or (len(spec) > kaxis and spec[kaxis] == "tp")):
                kind, reduce = "row", True
                wants = {0: True, 1: kaxis}
            elif spec and spec[-1] == "tp":
                kind, chan = "col", True
                wants = {0: False, 1: g.params[w].ndim - 1}
        elif self.tp > 1 and self._channel_local(node, vals):
            kind, chan = "channel", True
        c = node.shape[-1] if chan else None
        args = []
        for j, i in enumerate(node.inputs):
            src = g[i]
            if src.is_const:
                axis = wants.get(j) if kind in ("col", "row") else None
                if kind == "channel" and src.shape and src.shape[-1] == c:
                    axis = len(src.shape) - 1
                args.append(self._param_arg(i, batch, axis, node))
                continue
            # a broadcast operand of an elementwise op (lower rank) has no batch
            wb = batch and bool(src.shape) and src.shape[0] == node.shape[0] and (
                node.op not in ELEMENTWISE or len(src.shape) == len(node.shape))
            if kind in ("col", "row"):
                wc = wants[j] if j == 0 else False
            else:
                wc = chan and bool(src.shape) and src.shape[-1] == c
            args.append(("value", i, (bool(wb), bool(wc))))
        layout = (batch, chan)
        attrs = dict(node.attrs)
        if kind == "channel":
            t = self.mesh.index("tp")
            lo, hi = t * c // self.tp, (t + 1) * c // self.tp
            for k in QPARAMS:
                v = attrs.get(k)
                if np.ndim(v) == 1 and len(v) == c:
                    part = np.asarray(v)[lo:hi]
                    attrs[k] = type(v)(part.tolist()) if isinstance(v, (list, tuple)) else part
        local = node.with_(attrs=attrs,
                           shape=self._local_shape(node.shape, layout)
                           if node.dtype != "tuple" and node.shape is not None else node.shape)
        self._layout[node.name] = layout
        return Step(local, args, layout, kind, reduce)

    def _make_param(self, name: str, bslice: bool, axis: int | None) -> torch.Tensor:
        arr = self.graph.params[name]
        if bslice:
            d = self.mesh.index("dp")
            n = arr.shape[0] // self.dp
            arr = arr[d * n:(d + 1) * n]
        if axis is not None:
            t = self.mesh.index("tp")
            n = arr.shape[axis] // self.tp
            arr = np.take(arr, np.arange(t * n, (t + 1) * n), axis=axis)
        return to_device(np.ascontiguousarray(arr), self.device)

    def plan_counts(self) -> dict:
        """The plan's products by split, and the collectives and local slices
        one request makes (the captured values' gathers included)."""
        have = {n: {WHOLE} for n in self._var_names}
        conv = Counter()
        moves = Counter()

        def move(name, want):
            h = next(iter(have[name]))
            if want in have[name]:
                return
            if h[1] and not want[1]:
                moves["tp_all_gather"] += 1
            if h[0] and not want[0]:
                moves["dp_all_gather"] += 1
            if (not h[1] and want[1]) or (not h[0] and want[0]):
                moves["local_slice"] += 1
            have[name].add(want)

        for st in self.steps:
            for a in st.args:
                if a[0] == "value":
                    move(a[1], a[2])
            if st.node.op in PRODUCTS:
                conv[st.kind] += 1
            moves["all_reduce"] += st.reduce
            have[st.node.name] = {st.layout}
        for name in self.capture:
            move(name, WHOLE)
        return {"products": dict(conv), "collectives": dict(moves)}

    def describe(self) -> list[str]:
        """One line per qnn.conv2d / qnn.dense: its split and shapes."""
        out = []
        for st in self.steps:
            if st.node.op in PRODUCTS:
                w = self.graph.params.get(st.node.inputs[1])
                out.append(f"{st.node.name:24s} {st.kind:5s} "
                           f"w {tuple(w.shape) if w is not None else '?'} -> local out "
                           f"{st.node.shape}{' + int32 all-reduce over tp' if st.reduce else ''}")
        return out

    # -- running ------------------------------------------------------------

    def _value(self, env: dict, name: str, want: tuple) -> torch.Tensor:
        got = env[name]
        if want in got:
            return got[want]
        have, t = next(iter(got.items()))
        if have[1] and not want[1]:
            t = self.mesh.collective("tp").all_gather(t, -1)
        elif want[1] and not have[1]:
            n = t.shape[-1] // self.tp
            t = t.narrow(-1, self.mesh.index("tp") * n, n).contiguous()
        if have[0] and not want[0]:
            t = self.mesh.collective("dp").all_gather(t, 0)
        elif want[0] and not have[0]:
            n = t.shape[0] // self.dp
            t = t.narrow(0, self.mesh.index("dp") * n, n).contiguous()
        got[want] = t
        return t

    def run_device(self, inputs) -> list[torch.Tensor]:
        """Run on this rank's slices; returns the global captured values as
        tensors on the device."""
        feeds = self._normalize(inputs)
        env: dict[str, dict] = {k: {WHOLE: v} for k, v in feeds.items()}
        with walking_on(self.device):
            for st in self.steps:
                args = [self._params[a[1]] if a[0] == "param" else self._value(env, a[1], a[2])
                        for a in st.args]
                n = st.node
                if n.op == TUPLE:
                    out = list(args)
                elif n.op == TUPLE_GET_ITEM:
                    out = args[0][int(n.attrs["index"])]
                else:
                    out = get_op(n.op).torch_impl(*args, node=n)
                if st.reduce:
                    out = self.mesh.collective("tp").all_reduce(out)
                env[n.name] = {st.layout: out}
        return [self._value(env, name, WHOLE) for name in self.capture]

    def run(self, inputs) -> list[np.ndarray]:
        return [o.cpu().numpy() for o in self.run_device(inputs)]

    def _normalize(self, inputs) -> dict[str, torch.Tensor]:
        return graph_feeds(self.graph, self._var_names, inputs, self.device)
