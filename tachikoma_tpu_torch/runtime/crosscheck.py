"""Holding a run on the card against the CPU path, node by node.

A float op that the card computes in another order than the CPU (a cuDNN or
cuBLAS product, a reduction) or with another rounding (CUDA's `expf`,
`tanhf`) may differ from the CPU by an ulp.  Where a `qnn.quantize` follows,
that ulp can round one element the other way, and every integer node after
it then computes exactly, on another input.  So the nodes such a source
reaches are held at node level: each equals its own op's CPU impl run on the
card's own inputs.  Every other node equals the CPU path.

The elementwise float ops written op for op (`nn.batch_norm`, `nn.relu`,
`qnn.dequantize`, `sigmoid`'s add and division, `nn.bias_add`) are not
sources, nor are those that are exact or correctly rounded element by
element (`nn.leaky_relu`, `negative`, `abs`, `floor`, `ceil`, `round`,
`maximum`, `minimum`, `sign`, IEEE `divide` and `sqrt`, `mod` and
`trunc_mod`, which are fmod-exact, resize2d's three ops): a difference
there is a fault.
"""

from __future__ import annotations

from collections import Counter
from typing import Mapping, Sequence

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE_GET_ITEM, VAR, Graph
from ..ir.registry import get_op

# float products and convolutions: cuBLAS / cuDNN sum in another order
FLOAT_PRODUCTS = ("nn.dense", "nn.matmul", "nn.batch_matmul", "nn.conv2d", "nn.conv2d_transpose",
                  "nn.conv3d")
# and the reductions and transcendental functions (CUDA's expf / tanhf are
# not correctly rounded), the float transformers' fused ops included
FLOAT_SOURCES = FLOAT_PRODUCTS + ("mean", "nn.global_avg_pool2d", "nn.avg_pool2d", "exp",
                                  "sigmoid", "tanh", "nn.softmax", "nn.gelu", "nn.layer_norm",
                                  "tk.attention") + (
    # the ONNX importer's ops, one reason each:
    "einsum",            # a float product: cuBLAS's sum order
    "sum", "prod", "cumsum",  # float reductions and scans: the card's order
    "nn.log_softmax", "nn.instance_norm",  # reductions inside (max, sums, means)
    "nn.lrn",            # powf is not correctly rounded on CUDA
    "erf", "log", "power",  # CUDA's erff, logf, powf: not correctly rounded
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",  # likewise
    "scatter_elements", "scatter_nd",  # float adds into one place: CUDA's atomic order
    "nn.silu",           # the torch.fx importer's: CUDA's expf
)


def float_source_set(graph: Graph, sources: Sequence[str] = FLOAT_SOURCES,
                     floats_only: bool = False) -> set[str]:
    """The nodes that a float-typed node of one of `sources` reaches, the
    source included; with `floats_only`, only through float nodes."""
    cone: set[str] = set()
    for n in graph.nodes:  # topological order
        is_float = (n.dtype or "").startswith("float")
        if floats_only and not is_float:
            continue
        if (n.op in sources and is_float) or any(i in cone for i in n.inputs):
            cone.add(n.name)
    return cone


def _node_inputs(graph: Graph, node, captured: Mapping, feeds: Mapping) -> list:
    """`node`'s inputs as CPU tensors: the card's captured values, the
    graph's params, the request's inputs."""
    args = []
    for i in node.inputs:
        src = graph[i]
        if i in captured:
            v = captured[i]
        elif src.op == CONST:
            v = graph.params[i]
        elif src.op == VAR:
            v = feeds[i]
        elif src.op == TUPLE_GET_ITEM:
            v = captured[src.inputs[0]][int(src.attrs["index"])]
        else:
            raise KeyError(f"{node.name}: input {i} ({src.op}) was not captured")
        args.append([torch.from_numpy(np.ascontiguousarray(a)) for a in v]
                    if isinstance(v, list) else torch.from_numpy(np.ascontiguousarray(v)))
    return args


def hold_node_level(graph: Graph, names: Sequence[str], card: Sequence, cpu: Sequence,
                    feeds: Mapping, rtol: float, atol: float) -> tuple[Counter, list]:
    """Hold the card's captured values of `names` (host arrays; a list for
    a split's pieces, whose items are held where they are read) against the
    CPU path's.  Outside `float_source_set` an integer node == the CPU path
    and a float node is within `rtol` / `atol` of it.  Inside, each node
    equals its own op's CPU impl on the card's captured inputs (floats
    within `rtol` / `atol`).  Raises AssertionError on the first node that
    fails.  Returns the counts of nodes held each way and, for each integer
    node of the set that differs from the CPU path end to end, (name,
    elements that differ, the largest difference, the first index)."""
    cone = float_source_set(graph)
    captured = dict(zip(names, card))
    counts: Counter = Counter(cone=len(cone))
    differing = []
    for nm, a, b in zip(names, card, cpu):
        if isinstance(a, list):
            continue
        node = graph[nm]
        assert a.shape == b.shape and a.dtype == b.dtype, nm
        integer = a.dtype.kind in "iu"
        if nm not in cone:
            if integer:
                assert (a == b).all(), f"{nm} ({node.op}) != the CPU path"
            else:
                assert np.isfinite(a).all(), nm
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=nm)
                counts["float_bit_equal"] += a.tobytes() == b.tobytes()
            counts["int" if integer else "float"] += 1
            continue
        own = get_op(node.op).torch_impl(*_node_inputs(graph, node, captured, feeds),
                                         node=node).numpy()
        if not integer:
            np.testing.assert_allclose(a, own, rtol=rtol, atol=atol, err_msg=nm)
            counts["cone_float"] += 1
            continue
        assert (own == a).all(), f"{nm} ({node.op}) != its CPU impl on the card's inputs"
        counts["cone_int"] += 1
        diff = a.astype(np.int64) - b.astype(np.int64)
        if diff.any():
            first = tuple(int(v) for v in np.argwhere(diff)[0])
            differing.append((nm, int((diff != 0).sum()), int(np.abs(diff).max()), first))
    counts["cone_int_differing"] = len(differing)
    return counts, differing
