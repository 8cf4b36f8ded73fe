"""Graph validators and integer-overflow auditing (port of
`tachikoma_tpu/runtime/validate.py`).

  * validate_graph — static well-formedness: every op registered with both
    the numpy oracle and a torch impl, types infer, attrs JSON-canonical;
  * audit_int32_overflow — dynamic: recompute every int32 accumulation in
    int64 on sample inputs and report where the true sum leaves the int32
    range (the pinned semantics WRAP there, identically on all backends,
    but a quantizer producing such scales deserves a warning).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph
from ..ir.infer import infer_types
from ..ir.registry import get_op, has_op

_ACCUM_OPS = {"qnn.conv2d", "qnn.dense", "qnn.batch_matmul", "qnn.conv2d_transpose",
              "tk.conv2d_rq", "tk.dense_rq", "tk.bmm_rq"}


@dataclass
class ValidationReport:
    errors: list[str] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def validate_graph(graph: Graph, require_torch: bool = True) -> ValidationReport:
    """Errors: types that do not infer, unregistered ops, ops without an
    oracle, attrs that are not JSON, params that are not numpy arrays.
    Warnings (with `require_torch`): ops without a torch impl, which
    `TorchExecutor` refuses."""
    rep = ValidationReport()
    try:
        g = infer_types(graph)
    except Exception as e:
        rep.errors.append(f"type inference failed: {e}")
        return rep
    for n in g.nodes:
        if n.op in (VAR, CONST, TUPLE, TUPLE_GET_ITEM):
            continue
        if not has_op(n.op):
            rep.errors.append(f"{n.name}: unregistered op {n.op}")
            continue
        od = get_op(n.op)
        if od.np_impl is None:
            rep.errors.append(f"{n.name}: op {n.op} has no oracle impl")
        if require_torch and od.torch_impl is None:
            rep.warnings.append(f"{n.name}: op {n.op} has no torch impl")
        try:
            json.dumps(dict(n.attrs))
        except TypeError as e:
            rep.errors.append(f"{n.name}: non-serializable attrs ({e})")
    for name, arr in g.params.items():
        if not isinstance(arr, np.ndarray):
            rep.errors.append(f"param {name}: not a numpy array")
    return rep


@dataclass
class OverflowFinding:
    node: str
    op: str
    max_abs: int
    headroom_bits: float  # log2(int32_max / max_abs); negative = overflow


def audit_int32_overflow(graph: Graph, inputs) -> list[OverflowFinding]:
    """Run the oracle on `inputs`, recomputing each accumulation op in int64
    and reporting the true accumulator magnitude vs the int32 range."""
    from .interpreter import Interpreter

    g = infer_types(graph) if any(n.shape is None and n.dtype != "tuple" for n in graph.nodes) else graph
    findings: list[OverflowFinding] = []
    values: dict[str, np.ndarray] = {}
    interp = Interpreter(g)

    def hook(name, op, args, out):
        values[name] = out
        if op not in _ACCUM_OPS:
            return
        node = g[name]
        if node.attrs.get("out_dtype", "int32") == "int64":
            return  # W8A16: int64 accumulation is the design, not overflow
        # recompute in int64 with the same kernel semantics minus truncation
        od = get_op(op)
        wide = od.np_impl(*[a for a in args], node=node.with_(
            attrs={**dict(node.attrs), "out_dtype": "int64"}
        ))
        max_abs = int(np.abs(wide.astype(np.int64)).max()) if wide.size else 0
        imax = np.iinfo(np.int32).max
        if max_abs > imax:
            findings.append(OverflowFinding(
                name, op, max_abs, float(np.log2(imax / max(max_abs, 1)))
            ))

    interp.run(inputs, intercept=hook)
    return findings
