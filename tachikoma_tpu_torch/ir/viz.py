"""Graph visualization — Graphviz DOT and terminal rendering (port of
`tachikoma_tpu/ir/viz.py`).

The relay_viz/TEDD counterpart (`python/tvm/contrib/relay_viz`, SURVEY.md
§2.9): render a Graph as DOT text (for `dot -Tsvg`) or an indented terminal
summary, color-coded by op family (integer core vs float vs structural).
"""

from __future__ import annotations

from .graph import CONST, VAR, Graph

_COLORS = {
    "qnn": "#8ecae6",       # integer core
    "tk": "#219ebc",        # fused kernels
    "nn": "#ffb703",        # float nn
    "struct": "#e5e5e5",    # var/const/shape ops
    "other": "#fb8500",
}


def _family(op: str) -> str:
    if op in (VAR, CONST, "reshape", "transpose", "squeeze", "expand_dims",
              "nn.batch_flatten", "concatenate", "split", "tuple",
              "tuple_get_item", "strided_slice", "broadcast_to"):
        return "struct"
    if op.startswith("qnn."):
        return "qnn"
    if op.startswith("tk."):
        return "tk"
    if op.startswith("nn."):
        return "nn"
    return "other"


def to_dot(graph: Graph, name: str | None = None, show_consts: bool = False) -> str:
    lines = [f'digraph "{name or graph.name}" {{',
             "  rankdir=TB; node [shape=box, style=filled, fontname=monospace];"]
    for n in graph.nodes:
        if n.is_const and not show_consts:
            continue
        color = _COLORS[_family(n.op)]
        ty = f"\\n{n.dtype}{list(n.shape)}" if n.shape is not None else ""
        label = f"{n.name}\\n{n.op}{ty}"
        lines.append(f'  "{n.name}" [label="{label}", fillcolor="{color}"];')
    for n in graph.nodes:
        for i in n.inputs:
            if graph[i].is_const and not show_consts:
                continue
            lines.append(f'  "{i}" -> "{n.name}";')
    for o in graph.outputs:
        lines.append(f'  "out_{o}" [label="output", shape=doublecircle, fillcolor="#90ee90"];')
        lines.append(f'  "{o}" -> "out_{o}";')
    lines.append("}")
    return "\n".join(lines)


def render_text(graph: Graph, max_nodes: int | None = None) -> str:
    """Terminal summary with per-family counts and the hot path."""
    from collections import Counter

    counts = Counter(_family(n.op) for n in graph.nodes)
    ops = Counter(n.op for n in graph.nodes)
    lines = [
        f"graph {graph.name}: {len(graph)} nodes "
        f"(int-core {counts.get('qnn', 0) + counts.get('tk', 0)}, "
        f"float {counts.get('nn', 0) + counts.get('other', 0)}, "
        f"structural {counts.get('struct', 0)})",
    ]
    for op, c in ops.most_common(max_nodes):
        lines.append(f"  {op:<28} x{c}")
    return "\n".join(lines)
