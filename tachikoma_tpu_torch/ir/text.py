"""Text-format round trip for the graph IR (port of `tachikoma_tpu/ir/text.py`).

The role of the reference's relay text parser
(`src/parser/parser.cc:706`) for this IR's much smaller
surface: `parse_text` reconstructs a Graph from the `repr()` printing
(`ir/graph.py Node.__repr__` / `Graph.__repr__`), so printed IR is valid
input again.  Tensor VALUES don't travel in text (same as relay text without
metadata): constants rebuild zero-filled at the annotated shape/dtype unless
a params dict supplies them.
"""

from __future__ import annotations

import ast
import re

import numpy as np

from .graph import Graph, Node

_LINE = re.compile(
    r"^\s*%(?P<name>\S+)\s*=\s*(?P<op>[\w.]+)\((?P<args>.*)\)"
    r"(?:\s*/\*\s*(?P<dtype>\w+)\[(?P<shape>[^\]]*)\]\s*\*/)?\s*$"
)
_RET = re.compile(r"^\s*return\s+(?P<outs>.+?)\s*$")
_HDR = re.compile(r"^\s*graph\s+@(?P<name>\S+)")


def _split_args(s: str) -> list[str]:
    """Split on top-level commas (attrs may contain nested (),[],{})."""
    parts, depth, cur, in_str = [], 0, [], None
    for ch in s:
        if in_str:
            cur.append(ch)
            if ch == in_str:
                in_str = None
            continue
        if ch in "'\"":
            in_str = ch
            cur.append(ch)
        elif ch in "([{":
            depth += 1
            cur.append(ch)
        elif ch in ")]}":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        parts.append(tail)
    return parts


def parse_text(text: str, params: dict | None = None) -> Graph:
    """Parse the printed form back into a Graph.

    params: optional {const_name: np.ndarray} supplying constant values
    (zero-filled placeholders of the annotated shape/dtype otherwise)."""
    params = dict(params or {})
    nodes: list[Node] = []
    outputs: list[str] = []
    gname = "main"
    new_params: dict[str, np.ndarray] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        h = _HDR.match(line)
        if h:
            gname = h.group("name")
            continue
        r = _RET.match(line)
        if r:
            outputs = [o.strip().lstrip("%") for o in r.group("outs").split(",")]
            continue
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"unparseable line: {line!r}")
        name, op = m.group("name"), m.group("op")
        shape = None
        dtype = m.group("dtype")
        if m.group("shape") is not None:
            shape = tuple(int(v) for v in m.group("shape").split(",") if v.strip())
        args = _split_args(m.group("args"))
        inputs: list[str] = []
        attrs: dict = {}
        for a in args:
            if "=" in a and not a.startswith(("'", '"')):
                k, v = a.split("=", 1)
                attrs[k.strip()] = ast.literal_eval(v.strip())
            else:
                inputs.append(a.lstrip("%"))
        if op == "var":
            nodes.append(Node(name, "var", (), {}, shape, dtype))
        elif op == "const":
            arr = params.get(name)
            if arr is None:
                arr = np.zeros(shape or (), np.dtype(dtype or "float32"))
            new_params[name] = np.asarray(arr)
            nodes.append(Node(name, "const", (), {},
                              tuple(np.shape(arr)), str(np.asarray(arr).dtype)))
        else:
            nodes.append(Node(name, op, tuple(inputs), attrs, shape, dtype))
    return Graph(nodes, outputs, new_params, gname)


def to_text(graph: Graph) -> str:
    return repr(graph)
