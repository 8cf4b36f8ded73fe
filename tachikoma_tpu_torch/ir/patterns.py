"""Dataflow pattern language — declarative graph matching/rewriting (port
of `tachikoma_tpu/ir/patterns.py`).

The slim equivalent of the reference's pattern DSL
(`python/tvm/relay/dataflow_pattern/__init__.py:46` + C++ matcher
`src/relay/ir/dataflow_matcher.cc`): compose patterns out of op/wildcard/
constant nodes, match them against Graph nodes, rewrite matches, or
partition them for BYOC-style handling.

    pat = is_op("qnn.dequantize", is_op("qnn.quantize", wildcard()))
    g2 = rewrite(g, pat, lambda b, match: ...)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from .graph import CONST, VAR, Graph, GraphBuilder, Node


class Pattern:
    def match_node(self, g: Graph, node: Node, binds: dict) -> bool:
        raise NotImplementedError

    # sugar
    def __or__(self, other: "Pattern") -> "AltPattern":
        return AltPattern(self, other)

    def with_attrs(self, **attrs) -> "AttrPattern":
        return AttrPattern(self, attrs)

    def bind(self, name: str) -> "BindPattern":
        return BindPattern(self, name)


@dataclass
class WildcardPattern(Pattern):
    def match_node(self, g, node, binds):
        return True


@dataclass
class VarPattern(Pattern):
    def match_node(self, g, node, binds):
        return node.op == VAR


@dataclass
class ConstPattern(Pattern):
    predicate: Callable[[np.ndarray], bool] | None = None

    def match_node(self, g, node, binds):
        if node.op != CONST:
            return False
        if self.predicate is not None:
            return bool(self.predicate(g.params[node.name]))
        return True


@dataclass
class OpPattern(Pattern):
    op: str
    args: tuple
    allow_extra_args: bool = False

    def match_node(self, g, node, binds):
        if node.op != self.op:
            return False
        if self.args and not self.allow_extra_args and len(node.inputs) != len(self.args):
            return False
        if len(node.inputs) < len(self.args):
            return False
        for sub, inp in zip(self.args, node.inputs):
            if not sub.match_node(g, g[inp], binds):
                return False
        return True


@dataclass
class AttrPattern(Pattern):
    inner: Pattern
    attrs: dict

    def match_node(self, g, node, binds):
        if not self.inner.match_node(g, node, binds):
            return False
        for k, v in self.attrs.items():
            got = node.attrs.get(k)
            if callable(v):
                if not v(got):
                    return False
            elif got != v:
                return False
        return True


@dataclass
class AltPattern(Pattern):
    a: Pattern
    b: Pattern

    def match_node(self, g, node, binds):
        return self.a.match_node(g, node, binds) or self.b.match_node(g, node, binds)


@dataclass
class BindPattern(Pattern):
    inner: Pattern
    name: str

    def match_node(self, g, node, binds):
        if self.inner.match_node(g, node, binds):
            binds[self.name] = node.name
            return True
        return False


def wildcard() -> Pattern:
    return WildcardPattern()


def is_var() -> Pattern:
    return VarPattern()


def is_const(predicate=None) -> Pattern:
    return ConstPattern(predicate)


def is_op(op: str, *args: Pattern, allow_extra_args: bool = False) -> Pattern:
    return OpPattern(op, args, allow_extra_args)


@dataclass
class Match:
    root: str                      # matched root node name
    binds: dict[str, str]          # bind-name -> node name


def find_matches(graph: Graph, pattern: Pattern) -> list[Match]:
    out = []
    for n in graph.nodes:
        binds: dict[str, str] = {}
        if pattern.match_node(graph, n, binds):
            out.append(Match(n.name, binds))
    return out


def rewrite(
    graph: Graph,
    pattern: Pattern,
    callback: Callable[[GraphBuilder, Graph, Match, dict[str, str]], str | None],
) -> Graph:
    """Rewrite every match bottom-up.

    callback(builder, graph, match, mapping) builds the replacement value and
    returns its new-graph name, or None to keep the node unchanged; `mapping`
    is the full old->new name map accumulated so far, so callbacks can
    reference any upstream value (e.g. a bound sub-pattern's source).
    Mirrors DFPatternCallback
    (`python/tvm/relay/dataflow_pattern/__init__.py:786 rewrite`)."""
    matches = {m.root: m for m in find_matches(graph, pattern)}
    b = GraphBuilder(graph.name)
    mapping: dict[str, str] = {}
    for n in graph.nodes:
        m = matches.get(n.name)
        res = None
        if m is not None and not n.is_const and not n.is_var:
            res = callback(b, graph, m, mapping)
        if res is None:
            if n.is_const:
                res = b.const(graph.params[n.name], name=n.name)
            elif n.is_var:
                res = b.var(n.name, n.shape, n.dtype)
            else:
                res = b.call(n.op, *(mapping[i] for i in n.inputs),
                             name=n.name, **dict(n.attrs))
        mapping[n.name] = res
    return b.build([mapping[o] for o in graph.outputs])


def partition(graph: Graph, pattern: Pattern, label: str) -> Graph:
    """Annotate matched roots with a composite label attr — the role of
    MergeComposite/PartitionGraph for BYOC handoff
    (`src/relay/transforms/merge_composite.cc`)."""
    roots = {m.root for m in find_matches(graph, pattern)}

    def fn(b: GraphBuilder, node: Node, new_inputs):
        if node.name in roots and not node.is_const and not node.is_var:
            attrs = dict(node.attrs)
            attrs["composite"] = label
            return b.call(node.op, *new_inputs, name=node.name, **attrs)
        return None

    return graph.transform(fn)
