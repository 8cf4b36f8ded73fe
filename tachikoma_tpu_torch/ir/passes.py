"""Pass infrastructure — sequencing, configuration, instrumentation (port
of `tachikoma_tpu/ir/passes.py`).

The slim counterpart of the reference's pass infra (`Pass`, `PassContext`,
`Sequential`, `PassInstrument` — `include/tvm/ir/transform.h:78,363,456`,
`instrument.h:102`, PassTimingInstrument `src/ir/instrument.cc:320`): passes
are plain Graph -> Graph callables; a PassContext carries opt level, a typed
config map, disabled-pass sets, and instruments that hook before/after every
pass (timing built in).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from .graph import Graph

PassFn = Callable[[Graph], Graph]


@dataclass
class PassInfo:
    name: str
    opt_level: int = 0


class Pass:
    def __init__(self, fn: PassFn, name: str | None = None, opt_level: int = 0):
        self.fn = fn
        self.info = PassInfo(name or fn.__name__, opt_level)

    def __call__(self, graph: Graph) -> Graph:
        ctx = PassContext.current()
        if self.info.name in ctx.disabled_pass:
            return graph
        if self.info.opt_level > ctx.opt_level:
            return graph
        for ins in ctx.instruments:
            ins.run_before_pass(graph, self.info)
        out = self.fn(graph)
        for ins in ctx.instruments:
            ins.run_after_pass(out, self.info)
        return out


def module_pass(name: str | None = None, opt_level: int = 0):
    """Decorator: fn(Graph) -> Graph becomes an instrumented Pass."""

    def deco(fn: PassFn) -> Pass:
        return Pass(fn, name or fn.__name__, opt_level)

    return deco


class Sequential:
    def __init__(self, passes: list[Pass | PassFn], name: str = "sequential"):
        self.passes = [p if isinstance(p, Pass) else Pass(p) for p in passes]
        self.name = name

    def __call__(self, graph: Graph) -> Graph:
        for p in self.passes:
            graph = p(graph)
        return graph


class PassInstrument:
    def run_before_pass(self, graph: Graph, info: PassInfo) -> None: ...

    def run_after_pass(self, graph: Graph, info: PassInfo) -> None: ...


class PassTimingInstrument(PassInstrument):
    """Accumulates per-pass wall time (`instrument.cc:320` equivalent)."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self._start: dict[str, float] = {}

    def run_before_pass(self, graph, info):
        self._start[info.name] = time.perf_counter()

    def run_after_pass(self, graph, info):
        dt = time.perf_counter() - self._start.pop(info.name, time.perf_counter())
        self.times[info.name] = self.times.get(info.name, 0.0) + dt

    def render(self) -> str:
        total = sum(self.times.values()) or 1e-12
        lines = [f"{'pass':<32} {'ms':>9} {'%':>6}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<32} {t*1e3:>9.3f} {100*t/total:>6.1f}")
        return "\n".join(lines)


class PrintBeforeAfter(PassInstrument):
    """PrintIR analog: log node counts around selected passes."""

    def __init__(self, passes: set[str] | None = None, log=print):
        self.filter = passes
        self.log = log

    def _want(self, info):
        return self.filter is None or info.name in self.filter

    def run_before_pass(self, graph, info):
        if self._want(info):
            self.log(f"[before {info.name}] {len(graph)} nodes")

    def run_after_pass(self, graph, info):
        if self._want(info):
            self.log(f"[after  {info.name}] {len(graph)} nodes")


class PassContext:
    """Thread-local context stack with opt level, config map, instruments —
    used via `with PassContext(opt_level=3, instruments=[timer]): ...`."""

    _tls = threading.local()

    def __init__(self, opt_level: int = 2, config: dict | None = None,
                 disabled_pass: set[str] | None = None,
                 instruments: list[PassInstrument] | None = None):
        self.opt_level = opt_level
        self.config = dict(config or {})
        self.disabled_pass = set(disabled_pass or ())
        self.instruments = list(instruments or ())

    @classmethod
    def current(cls) -> "PassContext":
        stack = getattr(cls._tls, "stack", None)
        if not stack:
            return _DEFAULT
        return stack[-1]

    def __enter__(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._tls.stack.pop()


_DEFAULT = PassContext()


def default_pipeline() -> Sequential:
    """The standard pre-quantization cleanup as instrumented passes."""
    from .transforms import (
        eliminate_common_subexpr,
        fold_batch_norm,
        fold_constant,
        fuse_pad_into_conv,
    )

    return Sequential([
        Pass(fold_constant, "fold_constant", 1),
        Pass(fold_batch_norm, "fold_batch_norm", 1),
        Pass(fuse_pad_into_conv, "fuse_pad_into_conv", 2),
        Pass(eliminate_common_subexpr, "eliminate_common_subexpr", 2),
    ], "simplify")
