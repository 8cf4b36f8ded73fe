"""Segmented executor (port of `tachikoma_tpu/runtime/segmented.py`).

Graph-as-data execution for deep models: the graph is partitioned into
segments at minimal-boundary cut points (for transformers, the
single-tensor layer boundaries), and each segment runs as a "program": the
run function `_make_run_fn` builds once per structural key, with the op
impls resolved and the params and inputs passed positionally.  Segments with
the same structural hash (alpha-renamed nodes, attrs and shapes included,
param values excluded: `ir/graph.py structural_bytes`) share one program,
called with their own params; `n_programs` counts the keys, as in the JAX
package.

A run of >= min_scan_layers consecutive same-key segments in a simple carry
chain becomes a scan: each param is stacked along a leading layer axis on
the device once, at construction, and the run is a loop over the layers
that feeds layer k's params as views of the stacks -- the eager counterpart
of the JAX package's `lax.scan` (no CUDA graph capture).  The views are made
once and kept, so the kernels' caches keyed by weight tensor (K1's and K4's
K-major packing, `ops/kernels/_lib.py pack_once`) hit on every call, and a
scan member's weights live on the device only in the stacks.

Caches keyed by node (`ops/qnn.py _node_consts`) are shared by the segments
of one program: they hold constants made from node attrs, which are part of
the structural key, and never from a param.

Bit-exactness: the op impls are TorchExecutor's, called in the same order on
the same values, so integer outputs equal the whole-graph executor's and the
oracle's with `==`.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ir.graph import TUPLE, TUPLE_GET_ITEM, VAR, Graph, Node
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..utils import dtypes as dt
from .executor import check_torch_impls, graph_feeds, resolve_device


def partition(g: Graph, min_ops: int = 48, max_ops: int = 640) -> list[list[Node]]:
    """Split the op nodes of ``g`` into consecutive segments.

    Cuts prefer positions where exactly ONE plain tensor crosses the
    boundary (layer boundaries in sequential models); a cut is forced at
    the minimal-crossing position once a segment reaches ``max_ops``.
    Tuple-valued crossings are never allowed (segment boundary values must
    be tensors)."""
    ops = [n for n in g.nodes if not (n.is_var or n.is_const)]
    if not ops:
        return []
    pos = {n.name: i for i, n in enumerate(ops)}
    last_use: dict[str, int] = {}
    for i, n in enumerate(ops):
        for inp in n.inputs:
            if inp in pos:
                last_use[inp] = i

    # crossing[i]: values produced at <= i still needed by an op at > i
    # (graph outputs / captures do not cross: each segment emits its own)
    n_ops = len(ops)
    crossing = [0] * n_ops
    tuple_cross = [False] * n_ops
    open_at: list[list[str]] = [[] for _ in range(n_ops)]
    close_after: list[list[str]] = [[] for _ in range(n_ops)]
    for v, lu in last_use.items():
        open_at[pos[v]].append(v)
        close_after[lu].append(v)
    live: set[str] = set()
    for i in range(n_ops):
        live.update(open_at[i])
        for v in close_after[i]:
            live.discard(v)
        crossing[i] = len(live)
        tuple_cross[i] = any(g[v].dtype == "tuple" for v in live)

    segments: list[list[Node]] = []
    start = 0
    i = 0
    while i < n_ops:
        length = i - start + 1
        if i == n_ops - 1:
            segments.append(ops[start:])
            break
        if length >= min_ops and crossing[i] == 1 and not tuple_cross[i]:
            segments.append(ops[start:i + 1])
            start = i + 1
        elif length >= max_ops:
            # forced cut at the minimal-crossing point in the lookback window
            lo = start + max(min_ops, 1) - 1
            best = None
            for j in range(lo, i + 1):
                if tuple_cross[j]:
                    continue
                if best is None or crossing[j] <= crossing[best]:
                    best = j
            best = i if best is None else best
            segments.append(ops[start:best + 1])
            start = best + 1
            i = best
        i += 1
    return segments


class _Segment:
    """One segment instance: a canonical subgraph plus bindings.

    ``sub`` is a Graph whose node ORDER is a deterministic function of the
    segment's structure (vars/consts inserted at first use), so isomorphic
    segments produce identical ``structural_bytes`` and positionally
    corresponding nodes."""

    __slots__ = ("sub", "key", "in_names", "out_names", "params_np")

    def __init__(self, g: Graph, seg_nodes: list[Node], out_names: list[str]):
        names = {n.name for n in seg_nodes}
        sub_nodes: list[Node] = []
        added: set[str] = set()
        in_names: list[str] = []  # external tensor inputs, first-use order
        params_np: dict[str, np.ndarray] = {}
        for n in seg_nodes:
            for inp in n.inputs:
                if inp in added or inp in names:
                    continue
                src = g[inp]
                if src.is_const:
                    sub_nodes.append(src)
                    params_np[inp] = g.params[inp]
                else:
                    sub_nodes.append(Node(inp, VAR, (), {}, shape=src.shape, dtype=src.dtype))
                    in_names.append(inp)
                added.add(inp)
            sub_nodes.append(n)
            added.add(n.name)
        self.sub = Graph(sub_nodes, list(out_names), params_np, name="segment")
        self.key = self.sub.structural_hash()
        self.in_names = in_names
        self.out_names = list(out_names)
        self.params_np = params_np

    def canonical_param_order(self) -> list[str]:
        return [n.name for n in self.sub.nodes if n.is_const]


def _make_run_fn(sub: Graph) -> Callable:
    """fn(params_list, inputs_list) -> outputs_list for a segment.

    Params/inputs are passed POSITIONALLY (canonical node order) so one
    program serves every isomorphic segment regardless of its original node
    names; the op impls are resolved here, once."""
    const_order = [n.name for n in sub.nodes if n.is_const]
    var_order = [n.name for n in sub.nodes if n.is_var]
    steps = []
    for node in sub.nodes:
        if node.is_var or node.is_const:
            continue
        impl = None
        if node.op not in (TUPLE, TUPLE_GET_ITEM):
            impl = get_op(node.op).torch_impl
            if impl is None:
                raise NotImplementedError(f"op {node.op} has no torch impl")
        steps.append((node, impl))

    def run_fn(params: Sequence, inputs: Sequence) -> list:
        env: dict[str, Any] = dict(zip(const_order, params))
        env.update(zip(var_order, inputs))
        for node, impl in steps:
            if node.op == TUPLE:
                env[node.name] = [env[i] for i in node.inputs]
            elif node.op == TUPLE_GET_ITEM:
                env[node.name] = env[node.inputs[0]][int(node.attrs["index"])]
            else:
                env[node.name] = impl(*[env[i] for i in node.inputs], node=node)
        return [env[name] for name in sub.outputs]

    return run_fn


def _to_device(v: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(dt.c_contig(v))).to(device)


class SegmentedExecutor:
    """Executes a Graph as a pipeline of per-segment programs on `device`
    ("cuda" by default: with no card present it raises; pass device="cpu"
    for the CPU).  The run() / run_device() / capture contract of
    TorchExecutor; `segments`, `n_programs` and `scan_runs` describe the
    partition."""

    def __init__(self, graph: Graph, capture: Sequence[str] | None = None, fuse: bool = False,
                 min_ops: int = 48, max_ops: int = 640, min_scan_layers: int = 3,
                 scan: bool = True, device="cuda"):
        import sys

        self.device = resolve_device(device, "SegmentedExecutor")
        if sys.getrecursionlimit() < 100000:
            sys.setrecursionlimit(100000)

        g = graph
        if fuse:
            from .fuse import fuse_qnn

            g = fuse_qnn(g)
        if any(n.shape is None and n.dtype != "tuple" for n in g.nodes):
            g = infer_types(g)
        check_torch_impls(g)
        self.graph = g
        self.capture = list(capture) if capture is not None else list(g.outputs)
        self._var_names = [n.name for n in g.inputs]

        cap_set = set(self.capture) | set(g.outputs)
        seg_nodes = partition(g, min_ops=min_ops, max_ops=max_ops)

        # per-segment output lists: crossing values + captured/graph outputs
        seg_of: dict[str, int] = {}
        for si, seg in enumerate(seg_nodes):
            for n in seg:
                seg_of[n.name] = si
        needed_later: dict[str, int] = {}
        for si, seg in enumerate(seg_nodes):
            for n in seg:
                for inp in n.inputs:
                    src = seg_of.get(inp)
                    if src is not None and src < si:
                        needed_later[inp] = max(needed_later.get(inp, -1), si)
        self._needed_later = needed_later
        self._cap_set = cap_set

        self.segments: list[_Segment] = []
        for seg in seg_nodes:
            outs = [n.name for n in seg if n.name in needed_later or n.name in cap_set]
            self.segments.append(_Segment(g, seg, outs))

        # one program per structural key, shared by every isomorphic segment
        self._programs: dict[str, Callable] = {}
        for s in self.segments:
            if s.key not in self._programs:
                self._programs[s.key] = _make_run_fn(s.sub)

        self.scan_runs: list[tuple[int, int, int]] = (
            self._find_scan_runs(min_scan_layers) if scan else [])

        # device-resident params per segment, canonical (positional) order:
        # a scan member's are views of its run's stacks, made once; every
        # other segment's are one tensor per const node
        self._seg_params: list[list | None] = [None] * len(self.segments)
        self._scans: dict[int, dict] = {}
        self.stacked_bytes = 0
        for start, length, slot in self.scan_runs:
            self._scans[start] = self._stack(start, length, slot)
        shared: dict[str, torch.Tensor] = {}
        for si, s in enumerate(self.segments):
            if self._seg_params[si] is None:
                self._seg_params[si] = [
                    shared[k] if k in shared
                    else shared.setdefault(k, _to_device(s.params_np[k], self.device))
                    for k in s.canonical_param_order()]
        self.segment_bytes = sum(t.numel() * t.element_size() for t in shared.values())

    # -- scan-over-layers ---------------------------------------------------

    def _find_scan_runs(self, min_len: int) -> list[tuple[int, int, int]]:
        """(start, length, carry_slot) runs of >= min_len consecutive
        same-key single-output segments forming a simple carry chain:

          * member k+1 consumes member k's single output at one fixed input
            position (the carry slot), every other input is the SAME value
            for all members (loop-invariant);
          * intermediate outputs are consumed ONLY by the next member and
            are not captured (the scan hides them)."""
        runs = []
        segs = self.segments
        n = len(segs)
        i = 0
        while i < n:
            if len(segs[i].out_names) != 1:
                i += 1
                continue
            carry_slot = None
            j = i
            while j + 1 < n:
                s_prev, s_next = segs[j], segs[j + 1]
                if s_next.key != segs[i].key or len(s_next.out_names) != 1:
                    break
                slots = [q for q, nm in enumerate(s_next.in_names)
                         if nm == s_prev.out_names[0]]
                if len(slots) != 1:
                    break
                if carry_slot is None:
                    carry_slot = slots[0]
                elif slots[0] != carry_slot:
                    break
                # every non-carry input must match the run head's input
                # (loop-invariant value)
                if any(s_next.in_names[q] != segs[i].in_names[q]
                       for q in range(len(s_next.in_names)) if q != carry_slot):
                    break
                # the previous member's output must be PRIVATE to this chain
                prev_out = s_prev.out_names[0]
                if prev_out in self._cap_set or self._needed_later.get(prev_out, -1) > j + 1:
                    break
                j += 1
            if carry_slot is not None and j - i + 1 >= min_len:
                runs.append((i, j - i + 1, carry_slot))
                i = j + 1
            else:
                i += 1
        return runs

    def _stack(self, start: int, length: int, carry_slot: int) -> dict:
        """Stack each param of the run along a leading layer axis on the
        device (positional order is canonical, so isomorphic members line
        up) and keep layer k's views as the member's params."""
        orders = [self.segments[start + k].canonical_param_order() for k in range(length)]
        stacks = []
        for pi in range(len(orders[0])):
            mats = [dt.c_contig(self.segments[start + k].params_np[orders[k][pi]])
                    for k in range(length)]
            stacks.append(torch.from_numpy(np.stack(mats)).to(self.device))
        self.stacked_bytes += sum(t.numel() * t.element_size() for t in stacks)
        layers = [[st[k] for st in stacks] for k in range(length)]
        for k in range(length):
            self._seg_params[start + k] = layers[k]
        return {"program": self._programs[self.segments[start].key], "stacks": stacks,
                "layers": layers, "length": length, "slot": carry_slot}

    # -- public API ---------------------------------------------------------

    @property
    def n_programs(self) -> int:
        """Distinct programs (structural sharing diagnostic)."""
        return len(self._programs)

    def run(self, inputs) -> list[np.ndarray]:
        return [o.cpu().numpy() for o in self.run_device(inputs)]

    def run_device(self, inputs) -> list[torch.Tensor]:
        """Run and return tensors on the device (no host transfer)."""
        env: dict[str, Any] = dict(self._normalize(inputs))
        si = 0
        while si < len(self.segments):
            scan = self._scans.get(si)
            if scan is not None:
                ins = [env[nm] for nm in self.segments[si].in_names]
                slot, program = scan["slot"], scan["program"]
                for params in scan["layers"]:
                    ins[slot] = program(params, ins)[0]
                si += scan["length"]
                env[self.segments[si - 1].out_names[0]] = ins[slot]
                continue
            s = self.segments[si]
            outs = self._programs[s.key](self._seg_params[si], [env[nm] for nm in s.in_names])
            env.update(zip(s.out_names, outs))
            si += 1
        return [env[name] for name in self.capture]

    def _normalize(self, inputs) -> dict[str, torch.Tensor]:
        feeds = graph_feeds(self.graph, self._var_names, inputs, self.device)
        for k, v in feeds.items():
            shape = self.graph[k].shape
            if shape is not None and tuple(v.shape) != tuple(shape):
                raise ValueError(f"input {k}: expected shape {shape}, got {tuple(v.shape)}")
        return feeds


def _host(v):
    return [t.cpu().numpy() for t in v] if isinstance(v, (list, tuple)) else v.cpu().numpy()


def run_stream(executor: SegmentedExecutor, inputs, on_value) -> None:
    """Execute segment-by-segment, calling on_value(name, np_array) for
    every segment output and releasing values as soon as no later segment
    needs them -- bounded-memory full-graph capture (the calibration walk;
    whole-graph capture holds every intermediate at once).  Scan members
    run one by one, each on its views of the stacks."""
    ex = executor
    env: dict = dict(ex._normalize(inputs))
    last_need: dict[str, int] = {}
    for si, s in enumerate(ex.segments):
        for nm in s.in_names:
            last_need[nm] = si
    for si, s in enumerate(ex.segments):
        outs = ex._programs[s.key](ex._seg_params[si], [env[nm] for nm in s.in_names])
        for nm, val in zip(s.out_names, outs):
            env[nm] = val
            on_value(nm, _host(val))
        # free values no later segment consumes (on_value has already seen
        # them -- this is what bounds memory)
        for nm in list(env):
            if last_need.get(nm, -1) <= si:
                del env[nm]
