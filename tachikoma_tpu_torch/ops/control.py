"""Data-dependent control flow, `tk.cond` and `tk.while_loop` (port of
`tachikoma_tpu/ops/control.py`).

Control flow enters the static DAG as first-class ops whose branches and
bodies are nested subgraphs carried as serialized Graph JSON attrs:

  tk.cond(pred, *args, then_graph=<json>, else_graph=<json>)
      pred: scalar (bool/int); each subgraph maps args -> outputs; both
      branches must agree on output types (checked at infer time)
  tk.while_loop(*state, cond_graph=<json>, body_graph=<json>)
      cond_graph: state -> scalar bool; body_graph: state -> state
      (same types), raising after `max_iterations` (default 10^6)
      iterations as the oracle does

The numpy oracle interprets the chosen branch or iterates the loop, as the
JAX package's does.  The torch impls run the chosen subgraph op by op on
the device of the op's inputs, with the subgraph's torch impls, so a
branch's `qnn.dense` runs on the card's kernels as the outer graph's would:

  * a subgraph is loaded from its JSON once (`_load_subgraph`), and its
    constants go to a device once per op node, subgraph and device, not
    once per call, so that a kernel's per-tensor caches (K4's packed
    weight, ops/kernels/_lib.py `pack_once`) hold across calls; they are
    freed with the node, that is with its graph (`_device_consts`);
  * the subgraph is walked by the executor's own walk
    (runtime/executor.py `walk`);
  * the predicate of a `tk.cond` is read to the host once per call, and the
    loop condition of a `tk.while_loop` once per evaluation (n + 1 times
    for n iterations).  Those are the only host reads the ops make;
    `HOST_READS` counts them by op.

Trace records of these ops carry the executed output, as the JAX
package's do: the trace emitter captures the op's value like any node's.
"""

from __future__ import annotations

import weakref
from collections import Counter
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..ir.graph import Graph, Node
from ..ir.registry import TensorType, infer_rule, np_impl, torch_impl

# host reads of a predicate or loop condition, by op
HOST_READS: Counter = Counter()


@lru_cache(maxsize=256)
def _load_subgraph(graph_json: str) -> Graph:
    return Graph.from_json(graph_json)


@lru_cache(maxsize=256)
def _typed_subgraph(graph_json: str) -> Graph:
    from ..ir.infer import infer_types

    g = _load_subgraph(graph_json)
    return infer_types(g) if any(
        n.shape is None and n.dtype != "tuple" for n in g.nodes) else g


# a tk.* node's subgraph constants on a device, by id(node): an entry is
# dropped when its node is freed, so a branch's weights leave the device
# with the graph that holds them
_DEVICE_CONSTS: dict[int, dict] = {}


def _device_consts(node: Node, attr: str, device: torch.device) -> dict[str, torch.Tensor]:
    """The constants of `node`'s subgraph `attr` on `device`, made once
    while the node lives."""
    from ..runtime.executor import to_device

    held = _DEVICE_CONSTS.get(id(node))
    if held is None:
        held = _DEVICE_CONSTS[id(node)] = {}
        weakref.finalize(node, _DEVICE_CONSTS.pop, id(node), None)
    key = (attr, str(device))
    if key not in held:
        held[key] = {k: to_device(v, device)
                     for k, v in _load_subgraph(node.attrs[attr]).params.items()}
    return held[key]


def _sub_out_types(graph_json: str) -> list[tuple[tuple, str]]:
    g = _typed_subgraph(graph_json)
    return [(tuple(g[o].shape), g[o].dtype) for o in g.outputs]


def _check_subgraph_inputs(g: Graph, ins: Sequence[TensorType], what: str):
    vars_ = g.inputs
    if len(vars_) != len(ins):
        raise TypeError(
            f"{what} takes {len(vars_)} inputs, got {len(ins)}")
    for v, (shape, dtype) in zip(vars_, ins):
        if tuple(v.shape) != tuple(shape) or v.dtype != dtype:
            raise TypeError(
                f"{what} input {v.name}: declared {v.dtype}{list(v.shape)} "
                f"vs supplied {dtype}{list(shape)}")


def _run_sub_np(g: Graph, args) -> list[np.ndarray]:
    from ..runtime.interpreter import run_graph

    return run_graph(g, {v.name: a for v, a in zip(g.inputs, args)})


def _run_sub_torch(node: Node, attr: str, args, device: torch.device) -> list[torch.Tensor]:
    """`node`'s subgraph `attr` run op by op on `device` with its torch impls."""
    from ..runtime.executor import walk

    g = _typed_subgraph(node.attrs[attr])
    env = walk(g, dict(zip((v.name for v in g.inputs), args)),
               _device_consts(node, attr, device), device)
    return [env[o] for o in g.outputs]


def _read(op: str, flag: torch.Tensor) -> bool:
    """A predicate or loop condition read to the host (counted)."""
    HOST_READS[op] += 1
    return bool(flag.reshape(()).item())


# -- tk.cond -----------------------------------------------------------------

@infer_rule("tk.cond")
def _cond_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    then_j, else_j = node.attrs["then_graph"], node.attrs["else_graph"]
    pred_shape, _ = ins[0]
    if tuple(pred_shape) not in ((), (1,)):
        raise TypeError(f"tk.cond predicate must be scalar, got {pred_shape}")
    _check_subgraph_inputs(_load_subgraph(then_j), ins[1:], "tk.cond then_graph")
    _check_subgraph_inputs(_load_subgraph(else_j), ins[1:], "tk.cond else_graph")
    t_outs = _sub_out_types(then_j)
    e_outs = _sub_out_types(else_j)
    if t_outs != e_outs:
        raise TypeError(
            f"tk.cond branches disagree on output types: {t_outs} vs {e_outs}")
    if len(t_outs) == 1:
        return t_outs[0]
    return list(t_outs)  # tuple value: list of (shape, dtype)


@np_impl("tk.cond")
def _cond_np(pred, *args, node: Node):
    g = _load_subgraph(node.attrs["then_graph"] if bool(np.asarray(pred).reshape(()))
                       else node.attrs["else_graph"])
    outs = _run_sub_np(g, args)
    return outs[0] if len(outs) == 1 else list(outs)


@torch_impl("tk.cond")
def _cond_torch(pred: torch.Tensor, *args: torch.Tensor, node: Node):
    branch = "then_graph" if _read("tk.cond", pred) else "else_graph"
    outs = _run_sub_torch(node, branch, args, pred.device)
    return outs[0] if len(outs) == 1 else list(outs)


# -- tk.while_loop -----------------------------------------------------------

@infer_rule("tk.while_loop")
def _while_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    cond_j, body_j = node.attrs["cond_graph"], node.attrs["body_graph"]
    _check_subgraph_inputs(_load_subgraph(cond_j), ins, "tk.while_loop cond_graph")
    _check_subgraph_inputs(_load_subgraph(body_j), ins, "tk.while_loop body_graph")
    c_outs = _sub_out_types(cond_j)
    if len(c_outs) != 1 or tuple(c_outs[0][0]) != () or c_outs[0][1] != "bool":
        raise TypeError(
            f"cond_graph must return a scalar bool, got {c_outs}")
    b_outs = _sub_out_types(body_j)
    state = [(tuple(s), d) for s, d in ins]
    if b_outs != state:
        raise TypeError(
            f"body_graph must preserve state types: {state} vs {b_outs}")
    if len(state) == 1:
        return state[0]
    return list(state)  # tuple value: list of (shape, dtype)


@np_impl("tk.while_loop")
def _while_np(*state, node: Node):
    cond_g = _load_subgraph(node.attrs["cond_graph"])
    body_g = _load_subgraph(node.attrs["body_graph"])
    cur = list(state)
    max_iter = int(node.attrs.get("max_iterations", 1_000_000))
    it = 0
    while bool(np.asarray(_run_sub_np(cond_g, cur)[0]).reshape(())):
        cur = [np.asarray(v) for v in _run_sub_np(body_g, cur)]
        it += 1
        if it >= max_iter:
            raise RuntimeError(f"tk.while_loop exceeded {max_iter} iterations")
    return cur[0] if len(cur) == 1 else cur


@torch_impl("tk.while_loop")
def _while_torch(*state: torch.Tensor, node: Node):
    device = state[0].device
    cur = list(state)
    max_iter = int(node.attrs.get("max_iterations", 1_000_000))
    it = 0
    while _read("tk.while_loop", _run_sub_torch(node, "cond_graph", cur, device)[0]):
        cur = _run_sub_torch(node, "body_graph", cur, device)
        it += 1
        if it >= max_iter:  # the oracle's rule, to the iteration
            raise RuntimeError(f"tk.while_loop exceeded {max_iter} iterations")
    return cur[0] if len(cur) == 1 else cur
