"""Torch executor (port of `tachikoma_tpu/runtime/executor.py`).

Runs a Graph eagerly on one torch device: parameters go to the device once,
at construction, and each run walks the graph in topological order calling
each op's registered torch implementation.  The fused int8 ops launch the
port's CUDA kernels on a CUDA device (ops/kernels/); on the CPU they run the
kernels' plain PyTorch versions.  Per-op observability comes from `capture`,
the list of node names whose values a run returns, as in `JaxExecutor`.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..ops.fixed_point import torch_dtype
from ..ops.nn import walking_on
from ..utils import dtypes as dt


class TorchExecutor:
    """Executes a Graph on `device` ("cuda" by default: with no card present
    it raises rather than running on the CPU; pass device="cpu" for the CPU)."""

    def __init__(
        self,
        graph: Graph,
        capture: Sequence[str] | None = None,
        device="cuda",
        fuse: bool = False,
        params: Mapping[str, torch.Tensor] | None = None,
    ):
        self.device = resolve_device(device, "TorchExecutor")
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
        # `params`: tensors on the device already, shared with other
        # executors of graphs with the same parameters (runtime/dynshape.py)
        shared = params or {}
        self._params = {k: shared[k] if k in shared else to_device(v, self.device)
                        for k, v in g.params.items()}

    def run(self, inputs) -> list[np.ndarray]:
        return [o.cpu().numpy() for o in self.run_device(inputs)]

    def run_device(self, inputs, params: Mapping[str, torch.Tensor] | None = None
                   ) -> list[torch.Tensor]:
        """Run and return tensors on the device (no host transfer); `params`
        replaces the executor's parameters of those names for this run (a
        functional run: runtime/autodiff.py differentiates through it)."""
        feeds = self._normalize(inputs)
        consts = self._params if not params else {**self._params, **params}
        env = walk(self.graph, feeds, consts, self.device)
        return [env[name] for name in self.capture]

    def _normalize(self, inputs) -> dict[str, torch.Tensor]:
        return graph_feeds(self.graph, self._var_names, inputs, self.device)


def walk(graph: Graph, feeds: Mapping[str, Any], consts: Mapping[str, torch.Tensor],
         device: torch.device) -> dict[str, Any]:
    """Every node's value: `graph` walked in topological order on `device`,
    its inputs from `feeds` (shapes checked), its constants from `consts`,
    each op by its torch impl.  The executor's run and a control-flow
    subgraph's (ops/control.py) both walk here."""
    env: dict[str, Any] = {}
    with walking_on(device):
        for node in graph.nodes:
            if node.op == VAR:
                v = feeds[node.name]
                if node.shape is not None and tuple(v.shape) != tuple(node.shape):
                    raise ValueError(f"input {node.name}: expected shape {node.shape}, "
                                     f"got {tuple(v.shape)}")
                env[node.name] = v
            elif node.op == CONST:
                env[node.name] = consts[node.name]
            elif node.op == TUPLE:
                env[node.name] = [env[i] for i in node.inputs]
            elif node.op == TUPLE_GET_ITEM:
                env[node.name] = env[node.inputs[0]][int(node.attrs["index"])]
            else:
                impl = get_op(node.op).torch_impl
                env[node.name] = impl(*[env[i] for i in node.inputs], node=node)
    return env


def to_device(v: np.ndarray, device) -> torch.Tensor:
    """A graph constant as a tensor on `device`."""
    return torch.from_numpy(np.array(dt.c_contig(v))).to(device)


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device; a CUDA device with no card present raises
    (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device 'cuda' asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def check_torch_impls(graph: Graph) -> None:
    """Raise naming every op of `graph` that has no torch impl."""
    missing = sorted({n.op for n in graph.nodes
                      if n.op not in (VAR, CONST, TUPLE, TUPLE_GET_ITEM)
                      and get_op(n.op).torch_impl is None})
    if missing:
        raise NotImplementedError(f"ops without a torch impl: {missing}")


def graph_feeds(graph: Graph, var_names, inputs, device) -> dict[str, torch.Tensor]:
    """The graph's inputs (an array, a list in input order or a name -> value
    mapping) as tensors on `device` in the graph's dtypes."""
    if isinstance(inputs, (np.ndarray, torch.Tensor)):
        inputs = [inputs]
    if not isinstance(inputs, Mapping):
        assert len(var_names) == len(inputs), (
            f"expected {len(var_names)} inputs, got {len(inputs)}"
        )
        inputs = dict(zip(var_names, inputs))
    missing = [v for v in var_names if v not in inputs]
    if missing:
        raise KeyError(f"graph inputs not provided: {missing}")
    out = {}
    for k in var_names:
        v = torch.as_tensor(inputs[k], device=device)
        dtype = graph[k].dtype
        if dtype is not None and v.dtype != torch_dtype(dtype):
            v = v.to(torch_dtype(dtype))
        out[k] = v
    return out


def computational_nodes(graph: Graph) -> list[str]:
    """Names of all op nodes (the per-op capture set)."""
    return [
        n.name
        for n in graph.nodes
        if n.op not in (VAR, CONST, TUPLE, TUPLE_GET_ITEM)
    ]
