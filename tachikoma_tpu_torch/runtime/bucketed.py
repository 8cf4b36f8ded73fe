"""Shape-bucket executor (port of `tachikoma_tpu/runtime/bucketed.py`).

Dynamic batch sizes over executors built for static shapes: the graph is
re-typed once per SHAPE BUCKET, inputs are zero-padded up to the bucket and
outputs sliced back.  A bucket's `TorchExecutor` is built once and cached, so
the device holds one copy of the params per bucket built, and the kernels'
per-weight caches (K1's K-major packing) are warm after a bucket's first
call; any batch <= max(buckets) reuses a bucket.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..ir.graph import VAR, Graph
from ..ir.infer import infer_types
from .executor import TorchExecutor, resolve_device

_DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class BucketedExecutor:
    """Runs a graph at any batch size along `axis` of every input var, on
    `device` ("cuda" by default: with no card present it raises; pass
    device="cpu" for the CPU).

    Policy: pick the smallest bucket >= batch, zero-pad inputs to it, run
    the cached bucket executor, slice every output back to the true batch
    (all outputs are assumed batch-major on `axis`).  Batches larger than
    the biggest bucket get an exact-size executor (built and cached too).
    """

    def __init__(self, graph: Graph, axis: int = 0, buckets: Sequence[int] | None = None,
                 fuse: bool = False, device="cuda"):
        self.device = resolve_device(device, "BucketedExecutor")
        self.template = infer_types(graph)
        self.axis = axis
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self.fuse = fuse
        self._cache: dict[int, TorchExecutor] = {}
        self._var_names = [n.name for n in self.template.inputs]

    # -- internals -----------------------------------------------------------

    def _graph_for(self, b: int) -> Graph:
        return with_batch(self.template, b, self.axis)

    def executor_for(self, b: int) -> TorchExecutor:
        bucket = next((v for v in self.buckets if v >= b), b)
        ex = self._cache.get(bucket)
        if ex is None:
            ex = TorchExecutor(self._graph_for(bucket), fuse=self.fuse, device=self.device)
            self._cache[bucket] = ex
        return ex

    @property
    def compiled_buckets(self) -> list[int]:
        """The buckets whose executor has been built."""
        return sorted(self._cache)

    # -- public API ----------------------------------------------------------

    def run(self, inputs) -> list[np.ndarray]:
        return [o.cpu().numpy() for o in self.run_device(inputs)]

    def run_device(self, inputs) -> list[torch.Tensor]:
        """Run at the inputs' batch; the outputs stay on the device."""
        if isinstance(inputs, (np.ndarray, torch.Tensor)):
            inputs = [inputs]
        if isinstance(inputs, Mapping):
            inputs = [inputs[v] for v in self._var_names]
        inputs = [torch.as_tensor(x) for x in inputs]
        b = inputs[0].shape[self.axis]
        for x in inputs[1:]:
            if x.shape[self.axis] != b:
                raise ValueError(f"inconsistent batch sizes along axis {self.axis}: "
                                 f"{b} vs {x.shape[self.axis]}")
        ex = self.executor_for(b)
        bucket = ex.graph.inputs[0].shape[self.axis]
        if bucket != b:
            padded = []
            for x in inputs:
                shape = list(x.shape)
                shape[self.axis] = bucket - b
                padded.append(torch.cat([x, x.new_zeros(shape)], dim=self.axis))
            inputs = padded
        outs = ex.run_device(inputs)
        if bucket != b:
            for o in outs:
                if o.ndim <= self.axis:
                    # e.g. a scalar loss: the value was computed over the
                    # zero-padded rows and cannot be sliced back -- padding
                    # would silently corrupt it
                    raise ValueError(
                        f"bucketed output of rank {o.ndim} has no batch axis {self.axis}; "
                        "outputs that aggregate over the batch are not paddable -- run at an "
                        f"exact bucket size (buckets={self.buckets})")
            outs = [o.narrow(self.axis, 0, b) for o in outs]
        return outs


def with_batch(graph: Graph, b: int, axis: int = 0) -> Graph:
    """`graph` with every input var's `axis` set to `b`, types inferred
    again."""
    nodes = []
    for n in graph.nodes:
        if n.op == VAR:
            shape = list(n.shape)
            shape[axis] = b
            nodes.append(n.with_(shape=tuple(shape)))
        else:
            # drop stale inferred types; infer_types refills
            nodes.append(n.with_(shape=None, dtype=None) if n.op != "const" else n)
    g = Graph(nodes, list(graph.outputs), dict(graph.params), graph.name)
    return infer_types(g)
