"""Gradients over graphs (port of `tachikoma_tpu/runtime/autodiff.py`).

The JAX package differentiates its whole-graph program with `jax.grad`.
Here torch autograd differentiates a functional run of the port's executor:
the parameters are passed in as leaf tensors (`TorchExecutor.run_device(...,
params=...)`), each op's torch impl records its backward, and
`torch.autograd.grad` returns the loss's gradient with respect to each.  No
per-op gradient registry is kept, as in the JAX package.

No kernel of the port has, or needs, a backward: the JAX package has no
Pallas backward, and the graphs trained here (float graphs, the fake-quant
graphs of quantize/qat.py) run on plain torch ops, whose backward is
torch's.  `qnn.simulated_quantize` carries the straight-through estimator
as a torch.autograd.Function (ops/qnn.py).

`remat` wraps the forward in `torch.utils.checkpoint` (non-reentrant): its
activations are not kept, and the backward runs the forward again.

The backward runs under `ops/nn.py float32_products`, as each float
product's forward does: TF32 stays off for cuDNN and cuBLAS whatever the
caller's flags (torch's default allows it for cuDNN), so a gradient's
products are float32 products.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

from ..ir.graph import Graph
from ..ops.nn import float32_products
from .executor import TorchExecutor


def value_and_grad_fn(graph: Graph, loss_index: int = 0,
                      wrt: Sequence[str] | None = None,
                      remat: bool = False, device="cuda"):
    """(fn, train0, frozen) with fn(train_params, inputs) -> (loss,
    {param: grad}), tensors on `device`.

    loss_index selects which graph output is the scalar loss; wrt limits the
    differentiated parameter set (default: every float param).  train0 holds
    the differentiated parameters and frozen the others, as device tensors;
    fn differentiates every entry of the train_params it is given (arrays or
    tensors, moved to the device), the others taken from the graph."""
    ex = TorchExecutor(graph, device=device)
    params = ex._params
    if wrt is None:
        wrt = [k for k, v in params.items() if v.dtype.is_floating_point]
    wrt = list(wrt)
    frozen = {k: v for k, v in params.items() if k not in wrt}

    def fn(train_params: Mapping, inputs):
        train = {k: torch.as_tensor(v, device=ex.device).detach().requires_grad_(True)
                 for k, v in train_params.items()}

        def forward(p: dict) -> torch.Tensor:
            return ex.run_device(inputs, params=p)[loss_index]

        if remat:
            from torch.utils.checkpoint import checkpoint

            loss = checkpoint(forward, train, use_reentrant=False)
        else:
            loss = forward(train)
        if loss.ndim != 0:
            raise ValueError(
                f"graph output {loss_index} is not scalar: shape {tuple(loss.shape)}")
        with float32_products():
            grads = torch.autograd.grad(loss, list(train.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                               for (k, v), g in zip(train.items(), grads)}

    train0 = {k: params[k] for k in wrt}
    return fn, train0, frozen


def grad_graph(graph: Graph, loss_index: int = 0,
               wrt: Sequence[str] | None = None, device="cuda") -> Callable:
    """Callable(inputs) -> (loss, {param_name: gradient}) as numpy, for a
    graph whose `loss_index` output is a scalar loss."""
    vg, train0, _ = value_and_grad_fn(graph, loss_index, wrt, device=device)

    def run(inputs):
        loss, grads = vg(train0, dict(inputs))
        return loss.cpu().numpy(), {k: v.cpu().numpy() for k, v in grads.items()}

    return run
