"""Dynamic slicing with runtime start indices and the truncated modulo (port
of part of `tachikoma_tpu/ops/tail3.py`): `dynamic_slice` and
`dynamic_update_slice`, the primitives of the decode step's KV-cache writes
(models/decoding.py gpt2_decode_step), and `trunc_mod`, ONNX's Mod with
fmod=1, and `floor_mod`, TensorFlow's FloorMod: numpy's floor mod, the
torch impl of `mod` (ops/nn.py).

The slice extents are attrs (or the update's shape), the start indices are
scalar tensor inputs, clamped like `lax.dynamic_slice` so that the window
always fits.  The torch impls read no start index on the host: the clamp and
the window's indices are computed on the start tensors' device and the
values moved with `index_select` / `index_put_`, so a step holds no
device-to-host read and can be captured in a CUDA graph.  The update is
functional: it returns a new tensor.

Also `nn.cross_entropy_with_logits`, the loss of quantization-aware training
(quantize/qat.py): its prediction is already log-probabilities (a
`nn.log_softmax`), its target one-hot or soft labels, the loss -sum(target *
pred) / batch in float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import infer_rule, np_impl, register_op, torch_impl
from ..utils import dtypes as dt
from .nn import _mod_torch, _nonzero_divisor, _promoted


@infer_rule("dynamic_slice")
def _dyn_slice_rel(node: Node, ins):
    (a, adt) = ins[0]
    sizes = tuple(int(s) for s in node.attrs["sizes"])
    assert len(sizes) == len(a), f"sizes rank {len(sizes)} != data rank {len(a)}"
    assert len(ins) == 1 + len(a), "need one start scalar per dimension"
    return sizes, adt


@np_impl("dynamic_slice")
def _dyn_slice_np(a, *starts, node: Node):
    sizes = [int(s) for s in node.attrs["sizes"]]
    idx = []
    for d, (st, sz) in enumerate(zip(starts, sizes)):
        s = int(np.clip(int(np.asarray(st).reshape(())), 0, a.shape[d] - sz))
        idx.append(slice(s, s + sz))
    return a[tuple(idx)]


def _window(start: torch.Tensor, dim: int, size: int, device) -> torch.Tensor:
    """The indices start', ..., start' + size - 1 of one axis, start' the
    start clamped to [0, dim - size], on `device`, with no host read."""
    s = start.reshape(()).to(device=device, dtype=torch.int64).clamp(0, dim - size)
    return s + torch.arange(size, device=device)


@torch_impl("dynamic_slice")
def _dyn_slice_torch(a: torch.Tensor, *starts: torch.Tensor, node: Node) -> torch.Tensor:
    sizes = [int(s) for s in node.attrs["sizes"]]
    for d, (st, sz) in enumerate(zip(starts, sizes)):
        if sz != a.shape[d]:  # a full axis starts at 0 whatever its start
            a = a.index_select(d, _window(st, a.shape[d], sz, a.device))
    return a


@infer_rule("dynamic_update_slice")
def _dyn_upd_rel(node: Node, ins):
    (a, adt) = ins[0]
    (u, udt) = ins[1]
    assert len(u) == len(a), "update rank must match data rank"
    assert udt == adt, f"dtype mismatch {udt} vs {adt}"
    assert len(ins) == 2 + len(a), "need one start scalar per dimension"
    return tuple(a), adt


@np_impl("dynamic_update_slice")
def _dyn_upd_np(a, u, *starts, node: Node):
    out = a.copy()
    idx = []
    for d, st in enumerate(starts):
        s = int(np.clip(int(np.asarray(st).reshape(())), 0,
                        a.shape[d] - u.shape[d]))
        idx.append(slice(s, s + u.shape[d]))
    out[tuple(idx)] = u
    return out


def _update_indices(a: torch.Tensor, u: torch.Tensor,
                    starts: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """One index tensor per axis, each shaped to broadcast along its own axis
    to `u`'s shape, the starts clamped on the device (an axis the update
    spans whole starts at 0 whatever its start)."""
    idx = []
    for d, st in enumerate(starts):
        shape = [1] * a.ndim
        shape[d] = u.shape[d]
        if u.shape[d] == a.shape[d]:
            i = torch.arange(u.shape[d], device=a.device)
        else:
            i = _window(st, a.shape[d], u.shape[d], a.device)
        idx.append(i.reshape(shape))
    return tuple(idx)


@torch_impl("dynamic_update_slice")
def _dyn_upd_torch(a: torch.Tensor, u: torch.Tensor, *starts: torch.Tensor,
                   node: Node) -> torch.Tensor:
    return a.clone().index_put_(_update_indices(a, u, starts), u.to(a.dtype))


# ---------------------------------------------------------------------------
# trunc_mod: np.fmod, the sign of the dividend
# ---------------------------------------------------------------------------

def _bin_rel(node: Node, ins):
    (s0, d0), (s1, d1) = ins[0], ins[1]
    return tuple(np.broadcast_shapes(s0, s1)), dt.promote(d0, d1)


def _trunc_mod_np(a, b, *, node: Node):
    return np.fmod(a, b).astype(dt.promote(str(a.dtype), str(b.dtype)))


def _trunc_mod_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    """torch.fmod in the promoted dtype (C's fmod, exact); an integer zero
    divisor gives 0, as numpy's does, a float one NaN."""
    a, b = _promoted(a, b)
    if a.dtype.is_floating_point:
        return torch.fmod(a, b)
    zero, b1 = _nonzero_divisor(b)
    return torch.where(zero, torch.zeros_like(a), torch.fmod(a, b1))


register_op("trunc_mod", infer=_bin_rel, np_impl=_trunc_mod_np, torch_impl=_trunc_mod_torch)



# ---------------------------------------------------------------------------
# nn.cross_entropy_with_logits (pred already log-probabilities)
# ---------------------------------------------------------------------------

@infer_rule("nn.cross_entropy_with_logits")
def _cewl_rel(node: Node, ins):
    return (), "float32"


@np_impl("nn.cross_entropy_with_logits")
def _cewl_np(pred, target, *, node: Node):
    return np.float32(-np.sum(target * pred) / pred.shape[0])


@torch_impl("nn.cross_entropy_with_logits")
def _cewl_torch(pred: torch.Tensor, target: torch.Tensor, *, node: Node) -> torch.Tensor:
    return (-torch.sum(target * pred) / pred.shape[0]).to(torch.float32)


# ---------------------------------------------------------------------------
# floor_mod: np.mod, the sign of the divisor (TensorFlow's FloorMod)
# ---------------------------------------------------------------------------

def _floor_mod_np(a, b, *, node: Node):
    return np.mod(a, b).astype(dt.promote(str(a.dtype), str(b.dtype)))


register_op("floor_mod", infer=_bin_rel, np_impl=_floor_mod_np, torch_impl=_mod_torch)
