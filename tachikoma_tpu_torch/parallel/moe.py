"""Expert parallelism — int8 mixture-of-experts dense over an 'ep' axis
(port of `tachikoma_tpu/parallel/moe.py`).

Each rank of the 'ep' line owns E/ep experts and computes, on K4's GEMM mode
(`qgemm_raw` through `qmatmul_int8`), its experts' products for the tokens
routed to them; an int32 all-reduce over the line combines the ranks —
exact, because the rows of different experts are disjoint and integer
addition commutes.

Routing is the gate indices as data (`top1_gate`), with no all-to-all, as in
the JAX package: for trace determinism the combine is bit-identical to the
single-device loop over experts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.matmul_int8 import qmatmul_int8
from .mesh import Mesh


def moe_dense_int8_reference(x, w_experts, gate_idx):
    """Single-device oracle: out[t] = x[t] @ W[gate_idx[t]] (int32 accum)."""
    T, K = x.shape
    E, K2, N = w_experts.shape
    out = np.zeros((T, N), np.int64)
    for e in range(E):
        mask = gate_idx == e
        if mask.any():
            out[mask] = x[mask].astype(np.int64) @ w_experts[e].astype(np.int64)
    return out.astype(np.int32)


class ExpertParallelDense:
    """This rank's E/ep experts of `w_experts` (E, K, N) int8 on the mesh's
    device, put there once (as ShardedExecutor puts its weight slices, so K4
    packs each once); a call is moe_dense_int8 on them."""

    def __init__(self, w_experts, mesh: Mesh, axis: str = "ep"):
        E = w_experts.shape[0]
        nshard = mesh.size(axis)
        if E % nshard:
            raise ValueError(f"{E} experts over {nshard} shards")
        e_local = E // nshard
        self.base = mesh.index(axis) * e_local
        self.mesh, self.axis = mesh, axis
        self.experts = [torch.as_tensor(np.ascontiguousarray(w_experts[self.base + i]),
                                        device=mesh.device) for i in range(e_local)]

    def __call__(self, x, gate_idx) -> torch.Tensor:
        dev = self.mesh.device
        xs = torch.as_tensor(x if torch.is_tensor(x) else np.ascontiguousarray(x), device=dev)
        gate = torch.as_tensor(np.ascontiguousarray(gate_idx, np.int32), device=dev)
        out = torch.zeros((xs.shape[0], self.experts[0].shape[-1]), dtype=torch.int32,
                          device=dev)
        for i, w in enumerate(self.experts):
            rows = torch.nonzero(gate == self.base + i).squeeze(1)
            if rows.numel():
                out[rows] = qmatmul_int8(xs[rows], w)
        return self.mesh.collective(self.axis).all_reduce(out)


def moe_dense_int8(x, w_experts, gate_idx, mesh: Mesh, axis: str = "ep") -> torch.Tensor:
    """Expert-parallel int8 MoE dense over `mesh` axis `axis`.

    x (T, K) int8 tokens; w_experts (E, K, N) int8 (E divisible by the axis
    size); gate_idx (T,) int32 expert assignment — every rank passes the
    same global values.  Returns (T, N) int32 on the mesh's device,
    bit-identical to moe_dense_int8_reference.  A caller that routes many
    batches through the same experts keeps an ExpertParallelDense."""
    return ExpertParallelDense(w_experts, mesh, axis)(x, gate_idx)


def top1_gate(x, w_gate):
    """Deterministic integer router: argmax of an int32 gating matmul."""
    scores = x.astype(np.int64) @ w_gate.astype(np.int64)
    return np.argmax(scores, axis=-1).astype(np.int32)
