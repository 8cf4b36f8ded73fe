"""tachikoma_tpu_torch — the PyTorch and CUDA port of tachikoma_tpu.

Integer-only inference with the JAX package's exact semantics, on an NVIDIA
H100: the same graph IR and quantizer, a torch executor, and hand-written
Hopper kernels (csrc/) for the fused int8 ops and for the fused float
attention of the transformer zoo.  The port imports neither jax
nor the JAX package; graphs move between the two through the JSON format of
`Graph.to_json` (`interop.from_reference_graph`).

Subpackages:
  ir        — graph IR, type inference, pre-quantization passes
  ops       — op registry impls: numpy oracle, torch; ops/kernels: the CUDA
              kernels' wrappers and their plain PyTorch versions
  quantize  — calibration + float->integer graph rewriting
  runtime   — numpy interpreter, operator fusion, torch executor
  models    — built-in model zoo (the JAX package's fourteen vision
              builders, bert, gpt2, vit) and KV-cache decoding
              (models/decoding.py)
"""

__version__ = "0.1.0"

from .ir.graph import Graph, GraphBuilder, Node
from .ir.infer import infer_types

# Register the op vocabulary on import.
from .ops import attention as _ops_attention  # noqa: F401
from .ops import extra as _ops_extra  # noqa: F401
from .ops import nn as _ops_nn  # noqa: F401
from .ops import qnn as _ops_qnn  # noqa: F401
from .ops import tail as _ops_tail  # noqa: F401
from .ops import tail2 as _ops_tail2  # noqa: F401
from .ops import tail3 as _ops_tail3  # noqa: F401
from .runtime import fuse as _fuse  # noqa: F401

from .runtime.interpreter import Interpreter, run_graph

__all__ = [
    "Graph",
    "GraphBuilder",
    "Node",
    "infer_types",
    "Interpreter",
    "run_graph",
]
