"""K6 (flash_attn) of another tree of this repository, timed on one GPU at
the attention calls of BERT-base b4 s128, GPT-2 small b1 s128 (causal) and
ViT-B/16 b8 224^2, through that tree's own wrapper and library:

    python3 tools/parent_k6.py TREE

TREE is the root of a checkout (a `git archive` of an earlier commit, or
`.` for this one); only its flash_attn.cu is built.  Each call is timed on
the head-split views the graph hands over (a wrapper that copies them pays
for the copies) and on contiguous copies (the kernel alone), CUDA events
over CUDA-graph replays (utils/timing.py call_seconds), ms a call and a
forward (12 calls).  Run it for the parent and this tree in turns in one
command (parent, change, change, parent) to compare them on one card.
"""
import subprocess
import sys

import numpy as np

CALLS = [("BERT-base b4 s128", 4, 12, 128, 64, False), ("GPT-2 small b1 s128", 1, 12, 128, 64, True),
         ("ViT-B/16 b8 224^2", 8, 12, 197, 64, False)]


def main() -> int:
    sys.path.insert(0, sys.argv[1])
    import torch

    from tachikoma_tpu_torch.ops.kernels import _lib

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("kernels of", _lib.CSRC, flush=True)
    _lib.SOURCES = {"flash_attn.cu": _lib.SOURCES["flash_attn.cu"]}
    _lib.build()
    from tachikoma_tpu_torch.ops.kernels import flash_attention as fa
    from tachikoma_tpu_torch.utils.timing import call_seconds

    rng = np.random.default_rng(0)
    for name, b, h, s, d, causal in CALLS:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).cuda()
                   .permute(0, 2, 1, 3) for _ in range(3))
        views = call_seconds(lambda: fa.flash_attention(q, k, v, causal=causal), "cuda") * 1e3
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        contig = call_seconds(lambda: fa.flash_attention(qc, kc, vc, causal=causal), "cuda") * 1e3
        print(f"K6 {name}: views {views:.4f} ms a call ({12 * views:.4f} a forward), "
              f"contiguous {contig:.4f} ({12 * contig:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
