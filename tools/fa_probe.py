"""K6 (flash_attn) timed on one GPU at the attention calls of BERT-base b4
s128, GPT-2 small b1 s128 (causal) and ViT-B/16 b8 224^2, on the head-split
views the graph hands over, whole, at every launch plan, and with parts cut
out:

    python3 tools/fa_probe.py [--plans] [OUT_JSON]

  * whole: the kernel as it is, at the plan `fa_plan` picks, held within
    rtol 2e-5, atol 2e-6 of its plain version, beside
    torch's scaled_dot_product_attention on the same views;
  * `--plans`: every plan that fits (warps a block, output columns a block,
    column blocks, stages), each held to the plain version first;
  * the cuts (csrc/flash_attn.cu's FA_* switches, each a build of its own,
    loaded beside the others into this process): one plain TF32 product
    instead of three (no_split), no P.V (no_pv), no exp (no_exp), K and V
    not staged (no_copies), an empty kernel (empty); the staged tiles not
    split into their TF32 parts (no_split_pass), no Q.K^T (no_qk).  A cut's
    outputs are wrong by design and are not compared.

Times are CUDA events over CUDA-graph replays (`utils/timing.py
call_seconds`, warm L2), ms per call and per forward (12 calls).  The
card's name and power limit are printed; everything goes to OUT_JSON
(default fa_probe.json).
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dw_probe import build_variants, entries_of  # noqa: E402

SRC = "flash_attn.cu"
# (model, B, H, S, D, causal): the forwards' 12 identical calls each
CALLS = [("BERT-base b4 s128", 4, 12, 128, 64, False), ("GPT-2 small b1 s128", 1, 12, 128, 64, True),
         ("ViT-B/16 b8 224^2", 8, 12, 197, 64, False)]
CUTS = {name: [(f"#define {macro} 1", f"#define {macro} 0")]
        for name, macro in (("no_split", "FA_SPLIT"), ("no_pv", "FA_PV"), ("no_exp", "FA_EXP"),
                            ("no_copies", "FA_COPIES"), ("empty", "FA_BODY"))}
CUTS.update({
    # the staged tiles not split at all (the planes hold what they hold)
    "no_split_pass": [("    if (kt == 0 && !KG) fa_split_block<THREADS>(qh, ql, 16 * W * QST);\n"
                       "    fa_split_block<THREADS>(kt_h, kl, TILE);\n", "")],
    # no Q.K^T products (the scores stay 0)
    "no_qk": [("      for (int kb = 0; kb < kend; kb += 8 * KF) {",
               "      for (int kb = 0; kb < 0; kb += 8 * KF) {")],
})
RTOL, ATOL = 2e-5, 2e-6


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import _lib, flash_attention as fa
    from tachikoma_tpu_torch.utils.timing import call_seconds

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    out_path = args[0] if args else "fa_probe.json"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(0)
    ops = []
    for model, b, h, s, d, causal in CALLS:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).cuda()
                   .permute(0, 2, 1, 3) for _ in range(3))
        ops.append((model, q, k, v, causal))
    res = {"card": card, "calls": [list(c) for c in CALLS], "variants": {}, "plans": {}}
    workdir = Path(tempfile.mkdtemp(prefix="fa_probe_"))
    real_plan = fa.fa_plan
    try:
        libs = build_variants(_lib.CSRC, SRC, CUTS, workdir)
        for name, lib in libs.items():
            row = {}
            with entries_of(lib, SRC):
                for model, q, k, v, causal in ops:
                    def fn(): return fa.flash_attention(q, k, v, causal=causal)
                    if name == "whole":
                        err = float((fn() - fa.flash_attention_plain(q, k, v, causal=causal))
                                    .abs().max())
                        torch.testing.assert_close(fn(), fa.flash_attention_plain(
                            q, k, v, causal=causal), rtol=RTOL, atol=ATOL)
                        sdpa = call_seconds(lambda: torch.nn.functional.scaled_dot_product_attention(
                            q, k, v, is_causal=causal), "cuda") * 1e3
                        row[model + " sdpa"] = sdpa
                        row[model + " err"] = err
                    ms = call_seconds(fn, "cuda") * 1e3
                    row[model] = ms
                    print(f"{name:10s} {model:22s} {ms:.4f} ms a call, {12 * ms:.4f} a forward"
                          + (f"; SDPA {row[model + ' sdpa']:.4f}, max |err| {row[model + ' err']:.3e}"
                             if name == "whole" else ""), flush=True)
                if name == "whole" and "--plans" in sys.argv:
                    for model, q, k, v, causal in ops:
                        b, h, s, d = q.shape
                        want = fa.flash_attention_plain(q, k, v, causal=causal)
                        dq = real_plan(b * h, s, d)["dq"]
                        for dq_, dv, bk in fa.TILES:
                            for w, st in ((w, st) for w in fa.WARPS for st in (1, 2)):
                                if dq_ != dq or (st == 2 and s <= bk) or fa.fa_smem_bytes(
                                        w, dq, dv, bk, False, st) > fa._MAX_SMEM:
                                    continue
                                plan = dict(w=w, dq=dq, dv=dv, bk=bk, cs=-(-d // dv), kg=False,
                                            stages=st)
                                fa.fa_plan = lambda *a_, _p=plan: _p
                                try:
                                    def fn(): return fa.flash_attention(q, k, v, causal=causal)
                                    torch.testing.assert_close(fn(), want, rtol=RTOL, atol=ATOL)
                                    ms = call_seconds(fn, "cuda") * 1e3
                                finally:
                                    fa.fa_plan = real_plan
                                key = f"{model} w{w} dv{dv} stages{st}"
                                res["plans"][key] = ms
                                print(f"plan {key:40s} {ms:.4f} ms a call", flush=True)
            res["variants"][name] = row
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    finally:
        fa.fa_plan = real_plan
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
