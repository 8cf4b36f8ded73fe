"""K1's batched mode (`qbmm_rq`, `qbmm_raw`: `csrc/qbmm_hopper.cu`) timed
on one GPU at every distinct call of the attention products that
`chip_smoke.py` drives, beside an earlier tree's batched mode in the same
process:

    python3 tools/bmm_probe.py [--csrc DIR] [--no-cuts | --cuts=A,B] [--plans] [--models=A,B]
                               [OUT_JSON]

The calls (`MODELS`), each built with the main path's layout: q, k and v
head-split views (B, H, S, D) of (B, S, H * D) tensors, read in place; the
softmax output (B, H, S, S) contiguous with zero point -128; the decode
step's caches (B, H, L, D) contiguous; the ring's chunks contiguous:

  * int8 BERT-base b4 s128 (phase 17c), GPT-2 small b1 s128 and ViT-B/16
    b8 224^2 (phase 17), ViT-L/16 b1 224^2 (23a), the int8 GPT-2 small
    decode step per token (18e): `qbmm_rq`, the scores q . k^T and the
    context softmax . v;
  * int8 BERT-base b1 s128's trace (17e), the unfused decode step's trace
    (18f): `qbmm_raw`, the same products;
  * GPT-2 small's step verifying 8 or 16 draft tokens against the cache of
    128 (speculative decoding; no phase of `chip_smoke.py` makes it):
    `qbmm_rq` at M 8 and 16, the small path's rows above 1;
  * ring attention B 1, H 12, D 64, S 4096 on rank 0 (26e) at sp 2 (2048-row
    chunks) and sp 4 (1024): `qbmm_raw`, three scores products and two
    context products a ring step (the second of them the u == 256 term,
    zero point 0).

Per call:

  * `port`: the wrapper (`ops/kernels/matmul_int8.py`) at the plan it
    picks, held == its plain version (`exact_int_bmm`) first;
  * `before` (with `--csrc DIR`): `qgemm_rq.cu`'s `tk_qbmm_*` of DIR (a
    `git archive` of the parent tree: the batched mode on K1-K4's shared
    `wgmma` body, `igemm_hopper.cuh` BMM), built into a library of its own
    and launched with that design's parameters (its tile rule and staging
    modes, `parent_params`), == plain first; and with parts cut out (their
    outputs are wrong by design and not compared): `before_no_a_loads` /
    `before_no_b_loads` (an operand not staged), `before_no_loads` (neither),
    `before_no_zp` (no zero-point sums and no fold), `before_no_mma` (no
    `wgmma`), `before_no_epilogue` (no requantize and no store),
    `before_empty` (every block returns before its first item);
  * the port's kernel with its parts cut out, by the compile-time switches
    at the top of `csrc/qbmm_hopper.cu` (each 1 in the kernel as it runs):
    `port_no_loads` (no operand read: the tiles hold what shared memory
    held), `port_no_mma` (no product: no `wgmma` on the tiled path, no
    `dp4a` on the decode path), `port_no_epilogue` (nothing stored),
    `port_empty` (every block returns as it starts: the launch and the grid),
    `port_no_requant` (the RQ epilogue stores the sum's low byte);
  * the port's kernel against the designs it departs from, each == plain
    first, by the switches after the cuts: `port_fold` (QB_FLIP 0: a zero
    point of -128 folded like any other, no u8 operand), `port_kc64` (QB_KC
    64: K in 64-byte chunks, two buffers, at every K), `port_raw_staged`
    (QB_RAW_STAGED 1: the RAW tile staged, leaving in 16-byte stores; raw
    calls), `port_partial_staged` (QB_PARTIAL_STAGED 1: RQ tiles that are
    part of unaligned rows staged too; RQ calls), `port_bn128` (QB_BN128 1:
    the plan's tile at 128 columns; tiled calls), `port_copies_cg` (the
    16-byte copies in L2 alone), `port_no_reg_cap` (no register cap);
  * `--plans`: the port's kernel at every launch of `bmm_plans` (the small
    path where M <= 16; tiles of 64 or 128 rows by 64 or 256 columns, K in
    the chunks `bmm_kc` gives), each == plain first;
  * `library`: an fp16 `torch.matmul` of contiguous copies of the same
    shapes (timed only, never served; not exact);
  * `bound`: max(bytes / 3.35 TB/s, 2 M K N / 1979 TOP/s) a call, the bytes
    each operand read once and the output written once (int8, or int32 for
    `qbmm_raw`), as `chip_smoke.py work` counts them.

`--models=A,B` keeps the models whose name contains one of the strings;
`--cuts=A,B` builds only the cuts and variants named (e.g. `fold,bn128`).
Times are CUDA events over CUDA-graph replays (`utils/timing.py
call_seconds`, warm L2), per call and summed per forward with each call's
repeats.  The card's name and power limit are printed; everything goes to
OUT_JSON (default bmm_probe.json).
"""
import contextlib
import ctypes
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

SRC = "qbmm_hopper.cu"
BEFORE_SRC = "qgemm_rq.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core peak, same source


def _heads(rng, b, s, h, d):
    """A head-split (B, H, S, D) view of a (B, S, H * D) int8 tensor."""
    x = torch.from_numpy(rng.integers(-128, 128, (b, s, h * d)).astype(np.int8)).cuda()
    return x.reshape(b, s, h, d).permute(0, 2, 1, 3)


def _i8(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)).cuda()


def _attention(b, s, h, d):
    """The scores and context products of one attention layer, as the fused
    or unfused int8 graph makes them."""
    def scores(rng):
        return _heads(rng, b, s, h, d), _heads(rng, b, s, h, d), dict(transpose_b=True)

    def context(rng):
        return _i8(rng, (b, h, s, s)), _heads(rng, b, s, h, d), dict(lhs_zero_point=-128)

    return scores, context


def _decode(h, cache, d, rows=1):
    """The decode step's products: q (a head-split view of the step's rows)
    against the whole K cache, the softmax rows against the V cache."""
    def scores(rng):
        return _heads(rng, 1, rows, h, d), _i8(rng, (1, h, cache, d)), dict(transpose_b=True)

    def context(rng):
        return (_i8(rng, (1, h, rows, cache)), _i8(rng, (1, h, cache, d)),
                dict(lhs_zero_point=-128))

    return scores, context


def _ring(h, n, d):
    """A ring step's products on contiguous chunks of n rows: scores, the
    context of min(u, 255) - 128 at zero point -128, and the u == 256 term."""
    def scores(rng):
        return _i8(rng, (1, h, n, d)), _i8(rng, (1, h, n, d)), dict(transpose_b=True)

    def context(rng):
        return _i8(rng, (1, h, n, n)), _i8(rng, (1, h, n, d)), dict(lhs_zero_point=-128)

    def context_u256(rng):
        u = torch.from_numpy((rng.random((1, h, n, n)) < 0.001).astype(np.int8)).cuda()
        return u, _i8(rng, (1, h, n, d)), {}

    return scores, context, context_u256


def _layers(kernel, products, layers):
    return [(kernel, name, fn, layers) for name, fn in zip(("scores", "context"), products)]


_RING2, _RING4 = _ring(12, 2048, 64), _ring(12, 1024, 64)
# model -> [(kernel, call, operands(rng), calls a forward)]
MODELS = {
    "BERT-base b4 s128 (17c)": _layers("qbmm_rq", _attention(4, 128, 12, 64), 12),
    "GPT-2 small b1 s128 (17)": _layers("qbmm_rq", _attention(1, 128, 12, 64), 12),
    "ViT-B/16 b8 224^2 (17)": _layers("qbmm_rq", _attention(8, 197, 12, 64), 12),
    "ViT-L/16 b1 224^2 (23a)": _layers("qbmm_rq", _attention(1, 197, 16, 64), 24),
    "GPT-2 small decode step, a token (18e)": _layers("qbmm_rq", _decode(12, 128, 64), 12),
    "BERT-base b1 s128 trace (17e)": _layers("qbmm_raw", _attention(1, 128, 12, 64), 12),
    "decode step trace (18f)": _layers("qbmm_raw", _decode(12, 128, 64), 12),
    "GPT-2 small verify 8 drafts (no phase)": _layers("qbmm_rq", _decode(12, 128, 64, 8), 12),
    "GPT-2 small verify 16 drafts (no phase)": _layers("qbmm_rq", _decode(12, 128, 64, 16), 12),
    "ring sp 2, rank 0 (26e)": [("qbmm_raw", "scores", _RING2[0], 6),
                                ("qbmm_raw", "context", _RING2[1], 2),
                                ("qbmm_raw", "context_u256", _RING2[2], 2)],
    "ring sp 4, rank 0 (26e)": [("qbmm_raw", "scores", _RING4[0], 12),
                                ("qbmm_raw", "context", _RING4[1], 4),
                                ("qbmm_raw", "context_u256", _RING4[2], 4)],
}

_IGH = "igemm_hopper.cuh"
# cuts of the parent's batched mode (igemm_hopper.cuh BMM), applied to DIR's copy
BEFORE_CUTS = {
    "no_a_loads": [(_IGH, "      stage_operand<BM, NT>(as, x, bq.a_sm,",
                    "      if (g.M < 0) stage_operand<BM, NT>(as, x, bq.a_sm,")],
    "no_b_loads": [(_IGH, "      stage_operand<BN, NT>(as + BM * KSTEP, wk,",
                    "      if (g.M < 0) stage_operand<BN, NT>(as + BM * KSTEP, wk,")],
    "no_zp": [(_IGH, "      if (bq.za != 0) {", "      if (bq.za != 0 && g.M < 0) {"),
              (_IGH, "      if (bq.zb != 0) {", "      if (bq.zb != 0 && g.M < 0) {"),
              (_IGH, "      if (bq.za != 0 || bq.zb != 0) {",
               "      if ((bq.za != 0 || bq.zb != 0) && g.M < 0) {")],
    "no_mma": [(_IGH, "      wgmma_acc<BN>(acc, gmma_desc(as + wg * 4096 + kk * 256, 128, 512),",
                "      if (g.M < 0) wgmma_acc<BN>(acc, gmma_desc(as + wg * 4096 + kk * 256, "
                "128, 512),")],
    "no_epilogue": [(_IGH, "      if (run_epilogue && g.o_vec) {", "      if (g.M < 0) {"),
                    (_IGH, "      } else if (run_epilogue) {", "      } else if (g.M < 0) {"),
                    (_IGH, "    } else {\n      int32_t* const o32 = static_cast<int32_t*>(out);",
                     "    } else if (g.M < 0) {\n      int32_t* const o32 = "
                     "static_cast<int32_t*>(out);")],
    "empty": [(_IGH, "  const int kbeg = blockIdx.z * g.kper;\n",
               "  if (n_items > 0) return;\n  const int kbeg = blockIdx.z * g.kper;\n")],
}
BEFORE_CUTS["no_loads"] = BEFORE_CUTS["no_a_loads"] + BEFORE_CUTS["no_b_loads"]
# cuts of the port's kernel: its switches (csrc/qbmm_hopper.cu)
PORT_CUTS = {
    "no_loads": [("#define QB_LOADS 1", "#define QB_LOADS 0")],
    "no_mma": [("#define QB_MMA 1", "#define QB_MMA 0")],
    "no_epilogue": [("#define QB_EPILOGUE 1", "#define QB_EPILOGUE 0")],
    "empty": [("#define QB_BODY 1", "#define QB_BODY 0")],
    "no_requant": [("#define QB_REQUANT 1", "#define QB_REQUANT 0")],
    # not cuts: the designs this one departs from (each gives the same integers)
    "fold": [("#define QB_FLIP 1", "#define QB_FLIP 0")],
    "kc64": [("#define QB_KC 0", "#define QB_KC 64")],
    "raw_staged": [("#define QB_RAW_STAGED 0", "#define QB_RAW_STAGED 1")],
    "partial_staged": [("#define QB_PARTIAL_STAGED 0", "#define QB_PARTIAL_STAGED 1")],
    "bn128": [("#define QB_BN128 0", "#define QB_BN128 1")],
    "copies_cg": [("cp.async.ca.shared.global [%0], [%1], 16, %2;",
                   "cp.async.cg.shared.global [%0], [%1], 16, %2;")],
    "no_reg_cap": [("__launch_bounds__(128 * WG, NJ == 1 ? 4 / WG : 1)",
                    "__launch_bounds__(128 * WG)")],
}
# the variants held == plain, and the kernels each applies to
_BOTH = ("qbmm_rq", "qbmm_raw")
VARIANTS = {"fold": _BOTH, "kc64": _BOTH, "raw_staged": ("qbmm_raw",),
            "partial_staged": ("qbmm_rq",), "bn128": _BOTH}
PARENT_MODES = {"kmajor16": 0, "rows16": 1, "bytes": 2}  # the parent's OpMode


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def parent_params(a, b, za, zb, ta, tb, sms):
    """The parent wrapper's launch of one call (`_bmm_launch` of the tree
    before the redesign): the logical views, their merged batch axes and
    strides, its tile rule (64 x 64 unless 128-row tiles fill the SMs twice)
    and its staging modes.  Returns (A, B, nb, M, N, parameters)."""
    from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm

    A, B = mm._logical(a, b, ta, tb)
    m, k = A.shape[-2:]
    n = B.shape[-1]
    batch = tuple(torch.broadcast_shapes(A.shape[:-2], B.shape[:-2]))
    A, B = A.expand(batch + (m, k)), B.expand(batch + (k, n))
    (n0, a0, b0), (n1, a1, b1) = mm._merge_batch(batch, A.stride()[:-2], B.stride()[:-2])
    a_sm, a_sk = A.stride()[-2:]
    b_sk, b_sn = B.stride()[-2:]

    def mode(t, sr, sk, rows, sbs):
        aligned = t.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in sbs)
        if aligned and sk == 1 and k % 16 == 0 and sr % 16 == 0:
            return PARENT_MODES["kmajor16"]
        if aligned and sr == 1 and rows % 16 == 0 and sk % 16 == 0:
            return PARENT_MODES["rows16"]
        return PARENT_MODES["bytes"]

    bn = 128 if n > 64 else 64
    bm, bn = (128, bn) if n0 * n1 * -(-m // 128) * -(-n // bn) >= 2 * sms else (64, 64)
    p = dict(n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=n, oh=1, ow=1, sh=1, sw=1, bm=bm, bn=bn,
             ks=1, kper=-(-k // 64), bmm_nb=n0 * n1, bmm_nb1=n1,
             a_mode=mode(A, a_sm, a_sk, m, (a0, a1)), b_mode=mode(B, b_sn, b_sk, n, (b0, b1)),
             bmm_za=za, bmm_zb=zb, a_sb0=a0, a_sb1=a1, a_sm=a_sm, a_sk=a_sk, b_sb0=b0,
             b_sb1=b1, b_sn=b_sn, b_sk=b_sk)
    return A, B, n0 * n1, m, n, p


def before_launcher(lib_path: Path, kernel: str, sms: int):
    """fn(a, b, kw, vectors) -> output: the parent's tk_qbmm_rq / tk_qbmm_raw
    from `lib_path`, launched as its wrapper did."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    raw = kernel == "qbmm_raw"
    fn = getattr(ctypes.CDLL(str(lib_path)), f"tk_{kernel}")
    fn.argtypes = [ctypes.c_void_p] * (6 if raw else 8)
    fn.restype = ctypes.c_int

    def run(a, b, kw, vec):
        A, B, nb, m, n, p = parent_params(a, b, kw.get("lhs_zero_point", 0),
                                          kw.get("rhs_zero_point", 0),
                                          kw.get("transpose_a", False),
                                          kw.get("transpose_b", False), sms)
        out = torch.empty((nb, m, n), dtype=torch.int32 if raw else torch.int8, device="cuda")
        if not raw:
            p.update(qmin=-128, qmax=127)
        arr = (ctypes.c_int32 * len(_lib.PARAMS))(*(int(p.get(key, 0)) for key in _lib.PARAMS))
        ptrs = [A.data_ptr(), B.data_ptr(), out.data_ptr()] + [v.data_ptr() for v in vec]
        rc = fn(*ptrs, ctypes.addressof(arr), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"tk_{kernel} (before): CUDA error {rc}")
        return out

    return run


def work(a, b, kw, raw) -> tuple[int, int]:
    """(bytes, operations) of one call, as chip_smoke.py work counts them."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import _logical

    A, B = _logical(a, b, kw.get("transpose_a", False), kw.get("transpose_b", False))
    m, k, n = A.shape[-2], A.shape[-1], B.shape[-1]
    nb = int(np.prod(torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])))
    return A.numel() + B.numel() + (4 if raw else 1) * nb * m * n, 2 * nb * m * k * n


def library(a, b, kw):
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import _logical

    A, B = _logical(a.half(), b.half(), kw.get("transpose_a", False), kw.get("transpose_b", False))
    A, B = A.contiguous(), B.contiguous()
    return lambda: torch.matmul(A, B)


def _nbmkn(A, B) -> tuple[int, int, int, int]:
    """(products, M, K, N) of the logical views A (..., M, K), B (..., K, N)."""
    nb = int(np.prod(torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])))
    return nb, A.shape[-2], A.shape[-1], B.shape[-1]


@contextlib.contextmanager
def _bn128(on: bool):
    """The wrapper takes a 128-column tile (the kernel built with QB_BN128)."""
    from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm

    saved = mm.BMM_BN
    mm.BMM_BN = (64, 128, 256) if on else saved
    try:
        yield
    finally:
        mm.BMM_BN = saved


def _applies(csrc: Path, src: str, cut) -> bool:
    """Whether every replacement of a cut finds its text once in csrc."""
    return (csrc / src).exists() and all(
        (csrc / (r[0] if len(r) == 3 else src)).read_text().count(r[-2]) == 1 for r in cut)


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import _lib, conv, matmul_int8 as mm
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize
    from tachikoma_tpu_torch.utils.timing import call_seconds

    argv = sys.argv[1:]
    csrc = Path(argv[argv.index("--csrc") + 1]) if "--csrc" in argv else None
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--") and (i == 0 or argv[i - 1] != "--csrc")]
    out_path = args[0] if args else "bmm_probe.json"
    cuts = "--no-cuts" not in argv
    named = [a.split("=", 1)[1].split(",") for a in argv if a.startswith("--cuts=")]
    keep = (lambda name: name in named[0]) if named else (lambda name: True)
    the_card = card()
    print(the_card, flush=True)
    _lib.build()
    sms = conv.sm_count(0)
    workdir = Path(tempfile.mkdtemp(prefix="bmm_probe_"))
    res = {"card": the_card, "before_csrc": str(csrc) if csrc else None, "models": {}}
    try:
        jobs = {}
        if csrc is not None:
            before_cuts = {k: v for k, v in BEFORE_CUTS.items()
                           if cuts and keep(k) and _applies(csrc, BEFORE_SRC, v)}
            jobs["before"] = (csrc, BEFORE_SRC, before_cuts)
        port_cuts = {k: v for k, v in PORT_CUTS.items()
                     if cuts and keep(k) and _applies(_lib.CSRC, SRC, v)}
        if port_cuts:
            jobs["port"] = (_lib.CSRC, SRC, port_cuts)
        libs = {key: build_variants(d, src, cs, workdir / key) for key, (d, src, cs) in jobs.items()}
        rng = np.random.default_rng(0)
        only = [a.split("=", 1)[1].split(",") for a in argv if a.startswith("--models=")]
        for model, calls in MODELS.items():
            if only and not any(x in model for x in only[0]):
                continue
            rows = []
            for kernel, what, make, reps in calls:
                raw = kernel == "qbmm_raw"
                a, b, kw = make(rng)
                A, B = mm._logical(a, b, kw.get("transpose_a", False), kw.get("transpose_b", False))
                n = B.shape[-1]
                if raw:
                    vec = [channel_vector(0, n, "cuda")]
                    wrapper = lambda a=a, b=b, kw=kw, plan=None: mm.qbmm_raw(  # noqa: E731
                        a, b, plan=plan, **kw)
                    want = mm.qbmm_raw_plain(a, b, **kw)
                else:
                    mu, sh = plan_requantize(0.002 * (0.5 + rng.random(n)), 1.0)
                    vec = [channel_vector(0, n, "cuda"), channel_vector(mu, n, "cuda"),
                           channel_vector(sh, n, "cuda")]
                    wrapper = lambda a=a, b=b, kw=kw, vec=vec, plan=None: mm.qbmm_rq(  # noqa: E731
                        a, b, *vec, plan=plan, **kw)
                    want = mm.qbmm_rq_plain(a, b, *vec, **kw)
                nbytes, ops = work(a, b, kw, raw)
                row = {"kernel": kernel, "call": what, "reps": reps,
                       "shape": f"{tuple(A.shape)} x {tuple(B.shape)}",
                       "plan": mm.launch_summary(kernel, a, b, **kw)
                       if hasattr(mm, "launch_summary") else "",
                       "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3}
                got = wrapper()
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"port {kernel} {model} {what} != plain"
                row["port"] = call_seconds(wrapper, "cuda") * 1e3
                plan = mm.bmm_plan(*_nbmkn(A, B), conv.sm_count(0))
                for name, path in libs.get("port", {}).items():
                    if name == "whole" or kernel not in VARIANTS.get(name, _BOTH):
                        continue
                    fn = wrapper
                    if name == "bn128":
                        if plan["path"] != "tiles":
                            continue
                        fn = lambda w=wrapper, p=dict(plan, bn=128): w(plan=p)  # noqa: E731
                    with entries_of(path, SRC), _bn128(name == "bn128"):
                        if name in VARIANTS:
                            got = fn()
                            torch.cuda.synchronize()
                            assert torch.equal(got, want), f"port_{name} {model} {what} != plain"
                        row[f"port_{name}"] = call_seconds(fn, "cuda") * 1e3
                for name, path in libs.get("before", {}).items():
                    run = before_launcher(path, kernel, sms)
                    fn = lambda run=run, a=a, b=b, kw=kw, vec=vec: run(a, b, kw, vec)  # noqa: E731
                    key = "before" if name == "whole" else f"before_{name}"
                    if name == "whole":
                        got = fn()
                        torch.cuda.synchronize()
                        assert torch.equal(got.reshape(want.shape), want), \
                            f"before {kernel} {model} {what} != plain"
                    row[key] = call_seconds(fn, "cuda") * 1e3
                if "--plans" in argv:
                    row["plans"] = {}
                    for plan in mm.bmm_plans(A.shape[-2]):
                        fn = lambda plan=plan, w=wrapper: w(plan=plan)  # noqa: E731
                        got = fn()
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), f"port {kernel} {model} {what} {plan}"
                        row["plans"][str(plan)] = call_seconds(fn, "cuda") * 1e3
                row["library"] = call_seconds(library(a, b, kw), "cuda") * 1e3
                rows.append(row)
                keys = [key for key in row if isinstance(row[key], float)]
                print(f"{model:40s} {kernel} {what:13s} x{reps:2d} {row['shape']:34s} "
                      + " ".join(f"{key} {row[key]:.4f}" for key in keys)
                      + f" [{row['plan']}]", flush=True)
                for plan, t in sorted(row.get("plans", {}).items(), key=lambda kv: kv[1]):
                    print(f"    {t:.4f} {plan}", flush=True)
                del a, b, want, got
                torch.cuda.empty_cache()
            keys = list(dict.fromkeys(key for r in rows for key in r if isinstance(r[key], float)))
            total = {key: sum(r[key] * r["reps"] for r in rows if key in r) for key in keys}
            print(f"{model:40s} per forward ({sum(r['reps'] for r in rows)} calls): "
                  + " ".join(f"{key} {v:.4f}" for key, v in total.items()), flush=True)
            res["models"][model] = {"calls": rows, "per_forward": total}
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
