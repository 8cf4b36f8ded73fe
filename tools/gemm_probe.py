"""K1 (qgemm_rq) timed on one GPU at every call it gets in the int8 b8 224^2
forwards of ResNet-50, MobileNetV2 and VGG-16, beside an earlier tree's K1
in the same process:

    python3 tools/gemm_probe.py [--csrc DIR] [--no-cuts] [--k2] [--plans] [OUT_JSON]

Each call is an (M, K) x (K, N) GEMM with the exact requantize epilogue
(M = batch * H * W for a 1x1 conv, the batch for a dense layer).  Per call:

  * `port`: the port's K1 (`ops/kernels/matmul_int8.py qgemm_rq`, the plan
    it picks; the weights packed once before timing, as a forward finds
    them), held == its plain version first;
  * `before` (with `--csrc DIR`): `qgemm_rq.cu` of DIR (a `git archive` of
    an earlier tree gives the design before this one), built into a library
    of its own and launched with that design's arguments
    (the weight (K, N) row-major, the tile (P_BM, P_BN) 64 x 64), == plain
    first; with the `qgemm.cuh` body of the first port it is also built
    with a part cut out (their outputs are wrong by design and are not
    compared): `no_epilogue` (the accumulator's low byte stored, no
    requantize), `no_a_loads` / `no_b_loads` (x or w not read: the tile is
    made from the step's position), `empty` (every block returns as it
    starts: the launch and the grid);
  * the port's K1 with its own parts cut out, on the calls of the path
    each cut belongs to: `port_skinny_no_epilogue` (the sum's low byte
    stored), `port_skinny_no_a_loads` (x not copied), `port_skinny_empty`
    (the blocks return as they start; `csrc/qgemm_rq.cu`'s QG_* switches),
    and `port_tiled_no_epilogue` (no requantize and no store),
    `port_tiled_no_requant` (the staged tile holds the sum plus the bias:
    no int64 arithmetic), `port_tiled_no_store` (the staged tile is not
    stored), `port_tiled_no_a_loads` / `port_tiled_no_b_loads` (x or the
    weights not copied), `port_tiled_no_mma` (no wgmma),
    `port_tiled_loop_only` (those four at once), `port_tiled_empty`
    (every block returns before its first item), `port_tiled_stages2` and
    `port_tiled_stages8` (a ring of two stages, less shared memory and more
    blocks an SM; of eight, seven steps in flight) in
    `csrc/igemm_hopper.cuh`, `csrc/epilogue_hopper.cuh` and
    `csrc/layouts_hopper.cuh`;
  * `--k2`: K2 (`conv.qconv_rq`) on the same GEMM as a 1x1 conv of (M, 1, 1,
    K) images, == plain first (whether K2's body serves K1's calls);
  * `--plans`: the port's K1 at each tile of `_lib.TILES` on the tiled path
    and at other splits of K, == plain first;
  * `library`: `torch._int_mm` where cuBLASLt takes the shape (M > 16, K
    and N multiples of 8), else an fp16 `torch.matmul` of the same shape
    (timed only, never served);
  * `bound`: max(bytes / 3.35 TB/s, 2 M K N / 1979 TOP/s), the bytes each
    input read once (x, w, 12 bytes of column constants) and the output
    written once.

Times are CUDA events over CUDA-graph replays (`utils/timing.py
call_seconds`, warm L2), per call and summed per forward with each call's
repeats.  The card's name and power limit are printed; everything goes to
OUT_JSON (default gemm_probe.json).
"""
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

SRC = "qgemm_rq.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core peak, same source


def _resnet50(b):
    """ResNet-50's K1 calls, as a fused forward makes them (chip_smoke.py
    phase 4): each bottleneck's first 1x1 conv, the stride-2 stages' first
    block's last 1x1 and downsample, and the classifier; the other blocks'
    last 1x1 (with the residual add) runs K3."""
    calls = [(b * 56 * 56, 64, 256, 1), (b * 56 * 56, 64, 64, 1), (b * 56 * 56, 256, 64, 2)]
    side, cin = 56, 256
    for width, blocks in ((128, 4), (256, 6), (512, 3)):
        out = 4 * width
        calls.append((b * side * side, cin, width, 1))          # first block's first 1x1
        side //= 2
        calls.append((b * side * side, width, out, 1))          # its last 1x1
        calls.append((b * side * side, cin, out, 1))            # its downsample
        calls.append((b * side * side, out, width, blocks - 1))  # the other blocks' first 1x1
        cin = out
    calls.append((b, 2048, 1000, 1))
    return calls


def _mobilenet_v2(b):
    """MobileNetV2 (width 1.0)'s K1 calls: every expand and project 1x1, the
    last 1x1 conv and the classifier."""
    calls = []
    side, cin = 112, 32
    for t, c, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)):
        for i in range(n):
            hidden = cin * t
            if t != 1:
                calls.append((b * side * side, cin, hidden, 1))
            if i == 0:
                side //= s
            calls.append((b * side * side, hidden, c, 1))
            cin = c
    calls.append((b * side * side, 320, 1280, 1))
    calls.append((b, 1280, 1000, 1))
    merged = {}
    for m, k, n, r in calls:
        merged[(m, k, n)] = merged.get((m, k, n), 0) + r
    return [(m, k, n, r) for (m, k, n), r in merged.items()]


def _vgg16(b):
    """VGG-16's three dense layers (tk.dense_rq)."""
    return [(b, 25088, 4096, 1), (b, 4096, 4096, 1), (b, 4096, 1000, 1)]


MODELS = {"ResNet-50": _resnet50, "MobileNetV2": _mobilenet_v2, "VGG-16": _vgg16}
BATCH = 8

# cuts of the first port's body (csrc/qgemm.cuh), applied to DIR's copy
BEFORE_CUTS = {
    "no_epilogue": [("qgemm.cuh",
                     "static_cast<int8_t*>(out)[o] = (int8_t)requantize_channel(acc[mt][nt][i], "
                     "col, rq);",
                     "static_cast<int8_t*>(out)[o] = (int8_t)acc[mt][nt][i];")],
    "no_a_loads": [("qgemm.cuh",
                    "for (int j = 0; j < A_PER; ++j) a_reg[j] = a_chunk(x, rows[j], k0 + a_c * 16, g);",
                    "for (int j = 0; j < A_PER; ++j) a_reg[j] = make_uint4(k0, j, 0, 0);")],
    "no_b_loads": [("qgemm.cuh",
                    "b_reg[j][r] = b_word(w, k0 + b_kq[j] * 4 + r, n0 + b_nq[j] * 4, g);",
                    "b_reg[j][r] = (uint32_t)(k0 + r);")],
    "empty": [("qgemm.cuh",
               "  const int tid = threadIdx.x;\n  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;",
               "  if (g.M >= 0) return;\n  const int tid = threadIdx.x;\n"
               "  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;")],
}
# cuts of the port's K1: the skinny path's switches at the top of
# csrc/qgemm_rq.cu, the tiled path's body in csrc/igemm_hopper.cuh (K1's
# build alone: K2's library is not rebuilt)
_IGH = "igemm_hopper.cuh"
PORT_CUTS = {
    "port_skinny_no_epilogue": [("#define QG_EPILOGUE 1", "#define QG_EPILOGUE 0")],
    "port_skinny_no_a_loads": [("#define QG_A_LOADS 1", "#define QG_A_LOADS 0")],
    "port_skinny_empty": [("#define QG_BODY 1", "#define QG_BODY 0")],
    "port_tiled_no_epilogue": [(_IGH, "      if (run_epilogue && g.o_vec) {", "      if (g.M < 0) {"),
                               (_IGH, "      } else if (run_epilogue) {",
                                "      } else if (g.M < 0) {")],
    "port_tiled_no_a_loads": [(_IGH, "            copy16(d, src, true);", "            ;"),
                              (_IGH, "            cp_async8(d, src, true);\n"
                               "            cp_async8(d + 8, ci + 8 < g.cin ? src + 8 : x, "
                               "ci + 8 < g.cin);", "            ;")],
    "port_tiled_empty": [(_IGH, "  const int kbeg = blockIdx.z * g.kper;\n",
                          "  if (n_items > 0) return;\n  const int kbeg = blockIdx.z * g.kper;\n")],
    "port_tiled_no_requant": [("epilogue_hopper.cuh", "requant_wide(acc[4 * jb + 2 * h], c0, e)",
                               "acc[4 * jb + 2 * h] + c0.x"),
                              ("epilogue_hopper.cuh", "requant_wide(acc[4 * jb + 2 * h + 1], c1, e)",
                               "acc[4 * jb + 2 * h + 1] + c1.x")],
    "port_tiled_no_store": [(_IGH, "        epi::store_tile16(o8, rtile, S::RS, BM, min(BN, g.cout - n0), dst);\n",
                             "")],
    "port_tiled_no_b_loads": [(_IGH, "    if (!g.b_res) stage_b(bs, kstep);", "")],
    "port_tiled_no_mma": [(_IGH, "      wgmma_acc<BN>(acc, gmma_desc(as + wg * 4096 + kk * 256, 128, 512),",
                           "      if (g.M < 0) wgmma_acc<BN>(acc, gmma_desc(as + wg * 4096 + kk * 256, "
                           "128, 512),")],
    "port_tiled_stages2": [(_IGH, "STAGES = MODE == RES ? 3 : 4;", "STAGES = MODE == RES ? 3 : 2;")],
    # no epilogue, copies or wgmma: the ring's waits, barriers and fences alone
    "port_tiled_loop_only": [],
    "port_tiled_stages8": [(_IGH, "STAGES = MODE == RES ? 3 : 4;", "STAGES = MODE == RES ? 3 : 8;"),
                           ("layouts_hopper.cuh", "  if (n >= 2)\n    cp_async_wait2();",
                            "  if (n >= 6)\n    asm volatile(\"cp.async.wait_group 6;\" ::: \"memory\");\n"
                            "  else if (n >= 4)\n    asm volatile(\"cp.async.wait_group 4;\" ::: "
                            "\"memory\");\n  else if (n >= 2)\n    cp_async_wait2();")],
}
PORT_CUTS["port_tiled_loop_only"] = (PORT_CUTS["port_tiled_no_epilogue"]
                                     + PORT_CUTS["port_tiled_no_a_loads"]
                                     + PORT_CUTS["port_tiled_no_b_loads"]
                                     + PORT_CUTS["port_tiled_no_mma"])


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def bound_ms(m, k, n) -> float:
    nbytes = m * k + k * n + m * n + 12 * n
    return max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS_PER_S) * 1e3


def before_launcher(lib_path: Path):
    """fn(x, w, bias, mult, shift, out) launching the earlier design's
    tk_qgemm_rq from `lib_path` as its wrapper did (w (K, N), 64 x 64)."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    fn = ctypes.CDLL(str(lib_path)).tk_qgemm_rq
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int

    def run(x, w, bias, mult, shift, out):
        m, k = x.shape
        n = w.shape[1]
        p = dict(n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=n, oh=1, ow=1, sh=1, sw=1, qmin=-128,
                 qmax=127, a_vec=int(k % 16 == 0), b_vec=int(n % 4 == 0), bm=64, bn=64)
        arr = (ctypes.c_int32 * len(_lib.PARAMS))(*(int(p.get(key, 0)) for key in _lib.PARAMS))
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), bias.data_ptr(), mult.data_ptr(),
                shift.data_ptr(), ctypes.addressof(arr), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"tk_qgemm_rq (before): CUDA error {rc}")
        return out

    return run


def library(x, w):
    m, k = x.shape
    n = w.shape[1]
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        try:
            torch._int_mm(x, w)
            return lambda: torch._int_mm(x, w)
        except RuntimeError:
            pass
    x16, w16 = x.half(), w.half()
    return lambda: x16 @ w16


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import _lib, conv, matmul_int8 as mm
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize
    from tachikoma_tpu_torch.utils.timing import call_seconds

    argv = sys.argv[1:]
    csrc = Path(argv[argv.index("--csrc") + 1]) if "--csrc" in argv else None
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--") and (i == 0 or argv[i - 1] != "--csrc")]
    out_path = args[0] if args else "gemm_probe.json"
    cuts = "--no-cuts" not in argv
    the_card = card()
    print(the_card, flush=True)
    _lib.build()
    workdir = Path(tempfile.mkdtemp(prefix="gemm_probe_"))
    res = {"card": the_card, "before_csrc": str(csrc) if csrc else None, "models": {}}
    try:
        before = {}
        if csrc is not None:
            before_text = (csrc / "qgemm.cuh").read_text()
            before_cuts = {k: v for k, v in BEFORE_CUTS.items()
                           if cuts and all(before_text.count(old) == 1 for _, old, _ in v)}
            before = build_variants(csrc, SRC, before_cuts, workdir / "before")
        port_text = (_lib.CSRC / SRC).read_text()
        port_cuts = {k: v for k, v in PORT_CUTS.items()
                     if cuts and all((_lib.CSRC / r[0]).read_text().count(r[1]) == 1
                                     if len(r) == 3 else port_text.count(r[0]) == 1 for r in v)}
        port = build_variants(_lib.CSRC, SRC, port_cuts, workdir / "port")
        launchers = {f"before{'' if k == 'whole' else '_' + k}": before_launcher(p)
                     for k, p in before.items()}
        rng = np.random.default_rng(0)
        for model, make in MODELS.items():
            rows = []
            for m, k, n, reps in make(BATCH):
                x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).cuda()
                w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).cuda()
                bias = torch.from_numpy(rng.integers(-5000, 5000, n).astype(np.int32)).cuda()
                mu, sh = plan_requantize(0.002 * (0.5 + rng.random(n)), 1.0)
                ops = (x, w, bias, channel_vector(mu, n, "cuda"), channel_vector(sh, n, "cuda"))
                want = mm.qgemm_rq_plain(*ops)
                row = {"m": m, "k": k, "n": n, "reps": reps, "bound_ms": bound_ms(m, k, n)}
                row["plan"] = str(mm.gemm_plan(m, k, n, sms=conv.sm_count(0)))

                def port_fn(ops=ops):
                    return mm.qgemm_rq(*ops)

                got = port_fn()
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"port K1 != plain at {m}x{k}x{n}"
                row["port"] = call_seconds(port_fn, "cuda") * 1e3
                skinny = mm.gemm_plan(m, k, n, sms=conv.sm_count(0))["path"] == "skinny"
                for name, lib in port.items():
                    if name == "whole" or ("skinny" in name) != skinny:
                        continue
                    with entries_of(lib, SRC):
                        row[name] = call_seconds(port_fn, "cuda") * 1e3
                out = torch.empty((m, n), dtype=torch.int8, device="cuda")
                for name, run in launchers.items():
                    def fn(run=run, ops=ops, out=out):
                        return run(*ops, out)
                    if name == "before":
                        got = fn()
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), f"before K1 != plain at {m}x{k}x{n}"
                    row[name] = call_seconds(fn, "cuda") * 1e3
                if "--k2" in argv:
                    x4, w4 = x.reshape(m, 1, 1, k), w.reshape(1, 1, k, n)

                    def k2(x4=x4, w4=w4, ops=ops):
                        return conv.qconv_rq(x4, w4, *ops[2:])
                    got = k2()
                    torch.cuda.synchronize()
                    assert torch.equal(got.reshape(m, n), want), f"K2 != plain at {m}x{k}x{n}"
                    row["k2_1x1"] = call_seconds(k2, "cuda") * 1e3
                if "--plans" in argv:
                    row["plans"] = {}
                    for p in mm.gemm_plans(m, k, n, sms=conv.sm_count(0)):
                        def fp(ops=ops, p=p):
                            return mm.qgemm_rq(*ops, plan=p)
                        got = fp()
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), f"K1 {p} != plain at {m}x{k}x{n}"
                        row["plans"][str(p)] = call_seconds(fp, "cuda") * 1e3
                row["library"] = call_seconds(library(x, w), "cuda") * 1e3
                rows.append(row)
                keys = [key for key in row if isinstance(row[key], float)]
                print(f"{model:12s} M={m:6d} K={k:5d} N={n:5d} x{reps} "
                      + " ".join(f"{key} {row[key]:.4f}" for key in keys)
                      + (f" [{row['plan']}]" if "plan" in row else ""), flush=True)
                if "plans" in row:
                    for p, t in sorted(row["plans"].items(), key=lambda kv: kv[1]):
                        print(f"    {t:.4f} {p}", flush=True)
            # a cut of one path counts the other path's calls whole
            keys = list(dict.fromkeys(key for r in rows for key in r if isinstance(r[key], float)))
            total = {key: sum(r.get(key, r["port"]) * r["reps"] for r in rows) for key in keys}
            print(f"{model:12s} per forward ({sum(r['reps'] for r in rows)} calls): "
                  + " ".join(f"{key} {v:.4f}" for key, v in total.items()), flush=True)
            res["models"][model] = {"calls": rows, "per_forward": total}
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
