"""K1 (qgemm_rq) timed on one GPU at every call it gets in the int8 b8 224^2
forwards of ResNet-50, MobileNetV2 and VGG-16, the int8 GPT-2 small decode
step and the int8 LSTM b1 seq 16 (chip_smoke.py phases 18e and 19h: M = 1,
the skinny path), beside an earlier tree's K1 in the same process; with `--raw`, K4's GEMM mode (qgemm_raw) at every call
of the unfused b1 224^2 forwards of ResNet-50 (37) and MobileNetV2 (35),
beside an earlier tree's K4:

    python3 tools/gemm_probe.py [--csrc DIR] [--parent DIR] [--no-cuts] [--k2] [--plans] [OUT_JSON]
    python3 tools/gemm_probe.py --raw [--csrc DIR] [--parent DIR] [--no-cuts] [--plans] [OUT_JSON]

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
  * `--parent DIR` (a `csrc/` of the same design's C interface, e.g. a `git
    archive` of the parent tree, or of the one before the entries took a
    weight zero point: the port's null `kzp` pointer is then not passed):
    the port's own wrapper launching DIR's
    `qgemm_rq.cu` entries (`parent`, == plain first), timed in turns with
    its own (`port`, `parent`, `port_again`, `parent_again`); with `--k2`
    also K2 (`qconv_rq`) at ResNet-50 b8's eight 3x3 / 7x7 calls
    (tools/conv_probe.py K2_CALLS), its own and DIR's
    `qconv_igemm_hopper.cu` in turns: whether a change to the shared body
    moved K1, K2 or K4;
  * `--k2`: K2 (`conv.qconv_rq`) on the same GEMM as a 1x1 conv of (M, 1, 1,
    K) images, == plain first (whether K2's body serves K1's calls);
  * `--plans`: the port's K1 at every launch of `gemm_plans` and, at the
    default tile of the tiled path, at the splits 1, 2, 3, 4, 6 and 8 of K
    that cover it, == plain first;
  * `library`: `torch._int_mm` where cuBLASLt takes the shape (M > 16, K
    and N multiples of 8), else an fp16 `torch.matmul` of the same shape
    (timed only, never served);
  * `bound`: max(bytes / 3.35 TB/s, 2 M K N / 1979 TOP/s), the bytes each
    input read once (x, w, 12 bytes of column constants) and the output
    written once.

With `--raw` each call is x (M, K) @ w (K, N) + bias (extreme values, so
that the sums wrap), int32 out, and the same measurements are made of K4:
`port` (`qgemm_raw`, == `qgemm_raw_plain` first), `before` (with `--csrc
DIR`: `qgemm_raw.cu` of DIR on its `qgemm.cuh` body, launched with that
design's arguments, the weight (K, N) row-major, == plain first) and
`before_empty`; the port cut apart: `port_tiled_empty` /
`port_skinny_empty` (the zeroing of a split's output kept),
`port_tiled_raw_no_epilogue` / `port_skinny_no_epilogue` (no store),
`port_tiled_raw_no_bias` (the bias not read), the tiled path's copies, its
`wgmma`s, or all of those and the store (`port_tiled_raw_loop_only`), its
ring at 2 or 8 stages, the skinny path's copies of x; `--plans` as above;
`library` as above (the bias add not included); `bound`: the bytes of x, w,
the bias and the int32 output over 3.35 TB/s, or the operations over the
int8 peak.

Times are CUDA events over CUDA-graph replays (`utils/timing.py
call_seconds`, warm L2), per call and summed per forward with each call's
repeats.  The card's name and power limit are printed; everything goes to
OUT_JSON (default gemm_probe.json).
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


def _gpt2_decode(b):
    """The int8 GPT-2 small decode step's 36 tk.dense_rq calls (chip_smoke.py
    phase 18e), one token of one sequence: M = 1 whatever `b`."""
    return [(1, 768, 768, 12), (1, 768, 3072, 12), (1, 3072, 768, 12)]


def _lstm(b):
    """The int8 LSTM b1 seq 16's 32 calls (chip_smoke.py phase 19h): the
    input and recurrent products of each step and the head, M = 1 whatever
    `b`."""
    return [(1, 64, 512, 16), (1, 128, 512, 15), (1, 128, 10, 1)]


def _resnet50_unfused(b):
    """ResNet-50's K4 GEMM calls in an unfused forward (chip_smoke.py phase
    7): every 1x1 conv (each bottleneck's first and last, the four
    downsamples) and the classifier."""
    calls = [(b * 56 * 56, 64, 64, 1), (b * 56 * 56, 64, 256, 4), (b * 56 * 56, 256, 64, 2)]
    side, cin = 56, 256
    for width, blocks in ((128, 4), (256, 6), (512, 3)):
        out = 4 * width
        calls.append((b * side * side, cin, width, 1))           # first block's first 1x1
        side //= 2
        calls.append((b * side * side, width, out, blocks))      # every block's last 1x1
        calls.append((b * side * side, cin, out, 1))             # the downsample
        calls.append((b * side * side, out, width, blocks - 1))  # the other blocks' first 1x1
        cin = out
    calls.append((b, 2048, 1000, 1))
    return calls


MODELS = {"ResNet-50": _resnet50, "MobileNetV2": _mobilenet_v2, "VGG-16": _vgg16,
          "GPT-2 decode": _gpt2_decode, "LSTM": _lstm}
# K4's GEMM mode: the unfused forwards of the trace path (chip_smoke.py
# phases 7 and 10a); MobileNetV2 unfused makes K1's fused calls
RAW_MODELS = {"ResNet-50": _resnet50_unfused, "MobileNetV2": _mobilenet_v2}
SPLITS = (1, 2, 3, 4, 6, 8)  # --plans: splits of K tried at the default tile

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
# K4's tiled path without its epilogue (the RAW branch of igemm_hopper.cuh)
PORT_CUTS["port_tiled_raw_no_epilogue"] = [
    (_IGH, "    } else {\n      int32_t* const o32 = static_cast<int32_t*>(out);",
     "    } else if (g.M < 0) {\n      int32_t* const o32 = static_cast<int32_t*>(out);")]
PORT_CUTS["port_tiled_raw_no_bias"] = [
    (_IGH, "        const int32_t b0 = colb[cl], b1 = colb[cl + 1];",
     "        const int32_t b0 = 0, b1 = 0;")]
RQ_CUTS = ("port_skinny_no_epilogue", "port_skinny_no_a_loads", "port_skinny_empty",
           "port_tiled_no_epilogue", "port_tiled_no_requant", "port_tiled_no_store",
           "port_tiled_no_a_loads", "port_tiled_no_b_loads", "port_tiled_no_mma",
           "port_tiled_loop_only", "port_tiled_empty", "port_tiled_stages2",
           "port_tiled_stages8")
RAW_CUTS = ("port_tiled_empty", "port_skinny_empty", "port_tiled_raw_no_epilogue",
            "port_skinny_no_epilogue", "port_tiled_raw_no_bias", "port_tiled_no_a_loads",
            "port_tiled_no_b_loads", "port_tiled_no_mma", "port_tiled_raw_loop_only",
            "port_tiled_stages2", "port_tiled_stages8", "port_skinny_no_a_loads")
PORT_CUTS["port_tiled_loop_only"] = (PORT_CUTS["port_tiled_no_epilogue"]
                                     + PORT_CUTS["port_tiled_no_a_loads"]
                                     + PORT_CUTS["port_tiled_no_b_loads"]
                                     + PORT_CUTS["port_tiled_no_mma"])
PORT_CUTS["port_tiled_raw_loop_only"] = (PORT_CUTS["port_tiled_raw_no_epilogue"]
                                         + PORT_CUTS["port_tiled_no_a_loads"]
                                         + PORT_CUTS["port_tiled_no_b_loads"]
                                         + PORT_CUTS["port_tiled_no_mma"])


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def bound_ms(m, k, n, raw=False) -> float:
    nbytes = m * k + k * n + (4 * m * n + 4 * n if raw else m * n + 12 * n)
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


def before_raw_launcher(lib_path: Path):
    """fn(x, w, bias, out) launching the earlier design's tk_qgemm_raw from
    `lib_path` as its wrapper did (w (K, N) row-major, 64 x 64)."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    fn = ctypes.CDLL(str(lib_path)).tk_qgemm_raw
    fn.argtypes = [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int

    def run(x, w, bias, out):
        m, k = x.shape
        n = w.shape[1]
        p = dict(n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=n, oh=1, ow=1, sh=1, sw=1,
                 a_vec=int(k % 16 == 0), b_vec=int(n % 4 == 0))
        arr = (ctypes.c_int32 * len(_lib.PARAMS))(*(int(p.get(key, 0)) for key in _lib.PARAMS))
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), bias.data_ptr(), ctypes.addressof(arr),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"tk_qgemm_raw (before): CUDA error {rc}")
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


def time_checked(fn, want, what) -> float:
    """fn() == want, then its device ms (CUDA-graph replays)."""
    from tachikoma_tpu_torch.utils.timing import call_seconds

    got = fn()
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{what} != plain"
    return call_seconds(fn, "cuda") * 1e3


def _xw(rng, m, k, n):
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).cuda()
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).cuda()
    return x, w


def _rq_operands(rng, m, k, n):
    """K1's (x, w, bias, multiplier, shift) at production-like scales."""
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize

    x, w = _xw(rng, m, k, n)
    bias = torch.from_numpy(rng.integers(-5000, 5000, n).astype(np.int32)).cuda()
    mu, sh = plan_requantize(0.002 * (0.5 + rng.random(n)), 1.0)
    return x, w, bias, channel_vector(mu, n, "cuda"), channel_vector(sh, n, "cuda")


def _raw_operands(rng, m, k, n):
    """K4's (x, w, bias), the bias extreme so that the sums wrap."""
    x, w = _xw(rng, m, k, n)
    bias = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                            .astype(np.int32)).cuda()
    return x, w, bias


# what --raw changes: the calls, the kernel (and its plain version
# `<kernel>_plain`), its operands and output, the earlier tree's source,
# launcher and cuts, the port's cuts
MODES = {
    False: dict(models=MODELS, batch=8, kernel="qgemm_rq", operands=_rq_operands,
                out_dtype=torch.int8, before_src=SRC, launcher=before_launcher,
                before_cuts=tuple(BEFORE_CUTS), port_cuts=RQ_CUTS),
    True: dict(models=RAW_MODELS, batch=1, kernel="qgemm_raw", operands=_raw_operands,
               out_dtype=torch.int32, before_src="qgemm_raw.cu", launcher=before_raw_launcher,
               before_cuts=("empty",), port_cuts=RAW_CUTS),
}


def _applies(csrc: Path, src: str, cut) -> bool:
    """Whether every replacement of a cut finds its text once in csrc."""
    return all((csrc / (r[0] if len(r) == 3 else src)).read_text().count(r[-2]) == 1
               for r in cut)


def _signature(text: str, fn_name: str) -> str:
    i = text.index(f'extern "C" int {fn_name}(')
    return text[i:text.index("{", i)]


@contextlib.contextmanager
def parent_entries(lib_path: Path, parent: Path, src: str):
    """entries_of(lib_path, src) for a build of DIR's `src`; an entry whose
    C signature there takes no `kzp` while the port's does (the interface
    before the weight zero point, the pointer before `p`) gets the port's
    calls with that pointer dropped, which must be null."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    theirs, ours = (parent / src).read_text(), (_lib.CSRC / src).read_text()
    with entries_of(lib_path, src):
        for fn_name, n_ptr in _lib.SOURCES[src]:
            if "kzp" in _signature(theirs, fn_name) or "kzp" not in _signature(ours, fn_name):
                continue
            fn = _lib._entries[fn_name]
            fn.argtypes = [ctypes.c_void_p] * (n_ptr + 1)

            def call(*args, fn=fn, k=n_ptr - 1):
                assert args[k] is None, "a weight zero point reached an entry without one"
                return fn(*args[:k], *args[k + 1:])
            _lib._entries[fn_name] = call
        yield


def k2_turns(parent_lib: Path, parent: Path, rng) -> dict:
    """K2 at ResNet-50 b8's 3x3 / 7x7 calls, the port's library and
    `parent_lib` (a build of another qconv_igemm_hopper.cu) in turns, each
    == plain first; ms a call and summed a forward."""
    from conv_probe import K2_CALLS
    from tachikoma_tpu_torch.ops.kernels import conv
    from tachikoma_tpu_torch.utils.timing import call_seconds

    src = "qconv_igemm_hopper.cu"
    rows = []
    for shape, k, stride, pad, cout in K2_CALLS["ResNet-50"]:
        x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-127, 128, (k, k, shape[3], cout)).astype(np.int8)).cuda()
        _, _, bias, mult, shift = _rq_operands(rng, 1, 1, cout)
        kw = dict(strides=(stride, stride), padding=(pad,) * 4)
        want = conv.qconv_rq_plain(x, w, bias, mult, shift, **kw)

        def fn(x=x, w=w, bias=bias, mult=mult, shift=shift, kw=kw):
            return conv.qconv_rq(x, w, bias, mult, shift, **kw)

        label = f"{'x'.join(map(str, shape))} k{k} s{stride} -> {cout}"
        row = {"call": label, "port": time_checked(fn, want, f"K2 {label}")}
        with parent_entries(parent_lib, parent, src):
            row["parent"] = time_checked(fn, want, f"K2 (parent) {label}")
        row["port_again"] = call_seconds(fn, "cuda") * 1e3
        with parent_entries(parent_lib, parent, src):
            row["parent_again"] = call_seconds(fn, "cuda") * 1e3
        rows.append(row)
        print(f"K2 {label:34s} " + " ".join(f"{key} {v:.4f}" for key, v in row.items()
                                            if key != "call"), flush=True)
    total = {key: sum(r[key] for r in rows) for key in ("port", "parent", "port_again",
                                                         "parent_again")}
    print("K2 ResNet-50 b8 per forward: " + " ".join(f"{key} {v:.4f}" for key, v in total.items()),
          flush=True)
    return {"calls": rows, "per_forward": total}


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import _lib, conv, matmul_int8 as mm
    from tachikoma_tpu_torch.utils.timing import call_seconds

    argv = sys.argv[1:]
    csrc = Path(argv[argv.index("--csrc") + 1]) if "--csrc" in argv else None
    parent = Path(argv[argv.index("--parent") + 1]) if "--parent" in argv else None
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--") and (i == 0 or argv[i - 1] not in ("--csrc", "--parent"))]
    out_path = args[0] if args else "gemm_probe.json"
    cuts = "--no-cuts" not in argv
    raw = "--raw" in argv
    mode = MODES[raw]
    kernel = mode["kernel"]
    wrapper, plain = getattr(mm, kernel), getattr(mm, kernel + "_plain")
    the_card = card()
    print(the_card, flush=True)
    _lib.build()
    workdir = Path(tempfile.mkdtemp(prefix="gemm_probe_"))
    res = {"card": the_card, "before_csrc": str(csrc) if csrc else None, "models": {}}
    sms = conv.sm_count(0)
    try:
        before = {}
        if csrc is not None:
            before_cuts = {k: BEFORE_CUTS[k] for k in mode["before_cuts"]
                           if cuts and _applies(csrc, mode["before_src"], BEFORE_CUTS[k])}
            before = build_variants(csrc, mode["before_src"], before_cuts, workdir / "before")
        port_cuts = {k: PORT_CUTS[k] for k in mode["port_cuts"]
                     if cuts and _applies(_lib.CSRC, SRC, PORT_CUTS[k])}
        port = build_variants(_lib.CSRC, SRC, port_cuts, workdir / "port")
        parent_libs = {src: build_variants(parent, src, {}, workdir / f"parent_{Path(src).stem}")
                       ["whole"] for src in (SRC, "qconv_igemm_hopper.cu")} if parent else {}
        launchers = {f"before{'' if k == 'whole' else '_' + k}": mode["launcher"](p)
                     for k, p in before.items()}
        rng = np.random.default_rng(0)
        for model, make in mode["models"].items():
            rows = []
            for m, k, n, reps in make(mode["batch"]):
                ops = mode["operands"](rng, m, k, n)
                x, w = ops[0], ops[1]
                want = plain(*ops)
                plan = mm.gemm_plan(m, k, n, sms=sms)
                row = {"m": m, "k": k, "n": n, "reps": reps, "bound_ms": bound_ms(m, k, n, raw),
                       "plan": str(plan)}

                def port_fn(ops=ops):
                    return wrapper(*ops)

                row["port"] = time_checked(port_fn, want, f"port {kernel} {m}x{k}x{n}")
                if parent_libs:  # in turns: port, parent, port, parent
                    with parent_entries(parent_libs[SRC], parent, SRC):
                        row["parent"] = time_checked(port_fn, want, f"parent {kernel} {m}x{k}x{n}")
                    row["port_again"] = call_seconds(port_fn, "cuda") * 1e3
                    with parent_entries(parent_libs[SRC], parent, SRC):
                        row["parent_again"] = call_seconds(port_fn, "cuda") * 1e3
                for name, lib in port.items():
                    if name == "whole" or ("skinny" in name) != (plan["path"] == "skinny"):
                        continue
                    with entries_of(lib, SRC):
                        row[name] = call_seconds(port_fn, "cuda") * 1e3
                out = torch.empty((m, n), dtype=mode["out_dtype"], device="cuda")
                for name, run in launchers.items():
                    def fn(run=run, ops=ops, out=out):
                        return run(*ops, out)
                    row[name] = (time_checked(fn, want, f"before {kernel} {m}x{k}x{n}")
                                 if name == "before" else call_seconds(fn, "cuda") * 1e3)
                if "--k2" in argv and not raw:
                    x4, w4 = x.reshape(m, 1, 1, k), w.reshape(1, 1, k, n)
                    row["k2_1x1"] = time_checked(
                        lambda x4=x4, w4=w4, ops=ops: conv.qconv_rq(x4, w4, *ops[2:]).reshape(m, n),
                        want, f"K2 {m}x{k}x{n}")
                if "--plans" in argv:
                    steps = -(-k // mm.KSTEP)
                    plans = mm.gemm_plans(m, k, n, sms)
                    if plan["path"] == "tiled":
                        for ks in SPLITS:
                            kper = -(-steps // min(ks, steps))
                            plans.append(dict(plan, ks=-(-steps // kper), kper=kper))
                    row["plans"] = {}
                    for p in plans:
                        if str(p) not in row["plans"]:
                            row["plans"][str(p)] = time_checked(
                                lambda ops=ops, p=p: wrapper(*ops, plan=p), want,
                                f"{kernel} {p} at {m}x{k}x{n}")
                row["library"] = call_seconds(library(x, w), "cuda") * 1e3
                rows.append(row)
                keys = [key for key in row if isinstance(row[key], float)]
                print(f"{model:12s} M={m:6d} K={k:5d} N={n:5d} x{reps} "
                      + " ".join(f"{key} {row[key]:.4f}" for key in keys)
                      + f" [{row['plan']}]", flush=True)
                for p, t in sorted(row.get("plans", {}).items(), key=lambda kv: kv[1]):
                    print(f"    {t:.4f} {p}", flush=True)
            # a cut of one path counts the other path's calls whole
            keys = list(dict.fromkeys(key for r in rows for key in r if isinstance(r[key], float)))
            total = {key: sum(r.get(key, r["port"]) * r["reps"] for r in rows) for key in keys}
            print(f"{model:12s} per forward ({sum(r['reps'] for r in rows)} calls): "
                  + " ".join(f"{key} {v:.4f}" for key, v in total.items()), flush=True)
            res["models"][model] = {"calls": rows, "per_forward": total}
        if parent_libs and "--k2" in argv and not raw:
            res["k2_parent"] = k2_turns(parent_libs["qconv_igemm_hopper.cu"], parent, rng)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
