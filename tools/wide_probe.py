"""The W8A16 products (`qgemm_wide`, `qconv_wide`: csrc/qconv_wide_hopper.cu;
`qdwconv_wide`: K5's int16 mode in csrc/qdwconv.cu) timed on one GPU at
every distinct int64 product that `chip_smoke.py` phases 20c-20e drive,
beside the yardsticks in the same process:

    python3 tools/wide_probe.py [--no-cuts | --cuts=A,B] [--plans] [--models=A,B]
                                [--gemm-parent DIR] [OUT_JSON]
    python3 tools/wide_probe.py --lone [OUT_JSON]
    python3 tools/wide_probe.py [--bmm] [--geometry] [OUT_JSON]

The calls (`models`): ResNet-50 W8A16 b8 224^2 (20c: 24 distinct products
of 54) and b1 224^2 (20d), their shapes read from the float graph; the 16x8
TFLite fixture (20e: 5 products, read from the fixture).  Inputs are
seeded: int16 activations with an eighth of them at each int16 extreme,
int8 weights, input zero point -3.  Per call, in turns (`port`, `planes`,
`library`, `planes_again`, `port_again`):

  * `port`: the entry the main path calls (`wide.wide_conv` /
    `wide.wide_dense`, which picks the kernel; `kernel` names it), held ==
    its float64 plain version first;
  * `planes`: the route this one replaced, a copy of it kept here as its
    yardstick (`planes_conv`, `planes_dense`): the int16 operand split into
    two int8 planes by torch passes, each plane through K4's or K5's raw
    mode (`qconv2d_flat`, `qmatmul_int8` of this tree) with its zero point
    folded, the two int32 results combined in int64; == plain first;
  * `library`: the float64 cuBLAS / cuDNN product of the same shapes (exact
    here; timed only, never served);
  * the kernel with parts cut out, by the compile-time switches at the top
    of `csrc/qconv_wide_hopper.cu`, each build a library of its own loaded
    into this process (gemm and conv calls; the outputs of a cut are wrong
    by design and not compared): `port_no_loads` (QW_LOADS 0: no operand
    copied), `port_no_mma` (QW_MMA 0), `port_no_epilogue` (QW_EPILOGUE 0:
    nothing stored), `port_empty` (QW_BODY 0: the blocks return as they
    start; the zeroing of a split's output kept);
  * the designs this one departs from, each == plain first:
    `port_smem` (QW_SPLIT_SMEM 1: the raw int16 tile copied into the ring by
    cp.async and split from shared memory by the thread that copied it,
    in place of the loads into registers one step ahead) and `port_staged`
    (QW_STORE_STAGED 1: the int64 tile staged in shared memory and stored
    as whole rows; where its shared memory fits the tile);
  * `--plans`: the kernel at every launch of `wide.wide_plans` (each tile,
    K split 1 to 16 ways), == plain first;
  * `bound`: max(bytes / 3.35 TB/s, ops / 1979 TOP/s), the bytes of the
    int16 input, the int8 weights and the int64 output, the operations two
    int8 products (one for the depthwise conv), as `chip_smoke.py work`
    counts them.

`--lone` times what one K step costs a lone block (one 64 x 64 or 128 x
128 tile of a GEMM of K = 64 S, unsplit: the grid is that one block, S 8
and 72), whole and with parts cut out (`LONE_CUTS`: the switches above,
alone and together, and two text cuts, `no_sync`: the step's proxy fence
and barrier, `no_split`: the byte permutes), per step.

`--bmm` and `--geometry` time, in one process, the calls of `chip_smoke.py`
phase 29 (`--bmm`: `qbmm_wide` at W8A16 BERT-base b4 s128's and b1 s128's
and ViT-B/16 b1 224^2's scores and contexts, q, k and v head-split views of
one projection each, the softmax output contiguous; `--geometry`:
`qconv_wide` at DeepLabV3-ResNet-50 b1 520^2's 11 dilated convs and
ResNeXt-50 32x4d b1 224^2's 16 grouped ones, their shapes read from the
float graphs, and `qdwconv_wide` at DeepLab-MobileNetV2's 10 atrous calls),
each == its float64 plain version first, then in turns `port`, `library`
(the float64 cuBLAS / cuDNN call, dilated and grouped as the call is),
`port_again`, and `plain` (the plain version, eager, CUDA events, as
`chip_smoke.py eager_ms` times it), beside `bound` (the bytes of the
int16 inputs, the int8 weights and the int64 output, or the int8
products: four a batched product (both operands' byte planes), two a
conv, one a depthwise conv, counting only a grouped conv's products within
its groups), summed per forward.

`--gemm-parent DIR` (a `csrc/` of the parent tree, e.g. a `git archive`)
then runs `tools/gemm_probe.py --parent DIR --no-cuts --k2` and `--raw
--parent DIR --no-cuts` (K1, K2 and K4's GEMM mode, this tree's libraries
and DIR's in turns) and times K5 at MobileNetV2's 17 depthwise calls (b8
requantize, b1 raw) with this tree's `qdwconv.cu` and DIR's in turns
(`k5`, `k5_parent`, `k5_again`, `k5_parent_again`): whether K1-K5 moved.
Times are CUDA events over CUDA-graph replays (`utils/timing.py
call_seconds`, warm L2), per call and summed per forward with each call's
repeats.  The card's name and power limit are printed; everything goes to
OUT_JSON (default wide_probe.json).
"""
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dw_probe import build_variants, calls as dw_calls, entries_of  # noqa: E402

SRC = "qconv_wide_hopper.cu"
DW_SRC = "qdwconv.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core peak, same source
IZP = -3
FIXTURE_16X8 = os.path.join(ROOT, "tests", "fixtures", "small_cnn_16x8.tflite")
CUTS = {
    "no_loads": [("#define QW_LOADS 1", "#define QW_LOADS 0")],
    "no_mma": [("#define QW_MMA 1", "#define QW_MMA 0")],
    "no_epilogue": [("#define QW_EPILOGUE 1", "#define QW_EPILOGUE 0")],
    "empty": [("#define QW_BODY 1", "#define QW_BODY 0")],
    # not cuts: the designs this one departs from (each gives the same integers)
    "smem": [("#define QW_SPLIT_SMEM 0", "#define QW_SPLIT_SMEM 1")],
    "staged": [("#define QW_STORE_STAGED 0", "#define QW_STORE_STAGED 1")],
}
VARIANTS = ("smem", "staged")
_NO_LOADS, _NO_MMA, _NO_EPI = CUTS["no_loads"], CUTS["no_mma"], CUTS["no_epilogue"]
_NO_SYNC = [("    fence_proxy_async();\n    __syncthreads();\n#if QW_MMA",
             "    __syncwarp();\n#if QW_MMA")]
LONE_CUTS = {"no_loads": _NO_LOADS, "no_mma": _NO_MMA, "no_loads_mma": _NO_LOADS + _NO_MMA,
             "no_loads_mma_epilogue": _NO_LOADS + _NO_MMA + _NO_EPI,
             "no_loads_mma_sync": _NO_LOADS + _NO_MMA + _NO_SYNC, "no_sync": _NO_SYNC,
             "no_split": [("      split_planes(v0, v1, hi, lo);", "      hi = v0;\n      lo = v1;")],
             "smem": CUTS["smem"]}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


# ---------------------------------------------------------------------------
# the calls
# ---------------------------------------------------------------------------

def _products(g) -> Counter:
    """(op, x shape, w shape, strides, padding, groups) of every conv and
    dense of graph g, with its count."""
    from tachikoma_tpu_torch.ops import nn as tnn

    out = Counter()
    for n in g.nodes:
        if n.op not in ("nn.conv2d", "qnn.conv2d", "nn.dense", "qnn.dense"):
            continue
        xs, ws = tuple(g[n.inputs[0]].shape), tuple(g[n.inputs[1]].shape)
        if n.op.endswith("conv2d"):
            out[("conv", xs, ws, tnn._pair(n.attrs.get("strides", (1, 1))),
                 tnn._pad4(n.attrs.get("padding", (0, 0, 0, 0))),
                 int(n.attrs.get("groups", 1)))] += 1
        else:
            out[("dense", (int(np.prod(xs[:-1])), xs[-1]), ws, None, None, 1)] += 1
    return out


def models(only) -> dict:
    from tachikoma_tpu_torch.frontend import from_tflite
    from tachikoma_tpu_torch.models.vision import resnet

    out = {}
    for label, batch in (("ResNet-50 W8A16 b8 224^2 (20c)", 8), ("ResNet-50 W8A16 b1 224^2 (20d)", 1)):
        if not only or any(s in label for s in only):
            out[label] = _products(resnet(50, batch_size=batch, image_size=224, seed=0))
    label = "16x8 TFLite fixture (20e)"
    if not only or any(s in label for s in only):
        out[label] = _products(from_tflite(FIXTURE_16X8))
    return out


def _i16(rng, shape):
    x = rng.integers(-2 ** 15, 2 ** 15, shape).astype(np.int16)
    flat = x.reshape(-1)
    flat[: flat.size // 8] = -2 ** 15
    flat[flat.size // 8: flat.size // 4] = 2 ** 15 - 1
    rng.shuffle(flat)
    return torch.from_numpy(x).cuda()


def _i8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).cuda()


# ---------------------------------------------------------------------------
# the yardsticks: the plane route and the float64 library call
# ---------------------------------------------------------------------------

def split_planes(x: torch.Tensor, izp: int):
    """((hi, zh), (lo - 128, zl - 128)): the int8 planes of int16 x and the
    zero point of each, x - izp = 256 (hi - zh) + ((lo - 128) - (zl - 128))."""
    zh, zl = int(izp) >> 8, (int(izp) & 255) - 128
    return ((x >> 8).to(torch.int8), zh), (((x & 255) - 128).to(torch.int8), zl)


def _combine(plane_fn, x, izp):
    (hi, zh), (lo, zl) = split_planes(x, izp)
    return plane_fn(hi, zh).to(torch.int64) * 256 + plane_fn(lo, zl).to(torch.int64)


def planes_conv(x, w, *, strides, padding, groups, izp):
    from tachikoma_tpu_torch.ops.kernels.conv import qconv2d_flat

    return _combine(lambda xp, zp: qconv2d_flat(xp, w, strides=strides, padding=padding,
                                                groups=groups, input_zero_point=zp), x, izp)


def planes_dense(x, w, *, izp):
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qmatmul_int8

    return _combine(lambda xp, zp: qmatmul_int8(xp, w, input_zero_point=zp), x, izp)


def library(kind, x, w, strides, padding, groups, dilation=(1, 1)):
    xd, wd = x.to(torch.float64), w.to(torch.float64)
    if kind == "dense":
        return lambda: xd @ wd
    pt, pl, pb, pr = padding
    xd = torch.nn.functional.pad(xd, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2).contiguous()
    wd = wd.permute(3, 2, 0, 1).contiguous()
    return lambda: torch.nn.functional.conv2d(xd, wd, stride=strides, dilation=dilation,
                                              groups=groups)


def work(kind, x, w, strides, padding, groups, dilation=(1, 1)) -> tuple[int, int]:
    """(bytes, operations) of one product, as chip_smoke.py work counts them."""
    from tachikoma_tpu_torch.ops.nn import conv2d_out_hw

    if kind == "dense":
        m, k = x.shape
        n = w.shape[1]
        return 2 * m * k + k * n + 8 * m * n, 2 * 2 * m * k * n
    oh, ow = conv2d_out_hw(x.shape[1], x.shape[2], w.shape[0], w.shape[1], strides, padding,
                           dilation)
    out = x.shape[0] * oh * ow * w.shape[3]
    products = 1 if groups > 1 and groups == x.shape[3] == w.shape[3] else 2
    return (2 * x.numel() + w.numel() + 8 * out,
            products * 2 * out * int(np.prod(w.shape[:3])))


def kernel_of(kind, ws, strides, padding, groups) -> str:
    if kind == "dense" or (ws[:2] == (1, 1) and strides == (1, 1) and not any(padding)
                           and groups == 1):
        return "qgemm_wide"
    return "qdwconv_wide" if groups > 1 else "qconv_wide"


def _with_plan(kind, x, w, strides, padding, plan):
    """The kernel itself at `plan` (a 1x1 stride-1 conv as its GEMM)."""
    from tachikoma_tpu_torch.ops.kernels import wide

    if kind == "dense":
        return lambda: wide.qgemm_wide(x, w, izp=IZP, plan=plan)
    if w.shape[:2] == (1, 1) and strides == (1, 1) and not any(padding):
        n, h, wd, cin = x.shape
        x2, w2 = x.reshape(n * h * wd, cin), w.reshape(cin, w.shape[3])
        return lambda: wide.qgemm_wide(x2, w2, izp=IZP, plan=plan, w_src=w)
    return lambda: wide.qconv_wide(x, w, strides=strides, padding=padding, izp=IZP, plan=plan)


# ---------------------------------------------------------------------------
# K1-K5 against the parent tree
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _dw_entries(path: Path):
    """K5's wrappers launch the entries of `path` that it has (a parent's
    build of qdwconv.cu has no tk_qdwconv_wide)."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    lib = ctypes.CDLL(str(path))
    saved = dict(_lib._entries)
    for fn_name, n_ptr in _lib.SOURCES[DW_SRC]:
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes = [ctypes.c_void_p] * (n_ptr + 2)
            fn.restype = ctypes.c_int
            _lib._entries[fn_name] = fn
    try:
        yield
    finally:
        _lib._entries.clear()
        _lib._entries.update(saved)


def parent_turns(parent: Path, workdir: Path, out_prefix: str) -> dict:
    """tools/gemm_probe.py's parent turns (K1, K2, K4's GEMM mode), then K5
    with this tree's and `parent`'s qdwconv.cu in turns."""
    from tachikoma_tpu_torch.ops.kernels import depthwise
    from tachikoma_tpu_torch.utils.timing import call_seconds

    res = {}
    for args, tag in ((["--k2"], "gemm"), (["--raw"], "gemm_raw")):
        path = f"{out_prefix}_{tag}.json"
        cmd = [sys.executable, os.path.join(ROOT, "tools", "gemm_probe.py"), *args, "--parent",
               str(parent), "--no-cuts", path]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(proc.stdout[-6000:], proc.stderr[-3000:], flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"gemm_probe {args} failed ({proc.returncode})")
        res[tag] = path
    parent_lib = build_variants(parent, DW_SRC, {}, workdir / "dw_parent")["whole"]
    rng = np.random.default_rng(0)
    rows, totals = [], Counter()
    for batch, mode in ((8, "rq"), (1, "raw")):
        for label, x, w, bias, mult, shift, s in dw_calls(batch, rng):
            kw = dict(strides=(s, s), padding=(1, 1, 1, 1))
            if mode == "rq":
                def fn(): return depthwise.qdwconv_rq(x, w, bias, mult, shift, **kw)
                want = depthwise.qdwconv_rq_plain(x, w, bias, mult, shift, **kw)
            else:
                def fn(): return depthwise.qdwconv_raw(x, w, bias, **kw)
                want = depthwise.qdwconv_raw_plain(x, w, bias, **kw)
            row = {"call": f"{mode} {label}"}
            for turn in ("k5", "k5_parent", "k5_again", "k5_parent_again"):
                ctx = _dw_entries(parent_lib) if "parent" in turn else contextlib.nullcontext()
                with ctx:
                    got = fn()
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), f"{turn} {mode} {label} != plain"
                    row[turn] = call_seconds(fn, "cuda") * 1e3
                totals[f"{mode} b{batch} {turn}"] += row[turn]
            rows.append(row)
            print(f"K5 {row['call']:34s} " + " ".join(f"{k} {row[k]:.4f}" for k in row
                                                      if k != "call"), flush=True)
    for key, v in totals.items():
        print(f"K5 per MobileNetV2 forward {key}: {v:.4f} ms", flush=True)
    res["k5"] = {"calls": rows, "per_forward": dict(totals)}
    return res


# ---------------------------------------------------------------------------
# phase 29's calls: the batched products and the dilated / grouped convs
# ---------------------------------------------------------------------------

# (B, S, H, D, layers) of each W8A16 transformer of chip_smoke.py phase 29
BMM_MODELS = {"BERT-base W8A16 b4 s128 (29a)": (4, 128, 12, 64, 12),
              "BERT-base W8A16 b1 s128 trace (29b)": (1, 128, 12, 64, 12),
              "ViT-B/16 W8A16 b1 224^2 (29c)": (1, 197, 12, 64, 12)}


def bmm_calls(rng) -> dict:
    """{model: [(label, a, b, transpose_b, repeats a forward)]}: each
    transformer's scores q . k^T and context p . v, q, k and v (B, H, S, D)
    views of (B, S, H, D) projections, the softmax output p contiguous."""
    out = {}
    for model, (b, s, h, d, layers) in BMM_MODELS.items():
        q, k, v = (_i16(rng, (b, s, h, d)).permute(0, 2, 1, 3) for _ in range(3))
        p = _i16(rng, (b, h, s, s))
        out[model] = [(f"scores {b * h}x ({s}, {d}) x ({d}, {s})", q, k, True, layers),
                      (f"context {b * h}x ({s}, {s}) x ({s}, {d})", p, v, False, layers)]
    return out


def geometry_calls() -> dict:
    """{model: Counter((x shape, w shape, strides, padding, dilation, groups))}:
    the dilated and grouped convs of DeepLabV3-ResNet-50 b1 520^2 and
    ResNeXt-50 32x4d b1 224^2 (read from their float graphs), and DeepLab-
    MobileNetV2's atrous depthwise calls (chip_smoke.py ATROUS_CALLS)."""
    from chip_smoke import ATROUS_CALLS, ATROUS_MAP, DEEPLAB_CLASSES, DEEPLAB_SIDE
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.frontend.torch_fx import from_torch
    from tachikoma_tpu_torch.models.onnx_deeplab import deeplabv3_onnx
    from tachikoma_tpu_torch.models.torch_resnet import resnext50_32x4d_torch
    from tachikoma_tpu_torch.ops import nn as tnn

    def convs(g):
        out = Counter()
        for n in g.nodes:
            if n.op != "nn.conv2d":
                continue
            dil, groups = tnn._pair(n.attrs.get("dilation", (1, 1))), int(n.attrs.get("groups", 1))
            ws = tuple(g[n.inputs[1]].shape)
            if (dil == (1, 1) or ws[:2] == (1, 1)) and groups == 1:
                continue
            out[(tuple(g[n.inputs[0]].shape), ws, tnn._pair(n.attrs.get("strides", (1, 1))),
                 tnn._pad4(n.attrs.get("padding", (0, 0, 0, 0))), dil, groups)] += 1
        return out

    atrous = Counter(((1, ATROUS_MAP, ATROUS_MAP, c), (3, 3, 1, c), (1, 1), (d,) * 4, (d, d), c)
                     for c, d in ATROUS_CALLS)
    return {f"DeepLabV3-ResNet-50 W8A16 b1 {DEEPLAB_SIDE}^2 (29d)":
            convs(from_onnx(deeplabv3_onnx(1, DEEPLAB_SIDE, DEEPLAB_CLASSES, seed=0))),
            "ResNeXt-50 32x4d W8A16 b1 224^2 (29e)":
            convs(from_torch(resnext50_32x4d_torch(seed=0), {"x": (1, 3, 224, 224)})),
            "DeepLab-MobileNetV2 atrous int16 (29f)": atrous}


def _turns(row, port, lib, plain) -> None:
    from chip_smoke import eager_ms
    from tachikoma_tpu_torch.utils.timing import call_seconds

    for key, fn in (("port", port), ("library", lib), ("port_again", port)):
        row[key] = call_seconds(fn, "cuda") * 1e3
    row["plain"] = eager_ms(plain)


def _summary(model: str, rows: list) -> dict:
    total = Counter()
    for r in rows:
        for k in ("port", "library", "port_again", "plain", "bound_ms"):
            total[k] += r[k] * r["reps"]
    calls = sum(r["reps"] for r in rows)
    print(f"{model} per forward ({calls} calls): " + " ".join(f"{k} {v:.4f}"
                                                              for k, v in total.items()),
          flush=True)
    return {"calls": rows, "per_forward": dict(total), "n_calls": calls}


def bmm_and_geometry(argv, out_path: str) -> int:
    """`--bmm` and `--geometry`: phase 29's calls, each == plain, timed in
    turns beside the float64 library call and the bound."""
    from tachikoma_tpu_torch.ops.kernels import _lib, wide

    the_card = card()
    print(the_card, flush=True)
    print(f"build {_lib.build()[0]:.1f} s", flush=True)
    res = {"card": the_card, "models": {}}
    rng = np.random.default_rng(0)
    if "--bmm" in argv:
        for model, calls in bmm_calls(rng).items():
            rows = []
            for label, a, b, tb, reps in calls:
                want = wide.qbmm_wide_plain(a, b, transpose_b=tb)
                got = wide.qbmm_wide(a, b, transpose_b=tb)
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"{model} {label} != plain"
                A, B = (a, b.transpose(-1, -2)) if tb else (a, b)
                nb, m, kk, n = A.shape[0] * A.shape[1], A.shape[2], A.shape[3], B.shape[3]
                nbytes, ops = 2 * (A.numel() + B.numel()) + 8 * nb * m * n, 4 * 2 * nb * m * kk * n
                Ad, Bd = A.to(torch.float64), B.to(torch.float64)
                row = {"kernel": "qbmm_wide", "shape": label, "reps": reps,
                       "plan": wide.bmm_wide_summary(a, b, transpose_b=tb),
                       "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3}
                _turns(row, lambda: wide.qbmm_wide(a, b, transpose_b=tb),
                       lambda: torch.matmul(Ad, Bd),
                       lambda: wide.qbmm_wide_plain(a, b, transpose_b=tb))
                rows.append(row)
                print(f"{model:36s} {label:34s} x{reps} {row['plan']:34s} "
                      + " ".join(f"{k} {row[k]:.4f}" for k in ("port", "library", "port_again",
                                                               "plain", "bound_ms")), flush=True)
            res["models"][model] = _summary(model, rows)
    if "--geometry" in argv:
        for model, products in geometry_calls().items():
            rows = []
            for (xs, ws, strides, padding, dilation, groups), reps in products.items():
                x, w = _i16(rng, xs), _i8(rng, ws)
                geo = dict(strides=strides, padding=padding, dilation=dilation, groups=groups,
                           izp=IZP)
                name = kernel_of("conv", ws, strides, padding, groups)
                if name == "qdwconv_wide" and not (groups == xs[3] == ws[3] and ws[2] == 1):
                    name = "qconv_wide"
                want = wide.wide_conv_plain(x, w, **geo)
                before = _lib.LAUNCHES[name]
                got = wide.wide_conv(x, w, **geo)
                torch.cuda.synchronize()
                assert _lib.LAUNCHES[name] == before + 1 and torch.equal(got, want), \
                    f"{model} {xs} x {ws} != plain"
                nbytes, ops = work("conv", x, w, strides, padding, groups, dilation)
                row = {"kernel": name, "reps": reps,
                       "shape": f"{xs} x {ws} s{strides[0]} d{dilation[0]} g{groups}",
                       "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3}
                _turns(row, lambda: wide.wide_conv(x, w, **geo),
                       library("conv", x, w, strides, padding, groups, dilation),
                       lambda: wide.wide_conv_plain(x, w, **geo))
                rows.append(row)
                print(f"{model:40s} {name:12s} x{reps} {row['shape']:56s} "
                      + " ".join(f"{k} {row[k]:.4f}" for k in ("port", "library", "port_again",
                                                               "plain", "bound_ms")), flush=True)
                del x, w, want, got
                torch.cuda.empty_cache()
            res["models"][model] = _summary(model, rows)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def lone(out_path: str) -> int:
    """A lone block's cost a K step, whole and cut apart (`--lone`)."""
    from tachikoma_tpu_torch.ops.kernels import _lib, wide
    from tachikoma_tpu_torch.utils.timing import call_seconds

    the_card = card()
    print(the_card, flush=True)
    _lib.build()
    workdir = Path(tempfile.mkdtemp(prefix="wide_probe_"))
    res = {"card": the_card, "lone": {}}
    try:
        libs = build_variants(_lib.CSRC, SRC, LONE_CUTS, workdir)
        rng = np.random.default_rng(0)
        for steps in (8, 72):
            for bm, bn in ((64, 64), (128, 128)):
                x, w = _i16(rng, (bm, 64 * steps)), _i8(rng, (64 * steps, bn))
                plan = dict(bm=bm, bn=bn, ks=1, kper=steps)
                want = wide.qgemm_wide_plain(x, w)

                def fn():
                    return wide.qgemm_wide(x, w, plan=plan)

                row = {}
                for name, path in libs.items():
                    with entries_of(path, SRC):
                        if name in ("whole", "smem"):
                            got = fn()
                            torch.cuda.synchronize()
                            assert torch.equal(got, want), f"lone {name} {bm}x{bn} != plain"
                        row[name] = call_seconds(fn, "cuda") * 1e6 / steps
                res["lone"][f"{bm}x{bn} K {64 * steps}"] = row
                print(f"lone {bm}x{bn} K {64 * steps} us a step: "
                      + " ".join(f"{k} {v:.3f}" for k, v in row.items()), flush=True)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import _lib, wide
    from tachikoma_tpu_torch.utils.timing import call_seconds

    argv = sys.argv[1:]
    parent = Path(argv[argv.index("--gemm-parent") + 1]) if "--gemm-parent" in argv else None
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--") and (i == 0 or argv[i - 1] != "--gemm-parent")]
    out_path = args[0] if args else "wide_probe.json"
    if "--lone" in argv:
        return lone(out_path)
    if "--bmm" in argv or "--geometry" in argv:
        return bmm_and_geometry(argv, out_path)
    named = [a.split("=", 1)[1].split(",") for a in argv if a.startswith("--cuts=")]
    keep = (lambda name: name in named[0]) if named else (lambda name: True)
    cuts = {k: v for k, v in CUTS.items() if "--no-cuts" not in argv and keep(k)}
    only = [a.split("=", 1)[1].split(",") for a in argv if a.startswith("--models=")]
    the_card = card()
    print(the_card, flush=True)
    print(f"build {_lib.build()[0]:.1f} s", flush=True)
    workdir = Path(tempfile.mkdtemp(prefix="wide_probe_"))
    res = {"card": the_card, "models": {}}
    try:
        libs = build_variants(_lib.CSRC, SRC, cuts, workdir / "port") if cuts else {}
        rng = np.random.default_rng(0)
        for model, products in models(only[0] if only else None).items():
            rows = []
            for (kind, xs, ws, strides, padding, groups), reps in products.items():
                x, w = _i16(rng, xs), _i8(rng, ws)
                if kind == "dense":
                    def port(): return wide.wide_dense(x, w, izp=IZP)
                    def planes(): return planes_dense(x, w, izp=IZP)
                    want = wide.wide_dense_plain(x, w, izp=IZP)
                else:
                    geo = dict(strides=strides, padding=padding, groups=groups, izp=IZP)
                    def port(): return wide.wide_conv(x, w, **geo)
                    def planes(): return planes_conv(x, w, **geo)
                    want = wide.wide_conv_plain(x, w, **geo)
                name = kernel_of(kind, ws, strides, padding, groups)
                nbytes, ops = work(kind, x, w, strides, padding, groups)
                row = {"kernel": name, "reps": reps,
                       "shape": f"{xs} x {ws}" + (f" s{strides[0]} p{padding}" if strides else ""),
                       "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3}
                for fn, what in ((port, "port"), (planes, "planes")):
                    got = fn()
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), f"{what} {model} {row['shape']} != plain"
                lib = library(kind, x, w, strides, padding, groups)
                for key, fn in (("port", port), ("planes", planes), ("library", lib),
                                ("planes_again", planes), ("port_again", port)):
                    row[key] = call_seconds(fn, "cuda") * 1e3
                if name != "qdwconv_wide":
                    for cut, path in libs.items():
                        if cut == "whole":
                            continue
                        with entries_of(path, SRC):
                            try:
                                if cut in VARIANTS:
                                    got = port()
                                    torch.cuda.synchronize()
                                    assert torch.equal(got, want), f"port_{cut} {row['shape']}"
                                row[f"port_{cut}"] = call_seconds(port, "cuda") * 1e3
                            except RuntimeError as e:  # a tile whose staged output does not fit
                                print(f"  port_{cut}: {str(e)[:80]}", flush=True)
                    if "--plans" in argv:
                        row["plans"] = {}
                        for plan in wide.wide_plans(int(np.prod(ws[:-1]))):
                            fn = _with_plan(kind, x, w, strides, padding, plan)
                            got = fn()
                            torch.cuda.synchronize()
                            assert torch.equal(got.reshape(want.shape), want), (row["shape"], plan)
                            row["plans"][str(plan)] = call_seconds(fn, "cuda") * 1e3
                rows.append(row)
                keys = [k for k in row if isinstance(row[k], float)]
                print(f"{model:32s} {name:12s} x{reps} {row['shape']:58s} "
                      + " ".join(f"{k} {row[k]:.4f}" for k in keys), flush=True)
                for plan, t in sorted(row.get("plans", {}).items(), key=lambda kv: kv[1])[:4]:
                    print(f"    {t:.4f} {plan}", flush=True)
                del x, w, want
                torch.cuda.empty_cache()
            keys = list(dict.fromkeys(k for r in rows for k in r if isinstance(r[k], float)))
            total = {k: sum(r[k] * r["reps"] for r in rows if k in r) for k in keys}
            by_kernel = {}
            for r in rows:
                for k in ("port", "planes", "library", "bound_ms"):
                    by_kernel.setdefault(r["kernel"], Counter())[k] += r[k] * r["reps"]
            print(f"{model} per forward ({sum(r['reps'] for r in rows)} products): "
                  + " ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)
            for kern, t in by_kernel.items():
                print(f"    {kern}: " + " ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
            res["models"][model] = {"calls": rows, "per_forward": total,
                                    "by_kernel": {k: dict(v) for k, v in by_kernel.items()}}
        if parent is not None:
            res["parent"] = parent_turns(parent, workdir,
                                         os.path.splitext(out_path)[0] + "_parent")
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
