"""K5 (qdwconv_rq, qdwconv_raw) timed on one GPU at the 17 depthwise convs of
MobileNetV2 224^2, at batch 8 and batch 1, whole and with parts cut out:

    python3 tools/dw_probe.py [--design NAME] [--csrc DIR] [--plans] [OUT_JSON]
    python3 tools/dw_probe.py --k12 [--k12-csrc DIR] [OUT_JSON]

Every variant is a build of `qdwconv.cu` (from DIR, default the package's
`csrc/`) with a part cut out, loaded beside the others into this one process
(each library keeps its launchers' statics to itself: `_lib.NVCC_FLAGS` has
`-fno-gnu-unique`) and launched through the port's own wrappers:

  * whole: the kernel as it is; every call is held == its plain version
    before it is timed;
  * no_epilogue: the accumulator stored as it is (no requantize, no bias);
  * no_loads: the input image is not read (the taps use a value made from
    their position);
  * empty: the kernel returns as it starts (the launch and the grid alone);
  * `--plans`: the whole build at every tile that fits, at each distinct
    call (requantize mode at b8, raw mode at b1), == plain first.

With `--k12`, the probe times K12 (`conv_direct.qdwconv_direct`, which runs
K5's body with rq_izp 0) beside K5's requantize mode at the 17 b8 calls,
call by call in turns, each == its plain version first; with `--k12-csrc
DIR` also the K12 of an earlier tree (`qconv_direct.cu` of DIR, its own
kernel: a thread per pixel x 4 channels, 64 channels a block, the output
tile of its `dw_tile`), launched with that tree's arguments.

A cut's outputs are wrong by design and are not compared.  `--design` names
the cut set: `hopper` for the staged-window design (the default) or `first`
for the first design (one pixel x 4 channels a thread, nine 4-byte loads),
which a `git archive` of an earlier tree provides with `--csrc
OLD/tachikoma_tpu_torch/csrc`.  Times are CUDA events over CUDA-graph
replays (`utils/timing.py call_seconds`, warm L2), per call and summed per
forward, for both modes at both batches.  The card's name and power limit
are printed; everything goes to OUT_JSON (default dw_probe.json).
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

SRC = "qdwconv.cu"
# MobileNetV2 (width 1.0) at 224^2: the 17 depthwise 3x3 convs, pad 1, as
# (input side, channels, stride)
MBV2_DW = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2), (28, 192, 1), (28, 192, 1),
           (28, 192, 2), (14, 384, 1), (14, 384, 1), (14, 384, 1), (14, 384, 1), (14, 576, 1),
           (14, 576, 1), (14, 576, 2), (7, 960, 1), (7, 960, 1), (7, 960, 1)]
BATCHES = (8, 1)

# design -> cut -> [(old, new), ...] applied to qdwconv.cu
CUTS = {
    "first": {
        "no_epilogue": [
            ("v[j] = c + j < g.c ? wrap_add((int32_t)acc[j], rq.bias[c + j]) : 0;",
             "v[j] = (int32_t)acc[j];"),
            ("v[j] = c + j < g.c ? (int8_t)requantize_channel((int32_t)acc[j], c + j, rq) : 0;",
             "v[j] = (int8_t)acc[j];")],
        "no_loads": [("      load4(xi + ((long long)iy * g.w + ix) * g.c, c, g, xv);",
                      "      xv[0] = xv[1] = xv[2] = xv[3] = iy + ix;")],
        "empty": [("  extern __shared__ __align__(16) int8_t ws[];  // [tap][channel of the tile]",
                   "  extern __shared__ __align__(16) int8_t ws[];\n  if (g.n >= 0) return;")],
    },
    "hopper": {
        "no_epilogue": [("#define DW_EPILOGUE 1", "#define DW_EPILOGUE 0")],
        "no_loads": [("#define DW_STAGE_INPUT 1", "#define DW_STAGE_INPUT 0")],
        "empty": [("#define DW_BODY 1", "#define DW_BODY 0")],
    },
}


def build_variants(csrc: Path, src: str, cuts: dict, workdir: Path) -> dict:
    """Compile `src` as it is and with each cut, all at once; returns
    name -> library path.  A cut is a list of (old, new) replacements in
    `src`, or (file, old, new) in another file of `csrc` (a header)."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    jobs = {}
    for name, reps in {"whole": [], **cuts}.items():
        d = workdir / name
        shutil.copytree(csrc, d / "csrc")
        for rep in reps:
            file, old, new = rep if len(rep) == 3 else (src, *rep)
            text = (d / "csrc" / file).read_text()
            assert text.count(old) == 1, f"cut {name} does not apply: {old[:60]!r}"
            (d / "csrc" / file).write_text(text.replace(old, new))
        lib = d / f"lib{Path(src).stem}-{name}.so"
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(lib), str(d / "csrc" / src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = lib
    return libs


@contextlib.contextmanager
def entries_of(path: Path, src: str):
    """The port's wrappers launch the entries of `src` from the library at
    `path` (a build of that source alone)."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    lib = ctypes.CDLL(str(path))
    mine = {}
    for fn_name, n_ptr in _lib.SOURCES[src]:
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p] * (n_ptr + 2)
        fn.restype = ctypes.c_int
        mine[fn_name] = fn
    saved = dict(_lib._entries)
    _lib._entries.clear()
    _lib._entries.update(mine)
    try:
        yield
    finally:
        _lib._entries.clear()
        _lib._entries.update(saved)


def calls(batch: int, rng) -> list:
    """Operands of the 17 calls at `batch`: (label, x, w, bias, mult, shift, stride)."""
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize

    out = []
    for side, c, s in MBV2_DW:
        x = torch.from_numpy(rng.integers(-128, 128, (batch, side, side, c)).astype(np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 1, c)).astype(np.int8)).cuda()
        bias = torch.from_numpy(rng.integers(-5000, 5000, c).astype(np.int32)).cuda()
        m, sh = plan_requantize(0.002 * (0.5 + rng.random(c)), 1.0)
        out.append((f"{batch}x{side}x{side}x{c} s{s}", x, w, bias, channel_vector(m, c, "cuda"),
                    channel_vector(sh, c, "cuda"), s))
    return out


def sweep_plans(ops) -> dict:
    """K5 at every tile that fits (channels 16 to 64, 1 to 8 rows, strips of
    1 to 4 threads) at each distinct call: requantize mode at b8, raw mode
    at b1 (the two forwards' modes), each held == plain first; prints each
    call's best tile beside the one dw_plan picks."""
    from tachikoma_tpu_torch.ops.kernels import depthwise
    from tachikoma_tpu_torch.utils.timing import call_seconds

    real = depthwise.dw_plan
    out = {}
    seen = set()
    try:
        for b, mode in ((8, "rq"), (1, "raw")):
            for label, x, w, bias, mult, shift, s in ops[b]:
                if (label, mode) in seen:
                    continue
                seen.add((label, mode))
                n, h = x.shape[0], x.shape[1]
                c = x.shape[3]
                o = (h + 2 - 3) // s + 1
                kw = dict(strides=(s, s), padding=(1, 1, 1, 1))
                if mode == "rq":
                    def fn(): return depthwise.qdwconv_rq(x, w, bias, mult, shift, **kw)
                    want = depthwise.qdwconv_rq_plain(x, w, bias, mult, shift, **kw)
                else:
                    def fn(): return depthwise.qdwconv_raw(x, w, bias, **kw)
                    want = depthwise.qdwconv_raw_plain(x, w, bias, **kw)
                chosen = real(n, o, o, c, 3, 3, s, s)
                rows = {}
                for ct in depthwise.CHANNEL_TILES:
                    for th in (1, 2, 4, 8):
                        for nx in (1, 2, 4):
                            if ct // 4 * th * nx > depthwise.MAX_THREADS or th > o:
                                continue
                            iw = (4 * nx - 1) * s + 3
                            plan = dict(ct=ct, th=th, tw=4 * nx,
                                        rp=depthwise._row_pitch(ct, th, nx, iw, s, s))
                            depthwise.dw_plan = lambda *a_, _p=plan: _p
                            try:
                                got = fn()
                                torch.cuda.synchronize()
                                assert torch.equal(got, want), f"{label} {plan} != plain"
                                rows[f"ct{ct} th{th} tw{4 * nx}"] = call_seconds(fn, "cuda") * 1e3
                            finally:
                                depthwise.dw_plan = real
                best = min(rows, key=rows.get)
                key = f"ct{chosen['ct']} th{chosen['th']} tw{chosen['tw']}"
                print(f"plans {mode} {label:20s} best {best} {rows[best]:.4f} ms; dw_plan {key} "
                      f"{rows.get(key, float('nan')):.4f}", flush=True)
                out[f"{mode} {label}"] = rows
    finally:
        depthwise.dw_plan = real
    return out


def earlier_dw_tile(oh, ow, kh, kw, strides):
    """The earlier K12's output tile (TH, TW) (its conv_direct.dw_tile): 8
    rows by the whole output row, the columns halved down to 8, then the
    rows, until the window and weights of 64 channels fit 64 KB."""
    def smem(th, tw):
        return (((th - 1) * strides[0] + kh) * ((tw - 1) * strides[1] + kw) + kh * kw) * 64

    th, tw = min(8, oh), ow
    while smem(th, tw) > 64 * 1024 and (th, tw) != (1, 1):
        if tw > 8 or th == 1:
            tw = -(-tw // 2)
        else:
            th = -(-th // 2)
    return th, tw


def compare_k12(ops, before_csrc, workdir) -> dict:
    """K5 rq, K12 and (from `before_csrc`) the earlier K12 at the b8 calls,
    in turns, each == plain first; ms per call and per forward."""
    from tachikoma_tpu_torch.ops.kernels import _lib, conv_direct, depthwise
    from tachikoma_tpu_torch.utils.timing import call_seconds

    before = None
    if before_csrc is not None:
        lib = build_variants(Path(before_csrc), "qconv_direct.cu", {}, workdir / "k12")["whole"]
        before = ctypes.CDLL(str(lib)).tk_qdwconv_direct
        before.argtypes = [ctypes.c_void_p] * 8
        before.restype = ctypes.c_int
    rows = {"k5_rq": [], "k12": [], "k12_before": []}
    for label, x, w, bias, mult, shift, s in ops[8]:
        kw = dict(strides=(s, s), padding=(1, 1, 1, 1))
        want = conv_direct.qdwconv_direct_plain(x, w, bias, mult, shift, **kw)
        fns = {"k5_rq": lambda: depthwise.qdwconv_rq(x, w, bias, mult, shift, **kw),
               "k12": lambda: conv_direct.qdwconv_direct(x, w, bias, mult, shift, **kw)}
        if before is not None:
            n, h, wd, c = x.shape
            oh = ow = (h + 2 - 3) // s + 1
            th, tw = earlier_dw_tile(oh, ow, 3, 3, (s, s))
            out = torch.empty((n, oh, ow, c), dtype=torch.int8, device=x.device)
            p = dict(n=n, h=h, w=wd, cin=c, kh=3, kw=3, cout=c, oh=oh, ow=ow, sh=s, sw=s, pt=1,
                     pl=1, qmin=-128, qmax=127, a_vec=int(c % 16 == 0), b_vec=int(c % 4 == 0),
                     th=th, tw=tw)
            arr = (ctypes.c_int32 * len(_lib.PARAMS))(*(int(p.get(k, 0)) for k in _lib.PARAMS))

            def run(out=out, arr=arr, x=x, w=w, bias=bias, mult=mult, shift=shift):
                rc = before(x.data_ptr(), w.data_ptr(), out.data_ptr(), bias.data_ptr(),
                            mult.data_ptr(), shift.data_ptr(), ctypes.addressof(arr),
                            torch.cuda.current_stream().cuda_stream)
                assert rc == 0, f"earlier K12: CUDA error {rc}"
                return out
            fns["k12_before"] = run
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{name} != plain at {label}"
        for name, fn in fns.items():
            rows[name].append(call_seconds(fn, "cuda") * 1e3)
        print(f"{label:22s} " + " ".join(f"{k} {v[-1]:.4f}" for k, v in rows.items() if v),
              flush=True)
    res = {k: {"per_call": v, "per_forward": sum(v)} for k, v in rows.items() if v}
    print("per MobileNetV2 b8 forward: "
          + " ".join(f"{k} {v['per_forward']:.4f}" for k, v in res.items()), flush=True)
    return res


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import depthwise
    from tachikoma_tpu_torch.ops.kernels._lib import CSRC
    from tachikoma_tpu_torch.utils.timing import call_seconds

    argv = sys.argv[1:]
    design = "hopper"
    csrc = CSRC
    k12_csrc = None
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "--design":
            design, i = argv[i + 1], i + 2
        elif argv[i] == "--csrc":
            csrc, i = Path(argv[i + 1]), i + 2
        elif argv[i] == "--k12-csrc":
            k12_csrc, i = Path(argv[i + 1]), i + 2
        else:
            if not argv[i].startswith("--"):
                args.append(argv[i])
            i += 1
    out_path = args[0] if args else "dw_probe.json"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    workdir = Path(tempfile.mkdtemp(prefix="dw_probe_"))
    try:
        rng = np.random.default_rng(0)
        ops = {b: calls(b, rng) for b in BATCHES}
        if "--k12" in argv:
            res = {"card": card, "k12": compare_k12(ops, k12_csrc, workdir),
                   "calls": [f"{side}x{side}x{c} s{s}" for side, c, s in MBV2_DW]}
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1)
            return 0
        libs = build_variants(Path(csrc), SRC, CUTS[design], workdir)
        res = {"card": card, "design": design, "csrc": str(csrc), "variants": {}}
        pad = (1, 1, 1, 1)
        for name, lib in libs.items():
            rows = {}
            with entries_of(lib, SRC):
                for b in BATCHES:
                    for mode in ("rq", "raw"):
                        times = []
                        for label, x, w, bias, mult, shift, s in ops[b]:
                            kw = dict(strides=(s, s), padding=pad)
                            if mode == "rq":
                                def fn(): return depthwise.qdwconv_rq(x, w, bias, mult, shift, **kw)

                                def plain(): return depthwise.qdwconv_rq_plain(x, w, bias, mult,
                                                                               shift, **kw)
                            else:
                                def fn(): return depthwise.qdwconv_raw(x, w, bias, **kw)

                                def plain(): return depthwise.qdwconv_raw_plain(x, w, bias, **kw)
                            if name == "whole":
                                got = fn()
                                torch.cuda.synchronize()
                                assert torch.equal(got, plain()), f"{mode} {label} != plain"
                            times.append(call_seconds(fn, "cuda") * 1e3)
                        rows[f"{mode} b{b}"] = {"per_call": times, "per_forward": sum(times)}
                        print(f"{name:12s} {mode:3s} b{b}: {sum(times):.4f} ms per forward; "
                              + " ".join(f"{t:.4f}" for t in times), flush=True)
            res["variants"][name] = rows
            if name == "whole" and "--plans" in sys.argv:
                with entries_of(lib, SRC):
                    res["plans"] = sweep_plans(ops)
        res["calls"] = [f"{side}x{side}x{c} s{s}" for side, c, s in MBV2_DW]
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
