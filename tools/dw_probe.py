"""K5 (qdwconv_rq, qdwconv_raw) timed on one GPU at the 17 depthwise convs of
MobileNetV2 224^2, at batch 8 and batch 1, whole and with parts cut out:

    python3 tools/dw_probe.py [--design NAME] [--csrc DIR] [--plans] [OUT_JSON]

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
    name -> library path."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    jobs = {}
    for name, reps in {"whole": [], **cuts}.items():
        d = workdir / name
        shutil.copytree(csrc, d / "csrc")
        text = (d / "csrc" / src).read_text()
        for old, new in reps:
            assert text.count(old) == 1, f"cut {name} does not apply: {old[:60]!r}"
            text = text.replace(old, new)
        (d / "csrc" / src).write_text(text)
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


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import depthwise
    from tachikoma_tpu_torch.ops.kernels._lib import CSRC
    from tachikoma_tpu_torch.utils.timing import call_seconds

    argv = sys.argv[1:]
    design = "hopper"
    csrc = CSRC
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "--design":
            design, i = argv[i + 1], i + 2
        elif argv[i] == "--csrc":
            csrc, i = Path(argv[i + 1]), i + 2
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
        libs = build_variants(Path(csrc), SRC, CUTS[design], workdir)
        rng = np.random.default_rng(0)
        ops = {b: calls(b, rng) for b in BATCHES}
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
