"""K2's (qconv_rq) and K11's (qconv_direct) launch choices, timed on one GPU
at the conv calls of ResNet-50 b8 and VGG-16 b8 (224^2):

    python3 tools/conv_probe.py [--quick] [--cuts[=NAME,...]] [OUT_JSON]
    python3 tools/conv_probe.py --geometry [OUT_JSON]

  * K2 at each call shape: every tile of _lib.TILES at the wrapper's own
    split (`rq_split`), and at the 64 x 64 tile every split of K into
    1, 2, 3, 4, 6, 8 or 12 (forced, each split non-empty);
  * K11 at each VGG-16 3x3 shape and ResNet-50's stem and 3x3 s2 convs: the
    wrapper's own plan (`direct_plan`), the Hopper path at BN 64 and 128,
    the weights resident or streamed 3 or 9 taps a step, the copies 1 to 3
    steps ahead (where they fit), and the narrow path.

Every configuration's output is held == its plain version before it is
timed (CUDA events over CUDA-graph replays, chip_smoke.py's graph_ms), at
the input zero point 0 of the forwards' calls (a nonzero one adds the
wrapper's bias fold, a few small kernels, to every call).
`--quick` keeps K2's splits and K11's forced plans to the calls with few
tiles.  `--cuts` instead times builds of the two sources with a part cut
out or changed (CUTS: no wgmma, no A / window copies, no B / weight copies,
no epilogue; the copies in L2 alone; a deeper ring), each in a process of
its own, at a few calls, beside the whole kernel; a cut's outputs are wrong
by design and are not compared.  `--cuts=NAME,...` builds those alone.
`--geometry` times K2 and K4's conv mode at the dilated calls of
DeepLabV3-ResNet-50 b1 520^2 and the grouped calls of ResNeXt-50 32x4d b8
224^2 (chip_smoke.py phase 27): K2 at every tile at the wrapper's split
(a grouped call's super-group follows the tile's columns), at the
wrapper's tile every split of K (forced), K4 at every split, each beside
the fp16 cuDNN conv of the same shape, dilation and groups.  The card's
name and power limit are printed; everything goes to OUT_JSON (default
conv_probe.json in the working directory).
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (x shape, k, stride, padding, cout)
K2_CALLS = {
    "ResNet-50": [((8, 224, 224, 3), 7, 2, 3, 64), ((8, 56, 56, 64), 3, 1, 1, 64),
                  ((8, 56, 56, 128), 3, 2, 1, 128), ((8, 28, 28, 128), 3, 1, 1, 128),
                  ((8, 28, 28, 256), 3, 2, 1, 256), ((8, 14, 14, 256), 3, 1, 1, 256),
                  ((8, 14, 14, 512), 3, 2, 1, 512), ((8, 7, 7, 512), 3, 1, 1, 512)],
    "VGG-16": [((8, 224, 224, 3), 3, 1, 1, 64), ((8, 224, 224, 64), 3, 1, 1, 64),
               ((8, 112, 112, 64), 3, 1, 1, 128), ((8, 112, 112, 128), 3, 1, 1, 128),
               ((8, 56, 56, 128), 3, 1, 1, 256), ((8, 56, 56, 256), 3, 1, 1, 256),
               ((8, 28, 28, 256), 3, 1, 1, 512), ((8, 28, 28, 512), 3, 1, 1, 512),
               ((8, 14, 14, 512), 3, 1, 1, 512)],
}
# (x shape, k, stride, dilation, groups, cout): chip_smoke.py phase 27's
# dilated and grouped calls (tests/test_torch_port_cuda.py K2_DILATED_CASES,
# K2_GROUPED_CASES)
GEOMETRY_CALLS = {
    "DeepLabV3-ResNet-50 b1 520^2": [
        ((1, 65, 65, 256), 3, 1, 2, 1, 256), ((1, 65, 65, 512), 3, 1, 2, 1, 512),
        ((1, 65, 65, 512), 3, 1, 4, 1, 512), ((1, 65, 65, 2048), 3, 1, 12, 1, 256),
        ((1, 65, 65, 2048), 3, 1, 36, 1, 256)],
    "ResNeXt-50 32x4d b8 224^2": [
        ((8, 56, 56, 128), 3, 1, 1, 32, 128), ((8, 56, 56, 256), 3, 2, 1, 32, 256),
        ((8, 28, 28, 256), 3, 1, 1, 32, 256), ((8, 28, 28, 512), 3, 2, 1, 32, 512),
        ((8, 14, 14, 512), 3, 1, 1, 32, 512), ((8, 14, 14, 1024), 3, 2, 1, 32, 1024),
        ((8, 7, 7, 1024), 3, 1, 1, 32, 1024)],
}
K11_CALLS = K2_CALLS["VGG-16"] + [K2_CALLS["ResNet-50"][i] for i in (0, 2, 4, 6, 7)]
SPLITS = (1, 2, 3, 4, 6, 8, 12)
# name -> (the kernel's source, [(file, old, new), ...]): a build of csrc with
# a part cut out or changed
_IG, _DI, _LH = "qconv_igemm_hopper.cu", "qconv_direct.cu", "layouts_hopper.cuh"
_IGH = "igemm_hopper.cuh"  # K2's body, which qconv_igemm_hopper.cu includes
CUTS = {
    "k2_no_mma": (_IG, [(_IGH, "      wgmma_acc<BN>(acc, gmma_desc(as + wg * 4096 + kk * 256, 128, 512),",
                         "      if (g.M < 0) wgmma_acc<BN>(acc, gmma_desc(as + wg * 4096 + kk * 256, "
                         "128, 512),")]),
    "k2_no_a": (_IG, [(_IGH, "            copy16(d, src, true);", "            ;")]),
    "k2_no_b": (_IG, [(_IGH, "    if (!g.b_res) stage_b(bs, kstep);", "")]),
    "k2_no_copies": (_IG, [(_IGH, "      stage(issued % ST, kbeg + p_step);\n", "")]),
    "k2_no_epilogue": (_IG, [(_IGH, "      if (run_epilogue && g.o_vec) {", "      if (g.M < 0) {"),
                             (_IGH, "      } else if (run_epilogue) {", "      } else if (g.M < 0) {")]),
    # the copies in L2 alone (.cg), not cached in L1 as well (.ca)
    "k2_cg": (_IG, [(_IGH, "      hop::cp_async16_ca(d, src, ok);", "      cp_async16(d, src, ok);")]),
    # a ring of eight stages, seven ahead
    "k2_stages8": (_IG, [(_IGH, "STAGES = MODE == RES ? 3 : 4;", "STAGES = MODE == RES ? 3 : 8;"),
                         (_LH, "  if (n >= 2)\n    cp_async_wait2();",
                          "  if (n >= 6)\n    asm volatile(\"cp.async.wait_group 6;\" ::: \"memory\");\n"
                          "  else if (n >= 4)\n    asm volatile(\"cp.async.wait_group 4;\" ::: \"memory\");\n"
                          "  else if (n >= 2)\n    cp_async_wait2();")]),
    "k11_no_mma": (_DI, [
        (_DI, "      hop::wgmma_acc<BN>(acc, hop::gmma_desc(a, lbo, sbo), hop::gmma_desc(b, 128, 512));",
         "      if (g.n < 0) hop::wgmma_acc<BN>(acc, hop::gmma_desc(a, lbo, sbo), "
         "hop::gmma_desc(b, 128, 512));"),
        (_DI, "      if (ksteps == 2)\n", "      if (ksteps == 2 && g.n < 0)\n")]),
    "k11_no_window": (_DI, [(_DI, "    if (grp == 0) {\n      const Org o", "    if (g.n < 0) {\n      const Org o")]),
    "k11_no_epilogue": (_DI, [
        (_DI, "    if (g.o_vec) {\n      epi::stage_fragment<BN>(tile, RS",
         "    if (g.n < 0) {\n      epi::stage_fragment<BN>(tile, RS"),
        (_DI, "    } else {\n#pragma unroll\n      for (int jb = 0; jb < BN / 8; ++jb) {",
         "    } else if (g.n < 0) {\n#pragma unroll\n      for (int jb = 0; jb < BN / 8; ++jb) {")]),
    "k11_cg": (_DI, [(_DI, "hop::cp_async16_ca(d, src, true);", "hop::cp_async16(d, src, true);"),
                     (_DI, "hop::cp_async16_ca(wt + i * BN * 64", "hop::cp_async16(wt + i * BN * 64")]),
}
CUT_CALLS = [((8, 224, 224, 64), 3, 1, 1, 64), ((8, 56, 56, 64), 3, 1, 1, 64),
             ((8, 28, 28, 512), 3, 1, 1, 512), ((8, 14, 14, 256), 3, 1, 1, 256)]


def cut_build(name):
    """Point _lib at a copy of csrc with the cut `name` applied (or, named by
    a source file, as it is), that source built alone into a temporary
    directory: a second library of the same entries cannot be loaded beside
    the first into one process (its kernels of more than 48 KB of dynamic
    shared memory refuse to launch), so each cut is timed in a process of
    its own."""
    import shutil
    import tempfile
    from pathlib import Path

    from tachikoma_tpu_torch.ops.kernels import _lib

    src, reps = CUTS.get(name, (name, []))
    tmp = Path(tempfile.mkdtemp())
    shutil.copytree(_lib.CSRC, tmp / "csrc")
    for file, old, new in reps:
        text = (tmp / "csrc" / file).read_text()
        assert text.count(old) == 1, f"cut {name} does not apply: {old[:60]!r}"
        (tmp / "csrc" / file).write_text(text.replace(old, new))
    _lib.CSRC, _lib.BUILD_DIR = tmp / "csrc", tmp / "build"
    _lib.SOURCES = {src: _lib.SOURCES[src]}


def main() -> int:
    from tachikoma_tpu_torch.ops.kernels import _lib, conv, conv_direct
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize
    from tachikoma_tpu_torch.utils.timing import call_seconds

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    quick = "--quick" in sys.argv
    out_path = args[0] if args else "conv_probe.json"
    if "--cut" in sys.argv:
        cut_build(args[0])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _lib.build()
    rng = np.random.default_rng(0)
    sms = conv.sm_count(0)

    def operands(shape, k, cout):
        x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-127, 128, (k, k, shape[3], cout)).astype(np.int8)).cuda()
        bias = torch.from_numpy(rng.integers(-5000, 5000, cout).astype(np.int32)).cuda()
        m, s = plan_requantize(0.002 * (0.5 + rng.random(cout)), 1.0)
        return x, w, bias, channel_vector(m, cout, "cuda"), channel_vector(s, cout, "cuda")

    def timed(fn, plain):
        got = fn()
        torch.cuda.synchronize()
        assert torch.equal(got, plain), "!= plain"
        return call_seconds(fn, "cuda") * 1e3

    if "--cut" in sys.argv:  # one build, in this process: --cut NAME OUT_JSON
        name = args[0]
        src = CUTS[name][0] if name in CUTS else name
        kernel = conv.qconv_rq if src == "qconv_igemm_hopper.cu" else conv_direct.qconv_direct
        rows = []
        for shape, k, s, p, cout in CUT_CALLS:
            ops = operands(shape, k, cout)
            kw = dict(strides=(s, s), padding=(p,) * 4)
            rows.append(call_seconds(lambda: kernel(*ops, **kw), "cuda") * 1e3)
        with open(args[1], "w") as f:
            json.dump(rows, f)
        return 0
    if any(a.startswith("--cuts") for a in sys.argv):
        res = {"card": card, "calls": [list(c) for c in CUT_CALLS], "cuts": {}}
        chosen = [a.split("=", 1)[1].split(",") for a in sys.argv if a.startswith("--cuts=")]
        for name in (_IG, _DI, *(chosen[0] if chosen else CUTS)):
            path = f"{out_path}.{name}.json"
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cut", name, path],
                                  capture_output=True, text=True)
            res["cuts"][name] = (json.load(open(path)) if proc.returncode == 0
                                 else "error: " + proc.stderr[-300:])
            os.unlink(path) if proc.returncode == 0 else None
            print(name, res["cuts"][name], flush=True)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
        return 0

    real_split = conv.rq_split
    if "--geometry" in sys.argv:
        res = {"card": card, "geometry": []}
        real_raw = conv.raw_split

        def fp16_conv(x, w, s, d, g):
            x16 = x.permute(0, 3, 1, 2).half().contiguous(memory_format=torch.channels_last)
            w16 = w.permute(3, 2, 0, 1).half().contiguous(memory_format=torch.channels_last)
            return lambda: torch.nn.functional.conv2d(x16, w16, stride=s, padding=d, dilation=d,
                                                      groups=g)

        for model, calls in GEOMETRY_CALLS.items():
            for shape, k, s, d, g, cout in calls:
                x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).cuda()
                w = torch.from_numpy(rng.integers(-127, 128, (k, k, shape[3] // g, cout))
                                     .astype(np.int8)).cuda()
                _, bias, mult, shift = operands((1, 1, 1, 1), 1, cout)[1:]
                kw = dict(strides=(s, s), padding=(d,) * 4, dilation=(d, d), groups=g, out_zp=1)
                plain = conv.qconv_rq_plain(x, w, bias, mult, shift, **kw)
                oh = (shape[1] + 2 * d - 2 * d - 1) // s + 1
                m = shape[0] * oh * oh
                (tile, ks, kper) = conv.rq_launch(shape, tuple(w.shape), (s, s), (d,) * 4, None,
                                                  sms, (d, d), g)
                row = {"model": model, "shape": [shape, k, s, d, g, cout],
                       "own": [tile, ks, kper], "tiles": {}, "splits": {}, "raw": {},
                       "fp16_ms": call_seconds(fp16_conv(x, w, s, d, g), "cuda") * 1e3}
                for bm, bn in _lib.TILES:
                    kk, _ = conv._geometry(shape, tuple(w.shape), bn, g)
                    row["tiles"][f"{bm}x{bn}"] = [real_split(m, cout, kk, (bm, bn), sms), timed(
                        lambda: conv.qconv_rq(x, w, bias, mult, shift, blocks=(bm, bn, 64), **kw),
                        plain)]
                kk, _ = conv._geometry(shape, tuple(w.shape), tile[1], g)
                steps = -(-kk // 64)
                for n in SPLITS:
                    kper_n = -(-steps // n)
                    split = (-(-steps // kper_n), kper_n)
                    if split[0] != n:
                        continue
                    conv.rq_split = lambda *a, _s=split, **k_: _s
                    try:
                        row["splits"][str(n)] = timed(
                            lambda: conv.qconv_rq(x, w, bias, mult, shift, **kw), plain)
                    finally:
                        conv.rq_split = real_split
                rkw = dict(strides=(s, s), padding=(d,) * 4, dilation=(d, d), groups=g)
                raw_plain = conv.qconv_raw_plain(x, w, bias, **rkw)
                kk, _ = conv._geometry(shape, tuple(w.shape), conv.RAW_TILE[1], g)
                steps = -(-kk // 64)
                row["raw_own"] = real_raw(m, cout, kk, sms)
                for n in SPLITS:
                    kper_n = -(-steps // n)
                    split = (-(-steps // kper_n), kper_n)
                    if split[0] != n:
                        continue
                    conv.raw_split = lambda *a, _s=split, **k_: _s
                    try:
                        row["raw"][str(n)] = timed(lambda: conv.qconv_raw(x, w, bias, **rkw),
                                                   raw_plain)
                    finally:
                        conv.raw_split = real_raw
                print(json.dumps(row), flush=True)
                res["geometry"].append(row)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
        return 0

    res = {"card": card, "k2": [], "k11": []}
    for model, calls in K2_CALLS.items():
        for shape, k, s, p, cout in calls:
            ops = operands(shape, k, cout)
            kw = dict(strides=(s, s), padding=(p,) * 4, out_zp=1)
            plain = conv.qconv_rq_plain(*ops, **kw)
            oh = (shape[1] + 2 * p - k) // s + 1
            m, kk = shape[0] * oh * oh, k * k * shape[3]
            steps = -(-kk // 64)
            row = {"model": model, "shape": [shape, k, s, cout], "steps": steps, "tiles": {},
                   "splits": {}}
            for bm, bn in _lib.TILES:
                row["tiles"][f"{bm}x{bn}"] = [real_split(m, cout, kk, (bm, bn), sms),
                                              timed(lambda: conv.qconv_rq(*ops, blocks=(bm, bn, 64),
                                                                          **kw), plain)]
            tiles64 = -(-m // 64) * -(-cout // 64)
            if not quick or tiles64 < 2 * sms:
                for ks in SPLITS:
                    kper = -(-steps // ks)
                    split = (-(-steps // kper), kper)
                    if split[0] != ks:
                        continue
                    conv.rq_split = lambda *a, _s=split, **k_: _s
                    try:
                        row["splits"][str(ks)] = timed(lambda: conv.qconv_rq(*ops, **kw), plain)
                    finally:
                        conv.rq_split = real_split
            print(json.dumps(row), flush=True)
            res["k2"].append(row)

    for shape, k, s, p, cout in K11_CALLS:
        ops = operands(shape, k, cout)
        kw = dict(strides=(s, s), padding=(p,) * 4, out_zp=1)
        plain = conv_direct.qconv_direct_plain(*ops, **kw)
        wshape = (k, k, shape[3], cout)
        own = conv_direct.direct_plan(shape, wshape, (s, s), (p,) * 4, sms)
        row = {"shape": [shape, k, s, cout], "own": [own, timed(
            lambda: conv_direct.qconv_direct(*ops, **kw), plain)], "plans": []}
        forced = [] if quick and own["cc"] == conv_direct.KC and shape[1] >= 56 and s == 1 else [
            {"cc": 64, "bn": bn, "group": grp if not wres else k * k, "wres": wres,
             "ahead": ahead}
            for bn in (64, 128) for wres in (0, 1) for grp in ((3, 9) if not wres else (0,))
            for ahead in (1, 2, 3)
            if grp <= k * k and conv_direct.direct_smem(
                bn, grp if not wres else k * k, shape[3], k, k, (s, s), wres, ahead)
            <= conv_direct.SMEM_LIMIT]
        narrow = conv_direct.narrow_chunk(shape[3], k, k, (s, s))
        if narrow is not None:
            forced.append({"cc": narrow})
        for plan in forced:
            row["plans"].append([plan, timed(
                lambda: conv_direct.qconv_direct(*ops, plan=plan, **kw), plain)])
        print(json.dumps(row), flush=True)
        res["k11"].append(row)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
