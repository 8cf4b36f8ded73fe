"""Where K3's (qconv_rq_res) and K4's conv-mode (qconv_raw) time goes, on one
GPU, at the calls of ResNet-50 b8 fused (K3) and b1 unfused (K4):

    python3 tools/igemm_probe.py [--alt NAME=PATH ...] [--no-cuts] [--k3-only] [OUT_JSON]

For each distinct call shape of one recorded forward:
  * `ms`: the wrapper in a CUDA graph (chip_smoke.py's graph_ms: the
    kernel and, for a split K4 call, the zeroing of its output);
  * `kernel_ms` / `other_ms`: torch.profiler's device time per call of the
    igemm_hopper kernel and of everything else the wrapper launched;
  * K3 at each tile of _lib.TILES; K4 at other splits of K (steps per
    split 1, 2, 3, 4, 6, 9 and unsplit);
  * builds of csrc/qconv_igemm_hopper.cu with a part cut out, timed on the
    same calls (their outputs are wrong by design and are not compared):
    K3 `no_tables` (the residual add's lookups replaced by a plain add),
    `no_epilogue` (no requantize either), `no_mma` (no wgmma); K4
    `no_atomics` (a split stores instead of adding) and `no_mma`; K3 also
    `no_res_load` (the residual tile not copied), `no_store` (the output
    tile not stored), `no_table_build`, `bare_loop` (no epilogue, wgmma,
    residual or store: the A/B copies and the loop), `no_ab_copies`,
    `empty_loop` (the loop's waits and barriers alone), `empty_no_fence`
    and `empty_no_prologue` (that, without the proxy fence, or without the
    tables, the column constants and the resident weights), `no_b_res` (the
    weights streamed with A even where K has at most two steps); both
    `stages2` (a ring of two), `launch_only` (every block returns at once), `minblocks4` / `minblocks6` (launch bounds asking for 4
    or 6 blocks of 64 rows an SM at BN 64);
  * K3: `copy_residual_ms`, a torch copy of the call's residual (its
    bytes, read and written once: what moving them alone costs);
  * with `--alt NAME=PATH` (repeatable), another source of the same two C
    entries built and timed on the same calls (e.g. an earlier design).
`--no-cuts` skips the cut builds, `--k3-only` the K4 calls.  The cuts of
the requantize (`no_epilogue` and the builds on it) were written against
the source before the epilogue moved into csrc/epilogue_hopper.cuh; they
no longer apply and are skipped with a message.  A cut or an
alternative source is loaded as a second library into the process; on the
H100 one whose kernel takes more than 48 KB of dynamic shared memory fails
to launch from there (CUDA error 1, recorded in place of its time), though
the same kernel launches from the port's own library.  The card's name and
power limit are printed; everything goes to OUT_JSON (default
igemm_probe.json in the working directory).
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> (kernel, [(old, new), ...]) applied to csrc/qconv_igemm_hopper.cu
CUTS = {
    "no_tables": ("qconv_rq_res", [
        ("min(max(wrap_add(tl[q0 & 255], tr[rr & 255]), e.lo), e.hi)", "q0 + (int32_t)rr"),
        ("min(max(wrap_add(tl[q1 & 255], tr[rr >> 8]), e.lo), e.hi)", "q1 + (int32_t)rr"),
    ]),
    "no_epilogue": ("qconv_rq_res", [
        ("min(max(wrap_add(tl[q0 & 255], tr[rr & 255]), e.lo), e.hi)", "q0 + (int32_t)rr"),
        ("min(max(wrap_add(tl[q1 & 255], tr[rr >> 8]), e.lo), e.hi)", "q1 + (int32_t)rr"),
        ("requant_wide(acc[4 * jb + 2 * h], c0, e)", "acc[4 * jb + 2 * h] + c0.x"),
        ("requant_wide(acc[4 * jb + 2 * h + 1], c1, e)", "acc[4 * jb + 2 * h + 1] + c1.x"),
    ]),
    "no_mma": (None, [("for (int kk = 0; kk < 2; ++kk)\n        wgmma_acc<BN>",
                       "for (int kk = 0; kk < 2 * (int)(g.M < 0); ++kk)\n        wgmma_acc<BN>")]),
    "no_atomics": ("qconv_raw", [("if (split) {", "if (false) {")]),
    "no_res_load": ("qconv_rq_res", [("if (g.o_vec) {  // the item's residual tile",
                                      "if (g.M < 0) {  // the item's residual tile")]),
    "no_store": ("qconv_rq_res", [
        ("epi::store_tile16(o8, rtile, S::RS, BM, min(BN, g.cout - n0), dst);", "")]),
    "no_table_build": ("qconv_rq_res", [("for (int i = tid; i < 512; i += NT) {",
                                         "for (int i = tid; i < 512 * (int)(g.M < 0); i += NT) {")]),
    "stages2": (None, [("STAGES = MODE == RES ? 3 : 4;", "STAGES = 2;")]),
    "no_b_res": ("qconv_rq_res", [("g.b_res = MODE == RES && g.steps <= BRES_STEPS;",
                                   "g.b_res = false;")]),
    "minblocks4": (None, [("__launch_bounds__(2 * BM)\n",
                           "__launch_bounds__(2 * BM, BN == 64 ? 256 / BM : 1)\n")]),
    "minblocks6": (None, [("__launch_bounds__(2 * BM)\n",
                           "__launch_bounds__(2 * BM, BN == 64 ? 384 / BM : 1)\n")]),
}
_EPI = CUTS["no_epilogue"][1]
_BARE = _EPI + CUTS["no_mma"][1] + CUTS["no_res_load"][1] + CUTS["no_store"][1]
_NO_STAGE = [("      stage(issued % ST, kbeg + p_step);\n", "")]
CUTS.update({
    "bare_loop": ("qconv_rq_res", _BARE),                # only the A/B copies and the loop
    "no_ab_copies": ("qconv_rq_res", _NO_STAGE),          # no A/B copies
    "empty_loop": ("qconv_rq_res", _BARE + _NO_STAGE),   # the loop, barriers and waits alone
    "empty_no_fence": ("qconv_rq_res", _BARE + _NO_STAGE + [
        ("    fence_proxy_async();\n    __syncthreads();\n    const int8_t* const as",
         "    __syncthreads();\n    const int8_t* const as")]),
    "empty_no_prologue": ("qconv_rq_res", _BARE + _NO_STAGE + CUTS["no_table_build"][1] + [
        ("for (int c = tid; c < BN; c += NT) {", "for (int c = tid; c < BN * (int)(g.M < 0); c += NT) {"),
        ("if (g.b_res)  // every step", "if (g.M < 0)  // every step")]),
    "launch_only": (None, [("  const int kbeg = blockIdx.z * g.kper;\n",
                            "  if (n_items > 0) return;\n  const int kbeg = blockIdx.z * g.kper;\n")]),
})
RAW_KPER = (1, 2, 3, 4, 6, 9, None)  # None: unsplit


def main() -> int:
    args, alts, flags = sys.argv[1:], {}, set()
    while args and args[0].startswith("--"):
        if args[0] == "--alt":
            name, path = args[1].split("=", 1)
            alts[name] = os.path.abspath(path)
            args = args[2:]
        else:
            flags.add(args.pop(0))
    out_json = os.path.abspath(args[0] if args else "igemm_probe.json")
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tachikoma_tpu_torch.models.vision import resnet
    from tachikoma_tpu_torch.ops.kernels import _lib, conv
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    if not torch.cuda.is_available():
        print("igemm_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print("card:", card, flush=True)
    _lib.build()
    _lib._entry("tk_qconv_raw")
    # the body lives in igemm_hopper.cuh: inlined, so that the cuts see it
    src = (_lib.CSRC / "qconv_igemm_hopper.cu").read_text().replace(
        '#include "igemm_hopper.cuh"',
        (_lib.CSRC / "igemm_hopper.cuh").read_text().replace("#pragma once\n", ""))
    cuts = {}
    tmp = tempfile.mkdtemp()  # kept until the end: the loaded libraries live there
    try:
        for f in _lib.CSRC.iterdir():
            shutil.copy(f, tmp)
        jobs = {}
        builds = {**{name: reps for name, (_, reps) in CUTS.items() if "--no-cuts" not in flags},
                  **{name: open(path).read() for name, path in alts.items()}}
        for name, reps in builds.items():  # one nvcc per build, all at once
            text = src
            if isinstance(reps, str):
                text = reps
            elif all(text.count(old) == 1 for old, _ in reps):
                for old, new in reps:
                    text = text.replace(old, new)
            else:
                print(f"cut {name}: does not apply to this source, skipped", flush=True)
                continue
            path = os.path.join(tmp, f"{name}.cu")
            open(path, "w").write(text)
            so = os.path.join(tmp, f"{name}.so")
            jobs[name] = (so, subprocess.Popen([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", so, path],
                                               stdout=subprocess.DEVNULL))
        for name, (so, proc) in jobs.items():
            assert proc.wait() == 0, f"nvcc failed on the {name} cut"
            lib = ctypes.CDLL(so)
            cuts[name] = {}
            for entry, n_ptr in _lib.SOURCES["qconv_igemm_hopper.cu"]:
                fn = getattr(lib, entry)
                fn.argtypes = [ctypes.c_void_p] * (n_ptr + 2)
                fn.restype = ctypes.c_int
                cuts[name][entry] = fn
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(cs.SEED)

    def forward_calls(batch, fuse, kernel):
        calib = rng.standard_normal((batch, cs.IMAGE, cs.IMAGE, 3)).astype(np.float32)
        q = quantize(resnet(50, batch_size=batch, image_size=cs.IMAGE, seed=cs.SEED), [calib])
        g = fuse_qnn(q) if fuse else q
        ex = TorchExecutor(g, capture=computational_nodes(g), device="cuda", fuse=fuse)
        x = rng.standard_normal((batch, cs.IMAGE, cs.IMAGE, 3)).astype(np.float32)
        calls = []
        with cs.recording(calls):
            ex.run_device(x)
        torch.cuda.synchronize()
        seen, out = set(), []
        for n, a, k in calls:
            label = cs.work(n, a, k)[2]
            if n == kernel and label not in seen:
                seen.add(label)
                out.append((n, a, k, label, sum(1 for c in calls if c[0] == n
                                                and cs.work(*c)[2] == label)))
        return out

    def device_split(fn, reps=20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = other = 0.0
        for e in prof.key_averages():
            t = e.self_device_time_total
            if t <= 0 or e.device_type == torch.autograd.DeviceType.CPU:
                continue
            if "igemm_hopper" in e.key:
                kern += t
            else:
                other += t
        return kern / 1e3 / reps, other / 1e3 / reps

    def timed_cut(name, entry, fn):
        """The cut's time, or the launch error it raised (recorded, not fatal:
        a cut is a measurement, not a kernel of the port)."""
        saved = _lib._entries[entry]
        _lib._entries[entry] = cuts[name][entry]
        try:
            return cs.graph_ms(fn)
        except RuntimeError as err:
            torch.cuda.synchronize()
            return f"error: {err}"
        finally:
            _lib._entries[entry] = saved

    impl = cs.kernel_impls()
    res = {"card": card, "k3": [], "k4conv": []}
    for n, a, k, label, count in forward_calls(cs.BATCH, True, "qconv_rq_res"):
        fn = impl[n][0]
        r = dict(shape=label, calls=count, plan=cs.launch_plan(n, a, k),
                 ms=cs.graph_ms(lambda: fn(*a, **k)))
        r["kernel_ms"], r["other_ms"] = device_split(lambda: fn(*a, **k))
        for bm, bn in _lib.TILES:
            kk = dict(k, blocks=(bm, bn, 64))
            r[f"tile_{bm}x{bn}"] = cs.graph_ms(lambda: fn(*a, **kk))
        for name, (kernel, _) in CUTS.items():
            if kernel in (None, n) and name in cuts:
                r[name] = timed_cut(name, "tk_qconv_rq_res", lambda: fn(*a, **k))
        for name in alts:
            r[name] = timed_cut(name, "tk_qconv_rq_res", lambda: fn(*a, **k))
        res_t, dst = a[5], torch.empty_like(a[5])
        r["copy_residual_ms"] = cs.graph_ms(lambda: dst.copy_(res_t))  # the bytes alone
        res["k3"].append(r)
        print("K3", json.dumps(r), flush=True)
    for n, a, k, label, count in ([] if "--k3-only" in flags else
                                  forward_calls(cs.TRACE_BATCH, False, "qconv_raw")):
        fn = impl[n][0]
        r = dict(shape=label, calls=count, plan=cs.launch_plan(n, a, k),
                 ms=cs.graph_ms(lambda: fn(*a, **k)))
        r["kernel_ms"], r["other_ms"] = device_split(lambda: fn(*a, **k))
        x, w = a[0], a[1]
        kh, kw_, cin, cout = w.shape
        steps = -(-kh * kw_ * cin // conv.KSTEP)
        saved = conv.raw_split
        try:
            for kper in RAW_KPER:
                kper = steps if kper is None else min(kper, steps)
                plan = (-(-steps // kper), kper)
                conv.raw_split = lambda *_a, _p=plan, **_k: _p
                r[f"split_{plan[0]}x{plan[1]}"] = cs.graph_ms(lambda: fn(*a, **k))
        finally:
            conv.raw_split = saved
        for name, (kernel, _) in CUTS.items():
            if kernel in (None, n) and name in cuts:
                r[name] = timed_cut(name, "tk_qconv_raw", lambda: fn(*a, **k))
        for name in alts:
            r[name] = timed_cut(name, "tk_qconv_raw", lambda: fn(*a, **k))
        res["k4conv"].append(r)
        print("K4conv", json.dumps(r), flush=True)
    zeros = {}
    for size in (49 * 512, 196 * 256, 784 * 128, 3136 * 64):
        zeros[size] = cs.graph_ms(lambda: torch.zeros(size, dtype=torch.int32, device="cuda"))
    res["zeros_ms"] = zeros
    print("torch.zeros int32 ms by elements", zeros)
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1)
    print("card:", card)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
