"""K3's and K4's conv-mode times on a checkout of another tree, and K3's
epilogue share there, on one GPU:

    python3 tools/parent_k3_k4.py PARENT_DIR [OUT_JSON]

PARENT_DIR is a checkout (e.g. `git archive` of the commit before K3 and
K4's conv mode left csrc/qgemm.cuh, unpacked).  The script runs that tree's
own code: its chip_smoke.py records one ResNet-50 b8 fused forward and one
b1 unfused forward, and every K3 (qconv_rq_res) and K4 conv-mode (qconv_raw)
call is held == its plain version and timed beside its bound and library
call (check_call, as phases 4 and 7 do).  Then K3's calls are timed again
through two builds of that tree's csrc/qconv_rq.cu with the epilogue of
qgemm.cuh cut: variant 1 requantizes but skips the residual add, variant 2
stores the accumulator's low byte; then the full kernel once more.  Prints
one line per call and per forward, the card's name and power limit, and
writes everything to OUT_JSON (default parent_k3_k4.json in the working
directory).
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

EPILOGUE = """            int32_t v = requantize_channel(acc[mt][nt][i], col, rq);
            if (RES) v = residual_add(v, residual[o], ra);
            static_cast<int8_t*>(out)[o] = (int8_t)v;"""
CUT = """#if EPI_VARIANT == 2
            static_cast<int8_t*>(out)[o] = (int8_t)acc[mt][nt][i];
#else
            int32_t v = requantize_channel(acc[mt][nt][i], col, rq);
#if EPI_VARIANT != 1
            if (RES) v = residual_add(v, residual[o], ra);
#endif
            static_cast<int8_t*>(out)[o] = (int8_t)v;
#endif"""


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    out_json = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else "parent_k3_k4.json")
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tachikoma_tpu_torch.models.vision import resnet
    from tachikoma_tpu_torch.ops.kernels import _lib
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    if not torch.cuda.is_available():
        print("parent_k3_k4: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print("card:", card, flush=True)
    _lib.build()
    variants = {}
    with tempfile.TemporaryDirectory() as tmp:
        for f in ("qgemm.cuh", "qconv_rq.cu", "requantize.cuh", "params.cuh"):
            shutil.copy(_lib.CSRC / f, tmp)
        hdr = os.path.join(tmp, "qgemm.cuh")
        text = open(hdr).read()
        assert text.count(EPILOGUE) == 1, "this tree's qgemm.cuh has no K3 residual epilogue"
        open(hdr, "w").write(text.replace(EPILOGUE, CUT))
        for v in (1, 2):
            so = os.path.join(tmp, f"cut{v}.so")
            subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, f"-DEPI_VARIANT={v}", "-o", so,
                            os.path.join(tmp, "qconv_rq.cu")], check=True)
            fn = ctypes.CDLL(so).tk_qconv_rq_res
            fn.argtypes = [ctypes.c_void_p] * 9
            fn.restype = ctypes.c_int
            variants[v] = fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(cs.SEED)

    def r50(b):
        return resnet(50, batch_size=b, image_size=cs.IMAGE, seed=cs.SEED)

    def forward_calls(batch, fuse):
        calib = rng.standard_normal((batch, cs.IMAGE, cs.IMAGE, 3)).astype(np.float32)
        q = quantize(r50(batch), [calib])
        g = fuse_qnn(q) if fuse else q
        ex = TorchExecutor(g, capture=computational_nodes(g), device="cuda", fuse=fuse)
        x = rng.standard_normal((batch, cs.IMAGE, cs.IMAGE, 3)).astype(np.float32)
        calls = []
        with cs.recording(calls):
            ex.run_device(x)
        torch.cuda.synchronize()
        return calls

    impl = cs.kernel_impls()
    res = {"card": card}
    k3 = [c for c in forward_calls(cs.BATCH, True) if c[0] == "qconv_rq_res"]
    rows = [cs.check_call(n, a, k, impl) | {"blocks": k.get("blocks")} for n, a, k in k3]
    fn = impl["qconv_rq_res"][0]
    for v, vfn in variants.items():
        saved = _lib._entries["tk_qconv_rq_res"]
        _lib._entries["tk_qconv_rq_res"] = vfn
        for r, (_, a, k) in zip(rows, k3):
            r[f"ms_v{v}"] = cs.graph_ms(lambda: fn(*a, **k))
        _lib._entries["tk_qconv_rq_res"] = saved
    for r, (_, a, k) in zip(rows, k3):
        r["ms_again"] = cs.graph_ms(lambda: fn(*a, **k))
    for r in rows:
        print(f"K3 {r['shape']:36s} blocks {r['blocks']} ms {r['ms']:.4f} again "
              f"{r['ms_again']:.4f} rq-only {r['ms_v1']:.4f} lowbyte {r['ms_v2']:.4f} "
              f"bound {r['bound_ms']:.4f} lib {r['library_ms']:.4f}", flush=True)
    res["k3"] = rows
    res["k3_forward"] = {k: sum(r[k] for r in rows)
                         for k in ("ms", "ms_again", "ms_v1", "ms_v2", "bound_ms", "library_ms")}
    print("K3 per forward", res["k3_forward"], flush=True)
    rows = [cs.check_call(n, a, k, impl) for n, a, k in forward_calls(cs.TRACE_BATCH, False)
            if n == "qconv_raw"]
    for r in rows:
        print(f"K4conv {r['shape']:36s} ms {r['ms']:.4f} bound {r['bound_ms']:.4f} "
              f"lib {r['library_ms']:.4f}", flush=True)
    res["k4conv"] = rows
    res["k4conv_forward"] = {k: sum(r[k] for r in rows) for k in ("ms", "bound_ms", "library_ms")}
    print("K4conv per forward", res["k4conv_forward"], flush=True)
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1)
    print("card:", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
