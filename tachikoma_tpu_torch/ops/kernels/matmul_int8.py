"""K1: int8 GEMM with the exact requantize epilogue, and K4's GEMM mode: the
same GEMM storing the int32 accumulator plus bias (port of
`tachikoma_tpu/ops/pallas/matmul_int8.py`, `_mm_kernel` and `_mm_kernel_raw`).

`qgemm_rq` and `qgemm_raw` are the kernels' wrappers: on a CUDA tensor they
launch `csrc/qgemm_rq.cu`'s `tk_qgemm_rq` / `tk_qgemm_raw` (or raise), on a
CPU tensor they run `qgemm_rq_plain` / `qgemm_raw_plain`, the plain PyTorch
versions of the same integers.  Both have two paths, which `gemm_plan` picks
from the shape:

  * the tiled path (M above SKINNY_M: the 1x1 convs) runs the implicit-GEMM
    body of K2 (`csrc/igemm_hopper.cuh`: `wgmma`, persistent blocks, a
    `cp.async` ring, a split of K) on the GEMM as a 1x1 conv of 1 x 1
    images, at K2's tile and split rules (`rq_tile`, `rq_split`); K1's
    splits add into an int32 workspace whose last block requantizes, K4's
    into the zeroed output;
  * the skinny path (M <= SKINNY_M: the dense layers at small batch, K4's
    7^2 1x1 convs at batch 1) swaps the operands, out^T = W^T x^T, and
    splits K over enough blocks that every SM streams weights; K1's splits
    add into a workspace and the last block of an N tile requantizes, K4's
    add into the zeroed output.

Both read the weight packed K-major (`kmajor_weights`), once per weight
tensor: a caller whose weight is a view made per call (a 1x1 conv's
`w.reshape(CIN, COUT)`) names its stable tensor as `w_src`, which is packed
(and cached) in its place.

`qmatmul_int8` is the entry with the JAX package's signature; it takes
`blocks` (a compiled tile, `_lib.TILES`) or "xla", and without them reads the
tuning database's best record for the workload (`matmul_workload`, the JAX
package's key: `fused` with a multiplier, `raw` without).  A tile sets the
tiled path's (BM, BN); the skinny path reads no tile.  The record
`{"impl": "xla"}` keeps its JAX name: in the port it selects the library
route (`qgemm_library`, `qgemm_raw_library`: `torch._int_mm` on the card,
then the exact epilogue or the bias in plain torch), chosen only by a record
or by the caller, never as a fallback.

Zero points: a nonzero input zero point folds into the bias (acc(x - izp,
w) = x.w - izp * colsum(w), exact in int32 wraparound arithmetic).  The
quantizer and FQ2I emit a weight zero point of 0; legacy uint8 TFLite models
(TF1's quantization-aware converter) have uint8 data, uint8 weights with a
nonzero zero point kzp and uint8 outputs.  K1 and K4 take them: x may be
uint8 (the kernels read it unsigned), uint8 weights become int8 once per
tensor (w - 128 with kzp - 128: the same differences; `legacy_weights`),
and the kernel takes kzp[n] times each row's sum off its sums, the bias
carrying -izp colsum(w) + K izp kzp[n] (`fold_input_zero_point`); the
output may be uint8 (qmin 0, qmax 255, the same bytes).

K1's batched mode (`qbmm_rq`, `qbmm_raw`; `qbmm_int8` is the entry of
tk.bmm_rq and qnn.batch_matmul) runs a batch of products (a - za) @ (b - zb)
on a kernel of its own (`csrc/qbmm_hopper.cu`), the batch as the grid's y
dimension: the attention's scores q . k^T and context softmax . v.  Both
operands are activations, read in place through their strides
(`_bmm_launch`), never packed or cached.  `bmm_plan` picks its path: M <=
SMALL_M (the decode step) on CUDA cores with no 64-row tile, else `wgmma`
tiles of BM x BN with K staged whole where it fits; `_stage_mode` how each
operand reaches shared memory.  A zero point of -128 is flipped into its
operand (read as uint8); any other is folded from the staged tiles' sums.
Neither `torch.matmul` nor `torch._int_mm` takes a batched int8 product on
CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from ...tune.database import lookup_config
from ._lib import (BK, LAUNCHES, TILES, check_cuda_operands, compiled_blocks, launch,
                   pack_once, refuse_uint8, sm_count, tile_params)
from .requantize import channel_vector, epilogue_plain, out_torch_dtype

_TONEAREST = {"UPWARD": 0, "TONEAREST": 1}

KSTEP = BK             # the K step of K1's paths and K2-K4: a packed weight row
RQ_FILL = 2            # a split K1 (tiled) or K2 has about this many blocks per SM
RQ_UNSPLIT_STEPS = 9   # a call of at most this many K steps runs unsplit
RQ_MIN_STEPS = 4       # the fewest K steps a split walks
RQ_WIDE_FILL = 2       # the default tile is 128 rows where those tiles fill the SMs this many times
SKINNY_M = 64          # K1 runs its skinny path at M <= SKINNY_M (csrc/qgemm_rq.cu)
SKINNY_BN = 64         # output channels a skinny block (csrc SK_BN)
SKINNY_FILL = 4        # the skinny path's blocks: about this many per SM
SKINNY_MIN_STEPS = 2   # the fewest K steps a skinny split walks
PATHS = {"tiled": 0, "skinny": 1}
_KMAJOR: dict = {}
_UINT8_W: dict = {}    # uint8 weights as int8, w - 128, once per tensor
DATA_DTYPES = (torch.int8, torch.uint8)  # K1-K5's data operand


def matmul_workload(M: int, K: int, N: int, fused: bool) -> str:
    """Tuning-database key of a GEMM (`tachikoma_tpu/tune/tuner.py:28`)."""
    return f"qmatmul_int8/M{M}_K{K}_N{N}/{'fused' if fused else 'raw'}"


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """w (..., COUT), K the product of its other dimensions in their order
    ((KH, KW, CIN, COUT) of a conv, (K, N) of a GEMM), packed K-major, step
    by step, as (steps, COUT, 64): row (s, n) holds output channel n's
    weights at K indices 64 s .. 64 s + 63, zero past K.  The weight tile of
    a step (BN consecutive output channels) is then BN * 64 contiguous bytes,
    which K1, K2, K3 and K4's conv mode stage with 16-byte copies, a warp
    512 contiguous bytes, and no mask; made once per weight tensor
    (`pack_once`): a (1, 1, K, N) conv weight and its (K, N) view pack
    alike."""
    return pack_once(_KMAJOR, w, kmajor_pack)


def kmajor_pack(w: torch.Tensor) -> torch.Tensor:
    """`kmajor_weights`' packing, made anew on each call."""
    cout = w.shape[-1]
    k = w.numel() // cout
    steps = -(-k // KSTEP)
    flat = torch.zeros((cout, steps * KSTEP), dtype=torch.int8, device=w.device)
    flat[:, :k] = w.reshape(k, cout).t()
    return flat.reshape(cout, steps, KSTEP).transpose(0, 1).contiguous()


def rq_split(m: int, cout: int, k: int, tile=(64, 64), sms: int = 132) -> tuple[int, int]:
    """(splits, steps per split) of the implicit-GEMM body's requantize mode
    (K2, K1's tiled path) for an (M, K) x (K, COUT) product at the tile (BM,
    BN) on a card of `sms` SMs.  Unsplit where the tiles fill the SMs or K
    has at most RQ_UNSPLIT_STEPS steps of 64: a split costs the zeroing of
    the workspace, its atomics and the last block's read-back, more than it
    gains wherever every SM has a tile (tools/conv_probe.py on the H100: the
    28^2 calls of ResNet-50 b8, 196 tiles of 18 steps, ran faster unsplit).
    Else the fewest splits that bring the blocks to RQ_FILL * sms, with at
    least RQ_MIN_STEPS steps a split.  Split z walks steps [z*kper,
    min((z+1)*kper, steps)); every split is non-empty."""
    steps = -(-k // KSTEP)
    tiles = -(-m // tile[0]) * -(-cout // tile[1])
    if tiles >= sms or steps <= RQ_UNSPLIT_STEPS:
        return 1, steps
    ks = max(1, min(-(-RQ_FILL * sms // tiles), steps // RQ_MIN_STEPS))
    kper = -(-steps // ks)
    return -(-steps // kper), kper


def rq_tile(m: int, cout: int, sms: int = 132) -> tuple[int, int]:
    """The body's tile where neither the caller nor a record names one: 128
    rows (by 128 columns where COUT > 64, else 64) where those tiles fill the
    SMs RQ_WIDE_FILL times over; else 64 x 128 where COUT >= 256 and those
    tiles fill the SMs; else 64 x 64.  A wider tile stages fewer bytes per
    product, which set K2's pace on the H100 (tools/conv_probe.py --cuts:
    the copies, not wgmma or the epilogue); a narrow one keeps the SMs busy
    where the call is small."""
    bn = 128 if cout > 64 else 64
    if -(-m // 128) * -(-cout // bn) >= RQ_WIDE_FILL * sms:
        return 128, bn
    if cout >= 256 and -(-m // 64) * -(-cout // 128) >= sms:
        return 64, 128
    return 64, 64


def skinny_split(k: int, n: int, sms: int = 132) -> tuple[int, int]:
    """(splits, steps per split) of the skinny path: the fewest splits of K
    that bring its blocks (N / SKINNY_BN tiles, rounded up, times the
    splits) to SKINNY_FILL * sms, with at least SKINNY_MIN_STEPS steps a
    split; every split non-empty."""
    steps = -(-k // KSTEP)
    tiles = -(-n // SKINNY_BN)
    ks = max(1, min(-(-SKINNY_FILL * sms // tiles), steps // SKINNY_MIN_STEPS))
    kper = -(-steps // ks)
    return -(-steps // kper), kper


def gemm_plan(m: int, k: int, n: int, blocks=None, sms: int = 132) -> dict:
    """The launch of K1 and of K4's GEMM mode for an (M, K) x (K, N) call on
    a card of `sms` SMs: {"path": "skinny", "ks", "kper"} at M <= SKINNY_M
    (`skinny_split`; a tile in `blocks` is not read), else {"path": "tiled",
    "bm", "bn", "ks", "kper"} at `blocks`' tile or `rq_tile`'s, split as
    `rq_split` says where the tiles fill under half the SMs, else unsplit
    (tools/gemm_probe.py --plans on the H100: ResNet-50 b8's (1568, 1024,
    256) call, 100 tiles, ran in 0.0127 ms unsplit and 0.0189 split three
    ways; its (392, 2048, 512), 56 tiles, in 0.0173 split five ways and
    0.0220 unsplit).  K4's cheaper split (atomics into a zeroed output, no
    workspace or read-back) does not pay for a rule of its own
    (tools/gemm_probe.py --raw on the H100, ms per b1 forward): at
    ResNet-50's 37 calls this rule gave 0.2128, one splitting wherever the
    tiles fill at most a third of the SMs 0.2101 (MobileNetV2's 35 calls:
    0.1691 and 0.1617), and K4's conv-mode rule (`conv.raw_split`) 0.2492
    against this rule's 0.2427 in another run."""
    if m <= SKINNY_M:
        ks, kper = skinny_split(k, n, sms)
        return {"path": "skinny", "ks": ks, "kper": kper}
    bm, bn = rq_tile(m, n, sms) if blocks is None else (int(blocks[0]), int(blocks[1]))
    if 2 * -(-m // bm) * -(-n // bn) >= sms:
        ks, kper = 1, -(-k // KSTEP)
    else:
        ks, kper = rq_split(m, n, k, (bm, bn), sms)
    return {"path": "tiled", "bm": bm, "bn": bn, "ks": ks, "kper": kper}


def gemm_plans(m: int, k: int, n: int, sms: int = 132) -> list[dict]:
    """The launches K1 and K4's GEMM mode can make of one call: the tiled
    path at every tile of `_lib.TILES`, each at `rq_split`'s split and
    unsplit, and at M <= SKINNY_M the skinny path at `skinny_split`'s split,
    unsplit and at twice and half its splits (tools/gemm_probe.py --plans,
    the card tests)."""
    steps = -(-k // KSTEP)
    plans = []
    for bm, bn in TILES:
        ks, kper = rq_split(m, n, k, (bm, bn), sms)
        for ks_, kper_ in dict.fromkeys([(ks, kper), (1, steps)]):
            plans.append({"path": "tiled", "bm": bm, "bn": bn, "ks": ks_, "kper": kper_})
    if m <= SKINNY_M:
        ks, _ = skinny_split(k, n, sms)
        for want in dict.fromkeys([ks, 1, 2 * ks, max(1, ks // 2)]):
            kper = -(-steps // min(want, steps))
            plans.append({"path": "skinny", "ks": -(-steps // kper), "kper": kper})
    return plans


def split_covers(ks: int, kper: int, steps: int) -> bool:
    """Whether a split of ks ways, kper steps each, covers `steps` steps with
    every split non-empty (csrc igemm split_ok)."""
    return ks >= 1 and kper >= 1 and ks * kper >= steps and (ks - 1) * kper < steps


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """integer (M, K) @ integer (K, N) -> the int32 accumulator, through
    float64: with operands of at most 9 bits (int8, uint8, an int8 weight
    less its zero point) every partial sum is an integer of magnitude <= K *
    2^16 < 2^53, so the float64 product is exact in any summation order
    (torch has no integer matmul on CUDA, and on the CPU an int8 matmul
    wraps in int8)."""
    if a.shape[-1] >= 1 << 37:
        raise ValueError("reduction too deep for an exact float64 accumulator")
    acc = a.to(torch.float64) @ b.to(torch.float64)
    return acc.to(torch.int64).to(torch.int32)


def less_kzp(w: torch.Tensor, kzp) -> torch.Tensor:
    """w (..., N) less its zero point kzp (None, or int32 (N,) along the last
    axis) as int32: the weights the kernels' sums are of."""
    return w.to(torch.int32) if kzp is None else w.to(torch.int32) - kzp.to(torch.int32)


def qgemm_rq_plain(x, w, bias, mult, shift, *, rq_izp=0, out_zp=0, rounding="UPWARD",
                   qmin=-128, qmax=127, blocks=None, plan=None, w_src=None, kzp=None,
                   out_dtype="int8") -> torch.Tensor:
    """Plain PyTorch version of K1 (`blocks`, `plan` and `w_src` are the
    kernel's launch and weight cache: no effect)."""
    return epilogue_plain(exact_int_matmul(x, less_kzp(w, kzp)), bias, mult, shift, rq_izp,
                          out_zp, rounding, qmin, qmax, out_dtype)


def _gemm_launch(name: str, x: torch.Tensor, w: torch.Tensor, w_src, blocks, plan, kzp,
                 **vectors) -> tuple[dict, torch.Tensor, dict]:
    """The checks and launch parameters K1 and K4's GEMM mode share:
    the weight packed K-major once per tensor (w_src's where given), the
    operands checked (x int8 or uint8; `vectors`: the int32 (N,) bias,
    multiplier and shift, and kzp where given), the launch `plan`
    (`gemm_plan`'s where None) checked against K.  Returns (plan, packed
    weight, kernel parameters)."""
    m, k = x.shape
    n = w.shape[1]
    wk = kmajor_weights(w if w_src is None else w_src)
    if kzp is not None:
        vectors = dict(vectors, kzp=kzp)
    x_dtype = x.dtype if x.dtype in DATA_DTYPES else torch.int8
    check_cuda_operands(name, x.device, x=(x, x_dtype, (m, k)),
                        w=(w, torch.int8, (k, n)),
                        wk=(wk, torch.int8, (-(-k // KSTEP), n, KSTEP)),
                        **{key: (v, torch.int32, (n,)) for key, v in vectors.items()})
    if plan is None:
        plan = gemm_plan(m, k, n, blocks, sm_count(x.device.index))
    if not split_covers(plan["ks"], plan["kper"], -(-k // KSTEP)):
        raise ValueError(f"{name}: split {plan['ks']} x {plan['kper']} does not cover K {k}")
    if plan["path"] == "skinny" and m > SKINNY_M:
        raise ValueError(f"{name}: the skinny path takes M <= {SKINNY_M}, got {m}")
    params = dict(n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=n, oh=1, ow=1, sh=1, sw=1,
                  a_vec=k % 16 == 0 and x.data_ptr() % 16 == 0,
                  b_vec=k % 8 == 0 and x.data_ptr() % 8 == 0,
                  qg_path=PATHS[plan["path"]], bm=plan.get("bm", 0), bn=plan.get("bn", 0),
                  ks=plan["ks"], kper=plan["kper"], a_u8=x.dtype == torch.uint8)
    return plan, wk, params


def qgemm_rq(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             mult: torch.Tensor, shift: torch.Tensor, *, rq_izp: int = 0,
             out_zp: int = 0, rounding: str = "UPWARD", qmin: int = -128,
             qmax: int = 127, blocks=None, plan: dict | None = None,
             w_src: torch.Tensor | None = None, kzp: torch.Tensor | None = None,
             out_dtype: str = "int8") -> torch.Tensor:
    """K1: clip(q_multiply_shift(x @ (w - kzp) + bias - rq_izp, mult, shift)
    + out_zp, qmin, qmax) -> int8 (M, N), or uint8 with `out_dtype` "uint8".
    x int8 or uint8 (M, K), w int8 (K, N), bias / mult / shift int32 (N,);
    kzp None or the weights' zero point, int32 (N,); blocks (BM, BN, 64) a
    compiled tile (the tiled path's), None for `gemm_plan`'s; `plan` forces
    a launch as `gemm_plan` gives it; `w_src`: the stable tensor w is a view
    of ((1, 1, K, N)), packed in w's place (`kmajor_weights`, once per
    tensor); None packs w."""
    kw = dict(rq_izp=rq_izp, out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax, kzp=kzp,
              out_dtype=out_dtype)
    if blocks is not None:
        tile_params(blocks)  # a tile that is not built raises on every device
    if x.device.type == "cpu":
        return qgemm_rq_plain(x, w, bias, mult, shift, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm_rq: no kernel for device {x.device}")
    plan, wk, params = _gemm_launch("qgemm_rq", x, w, w_src, blocks, plan, kzp, bias=bias,
                                    mult=mult, shift=shift)
    m, n = x.shape[0], w.shape[1]
    out = torch.empty((m, n), dtype=out_torch_dtype(out_dtype), device=x.device)
    # a split adds its partial sums into zeros (M x N, then a counter an N
    # tile, or an (M, N) tile on the tiled path); unsplit, no workspace
    tiles = (-(-n // SKINNY_BN) if plan["path"] == "skinny"
             else -(-m // plan["bm"]) * -(-n // plan["bn"]))
    ws = (torch.zeros(m * n + tiles, dtype=torch.int32, device=x.device) if plan["ks"] > 1
          else out)
    launch("tk_qgemm_rq", [x, wk, out, bias, mult, shift, ws, kzp], params | dict(
        rq_izp=rq_izp, out_zp=out_zp, qmin=qmin, qmax=qmax, tonearest=_TONEAREST[rounding]))
    LAUNCHES["qgemm_rq"] += 1
    return out


def _tuned(m: int, k: int, n: int, fused: bool, blocks):
    """`blocks` as the caller gave it, or with blocks None what the active
    database's best record for the workload names: its tile, "xla", or None
    (no record, or blocks that are not a compiled tile: `gemm_plan`'s
    tile).  A string other than "xla" raises ValueError."""
    if blocks is None:
        cfg = lookup_config(matmul_workload(m, k, n, fused))
        if cfg and "blocks" in cfg and compiled_blocks(cfg["blocks"]):
            return tuple(cfg["blocks"])
        if cfg and cfg.get("impl") == "xla":
            return "xla"
    if isinstance(blocks, str) and blocks != "xla":
        raise ValueError(f"blocks {blocks!r}: a compiled tile or 'xla'")
    return blocks


def _library_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 product of the library route: `torch._int_mm` on the card
    (cuBLASLt; it refuses M <= 16, K or N not a multiple of 8, and some other
    shapes with a RuntimeError), `exact_int_matmul` on the CPU."""
    return torch._int_mm(x, w) if x.device.type == "cuda" else exact_int_matmul(x, w)


def qgemm_library(x, w, bias, mult, shift, *, rq_izp=0, out_zp=0, rounding="UPWARD",
                  qmin=-128, qmax=127, out_dtype="int8") -> torch.Tensor:
    """K1's function through the library route of the record `{"impl":
    "xla"}`: the library's int32 product, the exact epilogue in plain
    torch."""
    return epilogue_plain(_library_product(x, w), bias, mult, shift, rq_izp, out_zp, rounding,
                          qmin, qmax, out_dtype)


def _route(x, kzp, n: int, fused: bool, blocks):
    """`_tuned`'s blocks for an int8 call.  A call with uint8 data or a
    weight zero point reads no record and never takes the library route
    (`torch._int_mm`: int8 x int8 alone): it runs on K1 / K4 at the
    caller's tile, else `gemm_plan`'s; the caller's "xla" raises
    NotImplementedError."""
    if kzp is None and x.dtype == torch.int8:
        return _tuned(x.shape[0], x.shape[1], n, fused, blocks)
    if blocks == "xla":
        raise NotImplementedError("the library route takes int8 x int8 alone: uint8 data or a "
                                  "weight zero point runs on K1 / K4 (ROADMAP Queue 1 item 2)")
    if isinstance(blocks, str):
        raise ValueError(f"blocks {blocks!r}: a compiled tile or 'xla'")
    return blocks


def qgemm_rq_tuned(x, w, bias, mult, shift, *, rq_izp=0, out_zp=0, rounding="UPWARD",
                   qmin=-128, qmax=127, blocks=None, w_src=None, kzp=None,
                   out_dtype="int8") -> torch.Tensor:
    """K1 at `blocks`, or the library route for blocks == "xla"; with blocks
    None, what the active database's best record for the workload names
    (`_tuned`; uint8 data or a weight zero point: `_route`)."""
    blocks = _route(x, kzp, w.shape[1], True, blocks)
    kw = dict(rq_izp=rq_izp, out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax,
              out_dtype=out_dtype)
    if blocks == "xla":
        return qgemm_library(x, w, bias, mult, shift, **kw)
    return qgemm_rq(x, w, bias, mult, shift, blocks=blocks, w_src=w_src, kzp=kzp, **kw)


def _add_bias(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """acc + bias[n] in int32 wraparound."""
    return (acc.to(torch.int64) + bias.to(torch.int64)).to(torch.int32)


def qgemm_raw_plain(x, w, bias, *, blocks=None, plan=None, w_src=None,
                    kzp=None) -> torch.Tensor:
    """Plain PyTorch version of K4's GEMM mode (`blocks`, `plan` and `w_src`
    are the kernel's launch and weight cache: no effect)."""
    return _add_bias(exact_int_matmul(x, less_kzp(w, kzp)), bias)


def qgemm_raw(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, blocks=None,
              plan: dict | None = None, w_src: torch.Tensor | None = None,
              kzp: torch.Tensor | None = None) -> torch.Tensor:
    """K4, GEMM mode: x @ (w - kzp) + bias in int32 wraparound -> int32 (M,
    N).  x int8 or uint8 (M, K), w int8 (K, N), bias int32 (N,); kzp,
    blocks, plan and w_src as `qgemm_rq`'s.  A split adds its partial sums
    into a zeroed output, the bias with split 0."""
    if blocks is not None:
        tile_params(blocks)
    if x.device.type == "cpu":
        return qgemm_raw_plain(x, w, bias, kzp=kzp)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm_raw: no kernel for device {x.device}")
    plan, wk, params = _gemm_launch("qgemm_raw", x, w, w_src, blocks, plan, kzp, bias=bias)
    out = (torch.zeros if plan["ks"] > 1 else torch.empty)((x.shape[0], w.shape[1]),
                                                           dtype=torch.int32, device=x.device)
    launch("tk_qgemm_raw", [x, wk, out, bias, kzp], params)
    LAUNCHES["qgemm_raw"] += 1
    return out


def qgemm_raw_library(x, w, bias) -> torch.Tensor:
    """K4's GEMM mode through the library route of the record `{"impl":
    "xla"}`: the library's int32 product plus the bias in plain torch."""
    return _add_bias(_library_product(x, w), bias)


def qgemm_raw_tuned(x, w, bias, *, blocks=None, w_src=None, kzp=None) -> torch.Tensor:
    """K4's GEMM mode at `blocks`, or the library route for blocks == "xla";
    with blocks None, what the active database's best record for the raw
    workload names (`_tuned`), as the JAX package's `qmatmul_int8` without a
    multiplier reads it (uint8 data or a weight zero point: `_route`)."""
    blocks = _route(x, kzp, w.shape[1], False, blocks)
    if blocks == "xla":
        return qgemm_raw_library(x, w, bias)
    return qgemm_raw(x, w, bias, blocks=blocks, w_src=w_src, kzp=kzp)


def fold_input_zero_point(bias: torch.Tensor, w: torch.Tensor, izp: int,
                          kzp: torch.Tensor | None = None) -> torch.Tensor:
    """bias - izp * colsum(w) over all but the last axis, plus K * izp *
    kzp[n] with a weight zero point (K the product of w's other axes), in
    int32 wraparound: with the kernels' -kzp[n] rowsum(x_pad) the sum is
    that of (x - izp)(w - kzp)."""
    if not izp:
        return bias
    colsum = w.to(torch.int64).reshape(-1, w.shape[-1]).sum(dim=0)
    b = bias.to(torch.int64) - int(izp) * colsum
    if kzp is not None:
        b = b + (w.numel() // w.shape[-1]) * int(izp) * kzp.to(torch.int64)
    return b.to(torch.int32)


def legacy_weights(w: torch.Tensor, kernel_zero_point, device) -> tuple[torch.Tensor, object]:
    """(int8 weight, kzp) for the kernels from a weight w (..., N), int8 or
    uint8, and its zero point (a scalar or an (N,) array): uint8 weights as
    int8 w - 128, made once per tensor (`pack_once`), with kzp - 128 (the
    same differences w - kzp); kzp an int32 (N,) vector on `device`
    (`channel_vector`, cached), or None where it is 0 for every column."""
    n = w.shape[-1]
    zp = np.asarray(kernel_zero_point, np.int64).reshape(-1)
    if w.dtype == torch.uint8:
        w8 = pack_once(_UINT8_W, w, lambda t: (t.to(torch.int16) - 128).to(torch.int8))
        zp = zp - 128
    elif w.dtype == torch.int8:
        w8 = w
    else:
        raise NotImplementedError(f"weights of dtype {w.dtype}: the kernels take int8 or uint8 "
                                  "weights")
    return w8, (channel_vector(zp, n, device) if zp.any() else None)


def as_int32_vector(v, n: int, device) -> torch.Tensor:
    """A bias argument (None, numpy or tensor) as an int32 (n,) tensor."""
    if v is None:
        return torch.zeros(n, dtype=torch.int32, device=device)
    return torch.as_tensor(v).to(device=device, dtype=torch.int32).reshape(n)


def as_int8(v, device) -> torch.Tensor:
    """A weight argument (numpy or tensor) as a contiguous int8 tensor."""
    return torch.as_tensor(v).to(device=device, dtype=torch.int8).contiguous()


def as_weight(v, device) -> torch.Tensor:
    """A weight argument (numpy or tensor) as a contiguous int8 or uint8
    tensor (`legacy_weights` takes a uint8 one to int8)."""
    t = torch.as_tensor(v)
    if t.dtype == torch.uint8:
        return t.to(device=device).contiguous()
    return t.to(device=device, dtype=torch.int8).contiguous()


def check_data(kernel: str, x: torch.Tensor) -> None:
    """NotImplementedError unless x is int8 or uint8 (the kernels' data)."""
    if x.dtype not in DATA_DTYPES:
        raise NotImplementedError(f"{kernel}: data of dtype {x.dtype}: the kernels take int8 "
                                  "or uint8 data")


def qmatmul_int8(x, w, bias=None, multiplier=None, shift=None, out_zp: int = 0,
                 rounding: str = "UPWARD", out_dtype: str = "int8",
                 qmin: int = -128, qmax: int = 127, blocks=None, *,
                 input_zero_point: int = 0, rq_input_zero_point: int = 0,
                 kernel_zero_point=0):
    """x (M, K) int8 or uint8 @ w (K, N) int8 or uint8 -> requantized int8
    or uint8 (`out_dtype`) (M, N), bit-identical to the unfused qnn.dense +
    bias_add + qnn.requantize chain (the JAX package's entry of the same
    name, which takes legacy uint8 operands on XLA).  kernel_zero_point: a
    scalar or per-column (N,) array (`legacy_weights`); multiplier / shift:
    scalars or per-column (N,) arrays; blocks: a compiled tile (BM, BN, 64),
    "xla" (the library route: int8 operands with no weight zero point) or
    None (the tuning database's record for the workload, else `gemm_plan`'s
    tile); bad blocks raise ValueError.  Without a multiplier: the int32
    accumulator of (x - input_zero_point) @ (w - kernel_zero_point), plus
    bias (K4's GEMM mode, its tile and record read alike)."""
    if multiplier is not None:
        out_torch_dtype(out_dtype)
    check_data("qmatmul_int8", x)
    n = w.shape[1]
    dev = x.device
    w, kzp = legacy_weights(as_weight(w, dev), kernel_zero_point, dev)
    b = fold_input_zero_point(as_int32_vector(bias, n, dev), w, input_zero_point, kzp)
    if multiplier is None:
        return qgemm_raw_tuned(x.contiguous(), w, b.contiguous(), blocks=blocks, kzp=kzp)
    return qgemm_rq_tuned(x.contiguous(), w, b.contiguous(), channel_vector(multiplier, n, dev),
                          channel_vector(shift, n, dev), rq_izp=rq_input_zero_point,
                          out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax,
                          blocks=blocks, kzp=kzp, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# K1's batched mode: qnn.batch_matmul (raw) and tk.bmm_rq (requantized)
# ---------------------------------------------------------------------------

BMM_STAGES = {"kmajor16": 0, "kmajor": 1, "rows": 2}  # csrc/qbmm_hopper.cu Stage
BMM_PATHS = {"tiles": 0, "small": 1}                  # csrc/qbmm_hopper.cu Path
SMALL_M = 16          # the small path takes M <= SMALL_M (csrc S_MAX_M)
BMM_BN = (64, 256)    # the columns of a tile of the tiled path (n64 wgmma sub-tiles)


def bmm_kc(k: int) -> int:
    """The bytes of K a chunk of the tiled path, as the kernel derives them:
    K whole where it is at most 256 bytes (the least of 64, 128 and 256
    that holds it: D 64, S 128 and 197), else chunks of 256 bytes in two
    buffers (csrc/qbmm_hopper.cu make_args)."""
    return next((c for c in (64, 128) if k <= c), 256)


def bmm_plan(nb: int, m: int, k: int, n: int, sms: int = 132) -> dict:
    """The launch of a batched call of nb products (M, K) x (K, N).

    {"path": "small"} at M <= SMALL_M (the decode step's products at M =
    1): a warp a row and a group of columns, no `wgmma` and no 64-row tile.
    Else {"path": "tiles", "bm", "bn"}, from tools/bmm_probe.py --plans on
    the H100 (every tile at every call of the main path), K staged as
    `bmm_kc` says:
      * BN 256 where N is at most 256 but not a multiple of 16 and the
        products' 256-column tiles fill half the SMs (ViT-B/16 b8's N = 197:
        each row of the tile leaves whole, in aligned 16-byte stores; 19.9
        us a call against 21.4 at BN 64), or where N is 1024 or more (the
        ring's scores: A read from L2 a quarter as often; 94.9 against 100.7
        us at 2048 rows), else 64 (a thread requantizes 32 outputs, not
        128: BERT-base b4's scores 4.9 us against 8.4);
      * BM 128 where M > 64 and those tiles fill the SMs, or M is 1024 or
        more (the ring's context at 2048 rows: 65.5 against 72.1 us), else
        64."""
    if m <= SMALL_M:
        return {"path": "small"}
    bm = 128 if m > 64 and (nb * -(-m // 128) >= sms or m >= 1024) else 64
    whole_rows = 64 < n <= 256 and n % 16 and 2 * nb * -(-m // bm) >= sms
    bn = 256 if whole_rows or n >= 1024 else 64
    return {"path": "tiles", "bm": bm, "bn": bn}


def bmm_plans(m: int) -> list[dict]:
    """Every launch the batched mode can make of a call with M rows: the
    small path where it takes M, and the tiles at every BM and BN
    (tools/bmm_probe.py --plans, the card tests)."""
    plans = [{"path": "small"}] if m <= SMALL_M else []
    return plans + [{"path": "tiles", "bm": bm, "bn": bn} for bm in (64, 128) for bn in BMM_BN]


def _check_plan(name: str, plan: dict, m: int) -> None:
    """Raise for a plan the kernel does not take."""
    path = plan.get("path")
    if path == "small":
        if m > SMALL_M:
            raise ValueError(f"{name}: the small path takes M <= {SMALL_M}, got M {m}")
    elif path != "tiles" or plan.get("bm") not in (64, 128) or plan.get("bn") not in BMM_BN:
        raise ValueError(f"{name}: plan {plan} is not a launch of the kernel")


def _logical(a: torch.Tensor, b: torch.Tensor, transpose_a: bool, transpose_b: bool):
    """A as (..., M, K) and B as (..., K, N) views of the operands."""
    return (a.transpose(-1, -2) if transpose_a else a,
            b.transpose(-1, -2) if transpose_b else b)


def exact_int_bmm(a: torch.Tensor, b: torch.Tensor, lhs_zero_point: int = 0,
                  rhs_zero_point: int = 0, transpose_a: bool = False,
                  transpose_b: bool = False) -> torch.Tensor:
    """(a - lhs_zero_point) @ (b - rhs_zero_point), the operands' last two
    axes transposed as asked and their leading axes broadcast, -> int32 in
    wraparound, through float64: every product is at most 255^2, so the
    sums are exact integers below 2^53 (`exact_int_matmul`'s argument)."""
    x, y = _logical(a.to(torch.float64) - int(lhs_zero_point),
                    b.to(torch.float64) - int(rhs_zero_point), transpose_a, transpose_b)
    if x.shape[-1] >= 1 << 36:
        raise ValueError("reduction too deep for an exact float64 accumulator")
    return torch.matmul(x, y).to(torch.int64).to(torch.int32)


def qbmm_raw_plain(a, b, *, lhs_zero_point=0, rhs_zero_point=0, transpose_a=False,
                   transpose_b=False, plan=None) -> torch.Tensor:
    """Plain PyTorch version of K1's batched mode, raw (`plan` is the
    kernel's launch: no effect)."""
    return exact_int_bmm(a, b, lhs_zero_point, rhs_zero_point, transpose_a, transpose_b)


def qbmm_rq_plain(a, b, bias, mult, shift, *, lhs_zero_point=0, rhs_zero_point=0,
                  transpose_a=False, transpose_b=False, rq_izp=0, out_zp=0, rounding="UPWARD",
                  qmin=-128, qmax=127, plan=None) -> torch.Tensor:
    """Plain PyTorch version of K1's batched mode, requantizing."""
    acc = exact_int_bmm(a, b, lhs_zero_point, rhs_zero_point, transpose_a, transpose_b)
    return epilogue_plain(acc, bias, mult, shift, rq_izp, out_zp, rounding, qmin, qmax)


def _merge_batch(batch, sa, sb):
    """The batch axes of two operands as two (size, a stride, b stride)
    triples, adjacent axes merged where both operands' strides allow it;
    None where more than two remain."""
    merged = []
    for n, x, y in zip(batch, sa, sb):
        if n == 1:
            continue
        if merged and merged[-1][1] == x * n and merged[-1][2] == y * n:
            merged[-1] = (merged[-1][0] * n, x, y)
        else:
            merged.append((n, x, y))
    if len(merged) > 2:
        return None
    return [(1, 0, 0)] * (2 - len(merged)) + merged


def _stage_mode(t: torch.Tensor, sr: int, sk: int, rows: int, sbs) -> str | None:
    """How the kernel stages an operand whose element (r, k) sits at r sr + k
    sk (`BMM_STAGES`): "kmajor16" (16-byte cp.async copies; a zero point of
    -128 flipped in shared memory once they land) where k is contiguous and
    every row starts 16-byte aligned; "kmajor" (aligned 16-byte loads
    realigned in registers) where k is contiguous otherwise (the softmax
    output's 197-byte rows); "rows" (16 rows of one k a load, transposed in
    registers) where the rows are contiguous (v); None where neither is
    (the operand is copied first)."""
    if sk == 1:
        aligned = (t.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in sbs)
                   and (rows == 1 or sr % 16 == 0))
        return "kmajor16" if aligned else "kmajor"
    return "rows" if sr == 1 else None


def _bmm_launch(name: str, a: torch.Tensor, b: torch.Tensor, lhs_zero_point: int,
                rhs_zero_point: int, transpose_a: bool, transpose_b: bool, plan):
    """The operands and parameters of a batched launch: the batch axes
    broadcast and merged (the operands copied as they are laid out where
    more than two would remain), the plan (`bmm_plan`'s where None), each
    operand's strides and staging mode (an operand that no mode takes, or
    an A with its rows contiguous on the small path, copied contiguous
    first), the zero points (the kernel flips a -128 into its operand and
    folds any other: -za colsum(B) - zb rowsum(A) + K za zb).  Returns
    (output shape, A, B, parameters)."""
    for key, t in (("a", a), ("b", b)):
        if t.dtype != torch.int8:
            raise NotImplementedError(f"{name}: {key} is {t.dtype}; the kernel takes int8 x int8")
        if t.device != a.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {a.device}")
    za, zb = int(lhs_zero_point), int(rhs_zero_point)
    A, B = _logical(a, b, transpose_a, transpose_b)
    m, k = A.shape[-2:]
    if B.shape[-2] != k:
        raise ValueError(f"{name}: K mismatch {tuple(A.shape)} x {tuple(B.shape)}")
    n = B.shape[-1]
    batch = tuple(torch.broadcast_shapes(A.shape[:-2], B.shape[:-2]))
    A, B = A.expand(batch + (m, k)), B.expand(batch + (k, n))
    nb = int(np.prod(batch)) if batch else 1
    if nb > 65535:
        raise ValueError(f"{name}: {nb} products, the kernel takes at most 65535")
    if plan is None:
        plan = bmm_plan(nb, m, k, n, sm_count(a.device.index))
    _check_plan(name, plan, m)
    while True:
        dims = _merge_batch(batch, A.stride()[:-2], B.stride()[:-2])
        if dims is None:  # the operands copied as they are laid out, broadcast
            A, B = _logical(a.expand(batch + tuple(a.shape[-2:])).contiguous(),
                            b.expand(batch + tuple(b.shape[-2:])).contiguous(),
                            transpose_a, transpose_b)
            dims = _merge_batch(batch, A.stride()[:-2], B.stride()[:-2])
        (n0, a0, b0), (n1, a1, b1) = dims
        a_sm, a_sk = A.stride()[-2:]
        b_sk, b_sn = B.stride()[-2:]
        # a size-1 axis's stride is never read: the one that names a mode
        a_sk, b_sk = (1, 1) if k == 1 else (a_sk, b_sk)
        a_sm, b_sn = 1 if m == 1 else a_sm, 1 if n == 1 else b_sn
        a_mode = _stage_mode(A, a_sm, a_sk, m, (a0, a1))
        b_mode = _stage_mode(B, b_sn, b_sk, n, (b0, b1))
        copy_a = a_mode is None or (plan["path"] == "small" and a_mode == "rows")
        if not copy_a and b_mode is not None:
            break
        A = A.contiguous() if copy_a else A
        B = B.contiguous() if b_mode is None else B
    strides = dict(a_sb0=a0, a_sb1=a1, a_sm=a_sm, a_sk=a_sk, b_sb0=b0, b_sb1=b1, b_sn=b_sn,
                   b_sk=b_sk)
    if any(abs(v) >= 1 << 31 for v in strides.values()):
        raise ValueError(f"{name}: strides {strides} do not fit the kernel's int32 parameters")
    params = dict(n=m, cin=k, cout=n, bmm_path=BMM_PATHS[plan["path"]], bm=plan.get("bm", 0),
                  bn=plan.get("bn", 0), bmm_nb=n0 * n1, bmm_nb1=n1,
                  a_mode=BMM_STAGES[a_mode], b_mode=BMM_STAGES[b_mode], bmm_za=za, bmm_zb=zb,
                  **strides)
    return batch + (m, n), A, B, params


def launch_summary(name: str, a: torch.Tensor, b: torch.Tensor, *, lhs_zero_point: int = 0,
                   rhs_zero_point: int = 0, transpose_a: bool = False,
                   transpose_b: bool = False, plan: dict | None = None, **_) -> str:
    """The launch of one batched call as `_bmm_launch` makes it: the path
    and tile, the chunks of K, the products, each operand's staging mode and
    which operands are read as uint8 (a zero point of -128 flipped in)."""
    _, _, _, p = _bmm_launch(name, a, b, lhs_zero_point, rhs_zero_point, transpose_a,
                             transpose_b, plan)
    stages = {v: key for key, v in BMM_STAGES.items()}
    if p["bmm_path"] == BMM_PATHS["small"]:
        head = f"small M {p['n']}"
    else:
        kc = bmm_kc(p["cin"])
        head = f"tiles {p['bm']}x{p['bn']} kc {kc} ({-(-p['cin'] // kc)} chunks)"
    u8 = "".join(s for s, z in (("A", lhs_zero_point), ("B", rhs_zero_point)) if z == -128)
    return (f"{head}, {p['bmm_nb']} products, A {stages[p['a_mode']]}, B {stages[p['b_mode']]}"
            + (f", u8 {u8}" if u8 else ""))


def qbmm_rq(a: torch.Tensor, b: torch.Tensor, bias, mult: torch.Tensor, shift: torch.Tensor, *,
            lhs_zero_point: int = 0, rhs_zero_point: int = 0, transpose_a: bool = False,
            transpose_b: bool = False, rq_izp: int = 0, out_zp: int = 0,
            rounding: str = "UPWARD", qmin: int = -128, qmax: int = 127,
            plan: dict | None = None) -> torch.Tensor:
    """K1's batched mode: clip(q_multiply_shift((a - za) @ (b - zb) + bias -
    rq_izp, mult, shift) + out_zp, qmin, qmax) -> int8 (batch..., M, N), the
    products batched over the broadcast leading axes, each operand read in
    place through its strides (a head-split view, `v` N-major), the zero
    points applied in the kernel.  bias None or int32 (N,), mult / shift
    int32 (N,); `plan` (as `bmm_plan` gives it) forces a launch, else
    `bmm_plan`'s."""
    kw = dict(lhs_zero_point=lhs_zero_point, rhs_zero_point=rhs_zero_point,
              transpose_a=transpose_a, transpose_b=transpose_b, rq_izp=rq_izp, out_zp=out_zp,
              rounding=rounding, qmin=qmin, qmax=qmax)
    refuse_uint8("qbmm_rq", a, b)
    if a.device.type == "cpu":
        return qbmm_rq_plain(a, b, bias, mult, shift, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"qbmm_rq: no kernel for device {a.device}")
    shape, A, B, params = _bmm_launch("qbmm_rq", a, b, lhs_zero_point, rhs_zero_point,
                                      transpose_a, transpose_b, plan)
    n = shape[-1]
    bias = channel_vector(0, n, a.device) if bias is None else bias
    check_cuda_operands("qbmm_rq", a.device, bias=(bias, torch.int32, (n,)),
                        mult=(mult, torch.int32, (n,)), shift=(shift, torch.int32, (n,)))
    out = torch.empty(shape, dtype=torch.int8, device=a.device)
    launch("tk_qbmm_rq", [A, B, out, bias, mult, shift], params | dict(
        rq_izp=rq_izp, out_zp=out_zp, qmin=qmin, qmax=qmax, tonearest=_TONEAREST[rounding]))
    LAUNCHES["qbmm_rq"] += 1
    return out


def qbmm_raw(a: torch.Tensor, b: torch.Tensor, *, lhs_zero_point: int = 0,
             rhs_zero_point: int = 0, transpose_a: bool = False, transpose_b: bool = False,
             plan: dict | None = None) -> torch.Tensor:
    """K1's batched mode in the RAW epilogue: (a - za) @ (b - zb) -> int32
    (batch..., M, N) in wraparound (the unfused qnn.batch_matmul of the
    trace path); operands and `plan` as `qbmm_rq`'s."""
    kw = dict(lhs_zero_point=lhs_zero_point, rhs_zero_point=rhs_zero_point,
              transpose_a=transpose_a, transpose_b=transpose_b)
    refuse_uint8("qbmm_raw", a, b)
    if a.device.type == "cpu":
        return qbmm_raw_plain(a, b, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"qbmm_raw: no kernel for device {a.device}")
    shape, A, B, params = _bmm_launch("qbmm_raw", a, b, lhs_zero_point, rhs_zero_point,
                                      transpose_a, transpose_b, plan)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    launch("tk_qbmm_raw", [A, B, out, channel_vector(0, shape[-1], a.device)], params)
    LAUNCHES["qbmm_raw"] += 1
    return out


def qbmm_int8(a, b, bias=None, multiplier=None, shift=None, *, lhs_zero_point: int = 0,
              rhs_zero_point: int = 0, transpose_a: bool = False, transpose_b: bool = False,
              out_zp: int = 0, rounding: str = "UPWARD", qmin: int = -128, qmax: int = 127,
              rq_input_zero_point: int = 0) -> torch.Tensor:
    """The entry of tk.bmm_rq and qnn.batch_matmul: (a - za) @ (b - zb), the
    leading axes broadcast, requantized to int8 with `multiplier` / `shift`
    (scalars or per-column (N,) lists; `bias` int32 (N,) or None) by
    `qbmm_rq`, or without a multiplier the int32 accumulator by `qbmm_raw`."""
    kw = dict(lhs_zero_point=lhs_zero_point, rhs_zero_point=rhs_zero_point,
              transpose_a=transpose_a, transpose_b=transpose_b)
    if multiplier is None:
        if bias is not None:
            raise NotImplementedError("qbmm_int8: a bias without a requantize is not ported")
        return qbmm_raw(a, b, **kw)
    n = b.shape[-2] if transpose_b else b.shape[-1]
    return qbmm_rq(a, b, None if bias is None else as_int32_vector(bias, n, a.device),
                   channel_vector(multiplier, n, a.device), channel_vector(shift, n, a.device),
                   rq_izp=rq_input_zero_point, out_zp=out_zp, rounding=rounding, qmin=qmin,
                   qmax=qmax, **kw)
