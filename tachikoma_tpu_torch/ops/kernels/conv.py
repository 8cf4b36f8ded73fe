"""K2 and K3: NHWC int8 convolution with the exact requantize epilogue, and
the conv entries of the int8 path (port of
`tachikoma_tpu/ops/pallas/conv_flat.py`).

  * `qconv_rq` (K2) wraps `csrc/qconv_igemm_hopper.cu tk_qconv_rq`: an
    implicit-GEMM conv on `wgmma` with any stride and padding; taps outside
    the image read the input zero point.  Where the tiles leave the card
    idle, K is split across blocks (`rq_split`): the splits add into a
    zeroed int32 workspace and the last block of a tile to arrive
    requantizes the complete sum.
  * `qconv_rq_res` (K3) wraps `tk_qconv_rq_res`, the same body: the stride-1
    conv, whose epilogue then applies the fused residual `qnn.add` (as two
    256-entry tables in the kernel, `res_add_tables`).
  * `qconv_raw` (K4, conv mode) wraps `tk_qconv_raw`, the same body: the
    conv at any stride, storing the int32 accumulator plus bias, no
    requantize (the `fuse=False` branch of the TPU kernel), with K split
    across blocks where the tiles do not fill the card (`raw_split`).
    The three kernels take the weights packed K-major as (COUT, Kp)
    (`kmajor_weights`).
  * `qconv2d_flat`: 1x1 convs go to K1 (or, without a multiplier, K4's GEMM
    mode, on K1's two paths) as a GEMM (`_conv1x1_matmul`), every other kernel
    size, the 7x7 s2
    stem included, to K2 (or K4's conv mode) or, by `layout`, to one of
    K7-K10 (`conv_layouts.py`); depthwise convs (groups == C) to K5
    (`depthwise.py`: `qdwconv_rq`, or `qdwconv_raw` without a multiplier).
    Dilated convs (but a 1x1's, whose dilation is a no-op) and grouped convs
    other than depthwise go to K2 or K4's conv mode, which take the dilation
    and run a grouped conv as one dense conv a super-group of its groups
    (`group_span`), its weights expanded block-diagonally (`grouped_weights`);
    they read no K7-K10 layout.
  * Legacy uint8 models (TF1's quantization-aware converter): uint8 data,
    weights with a nonzero zero point (uint8 ones arrive as int8 w - 128,
    `legacy_weights`) and uint8 outputs run on K1 (1x1), K5 (depthwise) or
    K2 / K4, which read the data unsigned and take kzp[n] times the row
    sums of the staged data off their sums (`csrc/igemm_hopper.cuh`); like
    a dilated conv they read no layout and no database record.  Any other
    kernel refuses them (NotImplementedError, ROADMAP Queue 1 item 2).
  * `qconv2d_flat_chain` / `qconv2d_flat_block_stack` run a chain or a stack
    of residual blocks stage by stage: the last stage of each residual block
    launches K3, the others K1 (1x1) or K2.

Tuning: K1-K3 and K7-K10 take a block tile `blocks` = (BM, BN, 64) from
`_lib.TILES`.  Left None, the entries read the active tuning database (the
`apply_history_best` context, else `$TK_TUNE_DB`) under the JAX package's
workload keys (`flat_conv_workload`, `chain_workload`, `stack_workload`; a
1x1 conv's GEMM reads `matmul_workload`), and fall back to 64 x 64 when no
record names a compiled tile.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its kernel or raises.  K2-K4 read NHWC directly and take the
stride themselves; only the layouts K7-K10 build the TPU package's flat,
polyphase-stacked frame, because their data paths are defined on it.  Width
packing and VMEM budgets have no counterpart.
"""

from __future__ import annotations

import torch

from ...tune.database import lookup_config
from ._lib import (BK, DEFAULT_BLOCKS, LAUNCHES, LEGACY_ITEM, TILES, check_cuda_operands,
                   check_fill, compiled_blocks, launch, pack_once, refuse_uint8, sm_count,
                   tile_params)
from .conv_layouts import LAYOUTS, layout_fits, qconv_rq_r, qconv_rq_s, qconv_rq_t, qconv_rq_w
from .depthwise import qdwconv_raw, qdwconv_rq
# the body's plan and weight packing, shared with K1's tiled path
from .matmul_int8 import (_KMAJOR, _TONEAREST, KSTEP, RQ_FILL, RQ_MIN_STEPS,  # noqa: F401
                          RQ_UNSPLIT_STEPS, RQ_WIDE_FILL, as_int8, as_int32_vector, as_weight,
                          check_data, fold_input_zero_point, kmajor_pack, kmajor_weights,
                          legacy_weights, less_kzp, qgemm_raw_tuned, qgemm_rq_tuned, rq_split,
                          rq_tile)
from .requantize import (channel_vector, epilogue_plain, out_torch_dtype, plan_res_add,
                         res_add_plain)


def flat_conv_workload(n, h, w, cin, cout, kh, kw, strides, fuse, groups: int = 1,
                       dilation=(1, 1)) -> str:
    """Tuning-database key of a conv (`conv_flat.py:1264`); a dilated conv's
    key adds `_D{dh}x{dw}` (the reference keys undilated convs alone), so no
    record tuned for an undilated conv of the same shapes is applied to it."""
    sh, sw = strides
    dh, dw = dilation
    g = f"_G{groups}" if groups != 1 else ""
    d = f"_D{dh}x{dw}" if (dh, dw) != (1, 1) else ""
    return (f"qconv2d_flat/N{n}_H{h}_W{w}_C{cin}_O{cout}_K{kh}x{kw}"
            f"_S{sh}x{sw}{d}{g}{'_rq' if fuse else ''}")


def chain_workload(n, h, w, stage_dims) -> str:
    """Tuning-database key of a conv chain: stage_dims = [(kh, cin, cout), ...]
    (`conv_flat.py:1973`)."""
    stages = "+".join(f"K{kh}C{ci}O{co}" for (kh, ci, co) in stage_dims)
    return f"qconv2d_chain/N{n}_H{h}_W{w}/{stages}"


def stack_workload(n, h, w, block_dims) -> str:
    """Tuning-database key of a residual-block stack: block_dims =
    [[(kh, cin, cout), ...] per block] (`conv_flat.py:1979`)."""
    blocks = "|".join("+".join(f"K{kh}C{ci}O{co}" for (kh, ci, co) in b) for b in block_dims)
    return f"qconv2d_stack/N{n}_H{h}_W{w}/{blocks}"


# layout -> the name of its wrapper in this module, looked up at each call
# (as K2's `qconv_rq` is), so that a recording hook can wrap it
LAYOUT_KERNELS = {"t": "qconv_rq_t", "s": "qconv_rq_s", "w": "qconv_rq_w", "r": "qconv_rq_r"}


def _out_hw(x_shape, w_shape, strides, padding, dilation=(1, 1)):
    _, h, wd, _ = x_shape
    kh, kw = w_shape[:2]
    sh, sw = strides
    dh, dw = dilation
    pt, pl, pb, pr = padding
    return ((h + pt + pb - (kh - 1) * dh - 1) // sh + 1,
            (wd + pl + pr - (kw - 1) * dw - 1) // sw + 1)


def conv_acc_plain(x, w, strides, padding, izp, dilation=(1, 1), groups=1,
                   kzp=None) -> torch.Tensor:
    """int32 accumulator of qnn.conv2d, sum (x_pad - izp) * (w - kzp) with the
    border padded by izp, in float64 (exact, see `exact_int_matmul`)."""
    return conv_acc_exact(x, w, strides, padding, izp, dilation, groups, kzp).to(torch.int32)


def conv_acc_exact(x, w, strides, padding, izp, dilation=(1, 1), groups=1,
                   kzp=None) -> torch.Tensor:
    """`conv_acc_plain`'s sum in int64: exact while every partial sum stays
    below 2^53 (int8, uint8 or int16 x, int8 w, less kzp: None or int32
    (COUT,)).  w is (KH, KW, CIN / groups, COUT), group g's outputs COUT /
    groups channels from g * COUT / groups on."""
    n = x.shape[0]
    kh, kw, cin, cout = w.shape
    w = less_kzp(w, kzp)
    sh, sw = strides
    pt, pl, pb, pr = padding
    xp = torch.nn.functional.pad(x.to(torch.float64) - float(izp), (0, 0, pl, pr, pt, pb))
    if tuple(dilation) != (1, 1) or groups != 1:
        return _taps_acc(xp, w.to(torch.float64), strides, dilation, groups,
                         _out_hw(x.shape, w.shape, strides, padding, dilation))
    cols = xp.unfold(1, kh, sh).unfold(2, kw, sw)      # (n, oh, ow, cin, kh, kw)
    oh, ow = cols.shape[1], cols.shape[2]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, kh * kw * cin)
    acc = cols @ w.to(torch.float64).reshape(kh * kw * cin, cout)
    return acc.to(torch.int64).reshape(n, oh, ow, cout)


def _taps_acc(xp, wd, strides, dilation, groups, out_hw) -> torch.Tensor:
    """The dilated or grouped sum of `conv_acc_exact` over the padded float64
    image xp, tap by tap: each tap's (N, OH, OW, CIN) window times its
    (CIN / groups, COUT) weights, a batched product over the groups.  Every
    partial sum is an integer below 2^53, so the order does not matter."""
    kh, kw, cin_g, cout = wd.shape
    sh, sw = strides
    dh, dw = dilation
    oh, ow = out_hw
    n = xp.shape[0]
    cout_g = cout // groups
    acc = torch.zeros((n * oh * ow, groups, cout_g), dtype=torch.float64, device=xp.device)
    for ky in range(kh):
        for kx in range(kw):
            win = xp[:, ky * dh:ky * dh + (oh - 1) * sh + 1:sh,
                     kx * dw:kx * dw + (ow - 1) * sw + 1:sw, :]
            a = win.reshape(n * oh * ow, groups, cin_g).transpose(0, 1)   # (G, M, CIN/G)
            b = wd[ky, kx].reshape(cin_g, groups, cout_g).transpose(0, 1)  # (G, CIN/G, COUT/G)
            acc += torch.bmm(a, b).transpose(0, 1)
    return acc.to(torch.int64).reshape(n, oh, ow, cout)


def group_span(groups: int, cout_g: int, bn: int) -> int:
    """The groups a super-group of a grouped conv on K2 or K4's conv mode
    holds at the N tile `bn`: the fewest (a divisor of `groups`) whose output
    channels are a multiple of `bn`, so that no N tile straddles two
    super-groups; else all of them (one dense conv of the whole)."""
    return next((s for s in range(1, groups + 1)
                 if groups % s == 0 and s * cout_g % bn == 0), groups)


def expand_groups(w: torch.Tensor, groups: int, span: int) -> torch.Tensor:
    """A grouped weight (KH, KW, CIN / groups, COUT) expanded block-diagonally
    to (KH, KW, span * CIN / groups, COUT): output channel n of group g reads
    the channels of g's place in its super-group of `span` groups, zero
    elsewhere.  Column sums are the group's own."""
    kh, kw, cin_g, cout = w.shape
    cout_g = cout // groups
    sgs = groups // span
    w6 = w.reshape(kh, kw, cin_g, sgs, span, cout_g)
    we = torch.zeros((kh, kw, span, cin_g, sgs, span, cout_g), dtype=w.dtype, device=w.device)
    for s in range(span):
        we[:, :, s, :, :, s, :] = w6[:, :, :, :, s, :]
    return we.reshape(kh, kw, span * cin_g, cout)


_GROUPED: dict = {}  # span -> the packing cache of that span


def grouped_weights(w: torch.Tensor, groups: int, span: int) -> torch.Tensor:
    """`expand_groups(w, groups, span)` packed K-major (`kmajor_pack`), made
    once per weight tensor and span (`pack_once`)."""
    return pack_once(_GROUPED.setdefault(span, {}), w,
                     lambda w: kmajor_pack(expand_groups(w, groups, span)))


def _geometry(x_shape, w_shape, bn: int, groups: int) -> tuple[int, int]:
    """(K, span) of a K2 / K4 call at the N tile `bn`: the super-group's
    groups `span` (1 for a dense conv) and K = KH * KW * its channels."""
    kh, kw, cin_g, cout = w_shape
    span = group_span(groups, cout // groups, bn) if groups != 1 else 1
    return kh * kw * span * cin_g, span


def _packed(w, groups: int, span: int) -> torch.Tensor:
    return kmajor_weights(w) if groups == 1 else grouped_weights(w, groups, span)


def _conv_params(x, w, out, strides, padding, izp, rq_izp, out_zp, rounding, qmin, qmax,
                 dilation=(1, 1), cspan=0):
    """The kernel parameters of a K2 / K3 / K4 call; `cspan` the input
    channels of a grouped conv's super-group (0: dense)."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    a_span = cspan or cin
    return dict(n=n, h=h, w=wd, cin=cin, kh=kh, kw=kw, cout=cout, oh=out.shape[1],
                ow=out.shape[2], sh=strides[0], sw=strides[1], pt=padding[0],
                pl=padding[1], izp=izp, rq_izp=rq_izp, out_zp=out_zp, qmin=qmin,
                qmax=qmax, tonearest=_TONEAREST[rounding],
                a_vec=cin % 16 == 0 and a_span % 16 == 0 and x.data_ptr() % 16 == 0,
                b_vec=cout % 4 == 0 and w.data_ptr() % 4 == 0, dh=dilation[0],
                dw=dilation[1], cspan=cspan, a_u8=x.dtype == torch.uint8)


def _check_conv(kernel, x, w, bias, mult, shift, out_shape, residual=None, groups=1, kzp=None):
    i32 = torch.int32
    kh, kw, cin, cout = w.shape
    if groups < 1 or cout % groups:
        raise ValueError(f"{kernel}: groups {groups} do not divide COUT {cout}")
    x_dtype = x.dtype if x.dtype in (torch.int8, torch.uint8) and residual is None else torch.int8
    ops = dict(x=(x, x_dtype, (*x.shape[:3], cin * groups)),
               w=(w, torch.int8, (kh, kw, cin, cout)),
               bias=(bias, i32, (cout,)), mult=(mult, i32, (cout,)), shift=(shift, i32, (cout,)))
    if kzp is not None:
        ops["kzp"] = (kzp, i32, (cout,))
    if residual is not None:
        ops["residual"] = (residual, torch.int8, out_shape)
    check_cuda_operands(kernel, x.device, **ops)
    if x.ndim != 4 or min(out_shape) <= 0:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")


def qconv_rq_plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0),
                   izp=0, rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                   blocks=None, dilation=(1, 1), groups=1, kzp=None, out_dtype="int8"):
    """Plain PyTorch version of K2 (`blocks` is the kernel's tile: no effect)."""
    acc = conv_acc_plain(x, w, strides, padding, izp, dilation, groups, kzp)
    return epilogue_plain(acc, bias, mult, shift, rq_izp, out_zp, rounding, qmin, qmax,
                          out_dtype)


def _grouped_kzp(kernel: str, groups: int, kzp) -> None:
    """A grouped conv with a weight zero point raises: K2 / K4 run it as a
    dense conv of a super-group, whose row sums span its other groups'
    channels too."""
    if groups != 1 and kzp is not None:
        raise NotImplementedError(f"{kernel}: a grouped conv with a weight zero point is not "
                                  f"ported ({LEGACY_ITEM})")


def qconv_rq(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
             rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
             blocks=None, dilation=(1, 1), groups=1, kzp=None, out_dtype="int8") -> torch.Tensor:
    """K2: x int8 or uint8 NHWC, w int8 HWIO (KH, KW, CIN / groups, COUT),
    bias / mult / shift int32 (COUT,); kzp None or the weights' zero point,
    int32 (COUT,) (an undilated or dilated dense conv); padding (top, left,
    bottom, right); dilation (dh, dw); blocks (BM, BN, 64) a compiled tile,
    None for `rq_tile`'s -> int8 (or uint8, `out_dtype`) NHWC.  K is split
    as `rq_split` says; a grouped conv runs a super-group of `group_span`
    groups as one dense conv."""
    dilation = tuple(dilation)
    kw = dict(strides=strides, padding=padding, izp=izp, rq_izp=rq_izp, out_zp=out_zp,
              rounding=rounding, qmin=qmin, qmax=qmax, dilation=dilation, groups=groups,
              kzp=kzp, out_dtype=out_dtype)
    if blocks is not None:
        tile_params(blocks)  # a tile that is not built raises on every device
    _grouped_kzp("qconv_rq", groups, kzp)
    check_fill("qconv_rq", x, izp, padding)
    if x.device.type == "cpu":
        return qconv_rq_plain(x, w, bias, mult, shift, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_rq: no kernel for device {x.device}")
    oh, ow = _out_hw(x.shape, w.shape, strides, padding, dilation)
    out_shape = (x.shape[0], oh, ow, w.shape[3])
    _check_conv("qconv_rq", x, w, bias, mult, shift, out_shape, groups=groups, kzp=kzp)
    out = torch.empty(out_shape, dtype=out_torch_dtype(out_dtype), device=x.device)
    bias = fold_input_zero_point(bias, w, izp, kzp)
    (bm, bn), ks, kper = rq_launch(tuple(x.shape), tuple(w.shape), strides, padding, blocks,
                                   sm_count(x.device.index), dilation, groups)
    span = _geometry(tuple(x.shape), tuple(w.shape), bn, groups)[1]
    m, cout = out_shape[0] * oh * ow, w.shape[3]
    # a split adds its partial sums into zeros (M x COUT, then a counter a
    # tile); unsplit, the kernel reads no workspace
    ws = (torch.zeros(m * cout + -(-m // bm) * -(-cout // bn), dtype=torch.int32,
                      device=x.device) if ks > 1 else out)
    launch("tk_qconv_rq", [x, _packed(w, groups, span), out, bias, mult, shift, ws, kzp],
           _conv_params(x, w, out, strides, padding, izp, rq_izp, out_zp, rounding, qmin, qmax,
                        dilation, span * w.shape[2])
           | dict(bm=bm, bn=bn, ks=ks, kper=kper))
    LAUNCHES["qconv_rq"] += 1
    return out


RAW_TILE = (64, 64)    # K4's conv-mode tile
RAW_UNSPLIT_STEPS = 9  # a K4 conv of at most this many K steps runs unsplit
RAW_SPLIT_STEPS = 6    # the K steps a split of K4 walks, where it splits


def raw_split(m: int, cout: int, k: int, sms: int = 132) -> tuple[int, int]:
    """(splits, steps per split) of K4's conv mode for an (M, K) x (K, COUT)
    conv on a card of `sms` SMs.  Unsplit where the 64 x 64 tiles fill the
    SMs or K has at most RAW_UNSPLIT_STEPS steps of 64: a split costs the
    zeroing of the output and its atomics, about what three or four steps
    cost (tools/igemm_probe.py on the H100).  Else about RAW_SPLIT_STEPS
    steps a split, with at most two blocks an SM.  Split z walks steps
    [z*kper, min((z+1)*kper, steps)); every split is non-empty."""
    steps = -(-k // KSTEP)
    tiles = -(-m // RAW_TILE[0]) * -(-cout // RAW_TILE[1])
    if tiles >= sms or steps <= RAW_UNSPLIT_STEPS:
        return 1, steps
    ks = min(-(-steps // RAW_SPLIT_STEPS), max(1, 2 * sms // tiles))
    kper = -(-steps // ks)
    return -(-steps // kper), kper


GROUPED_BN = 64  # the N tile of K2's grouped calls where no tile is asked for


def rq_launch(x_shape, w_shape, strides, padding, blocks=None, sms: int = 132,
              dilation=(1, 1), groups: int = 1):
    """((BM, BN), splits, steps per split) of one K2 call: `blocks`' tile, or
    `rq_tile`'s (with GROUPED_BN columns for a grouped conv: a super-group
    of fewer groups wastes fewer zero products), and `rq_split`'s split of K
    at that tile (a grouped conv's K is its super-group's, `_geometry`)."""
    oh, ow = _out_hw(x_shape, w_shape, strides, padding, dilation)
    cout = w_shape[3]
    m = x_shape[0] * oh * ow
    if blocks is not None:
        tile = (int(blocks[0]), int(blocks[1]))
    elif groups != 1:
        tile = (rq_tile(m, cout, sms)[0], GROUPED_BN)
    else:
        tile = rq_tile(m, cout, sms)
    k, _ = _geometry(x_shape, w_shape, tile[1], groups)
    return (tile, *rq_split(m, cout, k, tile, sms))


def qconv_raw_plain(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0),
                    izp=0, dilation=(1, 1), groups=1, kzp=None) -> torch.Tensor:
    """Plain PyTorch version of K4's conv mode."""
    acc = conv_acc_plain(x, w, strides, padding, izp, dilation, groups, kzp)
    return (acc.to(torch.int64) + bias.to(torch.int64)).to(torch.int32)


def qconv_raw(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0, dilation=(1, 1),
              groups=1, kzp=None) -> torch.Tensor:
    """K4, conv mode: the int32 accumulator of qnn.conv2d, sum (x_pad - izp) *
    (w - kzp), plus bias in int32 wraparound.  x int8 or uint8 NHWC, w int8
    HWIO (KH, KW, CIN / groups, COUT), bias int32 (COUT,), kzp as K2's;
    padding (top, left, bottom, right); dilation (dh, dw) -> int32 NHWC.  A
    grouped conv runs as K2's does, at the 64-column tile."""
    dilation = tuple(dilation)
    _grouped_kzp("qconv_raw", groups, kzp)
    check_fill("qconv_raw", x, izp, padding)
    if x.device.type == "cpu":
        return qconv_raw_plain(x, w, bias, strides=strides, padding=padding, izp=izp,
                               dilation=dilation, groups=groups, kzp=kzp)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_raw: no kernel for device {x.device}")
    oh, ow = _out_hw(x.shape, w.shape, strides, padding, dilation)
    kh, kw, cin, cout = w.shape
    if groups < 1 or cout % groups:
        raise ValueError(f"qconv_raw: groups {groups} do not divide COUT {cout}")
    check_cuda_operands("qconv_raw", x.device,
                        x=(x, x.dtype if x.dtype == torch.uint8 else torch.int8,
                           (*x.shape[:3], cin * groups)),
                        w=(w, torch.int8, (kh, kw, cin, cout)),
                        bias=(bias, torch.int32, (cout,)),
                        **({} if kzp is None else {"kzp": (kzp, torch.int32, (cout,))}))
    if x.ndim != 4 or min(oh, ow) <= 0:
        raise ValueError(f"qconv_raw: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    k, span = _geometry(tuple(x.shape), tuple(w.shape), RAW_TILE[1], groups)
    ks, kper = raw_split(x.shape[0] * oh * ow, cout, k, sm_count(x.device.index))
    # a split adds its partial sums into zeros
    out = (torch.zeros if ks > 1 else torch.empty)((x.shape[0], oh, ow, cout),
                                                   dtype=torch.int32, device=x.device)
    bias = fold_input_zero_point(bias, w, izp, kzp)
    launch("tk_qconv_raw", [x, _packed(w, groups, span), out, bias, kzp],
           _conv_params(x, w, out, strides, padding, izp, 0, 0, "UPWARD", 0, 0, dilation,
                        span * cin)
           | dict(ks=ks, kper=kper))
    LAUNCHES["qconv_raw"] += 1
    return out


def qconv_rq_res_plain(x, w, bias, mult, shift, residual, res_params, *, padding=(0, 0, 0, 0),
                       izp=0, rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                       blocks=None):
    """Plain PyTorch version of K3 (`blocks` is the kernel's tile: no effect)."""
    cur = qconv_rq_plain(x, w, bias, mult, shift, padding=padding, izp=izp, rq_izp=rq_izp,
                         out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax)
    return res_add_plain(cur, residual, res_params)


def qconv_rq_res(x, w, bias, mult, shift, residual, res_params: dict, *,
                 padding=(0, 0, 0, 0), izp=0, rq_izp=0, out_zp=0, rounding="UPWARD",
                 qmin=-128, qmax=127, blocks=None) -> torch.Tensor:
    """K3: the stride-1 K2 conv, then the fused residual qnn.add with the
    add's attrs `res_params` (lhs = the conv output, rhs = `residual`);
    blocks (BM, BN, 64) a compiled tile, default 64 x 64."""
    kw = dict(padding=padding, izp=izp, rq_izp=rq_izp, out_zp=out_zp, rounding=rounding,
              qmin=qmin, qmax=qmax)
    tile = tile_params(blocks)
    refuse_uint8("qconv_rq_res", x, residual)
    if x.device.type == "cpu":
        return qconv_rq_res_plain(x, w, bias, mult, shift, residual, res_params, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_rq_res: no kernel for device {x.device}")
    oh, ow = _out_hw(x.shape, w.shape, (1, 1), padding)
    out_shape = (x.shape[0], oh, ow, w.shape[3])
    _check_conv("qconv_rq_res", x, w, bias, mult, shift, out_shape, residual)
    out = torch.empty(out_shape, dtype=torch.int8, device=x.device)
    bias = fold_input_zero_point(bias, w, izp)
    plan = plan_res_add(res_params)
    l_skip, lm, ls, lzp = plan["lhs"]
    r_skip, rm, rs, rzp = plan["rhs"]
    params = _conv_params(x, w, out, (1, 1), padding, izp, rq_izp, out_zp, rounding, qmin, qmax)
    params.update(l_skip=l_skip, lm=lm, ls=ls, lzp=lzp, r_skip=r_skip, rm=rm, rs=rs, rzp=rzp,
                  zo=plan["zo"], lo=plan["lo"], hi=plan["hi"],
                  add_tonearest=_TONEAREST[plan["rounding"]], **tile)
    launch("tk_qconv_rq_res", [x, kmajor_weights(w), out, bias, mult, shift, residual], params)
    LAUNCHES["qconv_rq_res"] += 1
    return out


# ---------------------------------------------------------------------------
# entries with the JAX package's signatures
# ---------------------------------------------------------------------------

def _conv1x1_matmul(x, w, bias, mult, shift, strides, padding, izp, rq_izp, out_zp,
                    rounding, qmin, qmax, blocks=None, kzp=None, out_dtype="int8"):
    """1x1 conv == GEMM on K1 (on K4's GEMM mode when `mult` is None);
    padding (with izp) and stride subsample first.  The tile: `blocks`, else
    the database's record for the GEMM's workload (`qgemm_rq_tuned`,
    `qgemm_raw_tuned`).  The GEMM packs the stable 4-D weight (`w_src`), not
    the view made here."""
    pt, pl, pb, pr = padding
    check_fill("qconv2d_flat", x, izp, padding)
    if any(padding):
        x = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb), value=int(izp))
    if tuple(strides) != (1, 1):
        x = x[:, ::strides[0], ::strides[1], :]
    n, oh, ow, cin = x.shape
    cout = w.shape[-1]
    x2, w2 = x.reshape(n * oh * ow, cin).contiguous(), w.reshape(cin, cout)
    bias = fold_input_zero_point(bias, w, izp, kzp)
    if mult is None:
        out = qgemm_raw_tuned(x2, w2, bias, blocks=blocks, w_src=w, kzp=kzp)
    else:
        out = qgemm_rq_tuned(x2, w2, bias, mult, shift, rq_izp=rq_izp, out_zp=out_zp,
                             rounding=rounding, qmin=qmin, qmax=qmax, blocks=blocks, w_src=w,
                             kzp=kzp, out_dtype=out_dtype)
    return out.reshape(n, oh, ow, cout)


def _conv_config(x_shape, w_shape, strides, padding, blocks, layout, dilation=(1, 1),
                 groups: int = 1):
    """(blocks, layout) of a K2-family conv: explicit `blocks` and `layout`
    are checked (ValueError when the tile is not compiled, the layout unknown
    or its shared memory too small); with blocks None, the database's best
    record for the workload, ignored when its blocks are not a compiled tile
    or its layout does not fit; else the 64 x 64 tile on K2.  A dilated or
    grouped conv runs on K2 whatever the layout: the record for its own
    workload (its dilation and groups in the key) gives the tile alone."""
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of None, {LAYOUTS}")
    dense = tuple(dilation) == (1, 1) and groups == 1
    if not dense:
        layout = None
    if blocks is None:
        n, h, wd, cin = x_shape
        kh, kw, _, cout = w_shape
        cfg = lookup_config(flat_conv_workload(n, h, wd, cin, cout, kh, kw, strides, True,
                                               groups, tuple(dilation)))
        if cfg and "blocks" in cfg and compiled_blocks(cfg["blocks"]):
            lay = layout if layout is not None or not dense else cfg.get("layout")
            if lay in LAYOUTS and not layout_fits(lay, cfg["blocks"], x_shape, w_shape, strides,
                                                  padding):
                return None, layout
            if lay is None or lay in LAYOUTS:
                return tuple(int(b) for b in cfg["blocks"]), lay
        return None, layout
    if not compiled_blocks(blocks):
        raise ValueError(f"conv blocks {tuple(blocks)} invalid: (BM, BN) must be one of {TILES} "
                         f"and BK {BK}")
    if layout is not None and not layout_fits(layout, blocks, x_shape, w_shape, strides, padding):
        raise ValueError(f"layout {layout!r} at blocks {tuple(blocks)} does not fit shared memory "
                         f"for {tuple(x_shape)} * {tuple(w_shape)}")
    return tuple(int(b) for b in blocks), layout


def qconv2d_flat(x, w, bias=None, multiplier=None, shift=None, *, strides=(1, 1),
                 padding=(0, 0, 0, 0), groups: int = 1, input_zero_point: int = 0,
                 rq_input_zero_point: int = 0, out_zp: int = 0, rounding: str = "UPWARD",
                 out_dtype: str = "int8", qmin: int = -128, qmax: int = 127,
                 blocks: tuple | None = None, layout: str | None = None,
                 dilation=(1, 1), kernel_zero_point=0):
    """NHWC conv with the fused exact requantize: x (N,H,W,CIN) int8 or
    uint8, w (KH,KW,CIN/groups,COUT) int8 or uint8 with its zero point
    `kernel_zero_point` (a scalar or per-channel), any groups dividing CIN
    and COUT; 1x1 -> K1, depthwise -> K5, any other size -> K2 or, by
    `layout` ("t", "s", "w", "r"), K7-K10, at the tile `blocks` (BM, BN,
    64); the output int8 or uint8 (`out_dtype`).  blocks None reads the
    tuning database (the record's layout too, unless `layout` is given);
    explicit bad blocks or layouts raise ValueError.  1x1 convs ignore
    `blocks` and `layout` (their GEMM reads its own record), as the JAX
    package's entry does.  A dilated conv (but a 1x1, whose dilation is a
    no-op), a grouped one other than depthwise, or one with legacy uint8
    operands (uint8 data, a weight zero point, a uint8 output) runs on K2
    (K1 for a 1x1, K5 for a depthwise conv) and ignores `layout`; the legacy
    ones read no record either.  Without a multiplier: the int32
    accumulator of sum (x_pad - izp) * (w - kzp) plus bias (the unfused
    qnn.conv2d + bias), on K4's GEMM or conv mode, or K5's raw mode; a raw
    conv other than a 1x1 reads no record and ignores `blocks` and
    `layout`."""
    cin = x.shape[-1]
    depthwise = groups > 1 and groups == cin and w.shape[2] == 1 and w.shape[3] == cin
    if groups < 1 or cin % groups or w.shape[3] % groups or w.shape[2] * groups != cin:
        raise ValueError(f"qconv2d_flat: groups {groups} do not fit input channels {cin} "
                         f"and weight {tuple(w.shape)}")
    if multiplier is not None:
        out_torch_dtype(out_dtype)
    check_data("qconv2d_flat", x)
    dev = x.device
    w, kzp = legacy_weights(as_weight(w, dev), kernel_zero_point, dev)
    legacy = kzp is not None or x.dtype == torch.uint8 or (multiplier is not None
                                                          and out_dtype != "int8")
    cout = w.shape[-1]
    b = as_int32_vector(bias, cout, dev)
    strides, padding = tuple(strides), tuple(padding)
    pointwise = w.shape[0] == 1 and w.shape[1] == 1
    dilation = (1, 1) if pointwise else tuple(int(d) for d in dilation)
    if depthwise:
        kw = dict(strides=strides, padding=padding, izp=input_zero_point, dilation=dilation,
                  kzp=kzp)
        if multiplier is None:
            return qdwconv_raw(x.contiguous(), w, b, **kw)
        return qdwconv_rq(x.contiguous(), w, b, channel_vector(multiplier, cout, dev),
                          channel_vector(shift, cout, dev), rq_izp=rq_input_zero_point,
                          out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax,
                          out_dtype=out_dtype, **kw)
    geometry = {} if (dilation, groups) == ((1, 1), 1) else dict(dilation=dilation,
                                                                  groups=groups)
    if kzp is not None:
        geometry["kzp"] = kzp
    if multiplier is None:
        if pointwise and groups == 1:
            return _conv1x1_matmul(x, w, b, None, None, strides, padding, input_zero_point,
                                   0, 0, "UPWARD", 0, 0, kzp=kzp)
        return qconv_raw(x.contiguous(), w, b, strides=strides, padding=padding,
                         izp=input_zero_point, **geometry)
    m = channel_vector(multiplier, cout, dev)
    s = channel_vector(shift, cout, dev)
    if pointwise and groups == 1:
        return _conv1x1_matmul(x, w, b, m, s, strides, padding, input_zero_point,
                               rq_input_zero_point, out_zp, rounding, qmin, qmax, kzp=kzp,
                               out_dtype=out_dtype)
    if legacy:
        layout = None
        if blocks is not None:
            tile_params(blocks)
    else:
        blocks, layout = _conv_config(tuple(x.shape), tuple(w.shape), strides, padding, blocks,
                                      layout, dilation, groups)
    kernel = qconv_rq if layout is None else globals()[LAYOUT_KERNELS[layout]]
    if legacy:
        geometry["out_dtype"] = out_dtype
    return kernel(x.contiguous(), w, b, m, s, strides=strides, padding=padding,
                  izp=input_zero_point, rq_izp=rq_input_zero_point, out_zp=out_zp,
                  rounding=rounding, qmin=qmin, qmax=qmax, blocks=blocks, **geometry)


def _stage(cur, st: dict, residual=None, res_params=None, blocks=None):
    """One stride-1 stage of a chain: dict keys as qconv2d_flat_chain's."""
    dev = cur.device
    w = as_int8(st["w"], dev)
    cout = w.shape[-1]
    kw = dict(izp=int(st.get("izp", 0)), out_zp=int(st.get("out_zp", 0)),
              rounding=st.get("rounding", "UPWARD"), qmin=int(st.get("qmin", -128)),
              qmax=int(st.get("qmax", 127)))
    b = as_int32_vector(st.get("bias"), cout, dev)
    m = channel_vector(st["multiplier"], cout, dev)
    s = channel_vector(st["shift"], cout, dev)
    padding = tuple(st["padding"])
    if residual is not None:
        return qconv_rq_res(cur, w, b, m, s, residual.contiguous(), res_params,
                            padding=padding, blocks=blocks, **kw)
    if w.shape[0] == 1 and w.shape[1] == 1:
        return _conv1x1_matmul(cur, w, b, m, s, (1, 1), padding, kw["izp"], 0,
                               kw["out_zp"], kw["rounding"], kw["qmin"], kw["qmax"],
                               blocks=blocks or DEFAULT_BLOCKS)
    return qconv_rq(cur, w, b, m, s, padding=padding, blocks=blocks, **kw)


def _chain_blocks(cfg, bm, bn_cap):
    """(BM, BN, 64) of a chain or stack: explicit bm / bn_cap (ValueError when
    not a compiled tile), else a record's {bm, bn} (ignored when not
    compiled), else None (64 x 64)."""
    if bm is not None:
        blocks = (int(bm), int(bn_cap if bn_cap is not None else 64), BK)
        if not compiled_blocks(blocks):
            raise ValueError(f"chain bm {bm} / bn {bn_cap}: (BM, BN) must be one of {TILES}")
        return blocks
    if cfg and "bm" in cfg:
        blocks = (int(cfg["bm"]), int(cfg.get("bn", 64)), BK)
        if compiled_blocks(blocks):
            return blocks
    return None


def _dims(stages):
    return [(st["w"].shape[0], st["w"].shape[2], st["w"].shape[3]) for st in stages]


def qconv2d_flat_chain(x, stages, *, bm=None, bn_cap=None, residual=None,
                       res_params: dict | None = None):
    """Run a chain of stride-1, same-spatial-size, fused-requantize convs.

    x: (N, H, W, CIN) int8.  Each stage is a dict with keys w (KH,KW,CIN,COUT)
    int8, bias (COUT,) int32 or None, multiplier / shift (scalar or
    per-channel), izp, out_zp, rounding, qmin, qmax, padding (pt, pl, pb, pr).
    residual / res_params: the fused qnn.add on the LAST stage (K3): residual
    (N,H,W,COUT_last) int8, res_params the add's attrs (lhs = chain output).
    bm / bn_cap: the tile (BM, BN) of every stage's K1, K2 and K3 launch;
    None reads the chain's record {bm, bn} (`chain_workload`), else 64 x 64.
    """
    cur = x.contiguous()
    blocks = _chain_blocks(
        None if bm is not None else lookup_config(chain_workload(*x.shape[:3], _dims(stages))),
        bm, bn_cap)
    for i, st in enumerate(stages):
        last = i == len(stages) - 1
        cur = _stage(cur, st, residual if last else None, res_params, blocks)
    return cur


def qconv2d_flat_chain_plain(x, stages, *, residual=None, res_params: dict | None = None,
                             **_):
    """Plain PyTorch version of `qconv2d_flat_chain`: K2's plain version per
    stage, K3's on the last when there is a residual."""
    cur = x
    for i, st in enumerate(stages):
        dev = cur.device
        w = as_int8(st["w"], dev)
        cout = w.shape[-1]
        args = (cur, w, as_int32_vector(st.get("bias"), cout, dev),
                channel_vector(st["multiplier"], cout, dev), channel_vector(st["shift"], cout, dev))
        kw = dict(padding=tuple(st["padding"]), izp=int(st.get("izp", 0)),
                  out_zp=int(st.get("out_zp", 0)), rounding=st.get("rounding", "UPWARD"),
                  qmin=int(st.get("qmin", -128)), qmax=int(st.get("qmax", 127)))
        if residual is not None and i == len(stages) - 1:
            cur = qconv_rq_res_plain(*args, residual, res_params, **kw)
        else:
            cur = qconv_rq_plain(*args, **kw)
    return cur


def qconv2d_flat_block_stack_plain(x, blocks, **_):
    """Plain PyTorch version of `qconv2d_flat_block_stack`."""
    cur = x
    for stages, rp in blocks:
        cur = qconv2d_flat_chain_plain(cur, stages, residual=cur if rp else None, res_params=rp)
    return cur


def qconv2d_flat_block_stack(x, blocks, *, bm=None, bn_cap=None):
    """Run a stack of identity-residual blocks: blocks [(stages, res_params |
    None)]; with res_params the block computes qnn.add(chain(x), x), its last
    stage on K3 with the block's input as the residual.  bm / bn_cap as in
    the chain; None reads the stack's record (`stack_workload`), then the
    first block's chain record, as the JAX package does."""
    cfg = None
    if bm is None:
        n, h, wd = x.shape[:3]
        cfg = lookup_config(stack_workload(n, h, wd, [_dims(sts) for sts, _ in blocks]))
        if not (cfg and "bm" in cfg):
            cfg = lookup_config(chain_workload(n, h, wd, _dims(blocks[0][0])))
    tile = _chain_blocks(cfg, bm, bn_cap) or DEFAULT_BLOCKS
    cur = x.contiguous()
    for stages, rp in blocks:
        cur = qconv2d_flat_chain(cur, stages, bm=tile[0], bn_cap=tile[1],
                                 residual=cur if rp else None, res_params=rp)
    return cur
