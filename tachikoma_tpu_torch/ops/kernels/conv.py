"""K2 and K3: NHWC int8 convolution with the exact requantize epilogue, and
the conv entries of the int8 path (port of
`tachikoma_tpu/ops/pallas/conv_flat.py`).

  * `qconv_rq` (K2) wraps `csrc/qconv_rq.cu tk_qconv_rq`: an implicit-GEMM
    conv with any stride and padding; taps outside the image read the input
    zero point.
  * `qconv_rq_res` (K3) wraps `tk_qconv_rq_res`: the same conv, whose epilogue
    then applies the fused residual `qnn.add`.
  * `qconv_raw` (K4, conv mode) wraps `csrc/qgemm_raw.cu tk_qconv_raw`: the
    same conv storing the int32 accumulator plus bias, no requantize (the
    `fuse=False` branch of the TPU kernel).
  * `qconv2d_flat`: 1x1 convs go to K1 (or, without a multiplier, K4's GEMM
    mode) as a GEMM (`_conv1x1_matmul`), every other kernel size, the 7x7 s2
    stem included, to K2 (or K4's conv mode); depthwise convs (groups == C)
    to K5 (`depthwise.py`: `qdwconv_rq`, or `qdwconv_raw` without a
    multiplier).
  * `qconv2d_flat_chain` / `qconv2d_flat_block_stack` run a chain or a stack
    of residual blocks stage by stage: the last stage of each residual block
    launches K3, the others K1 (1x1) or K2.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its kernel or raises.  The TPU package's frame layout, width
packing, polyphase stacking and VMEM budgets have no counterpart here: the
kernels read NHWC directly and take the stride themselves.
"""

from __future__ import annotations

import torch

from ._lib import LAUNCHES, check_cuda_operands, launch
from .depthwise import qdwconv_raw, qdwconv_rq
from .matmul_int8 import (_TONEAREST, as_int8, as_int32_vector, fold_input_zero_point,
                          qgemm_raw, qgemm_rq)
from .requantize import channel_vector, epilogue_plain, plan_res_add, res_add_plain


def _out_hw(x_shape, w_shape, strides, padding):
    _, h, wd, _ = x_shape
    kh, kw = w_shape[:2]
    sh, sw = strides
    pt, pl, pb, pr = padding
    return (h + pt + pb - kh) // sh + 1, (wd + pl + pr - kw) // sw + 1


def conv_acc_plain(x, w, strides, padding, izp) -> torch.Tensor:
    """int32 accumulator of qnn.conv2d, sum (x_pad - izp) * w with the border
    padded by izp, in float64 (exact, see `exact_int_matmul`)."""
    n = x.shape[0]
    kh, kw, cin, cout = w.shape
    sh, sw = strides
    pt, pl, pb, pr = padding
    xp = torch.nn.functional.pad(x.to(torch.float64) - float(izp), (0, 0, pl, pr, pt, pb))
    cols = xp.unfold(1, kh, sh).unfold(2, kw, sw)      # (n, oh, ow, cin, kh, kw)
    oh, ow = cols.shape[1], cols.shape[2]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, kh * kw * cin)
    acc = cols @ w.to(torch.float64).reshape(kh * kw * cin, cout)
    return acc.to(torch.int64).to(torch.int32).reshape(n, oh, ow, cout)


def _conv_params(x, w, out, strides, padding, izp, rq_izp, out_zp, rounding, qmin, qmax):
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    return dict(n=n, h=h, w=wd, cin=cin, kh=kh, kw=kw, cout=cout, oh=out.shape[1],
                ow=out.shape[2], sh=strides[0], sw=strides[1], pt=padding[0],
                pl=padding[1], izp=izp, rq_izp=rq_izp, out_zp=out_zp, qmin=qmin,
                qmax=qmax, tonearest=_TONEAREST[rounding],
                a_vec=cin % 16 == 0 and x.data_ptr() % 16 == 0,
                b_vec=cout % 4 == 0 and w.data_ptr() % 4 == 0)


def _check_conv(kernel, x, w, bias, mult, shift, out_shape, residual=None):
    i32 = torch.int32
    kh, kw, cin, cout = w.shape
    ops = dict(x=(x, torch.int8, (*x.shape[:3], cin)), w=(w, torch.int8, (kh, kw, cin, cout)),
               bias=(bias, i32, (cout,)), mult=(mult, i32, (cout,)), shift=(shift, i32, (cout,)))
    if residual is not None:
        ops["residual"] = (residual, torch.int8, out_shape)
    check_cuda_operands(kernel, x.device, **ops)
    if x.ndim != 4 or min(out_shape) <= 0:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")


def qconv_rq_plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0),
                   izp=0, rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127):
    """Plain PyTorch version of K2."""
    acc = conv_acc_plain(x, w, strides, padding, izp)
    return epilogue_plain(acc, bias, mult, shift, rq_izp, out_zp, rounding, qmin, qmax)


def qconv_rq(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
             rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127) -> torch.Tensor:
    """K2: x int8 NHWC, w int8 HWIO, bias / mult / shift int32 (COUT,);
    padding (top, left, bottom, right) -> int8 NHWC."""
    kw = dict(strides=strides, padding=padding, izp=izp, rq_izp=rq_izp, out_zp=out_zp,
              rounding=rounding, qmin=qmin, qmax=qmax)
    if x.device.type == "cpu":
        return qconv_rq_plain(x, w, bias, mult, shift, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_rq: no kernel for device {x.device}")
    oh, ow = _out_hw(x.shape, w.shape, strides, padding)
    out_shape = (x.shape[0], oh, ow, w.shape[3])
    _check_conv("qconv_rq", x, w, bias, mult, shift, out_shape)
    out = torch.empty(out_shape, dtype=torch.int8, device=x.device)
    bias = fold_input_zero_point(bias, w, izp)
    launch("tk_qconv_rq", [x, w, out, bias, mult, shift],
           _conv_params(x, w, out, strides, padding, izp, rq_izp, out_zp, rounding, qmin, qmax))
    LAUNCHES["qconv_rq"] += 1
    return out


def qconv_raw_plain(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0),
                    izp=0) -> torch.Tensor:
    """Plain PyTorch version of K4's conv mode."""
    acc = conv_acc_plain(x, w, strides, padding, izp)
    return (acc.to(torch.int64) + bias.to(torch.int64)).to(torch.int32)


def qconv_raw(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0) -> torch.Tensor:
    """K4, conv mode: the int32 accumulator of qnn.conv2d, sum (x_pad - izp) *
    w, plus bias in int32 wraparound.  x int8 NHWC, w int8 HWIO, bias int32
    (COUT,); padding (top, left, bottom, right) -> int32 NHWC."""
    if x.device.type == "cpu":
        return qconv_raw_plain(x, w, bias, strides=strides, padding=padding, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_raw: no kernel for device {x.device}")
    oh, ow = _out_hw(x.shape, w.shape, strides, padding)
    kh, kw, cin, cout = w.shape
    check_cuda_operands("qconv_raw", x.device, x=(x, torch.int8, (*x.shape[:3], cin)),
                        w=(w, torch.int8, (kh, kw, cin, cout)),
                        bias=(bias, torch.int32, (cout,)))
    if x.ndim != 4 or min(oh, ow) <= 0:
        raise ValueError(f"qconv_raw: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    out = torch.empty((x.shape[0], oh, ow, cout), dtype=torch.int32, device=x.device)
    bias = fold_input_zero_point(bias, w, izp)
    launch("tk_qconv_raw", [x, w, out, bias],
           _conv_params(x, w, out, strides, padding, izp, 0, 0, "UPWARD", 0, 0))
    LAUNCHES["qconv_raw"] += 1
    return out


def qconv_rq_res_plain(x, w, bias, mult, shift, residual, res_params, *, padding=(0, 0, 0, 0),
                       izp=0, rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127):
    """Plain PyTorch version of K3."""
    cur = qconv_rq_plain(x, w, bias, mult, shift, padding=padding, izp=izp, rq_izp=rq_izp,
                         out_zp=out_zp, rounding=rounding, qmin=qmin, qmax=qmax)
    return res_add_plain(cur, residual, res_params)


def qconv_rq_res(x, w, bias, mult, shift, residual, res_params: dict, *,
                 padding=(0, 0, 0, 0), izp=0, rq_izp=0, out_zp=0, rounding="UPWARD",
                 qmin=-128, qmax=127) -> torch.Tensor:
    """K3: the stride-1 K2 conv, then the fused residual qnn.add with the
    add's attrs `res_params` (lhs = the conv output, rhs = `residual`)."""
    kw = dict(padding=padding, izp=izp, rq_izp=rq_izp, out_zp=out_zp, rounding=rounding,
              qmin=qmin, qmax=qmax)
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
                  add_tonearest=_TONEAREST[plan["rounding"]])
    launch("tk_qconv_rq_res", [x, w, out, bias, mult, shift, residual], params)
    LAUNCHES["qconv_rq_res"] += 1
    return out


# ---------------------------------------------------------------------------
# entries with the JAX package's signatures
# ---------------------------------------------------------------------------

def _conv1x1_matmul(x, w, bias, mult, shift, strides, padding, izp, rq_izp, out_zp,
                    rounding, qmin, qmax):
    """1x1 conv == GEMM on K1 (on K4 when `mult` is None); padding (with izp)
    and stride subsample first."""
    pt, pl, pb, pr = padding
    if any(padding):
        x = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb), value=int(izp))
    if tuple(strides) != (1, 1):
        x = x[:, ::strides[0], ::strides[1], :]
    n, oh, ow, cin = x.shape
    cout = w.shape[-1]
    x2, w2 = x.reshape(n * oh * ow, cin).contiguous(), w.reshape(cin, cout)
    bias = fold_input_zero_point(bias, w, izp)
    if mult is None:
        out = qgemm_raw(x2, w2, bias)
    else:
        out = qgemm_rq(x2, w2, bias, mult, shift, rq_izp=rq_izp, out_zp=out_zp,
                       rounding=rounding, qmin=qmin, qmax=qmax)
    return out.reshape(n, oh, ow, cout)


def qconv2d_flat(x, w, bias=None, multiplier=None, shift=None, *, strides=(1, 1),
                 padding=(0, 0, 0, 0), groups: int = 1, input_zero_point: int = 0,
                 rq_input_zero_point: int = 0, out_zp: int = 0, rounding: str = "UPWARD",
                 out_dtype: str = "int8", qmin: int = -128, qmax: int = 127):
    """NHWC int8 conv with the fused exact requantize: x (N,H,W,CIN) int8,
    w (KH,KW,CIN/groups,COUT) int8, groups 1 or CIN (depthwise, COUT == CIN);
    1x1 -> K1, any other size -> K2, depthwise -> K5.  Without a multiplier:
    the int32 accumulator of sum (x_pad - izp) * w plus bias (the unfused
    qnn.conv2d + bias), on K4's GEMM or conv mode, or K5's raw mode."""
    cin = x.shape[-1]
    depthwise = groups > 1 and groups == cin and w.shape[2] == 1 and w.shape[3] == cin
    if groups != 1 and not depthwise:
        raise NotImplementedError(
            f"qconv2d_flat: groups {groups} with weight {tuple(w.shape)}: only groups 1 "
            "and depthwise (groups == CIN == COUT) are supported")
    if multiplier is not None and out_dtype != "int8":
        raise NotImplementedError(f"qconv2d_flat: out_dtype {out_dtype} is not ported yet")
    dev = x.device
    w = as_int8(w, dev)
    cout = w.shape[-1]
    b = as_int32_vector(bias, cout, dev)
    strides, padding = tuple(strides), tuple(padding)
    if depthwise:
        if multiplier is None:
            return qdwconv_raw(x.contiguous(), w, b, strides=strides, padding=padding,
                               izp=input_zero_point)
        return qdwconv_rq(x.contiguous(), w, b, channel_vector(multiplier, cout, dev),
                          channel_vector(shift, cout, dev), strides=strides,
                          padding=padding, izp=input_zero_point,
                          rq_izp=rq_input_zero_point, out_zp=out_zp, rounding=rounding,
                          qmin=qmin, qmax=qmax)
    if multiplier is None:
        if w.shape[0] == 1 and w.shape[1] == 1:
            return _conv1x1_matmul(x, w, b, None, None, strides, padding, input_zero_point,
                                   0, 0, "UPWARD", 0, 0)
        return qconv_raw(x.contiguous(), w, b, strides=strides, padding=padding,
                         izp=input_zero_point)
    m = channel_vector(multiplier, cout, dev)
    s = channel_vector(shift, cout, dev)
    if w.shape[0] == 1 and w.shape[1] == 1:
        return _conv1x1_matmul(x, w, b, m, s, strides, padding, input_zero_point,
                               rq_input_zero_point, out_zp, rounding, qmin, qmax)
    return qconv_rq(x.contiguous(), w, b, m, s, strides=strides, padding=padding,
                    izp=input_zero_point, rq_izp=rq_input_zero_point, out_zp=out_zp,
                    rounding=rounding, qmin=qmin, qmax=qmax)


def _stage(cur, st: dict, residual=None, res_params=None):
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
                            padding=padding, **kw)
    if w.shape[0] == 1 and w.shape[1] == 1:
        return _conv1x1_matmul(cur, w, b, m, s, (1, 1), padding, kw["izp"], 0,
                               kw["out_zp"], kw["rounding"], kw["qmin"], kw["qmax"])
    return qconv_rq(cur, w, b, m, s, padding=padding, **kw)


def qconv2d_flat_chain(x, stages, *, residual=None, res_params: dict | None = None):
    """Run a chain of stride-1, same-spatial-size, fused-requantize convs.

    x: (N, H, W, CIN) int8.  Each stage is a dict with keys w (KH,KW,CIN,COUT)
    int8, bias (COUT,) int32 or None, multiplier / shift (scalar or
    per-channel), izp, out_zp, rounding, qmin, qmax, padding (pt, pl, pb, pr).
    residual / res_params: the fused qnn.add on the LAST stage (K3): residual
    (N,H,W,COUT_last) int8, res_params the add's attrs (lhs = chain output).
    """
    cur = x.contiguous()
    for i, st in enumerate(stages):
        last = i == len(stages) - 1
        cur = _stage(cur, st, residual if last else None, res_params)
    return cur


def qconv2d_flat_block_stack(x, blocks):
    """Run a stack of identity-residual blocks: blocks [(stages, res_params |
    None)]; with res_params the block computes qnn.add(chain(x), x), its last
    stage on K3 with the block's input as the residual."""
    cur = x.contiguous()
    for stages, rp in blocks:
        cur = qconv2d_flat_chain(cur, stages, residual=cur if rp else None, res_params=rp)
    return cur
