"""MobileNetV2 1.0 224 as a legacy uint8 TFLite file, laid out as TF1's
quantization-aware converter writes TF's hosted
`mobilenet_v2_1.0_224_quant.tflite` (`inference_type=QUANTIZED_UINT8`):

  * a uint8 input, scale 1/128 and zero point 128;
  * CONV_2D 3x3 s2 to 32 channels, SAME padding ((0, 0, 1, 1) at 224^2),
    RELU6;
  * 17 inverted residuals, (t, c, n, s) = (1, 16, 1, 1), (6, 24, 2, 2),
    (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320,
    1, 1): a 1x1 CONV_2D expanding by t with RELU6 (not in the first), a
    3x3 DEPTHWISE_CONV_2D at stride s with RELU6, a linear 1x1 CONV_2D, and
    an ADD where the block keeps its shape (ten of them);
  * CONV_2D 1x1 320 -> 1280 with RELU6, AVERAGE_POOL_2D 7x7, CONV_2D 1x1
    1280 -> 1001, RESHAPE to (batch, 1001), SOFTMAX to uint8 at scale
    1/256 and zero point 0.

Every weight is uint8, per tensor, with the zero point its min and max
give (not 0); every bias int32 at input scale x weight scale.  The
weights are random from the seed (He-scaled, the projections' scaled by
0.5, the classifier's by LOGIT_GAIN), and each activation's range comes
from a float pass of the writer's own seeded input, as quantization-aware
training would have learned it.  An AVERAGE_POOL_2D and a RESHAPE keep
their input's range.  The batch is in the file.

The bytes are a minimal FlatBuffer of the TFLite schema (`_Builder`: the
root table first, each table's children after it, so every offset points
forward; slots as `frontend/tflite_fb.py` reads them), with no TensorFlow;
both packages' `from_tflite` read them, and TFLite's interpreter runs them.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..frontend.tflite_fb import Act, Op, PAD_SAME, PAD_VALID, TType

INPUT_SCALE, INPUT_ZP = 1.0 / 128.0, 128   # the hosted model's input
SOFTMAX_SCALE, SOFTMAX_ZP = 1.0 / 256.0, 0
NUM_CLASSES = 1001
BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
          (6, 160, 3, 2), (6, 320, 1, 1))
CALIB_BATCH = 2  # images of the float pass that sets the activation ranges
# the classifier's gain: logits spread over about +-8, as a trained model's
# do, so that the uint8 softmax is not 0 at every class
LOGIT_GAIN = 10.0

# BuiltinOptions union members (schema_py_generated BuiltinOptions)
_CONV_OPTS, _DW_OPTS, _POOL_OPTS, _SOFTMAX_OPTS, _ADD_OPTS, _RESHAPE_OPTS = 1, 2, 5, 9, 11, 17


# ---------------------------------------------------------------------------
# a FlatBuffer writer: tables are lists of (slot, kind, value)
# ---------------------------------------------------------------------------

_SCALAR = {"u8": "<B", "i8": "<b", "i32": "<i", "u32": "<I", "f32": "<f"}
_VEC = {"vi32": ("<i", 4, 4), "vf32": ("<f", 4, 4), "vi64": ("<q", 8, 8), "vu8": ("<B", 1, 16)}


class _Builder:
    """Lays a table tree out front to back: root offset and file id, then
    each table (its vtable just before it) and, after it, what its offset
    fields point to, each aligned to its elements; every uoffset points
    forward, as the format requires."""

    def __init__(self):
        self.buf = bytearray()

    def _align(self, n: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % n:
            self.buf.append(0)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def _table(self, fields) -> tuple[int, list]:
        """Writes a table's vtable and inline part; returns (table position,
        [(offset field position, kind, value)] still to write)."""
        fields = sorted(fields, key=lambda f: f[0])
        inline, later = [], []
        for slot, kind, value in fields:
            if kind in _SCALAR:
                inline.append((slot, _SCALAR[kind], value))
            else:
                inline.append((slot, "<I", 0))
                later.append((slot, kind, value))
        # layout: soffset, then the fields in slot order, each aligned to its size
        offs, size = {}, 4
        for slot, fmt, _ in inline:
            n = struct.calcsize(fmt)
            size += -size % n
            offs[slot] = size
            size += n
        size += -size % 4
        nslots = max((f[0] for f in fields), default=-1) + 1
        vt = [4 + 2 * nslots, size] + [offs.get(s, 0) for s in range(nslots)]
        self._align(4, extra=2 * len(vt))
        vpos = len(self.buf)
        self.buf += struct.pack(f"<{len(vt)}H", *vt)
        pos = len(self.buf)
        self.buf += bytes(size)
        struct.pack_into("<i", self.buf, pos, pos - vpos)
        for slot, kind, value in fields:
            if kind in _SCALAR:
                struct.pack_into(_SCALAR[kind], self.buf, pos + offs[slot], value)
        return pos, [(pos + offs[slot], kind, value) for slot, kind, value in later]

    def _object(self, kind, value) -> tuple[int, list]:
        """Writes a string, a vector or a table; returns (its position, the
        offset fields still to write)."""
        if kind == "str":
            data = value.encode()
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return pos, []
        if kind in _VEC:
            fmt, n, align = _VEC[kind]
            self._align(align, extra=4)
            pos = len(self.buf)
            if kind == "vu8":
                data = bytes(value)
                self.buf += struct.pack("<I", len(data)) + data
            else:
                self.buf += struct.pack(f"<I{len(value)}{fmt[1]}", len(value), *value)
            return pos, []
        if kind == "vtab":
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(value)) + bytes(4 * len(value))
            return pos, [(pos + 4 + 4 * i, "tab", t) for i, t in enumerate(value)]
        if kind == "tab":
            return self._table(value)
        raise ValueError(f"unknown kind {kind!r}")

    def finish(self, root, file_id: bytes = b"TFL3") -> bytes:
        self.buf = bytearray(8)
        self.buf[4:8] = file_id
        pos, todo = self._table(root)
        self._patch(0, pos)
        while todo:
            nxt = []
            for at, kind, value in todo:
                p, more = self._object(kind, value)
                self._patch(at, p)
                nxt += more
            todo = nxt
        self._align(16)
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _qparams(lo: float, hi: float) -> tuple[float, int]:
    """(scale, zero point) of uint8 over [min(lo, 0), max(hi, 0)], the zero
    point nudged to an integer as TF's fake-quant does."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    if hi - lo < 1e-6:
        hi = lo + 1e-6
    scale = (hi - lo) / 255.0
    zp = int(np.clip(np.round(-lo / scale), 0, 255))
    return float(np.float32(scale)), zp


def _starts_block(rows, i: int) -> bool:
    """Whether row i takes a block's input: an expansion, or the depthwise
    conv of a block with none (t = 1)."""
    return rows[i][0] == "expand" or rows[i][0] == "dw" and rows[i - 1][0] != "expand"


def _layers() -> list[tuple]:
    """The network as (kind, cin, cout, stride, act, residual) rows: kind
    "conv3" (the stem), "expand", "dw", "project", "head" (320 -> 1280),
    "pool", "logits"; residual marks a projection whose block adds its
    input."""
    rows = [("conv3", 3, 32, 2, True, False)]
    cin = 32
    for t, c, n, s in BLOCKS:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            if t != 1:
                rows.append(("expand", cin, hidden, 1, True, False))
            rows.append(("dw", hidden, hidden, stride, True, False))
            rows.append(("project", hidden, c, 1, False, stride == 1 and cin == c))
            cin = c
    rows += [("head", cin, 1280, 1, True, False), ("pool", 1280, 1280, 1, False, False),
             ("logits", 1280, NUM_CLASSES, 1, False, False)]
    return rows


def _float_weights(seed: int) -> list[tuple[np.ndarray, np.ndarray] | None]:
    """Each row's float (weight, bias): conv weights OHWI (COUT, KH, KW,
    CIN), depthwise (1, 3, 3, C), He-scaled normals (projections by 0.5, the
    logits by LOGIT_GAIN), biases uniform in +-0.1; None for the pool."""
    rng = np.random.default_rng(seed)
    out = []
    for kind, cin, cout, _, _, _ in _layers():
        if kind == "pool":
            out.append(None)
            continue
        k = 3 if kind in ("conv3", "dw") else 1
        fan_in = k * k * (1 if kind == "dw" else cin)
        gain = {"project": 0.5, "logits": LOGIT_GAIN}.get(kind, 1.0)
        shape = (1, k, k, cout) if kind == "dw" else (cout, k, k, cin)
        w = (rng.standard_normal(shape) * gain * np.sqrt(2.0 / fan_in)).astype(np.float32)
        b = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
        out.append((w, b))
    return out


def float_input(batch_size: int, image_size: int, seed: int) -> np.ndarray:
    """The seeded float image batch (N, H, W, 3) in [-1, 1), whose uint8
    quantization at the input's (1/128, 128) is `mobilenet_v2_input`."""
    rng = np.random.default_rng(seed + 1)
    return rng.uniform(-1.0, 1.0, (batch_size, image_size, image_size, 3)).astype(np.float32)


def mobilenet_v2_input(batch_size: int = 1, image_size: int = 224, seed: int = 0) -> np.ndarray:
    """The uint8 input the writer's model takes, from the seed."""
    x = float_input(batch_size, image_size, seed)
    return np.clip(np.round(x / INPUT_SCALE) + INPUT_ZP, 0, 255).astype(np.uint8)


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _ranges(weights, image_size: int, seed: int) -> list[tuple[float, float]]:
    """The float pass: each row's output (min, max) over CALIB_BATCH seeded
    images (the input's quantization applied first), in torch float32 on the
    CPU; a projection's range is that of its block's output (after the add)
    where the block adds, and the add's own range the projection's."""
    x = torch.from_numpy(float_input(CALIB_BATCH, image_size, seed)).permute(0, 3, 1, 2)
    x = (torch.round(x / INPUT_SCALE).clamp(-INPUT_ZP, 255 - INPUT_ZP)) * INPUT_SCALE
    rows = _layers()
    ranges, block_in = [], x
    for i, ((kind, cin, cout, stride, act, residual), wb) in enumerate(zip(rows, weights)):
        if kind == "pool":
            x = torch.nn.functional.avg_pool2d(x, x.shape[-1])
            ranges.append(ranges[-1])
            continue
        w, b = (torch.from_numpy(a) for a in wb)
        if _starts_block(rows, i):
            block_in = x
        if kind == "dw":
            wt = w.permute(3, 0, 1, 2)  # (C, 1, 3, 3)
            pt, pb = _same_pad(x.shape[2], 3, stride)
            pl, pr = _same_pad(x.shape[3], 3, stride)
            x = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (pl, pr, pt, pb)), wt,
                                           b, stride, groups=cin)
        else:
            k = w.shape[1]
            wt = w.permute(0, 3, 1, 2)
            if k == 3:
                pt, pb = _same_pad(x.shape[2], 3, stride)
                pl, pr = _same_pad(x.shape[3], 3, stride)
                x = torch.nn.functional.pad(x, (pl, pr, pt, pb))
            x = torch.nn.functional.conv2d(x, wt, b, stride)
        if act:
            x = x.clamp(0.0, 6.0)
        if residual:
            ranges.append((float(x.min()), float(x.max())))
            x = x + block_in
            ranges.append((float(x.min()), float(x.max())))
        else:
            ranges.append((float(x.min()), float(x.max())))
    return ranges


class _Tensors:
    def __init__(self):
        self.tensors, self.buffers = [], [[]]

    def add(self, name, shape, ttype, scale=None, zp=None, data=None) -> int:
        buf = 0
        if data is not None:
            self.buffers.append([(0, "vu8", np.ascontiguousarray(data).tobytes())])
            buf = len(self.buffers) - 1
        fields = [(0, "vi32", [int(d) for d in shape]), (1, "i8", ttype), (2, "u32", buf),
                  (3, "str", name)]
        if scale is not None:
            fields.append((4, "tab", [(2, "vf32", [float(scale)]), (3, "vi64", [int(zp)]),
                                      (6, "i32", 0)]))
        self.tensors.append(fields)
        return len(self.tensors) - 1


def mobilenet_v2_tflite(batch_size: int = 1, image_size: int = 224, seed: int = 0) -> bytes:
    """The uint8 MobileNetV2 1.0 as TFLite bytes at (batch, image_size^2,
    3), weights from `seed` (the same at every batch and size), activation
    ranges from the float pass at `image_size` (`_ranges`)."""
    weights = _float_weights(seed)
    ranges = _ranges(weights, image_size, seed)
    ts = _Tensors()
    ops, opcodes = [], []

    def opcode(code: int) -> int:
        if code not in opcodes:
            opcodes.append(code)
        return opcodes.index(code)

    cur = ts.add("input", (batch_size, image_size, image_size, 3), TType.UINT8, INPUT_SCALE,
                 INPUT_ZP)
    inp = cur
    cur_q = (INPUT_SCALE, INPUT_ZP)
    hw = image_size
    block_in, block_in_q = cur, cur_q
    ri = 0
    rows = _layers()
    for i, ((kind, cin, cout, stride, act, residual), wb) in enumerate(zip(rows, weights)):
        name = f"l{i}_{kind}"
        if kind == "pool":
            out = ts.add(name, (batch_size, 1, 1, cout), TType.UINT8, *cur_q)
            ops.append([(0, "u32", opcode(Op.AVERAGE_POOL_2D)), (1, "vi32", [cur]),
                        (2, "vi32", [out]), (3, "u8", _POOL_OPTS),
                        (4, "tab", [(0, "i8", PAD_VALID), (1, "i32", 1), (2, "i32", 1),
                                    (3, "i32", hw), (4, "i32", hw), (5, "i8", Act.NONE)])])
            cur, hw = out, 1
            ri += 1
            continue
        if _starts_block(rows, i):
            block_in, block_in_q = cur, cur_q
        w, b = wb
        wq_scale, wq_zp = _qparams(w.min(), w.max())
        wq = np.clip(np.round(w / wq_scale) + wq_zp, 0, 255).astype(np.uint8)
        bscale = float(np.float32(np.float64(cur_q[0]) * np.float64(wq_scale)))
        bq = np.round(b.astype(np.float64) / bscale).astype(np.int32)
        wt = ts.add(f"{name}/weights", wq.shape, TType.UINT8, wq_scale, wq_zp, wq)
        bt = ts.add(f"{name}/bias", (cout,), TType.INT32, bscale, 0, bq)
        out_q = _qparams(*ranges[ri])
        ri += 1
        if stride == 1:
            ohw = hw
        else:
            ohw = -(-hw // stride)
        out = ts.add(name, (batch_size, ohw, ohw, cout), TType.UINT8, *out_q)
        a = Act.RELU6 if act else Act.NONE
        if kind == "dw":
            ops.append([(0, "u32", opcode(Op.DEPTHWISE_CONV_2D)), (1, "vi32", [cur, wt, bt]),
                        (2, "vi32", [out]), (3, "u8", _DW_OPTS),
                        (4, "tab", [(0, "i8", PAD_SAME), (1, "i32", stride), (2, "i32", stride),
                                    (3, "i32", 1), (4, "i8", a), (5, "i32", 1), (6, "i32", 1)])])
        else:
            ops.append([(0, "u32", opcode(Op.CONV_2D)), (1, "vi32", [cur, wt, bt]),
                        (2, "vi32", [out]), (3, "u8", _CONV_OPTS),
                        (4, "tab", [(0, "i8", PAD_SAME if kind == "conv3" else PAD_VALID),
                                    (1, "i32", stride), (2, "i32", stride), (3, "i8", a),
                                    (4, "i32", 1), (5, "i32", 1)])])
        cur, cur_q, hw = out, out_q, ohw
        if residual:
            add_q = _qparams(*ranges[ri])
            ri += 1
            out = ts.add(f"{name}/add", (batch_size, hw, hw, cout), TType.UINT8, *add_q)
            ops.append([(0, "u32", opcode(Op.ADD)), (1, "vi32", [cur, block_in]),
                        (2, "vi32", [out]), (3, "u8", _ADD_OPTS),
                        (4, "tab", [(0, "i8", Act.NONE)])])
            cur, cur_q = out, add_q
    shape_t = ts.add("reshape/shape", (2,), TType.INT32,
                     data=np.array([batch_size, NUM_CLASSES], np.int32))
    flat = ts.add("logits", (batch_size, NUM_CLASSES), TType.UINT8, *cur_q)
    ops.append([(0, "u32", opcode(Op.RESHAPE)), (1, "vi32", [cur, shape_t]),
                (2, "vi32", [flat]), (3, "u8", _RESHAPE_OPTS),
                (4, "tab", [(0, "vi32", [batch_size, NUM_CLASSES])])])
    prob = ts.add("probabilities", (batch_size, NUM_CLASSES), TType.UINT8, SOFTMAX_SCALE,
                  SOFTMAX_ZP)
    ops.append([(0, "u32", opcode(Op.SOFTMAX)), (1, "vi32", [flat]), (2, "vi32", [prob]),
                (3, "u8", _SOFTMAX_OPTS), (4, "tab", [(0, "f32", 1.0)])])
    subgraph = [(0, "vtab", ts.tensors), (1, "vi32", [inp]), (2, "vi32", [prob]),
                (3, "vtab", ops), (4, "str", "main")]
    model = [(0, "u32", 3),
             (1, "vtab", [[(0, "i8", min(c, 127)), (2, "i32", 1), (3, "i32", c)]
                          for c in opcodes]),
             (2, "vtab", [subgraph]), (3, "str", "tachikoma_tpu_torch MobileNetV2 uint8"),
             (4, "vtab", ts.buffers)]
    return _Builder().finish(model)
