"""Build, load and launch the port's CUDA kernels, and count their launches.

The sources in `tachikoma_tpu_torch/csrc/` compile with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into one shared library per source, with a plain C interface, loaded with
ctypes.  The build runs at first use, into `tachikoma_tpu_torch/_build/`
(listed in .gitignore), one nvcc process per source, all started together.
A library's file name carries a hash of `csrc/`, so an edited source is
rebuilt.

Every C entry takes its tensor pointers, a host int32 parameter array laid out
as `PARAMS` (`csrc/params.cuh` enum Param) and the CUDA stream, launches on
that stream and returns `cudaGetLastError()`.  One array for every kernel:
K6's float32 scale travels in it as the int32 that holds its bits
(`float32_bits`), so there is one build and one launch path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from collections import Counter
from pathlib import Path

import numpy as np
import torch

# Launches per kernel; each wrapper adds one where it launches its kernel.
LAUNCHES: Counter = Counter()

PARAMS = (
    "n", "h", "w", "cin", "kh", "kw", "cout", "oh", "ow", "sh", "sw", "pt", "pl",
    "izp", "rq_izp", "out_zp", "qmin", "qmax", "tonearest", "a_vec", "b_vec",
    "l_skip", "lm", "ls", "lzp", "r_skip", "rm", "rs", "rzp", "zo", "lo", "hi",
    "add_tonearest", "g", "s", "d", "causal", "scale_bits", "bm", "bn",
    "group", "cc", "th", "tw", "ks", "kper", "wres", "ahead",
    "heads", "q_sb", "q_sh", "q_ss", "k_sb", "k_sh", "k_ss", "v_sb", "v_sh", "v_ss",
    "fa_w", "fa_dq", "fa_dv", "fa_cs", "fa_kg", "fa_vec", "dw_rp",
    "fa_stages", "fa_bk", "qg_path",
    "bmm_nb", "bmm_nb1", "a_mode", "b_mode", "a_sb0", "a_sb1", "a_sm", "a_sk", "b_sb0", "b_sb1",
    "b_sn", "b_sk", "bmm_za", "bmm_zb", "bmm_path", "dh", "dw", "cspan", "a_u8",
)

# The block tiles (BM, BN) that the tiled paths of K1 and K4's GEMM mode, K2,
# K3 and K7-K10 are built at, with BK = 64: the tuner's config space for
# `blocks` = [BM, BN, BK]
# (csrc/igemm_hopper.cuh igemm_hopper, csrc/layouts_hopper.cuh).
BK = 64
TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
DEFAULT_BLOCKS = (64, 64, BK)


def compiled_blocks(blocks) -> bool:
    """Whether `blocks` (BM, BN, BK) names a tile the kernels are built at."""
    try:
        bm, bn, bk = (int(b) for b in blocks)
    except (TypeError, ValueError):
        return False
    return (bm, bn) in TILES and bk == BK


def tile_params(blocks) -> dict:
    """The kernel parameters (bm, bn) of `blocks`, or of the default tile for
    None; ValueError for a tile the kernels are not built at."""
    if blocks is None:
        blocks = DEFAULT_BLOCKS
    if not compiled_blocks(blocks):
        raise ValueError(f"blocks {tuple(blocks)} is not a compiled tile: (BM, BN) in {TILES} "
                         f"with BK {BK}")
    return {"bm": int(blocks[0]), "bn": int(blocks[1])}


_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# source -> (C entry, number of tensor pointers it takes)
SOURCES = {
    "qgemm_rq.cu": (("tk_qgemm_rq", 8), ("tk_qgemm_raw", 5)),
    "qbmm_hopper.cu": (("tk_qbmm_rq", 6), ("tk_qbmm_raw", 4)),
    "qbmm_wide_hopper.cu": (("tk_qbmm_wide", 3),),
    "qconv_igemm_hopper.cu": (("tk_qconv_rq", 8), ("tk_qconv_rq_res", 7), ("tk_qconv_raw", 5)),
    "qdwconv.cu": (("tk_qdwconv_rq", 7), ("tk_qdwconv_raw", 5), ("tk_qdwconv_direct", 6),
                   ("tk_qdwconv_wide", 3)),
    "flash_attn.cu": (("tk_flash_attn", 4),),
    "qconv_layouts.cu": (("tk_qconv_rq_s", 6), ("tk_qconv_rq_r", 6)),
    "qconv_layouts_hopper.cu": (("tk_qconv_rq_t", 6), ("tk_qconv_rq_w", 6)),
    "qconv_direct.cu": (("tk_qconv_direct", 6),),
    "qconv_wide_hopper.cu": (("tk_qgemm_wide", 4), ("tk_qconv_wide", 4)),
}
# -fno-gnu-unique: g++ would give the launchers' once-per-kernel statics
# (function-template locals) STB_GNU_UNIQUE binding, which the dynamic linker
# shares across every library loaded in the process, even under RTLD_LOCAL;
# a second copy of a library would then skip raising its own kernels'
# shared-memory limit.  With it they stay local to each library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique")

_entries: dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels build where the CUDA toolkit is")
    return found


def _library(src: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> tuple[float, str]:
    """Compile every source whose library is missing, all at once.  Returns
    (seconds, compiler output); `verbose` adds `-Xptxas=-v` (registers,
    shared memory and spills of each kernel)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for src in SOURCES:
        lib = _library(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, proc, tmp, lib))
    logs, failed = [], []
    for src, proc, tmp, lib in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, lib)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    return time.perf_counter() - t0, log


def _entry(name: str):
    with _lock:
        if not _entries:
            build()
            for src, entries in SOURCES.items():
                lib = ctypes.CDLL(str(_library(src)))
                for fn_name, n_ptr in entries:
                    fn = getattr(lib, fn_name)
                    # tensor pointers, the host parameter array, the stream
                    fn.argtypes = [ctypes.c_void_p] * (n_ptr + 2)
                    fn.restype = ctypes.c_int
                    _entries[fn_name] = fn
        return _entries[name]


def float32_bits(x: float) -> int:
    """The int32 whose bits are the float32 `x` (K6's scale parameter)."""
    return int(np.float32(x).view(np.int32))


def launch(name: str, tensors, params: dict) -> None:
    """Call C entry `name` on the current stream of the tensors' device and
    raise if the launch failed; a None among `tensors` passes a null
    pointer (an operand the call does not have: K1-K5's kzp)."""
    unknown = set(params) - set(PARAMS)
    if unknown:
        raise KeyError(f"unknown kernel parameters {sorted(unknown)}")
    arr = (ctypes.c_int32 * len(PARAMS))(*(int(params.get(k, 0)) for k in PARAMS))
    fn = _entry(name)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors), ctypes.addressof(arr),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check_cuda_operands(kernel: str, device: torch.device, contiguous: bool = True,
                        **operands) -> None:
    """Raise unless every operand (tensor, dtype, shape) is a tensor of that
    dtype and shape on `device`, contiguous unless `contiguous` is False
    (K6 reads strided views through their strides)."""
    for key, (t, dtype, shape) in operands.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {key} must be a tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{kernel}: {key} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {key} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{kernel}: {key} must be contiguous")


LEGACY_ITEM = ("ROADMAP Queue 1 item 2: legacy uint8 operands (uint8 data, a weight zero "
               "point, a uint8 output) run on K1, K2, K4 and K5 alone")


def refuse_uint8(kernel: str, *xs) -> None:
    """NotImplementedError, naming LEGACY_ITEM, where any of `xs` is uint8:
    the kernels other than K1, K2, K4 and K5 take no legacy uint8 data."""
    if any(isinstance(x, torch.Tensor) and x.dtype == torch.uint8 for x in xs):
        raise NotImplementedError(f"{kernel}: uint8 data ({LEGACY_ITEM})")


def check_fill(kernel: str, x: torch.Tensor, izp: int, padding, always: bool = False) -> None:
    """NotImplementedError where the input zero point is not a value of x's
    dtype and the kernel would fill a border with it (K2 / K4 where there
    is padding; K5, whose window is filled at every tile's edge, always):
    the kernels stage the border as izp's byte."""
    lo, hi = (0, 255) if x.dtype == torch.uint8 else (-128, 127)
    if (always or any(padding)) and not lo <= int(izp) <= hi:
        raise NotImplementedError(f"{kernel}: input zero point {izp} pads a {x.dtype} image: "
                                  "the kernels fill the border with its byte (ROADMAP Queue 1 "
                                  "item 2)")


def pack_once(cache: dict, w: torch.Tensor, make) -> torch.Tensor:
    """`make(w)`, made once per weight tensor and kept in `cache` while the
    tensor lives and its `_version` (in-place writes) is unchanged: the
    weights are constants of the graph."""
    key = id(w)
    hit = cache.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    wk = make(w)
    cache[key] = (weakref.ref(w, lambda _, key=key, cache=cache: cache.pop(key, None)),
                  w._version, wk)
    return wk


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count
