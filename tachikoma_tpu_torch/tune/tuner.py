"""Block-tile and layout tuner for the port's kernels (port of
`tachikoma_tpu/tune/tuner.py`).

Candidate configs are measured on the card and every trial, failures
included, is recorded in a `TuneDatabase` with the JAX package's error
taxonomy.  The config space is the port's own: `blocks` = [BM, BN, 64] over
the tiles the kernels are built at (`ops/kernels/_lib.py TILES`), times the
layouts None (K2), "t", "s", "w", "r" (K7-K10) for a conv; {bm, bn} for a
chain or a stack; the tiles plus {"impl": "xla"} (the library route) for a
GEMM.  The TPU's block sizes never enter it.  `tune_conv` measures the
direct conv (`ops/kernels/conv_direct.py`: K11, K12) at one layer shape: it
has no config to search.

Measure, then verify: a trial's output is first compared == with the plain
version on the same inputs, and only then timed (`utils/timing.py`); a
difference is recorded as WRONG_ANSWER, which is never best.  Inputs are the
JAX package's: numpy `default_rng(0)` and `plan_requantize(0.0004, 0.05)`.
Tasks measure on `device` ("cuda" by default; with no card they raise), and
on the CPU only when asked.
"""

from __future__ import annotations

import traceback
from typing import Sequence

import numpy as np
import torch

from ..ops.kernels._lib import DEFAULT_BLOCKS, TILES, compiled_blocks
from ..ops.kernels.conv import (chain_workload, flat_conv_workload, qconv2d_flat,
                                qconv2d_flat_block_stack, qconv2d_flat_block_stack_plain,
                                qconv2d_flat_chain, qconv2d_flat_chain_plain, qconv_rq_plain,
                                stack_workload)
from ..ops.kernels.conv_direct import qconv2d_int8, qconv2d_int8_plain, qconv2d_supported
from ..ops.kernels.conv_layouts import LAYOUTS, layout_fits
from ..ops.kernels.depthwise import qdwconv_rq_plain
from ..ops.kernels.matmul_int8 import (matmul_workload, qgemm_raw_plain, qgemm_raw_tuned,
                                       qgemm_rq_plain, qgemm_rq_tuned)
from ..ops.kernels.requantize import channel_vector, plan_requantize
from ..utils.timing import call_seconds
from .database import (COMPILE_ERROR, NO_ERROR, RUNTIME_ERROR, WRONG_ANSWER, TuneDatabase,
                       TuneRecord)

__all__ = ["matmul_workload", "flat_conv_workload", "chain_workload", "stack_workload",
           "conv_workload"]


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tune: device 'cuda' asked for but no CUDA device is available; "
                           "pass device='cpu' to tune the plain versions on the CPU")
    return device


def _to(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _trial(run, reference: torch.Tensor, device: torch.device) -> tuple[float, int, str]:
    """(seconds, error_no, msg) of one candidate: run it, compare its output
    == `reference`, then time it.  A refused config (ValueError: a tile not
    built, shared memory too small) or a failed build is a COMPILE_ERROR, a
    failed launch a RUNTIME_ERROR (torch._int_mm's refusals included)."""
    try:
        out = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception as e:
        tb = traceback.format_exc(limit=4)
        err = COMPILE_ERROR if isinstance(e, ValueError) or "nvcc" in str(e) else RUNTIME_ERROR
        return float("inf"), err, tb[-500:]
    if out.shape != reference.shape or not torch.equal(out, reference):
        bad = int((out != reference).sum()) if out.shape == reference.shape else -1
        return float("inf"), WRONG_ANSWER, (f"output != plain version: {bad} of "
                                            f"{reference.numel()} elements differ")
    try:
        return call_seconds(run, device), NO_ERROR, ""
    except Exception:
        return float("inf"), RUNTIME_ERROR, traceback.format_exc(limit=4)[-500:]


def _tops(ops: int):
    return lambda t: {"tops": round(ops / t / 1e12, 2)}


def matmul_candidates(M: int, K: int, N: int) -> list[tuple[int, int, int]]:
    """The compiled tiles (every shape takes every tile: edges are masked)."""
    return [(bm, bn, DEFAULT_BLOCKS[2]) for bm, bn in TILES]


def _record(db, workload, cfg, t, err, msg, meta_fn, verbose):
    rec = TuneRecord(workload, cfg, t * 1e3 if np.isfinite(t) else float("inf"), err, msg,
                     meta=meta_fn(t) if err == NO_ERROR else {})
    db.add(rec)
    if verbose:
        status = (f"{t*1e6:.1f} us ({rec.meta.get('tops', 0)} TOPS)"
                  if err == NO_ERROR else f"err{err}: {msg[:60]}")
        print(f"  {workload} {cfg}: {status}", flush=True)


def matmul_task(M: int, K: int, N: int, fused: bool = True,
                candidates: Sequence[tuple[int, int, int]] | None = None,
                weight: int = 1, device="cuda"):
    """(workload, configs, measure, meta_fn, weight) for a GEMM workload: the
    task unit of schedule_tune and of tune_matmul's own loop.  K1 (fused) and
    K4's GEMM mode (fused False) alike: the compiled tiles and the library
    route."""
    dev = _device(device)
    rng = np.random.default_rng(0)
    a = _to(rng.integers(-127, 127, (M, K)).astype(np.int8), dev)
    b = _to(rng.integers(-127, 127, (K, N)).astype(np.int8), dev)
    bias = torch.zeros(N, dtype=torch.int32, device=dev)
    workload = matmul_workload(M, K, N, fused)
    if fused:
        mult, shift = plan_requantize(0.0004, 0.05)
        m, s = channel_vector(mult, N, dev), channel_vector(shift, N, dev)
        reference = qgemm_rq_plain(a, b, bias, m, s)
    else:
        reference = qgemm_raw_plain(a, b, bias)
    cands = list(candidates or matmul_candidates(M, K, N)) + ["xla"]
    configs = [{"impl": "xla"} if c == "xla" else {"blocks": list(c)} for c in cands]

    def measure(cfg):
        blocks = tuple(cfg["blocks"]) if "blocks" in cfg else "xla"
        if fused:
            run = lambda: qgemm_rq_tuned(a, b, bias, m, s, blocks=blocks)  # noqa: E731
        else:
            run = lambda: qgemm_raw_tuned(a, b, bias, blocks=blocks)  # noqa: E731
        return _trial(run, reference, dev)

    return workload, configs, measure, _tops(2 * M * K * N), weight


def _valid_gemm_config(cfg: dict) -> bool:
    return cfg.get("impl") == "xla" or compiled_blocks(cfg.get("blocks"))


def tune_matmul(M: int, K: int, N: int, db: TuneDatabase, fused: bool = False,
                candidates: Sequence[tuple[int, int, int]] | None = None,
                verbose: bool = True, strategy: str = "auto",
                device="cuda") -> TuneRecord | None:
    """Search a GEMM's tile (and the library route) on `device`.

    strategy: 'grid' measures every candidate; 'model' ranks by the learned
    cost model (tune/model.py) and stops early; 'evolve' breeds configs
    (tune/evolutionary.py, compiled tiles only); 'auto' uses the model when
    the database has enough records to fit one."""
    workload, configs, measure, meta_fn, _w = matmul_task(
        M, K, N, fused=fused, candidates=candidates, device=device)

    from .model import fit_from_db, model_search

    if strategy == "evolve":
        from .evolutionary import evolutionary_search

        best, n = evolutionary_search(workload, configs, measure, db,
                                      valid_fn=_valid_gemm_config, verbose=verbose,
                                      meta_fn=meta_fn)
        if verbose:
            print(f"  {workload}: evolutionary search measured {n} configs", flush=True)
        return best
    if strategy == "model" or (strategy == "auto" and fit_from_db(db) is not None):
        best, trials = model_search(workload, configs, measure, db, verbose=verbose,
                                    meta_fn=meta_fn)
        if verbose:
            print(f"  {workload}: model search measured {trials}/{len(configs)} candidates",
                  flush=True)
        return best
    for cfg in configs:
        t, err, msg = measure(cfg)
        _record(db, workload, cfg, t, err, msg, meta_fn, verbose)
    return db.best(workload)


def conv_flat_candidates(shape, wshape, strides, padding) -> list[tuple[tuple, str | None]]:
    """(blocks, layout) pairs: every compiled tile with K2 and with each
    layout whose shared memory fits this conv."""
    return [((bm, bn, DEFAULT_BLOCKS[2]), lay) for bm, bn in TILES for lay in (None,) + LAYOUTS
            if lay is None or layout_fits(lay, (bm, bn), shape, wshape, strides, padding)]


def _conv_supported(shape, wshape, groups) -> bool:
    cin, (wcin, cout) = shape[3], wshape[2:]
    return groups == 1 or (groups == cin and wcin == 1 and cout == cin)


def conv_flat_task(shape: tuple, wshape: tuple, strides, padding, groups,
                   weight: int = 1, device="cuda"):
    """(workload, configs, measure, meta_fn, weight) for a conv workload, or
    None for a geometry the port does not run (grouped, not depthwise).  A
    1x1 or depthwise conv has one config, {"kernel": "routed"} (its GEMM or
    K5 takes no conv tile), as in the JAX package."""
    n, h, w, cin = shape
    kh, kw, wcin, cout = wshape
    sh, sw = strides
    workload = flat_conv_workload(n, h, w, cin, cout, kh, kw, strides, True, groups)
    if not _conv_supported(shape, wshape, groups):
        return None
    dev = _device(device)
    rng = np.random.default_rng(0)
    x = _to(rng.integers(-127, 127, shape).astype(np.int8), dev)
    wt = _to(rng.integers(-127, 127, wshape).astype(np.int8), dev)
    mult, shift = plan_requantize(0.0004, 0.05)
    strides, padding = tuple(strides), tuple(padding)
    m, s = channel_vector(mult, cout, dev), channel_vector(shift, cout, dev)
    bias = torch.zeros(cout, dtype=torch.int32, device=dev)
    if groups == 1:
        reference = qconv_rq_plain(x, wt, bias, m, s, strides=strides, padding=padding)
    else:
        reference = qdwconv_rq_plain(x, wt, bias, m, s, strides=strides, padding=padding)
    if groups == 1 and (kh, kw) != (1, 1):
        configs = []
        for blocks, layout in conv_flat_candidates(shape, wshape, strides, padding):
            cfg = {"blocks": list(blocks)}
            if layout:
                cfg["layout"] = layout
            configs.append(cfg)
    else:
        configs = [{"kernel": "routed"}]
    macs = n * ((h + padding[0] + padding[2] - kh) // sh + 1) * (
        (w + padding[1] + padding[3] - kw) // sw + 1) * cout * kh * kw * (cin // groups)

    def measure(cfg):
        blocks = tuple(cfg["blocks"]) if "blocks" in cfg else None
        layout = cfg.get("layout")

        def run():
            return qconv2d_flat(x, wt, multiplier=mult, shift=shift, strides=strides,
                                padding=padding, groups=groups, blocks=blocks, layout=layout)

        return _trial(run, reference, dev)

    return workload, configs, measure, _tops(2 * macs), weight


def tune_conv_flat(shape: tuple, wshape: tuple, strides, padding, groups, db: TuneDatabase,
                   verbose: bool = True, strategy: str = "auto",
                   device="cuda") -> TuneRecord | None:
    """Search a conv's (tile, layout) (grid, or model-ranked with early stop
    -- see tune_matmul)."""
    task = conv_flat_task(shape, wshape, strides, padding, groups, device=device)
    if task is None:
        n, h, w, cin = shape
        kh, kw, _, cout = wshape
        db.add(TuneRecord(flat_conv_workload(n, h, w, cin, cout, kh, kw, strides, True, groups),
                          {}, float("inf"), COMPILE_ERROR, "unsupported"))
        return None
    workload, configs, measure, meta_fn, _w = task

    from .model import fit_from_db, model_search

    if len(configs) > 6 and (strategy == "model" or (
            strategy == "auto" and fit_from_db(db) is not None)):
        best, trials = model_search(workload, configs, measure, db, verbose=verbose,
                                    meta_fn=meta_fn)
        if verbose:
            print(f"  {workload}: model search measured {trials}/{len(configs)} candidates",
                  flush=True)
        return best
    for cfg in configs:
        t, err, msg = measure(cfg)
        _record(db, workload, cfg, t, err, msg, meta_fn, verbose)
    return db.best(workload)


def conv_workload(n, h, w, cin, cout, kh, kw, stride, groups) -> str:
    """Tuning-database key of a direct conv (`tachikoma_tpu/tune/tuner.py:57`)."""
    return (f"qconv2d_int8/N{n}_H{h}_W{w}_C{cin}_O{cout}_K{kh}x{kw}"
            f"_S{stride[0]}x{stride[1]}_G{groups}")


def tune_conv(shape: tuple, wshape: tuple, strides, padding, groups, db: TuneDatabase,
              verbose: bool = True, device="cuda") -> TuneRecord | None:
    """Measure the direct conv (`qconv2d_int8`: K11, or K12 for a depthwise
    conv) at one layer shape and record its time and TOP/s; it has no
    config to search.  The record's config is the JAX package's,
    {"kernel": "pallas_direct"}, so that the records of both packages stay
    byte-equal apart from the time; a geometry `qconv2d_supported` refuses
    gets the COMPILE_ERROR record "unsupported"."""
    dev = _device(device)
    n, h, w, cin = shape
    kh, kw, wcin, cout = wshape
    workload = conv_workload(n, h, w, cin, cout, kh, kw, strides, groups)
    if not qconv2d_supported(shape, wshape, strides, padding, groups):
        db.add(TuneRecord(workload, {}, float("inf"), COMPILE_ERROR, "unsupported"))
        return None
    rng = np.random.default_rng(0)
    x = _to(rng.integers(-127, 127, shape).astype(np.int8), dev)
    wt = _to(rng.integers(-127, 127, wshape).astype(np.int8), dev)
    mult, shift = plan_requantize(0.0004, 0.05)
    kw_ = dict(multiplier=mult, shift=shift, strides=tuple(strides), padding=tuple(padding),
               groups=groups)
    reference = qconv2d_int8_plain(x, wt, **kw_)
    t, err, msg = _trial(lambda: qconv2d_int8(x, wt, **kw_), reference, dev)
    macs = n * ((h + padding[0] + padding[2] - kh) // strides[0] + 1) * (
        (w + padding[1] + padding[3] - kw) // strides[1] + 1) * cout * kh * kw * (cin // groups)
    rec = TuneRecord(workload, {"kernel": "pallas_direct"},
                     t * 1e3 if np.isfinite(t) else float("inf"), err, msg,
                     meta={"tops": round(2 * macs / t / 1e12, 2) if err == NO_ERROR else 0})
    db.add(rec)
    if verbose:
        status = (f"{t * 1e3:.3f} ms ({rec.meta['tops']} TOPS)" if err == NO_ERROR
                  else f"err{err}: {msg[:80]}")
        print(f"  {workload}: {status}", flush=True)
    return db.best(workload)


def _stage_dicts(rng, dims, mult, shift, dev):
    stages = []
    for (kh, ci, co) in dims:
        pad = kh // 2
        stages.append(dict(
            w=_to(rng.integers(-127, 127, (kh, kh, ci, co)).astype(np.int8), dev),
            bias=_to(rng.integers(-500, 500, (co,)).astype(np.int32), dev),
            multiplier=mult, shift=shift, izp=0, out_zp=0, padding=(pad, pad, pad, pad)))
    return stages


def _tile_configs(bms, bn_caps) -> list[dict]:
    return [{"bm": bm, "bn": bn} for bm in bms for bn in bn_caps]


def conv_chain_task(n, h, w, stage_dims, weight: int = 1, device="cuda",
                    bms=(64, 128), bn_caps=(64, 128)):
    """(workload, configs, measure, meta_fn, weight) for a chain geometry
    (stage_dims = [(kh, cin, cout), ...], 'same' padding): {bm, bn} is the
    tile of every stage's K1, K2 and K3 launch."""
    dev = _device(device)
    workload = chain_workload(n, h, w, stage_dims)
    rng = np.random.default_rng(0)
    mult, shift = plan_requantize(0.0004, 0.05)
    stages = _stage_dicts(rng, stage_dims, mult, shift, dev)
    x = _to(rng.integers(-127, 127, (n, h, w, stage_dims[0][1])).astype(np.int8), dev)
    macs = sum(n * h * w * co * kh * kh * ci for (kh, ci, co) in stage_dims)
    reference = qconv2d_flat_chain_plain(x, stages)

    def measure(cfg):
        return _trial(lambda: qconv2d_flat_chain(x, stages, bm=cfg["bm"], bn_cap=cfg["bn"]),
                      reference, dev)

    return workload, _tile_configs(bms, bn_caps), measure, _tops(2 * macs), weight


def tune_conv_chain(n, h, w, stage_dims, db: TuneDatabase, verbose: bool = True,
                    bms=(64, 128), bn_caps=(64, 128), device="cuda") -> TuneRecord | None:
    """Tune a chain geometry's tile (grid over the compiled tiles)."""
    workload, configs, measure, meta_fn, _w = conv_chain_task(
        n, h, w, stage_dims, device=device, bms=bms, bn_caps=bn_caps)
    for cfg in configs:
        t, err, msg = measure(cfg)
        _record(db, workload, cfg, t, err, msg, meta_fn, verbose)
    return db.best(workload)


def conv_stack_task(n, h, w, block_dims, weight: int = 1, device="cuda",
                    bms=(64, 128), bn_caps=(64, 128)):
    """(workload, configs, measure, meta_fn, weight) for a residual-block
    stack (block_dims = [[(kh, cin, cout), ...] per block], every block an
    identity residual, 'same' padding)."""
    dev = _device(device)
    workload = stack_workload(n, h, w, block_dims)
    rng = np.random.default_rng(0)
    mult, shift = plan_requantize(0.0004, 0.05)
    blocks = []
    for dims in block_dims:
        rp = dict(lhs_scale=0.05, lhs_zero_point=0, rhs_scale=0.04, rhs_zero_point=0,
                  output_scale=0.04, output_zero_point=0, rounding="UPWARD")
        blocks.append((_stage_dicts(rng, dims, mult, shift, dev), rp))
    x = _to(rng.integers(-127, 127, (n, h, w, block_dims[0][0][1])).astype(np.int8), dev)
    macs = sum(n * h * w * co * kh * kh * ci for dims in block_dims for (kh, ci, co) in dims)
    reference = qconv2d_flat_block_stack_plain(x, blocks)

    def measure(cfg):
        return _trial(lambda: qconv2d_flat_block_stack(x, blocks, bm=cfg["bm"],
                                                       bn_cap=cfg["bn"]),
                      reference, dev)

    return workload, _tile_configs(bms, bn_caps), measure, _tops(2 * macs), weight
