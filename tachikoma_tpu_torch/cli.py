"""Command-line interface of the port (port of `tachikoma_tpu/cli.py`).

  quantize  — build a zoo model (or read a graph .json / .tkmod), calibrate,
              write the integer graph JSON
  compile   — quantize (unless already integer) and bundle into a .tkmod
  run       — execute a graph (TorchExecutor, SegmentedExecutor with
              --segmented, or the numpy oracle), print outputs
  trace     — emit a tachikoma-standard trace binary for given inputs
              (--backend torch | torch-segmented | oracle)
  verify    — CRC + semantic verification of a trace binary
  info      — show a graph (ops, shapes, hash)
  evaluate  — quantization quality: per-layer SNR and output agreement, or
              dataset-scale top-1 / top-5 agreement and accuracy (--dataset)
  tune      — measure tiles and layouts of a graph's kernels on the card, append
              the records to a tuning database (--db, required)
  profile   — timing report on --device: --mode ablate (the graph cut at the
              segmented executor's cut points, cumulative latency per prefix;
              the default) or --mode isolated (each op timed alone)

Usage: python -m tachikoma_tpu_torch.cli <subcommand> [args]

`--device` defaults to "cuda" and never falls back to the CPU; pass
`--device cpu` to run the kernels' plain PyTorch versions.  Graph files are
`.json` or `.tkmod` artifacts (either package's), float `.onnx` models
(`quantize` calibrates them; QDQ models import as quantize-dequantize
islands), prequantized `.tflite` models (int8, or 16x8 on the W8A16 path),
`torch.save`d `.pt` / `.pth` modules (a torch.ao-quantized one becomes
an integer graph at its own scales, a float one a float graph; the input
shape comes from a saved `(model, shape)` tuple or
`TK_TORCH_INPUT_SHAPE=1,3,224,224`), frozen TensorFlow GraphDefs (`.pb`,
read by the in-tree codec: no TensorFlow needed), and Keras models (`.keras`,
`.h5`) and SavedModel directories, which need TensorFlow to trace and
freeze (without it they exit naming it); the zoo is the JAX CLI's:
lenet5 / mlp / digits_cnn / resnet18 / resnet34 / resnet50 / mobilenet_v2 /
vgg16 / vgg19 / squeezenet / densenet / resnet3d18 / lstm and the float
transformers bert / bert_base / gpt2 / vit_b16 / vit_l16 (`--image-size`,
`--seq-len` for lstm, bert and gpt2).  A transformer quantizes as in the JAX
package: `--transformer` takes the integer-attention preset (TRANSFORMER_INT8:
qnn.softmax, qnn.lut, qnn.layer_norm), without it the default QConfig keeps
softmax and gelu in float; a fused float graph's tk.attention stays float.
A float transformer graph also runs (`run`, with its attention fused by
`ir/transforms.py fuse_attention` when the graph was written).  The JAX
package's other subcommands are not ported yet and exit with the ROADMAP
item that ports them (`bench`: item 3).

Evaluation: `evaluate float.json quant.json [--input x.npy]` prints the
per-layer SNR report (the numpy oracle); `evaluate float.json quant.json
--dataset synthetic|digits|path.npz` the top-k agreement of the two graphs
over the dataset, and without the quantized graph one row per calibration
mode (`--modes`), on `--backend torch` (the default, on `--device`) or
`oracle`.

Tuning: `tune g.json --db h100.jsonl [--budget N]` appends H100 records to
the database; `run` (and every entry point) then dispatches each kernel call
by the best record of the database `$TK_TUNE_DB` names, and `compile` bundles
that file into the `.tkmod`.  The port has no packaged database and never
reads the JAX package's TPU one.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from collections import Counter

import numpy as np

ZOO = ("lenet5", "mlp", "resnet18", "resnet34", "resnet50", "mobilenet_v2", "bert", "bert_base",
       "vit_b16", "vit_l16", "gpt2", "vgg16", "vgg19", "squeezenet", "densenet", "resnet3d18",
       "lstm", "digits_cnn")
MODEL_SUFFIXES = (".json", ".tkmod", ".onnx", ".tflite", ".pt", ".pth", ".pb", ".keras", ".h5")
NOT_PORTED = {
    "bench": "the port's benchmark, ROADMAP Queue 1 item 3",
}


def _load_graph(path: str):
    from .ir.graph import Graph

    if path.endswith(".tkmod"):
        from .runtime.artifact import load_artifact

        return load_artifact(path)[0]
    if path.endswith(".onnx"):
        from .frontend.onnx import from_onnx

        return from_onnx(path)
    if path.endswith(".tflite"):
        # prequantized: already an integer graph, runnable and traceable as it is
        from .frontend.tflite import from_tflite

        return from_tflite(path)
    if path.endswith((".pt", ".pth")):
        return _load_torch(path)
    if path.endswith(".pb"):
        # a frozen GraphDef, through the in-tree codec
        from .frontend.tensorflow import from_tf_graphdef

        return from_tf_graphdef(path)
    if path.endswith((".keras", ".h5")) or os.path.isdir(path):
        if importlib.util.find_spec("tensorflow") is None:
            raise SystemExit(f"{path}: Keras models and SavedModels are traced and frozen by "
                             "TensorFlow, which is not installed; freeze the model to a .pb "
                             "GraphDef and pass that")
        if os.path.isdir(path):
            from .frontend.tensorflow import from_saved_model

            return from_saved_model(path)
        from .frontend.keras import from_keras

        return from_keras(path)
    if not path.endswith(".json"):
        raise SystemExit(f"{path}: not a graph .json / .tkmod, nor an .onnx, .tflite, .pt / .pth, "
                         ".pb, .keras / .h5 model or a SavedModel directory")
    with open(path) as f:
        return Graph.from_json(f.read())


def _load_torch(path: str):
    """A torch.save'd nn.Module / fx GraphModule, as the JAX CLI reads it: a
    torch.ao-quantized model through the prequantized importer (FQ2I, the
    model's own scales), a float one through the fx importer.  Input shape: a
    (model, shape) tuple in the file, or TK_TORCH_INPUT_SHAPE="1,3,224,224".
    The file is read with `frontend.torch_quantized.torch_load`, which also
    reads the quantized modules torch's own unpickling leaves broken."""
    from .frontend.torch_quantized import torch_load

    obj = torch_load(path)
    shape = None
    if isinstance(obj, (tuple, list)) and len(obj) == 2:
        obj, shape = obj
    if shape is None:
        env = os.environ.get("TK_TORCH_INPUT_SHAPE")
        if not env:
            raise SystemExit("torch import needs an input shape: save a (model, shape) tuple or "
                             "set TK_TORCH_INPUT_SHAPE=1,3,224,224")
        shape = tuple(int(v) for v in env.split(","))
    # quantized-module detection, with the JAX CLI's fallback to the fx
    # graph's call targets where module iteration raises
    try:
        quantized = any(
            type(m).__module__.startswith(("torch.ao.nn.quantized",
                                           "torch.ao.nn.intrinsic.quantized"))
            for m in dict(obj.named_modules()).values())
    except Exception:
        quantized = hasattr(obj, "graph") and any(
            "quantiz" in str(getattr(n, "target", "")) for n in obj.graph.nodes)
    if quantized:
        from .frontend.torch_quantized import import_torch_quantized

        return import_torch_quantized(obj, {"x": tuple(shape)})
    from .frontend.torch_fx import from_torch

    return from_torch(obj, {"x": tuple(shape)})


def _zoo(name: str, batch: int, image: int | None, seq: int | None = None):
    """The JAX CLI's zoo (`tachikoma_tpu/cli.py` _zoo), name for name and
    default for default."""
    from .models import transformer, vision

    name = name.lower()
    if name not in ZOO:
        raise SystemExit(f"unknown zoo model {name!r} (the zoo: {', '.join(ZOO)})")
    if name == "lenet5":
        return vision.lenet5(batch_size=batch)
    if name == "mlp":
        return vision.mlp(batch_size=batch)
    if name in ("resnet18", "resnet34", "resnet50"):
        return vision.resnet(int(name[6:]), batch_size=batch, image_size=image or 224)
    if name == "mobilenet_v2":
        return vision.mobilenet_v2(batch_size=batch, image_size=image or 224)
    if name in ("bert", "bert_base"):
        return transformer.bert_base(batch_size=batch, seq_len=seq or 128)
    if name == "vit_b16":
        return transformer.vit_b16(batch_size=batch, image_size=image or 224)
    if name == "vit_l16":
        return transformer.vit_l16(batch_size=batch, image_size=image or 224)
    if name == "gpt2":
        return transformer.gpt2_small(batch_size=batch, seq_len=seq or 128)
    if name in ("vgg16", "vgg19"):
        return vision.vgg(int(name[3:]), batch_size=batch, image_size=image or 224)
    if name == "squeezenet":
        return vision.squeezenet(batch_size=batch, image_size=image or 224)
    if name == "densenet":
        return vision.densenet(batch_size=batch, image_size=image or 224)
    if name == "resnet3d18":
        return vision.resnet_3d(18, batch_size=batch, image_size=image or 112)
    if name == "lstm":
        return vision.lstm(batch_size=batch, seq_len=seq or 16)
    # digits_cnn: the trained weights in the repo's test fixtures
    fx = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                      "fixtures", "digits_cnn.npz")
    return vision.digits_cnn(fx, batch_size=batch)


def _model(args):
    """The float (or integer) graph of a zoo name or a graph file."""
    if args.model.endswith(MODEL_SUFFIXES) or os.path.isfile(args.model) \
            or os.path.isdir(args.model):
        return _load_graph(args.model)
    return _zoo(args.model, args.batch, args.image_size, args.seq_len)


def _rand_inputs(graph, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for n in graph.inputs:
        if n.dtype.startswith("int"):
            out[n.name] = rng.integers(0, 100, n.shape).astype(n.dtype)
        else:
            out[n.name] = rng.standard_normal(n.shape).astype(n.dtype)
    return out


def _load_inputs(args, graph):
    if getattr(args, "input", None):
        data = np.load(args.input)
        if hasattr(data, "files"):
            return {k: data[k] for k in data.files}
        return {graph.inputs[0].name: data}
    return _rand_inputs(graph)


def cmd_quantize(args):
    from .quantize.config import TRANSFORMER_INT8, QConfig
    from .quantize.quantizer import quantize

    g = _model(args)
    if args.calib_data:
        data = np.load(args.calib_data)
        batches = [{k: data[k] for k in data.files}] if hasattr(data, "files") else [data]
    else:
        batches = [_rand_inputs(g, seed=i) for i in range(args.calib_batches)]
    cfg = TRANSFORMER_INT8 if args.transformer else QConfig(calibrate_mode=args.calibrate_mode)
    qg = quantize(g, batches, cfg)
    with open(args.output, "w") as f:
        f.write(qg.to_json())
    print(f"wrote {args.output}: {len(qg)} nodes, hash {qg.structural_hash()[:16]}")


def cmd_compile(args):
    """Quantize (unless already integer) and bundle into a .tkmod artifact,
    with the port's default tuning database ($TK_TUNE_DB) when one is set."""
    from .runtime.artifact import save_artifact

    g = _model(args)
    if not any(n.dtype in ("int8", "uint8", "int16") for n in g.nodes if not n.is_var):
        from .quantize.config import TRANSFORMER_INT8, QConfig
        from .quantize.quantizer import quantize

        cfg = TRANSFORMER_INT8 if args.transformer else QConfig()
        g = quantize(g, [_rand_inputs(g, seed=i) for i in range(args.calib_batches)], cfg)
    tune_db = os.environ.get("TK_TUNE_DB")
    save_artifact(args.output, g, tune_db_path=tune_db, meta={"source": args.model})
    print(f"wrote {args.output}: {len(g)} nodes, hash {g.structural_hash()[:16]}"
          + (f", tuning database {tune_db}" if tune_db and os.path.exists(tune_db) else ""))


def cmd_run(args):
    g = _load_graph(args.graph)
    inputs = _load_inputs(args, g)
    if args.backend == "oracle":
        from .runtime.interpreter import run_graph

        outs = run_graph(g, inputs)
    elif args.segmented:
        # graph-as-data execution for deep models (per-segment programs,
        # structural sharing, a scan over stacked layers: runtime/segmented.py)
        from .runtime.segmented import SegmentedExecutor

        outs = SegmentedExecutor(g, fuse=not args.no_fuse, device=args.device).run(inputs)
    else:
        from .runtime.executor import TorchExecutor

        outs = TorchExecutor(g, fuse=not args.no_fuse, device=args.device).run(inputs)
    for name, o in zip(g.outputs, outs):
        print(f"{name}: {o.dtype}{list(o.shape)}")
        with np.printoptions(threshold=20, precision=4):
            print(o)
    if args.output:
        np.savez(args.output, **dict(zip(g.outputs, outs)))


def cmd_trace(args):
    g = _load_graph(args.graph)
    inputs = _load_inputs(args, g)
    meta = {"model": args.graph}
    if args.native:
        from .trace.native import emit_trace_native

        if args.require_integer:
            from .trace.emitter import TraceEmitter

            TraceEmitter(g, backend="oracle", require_integer=True)
        n = emit_trace_native(g, inputs, args.output, backend=args.backend,
                              device=args.device, meta=meta)
    else:
        from .trace.emitter import emit_trace

        n = emit_trace(g, inputs, path=args.output, backend=args.backend, device=args.device,
                       meta=meta, require_integer=args.require_integer)
    print(f"wrote {args.output}: {n} records, {os.path.getsize(args.output)} bytes")


def cmd_verify(args):
    from .trace.emitter import verify_trace

    graph = _load_graph(args.graph) if args.graph else None
    if args.crc_only:
        from .trace.native import native_available, native_verify

        if native_available():
            print(f"CRC OK: {native_verify(args.trace)} records")
            return
    res = verify_trace(args.trace, graph)
    ok = res["verified"] == res["records"]
    print(f"verified {res['verified']}/{res['records']} records")
    for name, why in res["mismatches"][:20]:
        print(f"  MISMATCH {name}: {why}")
    sys.exit(0 if ok else 1)


def cmd_evaluate(args):
    """Quantization quality reports.

    Default: per-layer SNR + output agreement on one input batch
    (quantize/evaluate.py, on the numpy oracle).  With --dataset:
    dataset-scale top-1/top-5 accuracy + float-vs-int8 agreement
    (quantize/accuracy.py) on --backend — per calibration mode when no
    quantized graph is given."""
    def load(path):
        if path and not os.path.exists(path) and "." not in path:
            return _zoo(path, args.batch, None, None)
        return _load_graph(path)

    fg = load(args.float_graph)
    if args.dataset:
        from .quantize.accuracy import compare_calibrations, eval_topk, table
        from .quantize.dataset import get_dataset

        ds = get_dataset(args.dataset, tuple(fg.inputs[0].shape), samples=args.samples)
        if args.quant_graph:
            rep = eval_topk(fg, load(args.quant_graph), ds, executor=args.backend,
                            limit=args.samples, device=args.device)
            print(rep.row())
        else:
            reps = compare_calibrations(fg, ds, modes=args.modes.split(","),
                                        calib_samples=args.calib_samples, executor=args.backend,
                                        limit=args.samples, device=args.device)
            print(table(reps))
        return
    if not args.quant_graph:
        raise SystemExit("evaluate needs a quantized graph for the SNR report, or --dataset for "
                         "the accuracy harness")
    from .quantize.evaluate import quantization_report

    qg = _load_graph(args.quant_graph)
    rep = quantization_report(fg, qg, _load_inputs(args, fg))
    print(rep.table(worst=args.worst))


def cmd_info(args):
    g = _load_graph(args.graph)
    print(f"graph {g.name}: {len(g)} nodes, hash {g.structural_hash()[:16]}")
    print(f"inputs : {[(n.name, n.dtype, n.shape) for n in g.inputs]}")
    print(f"outputs: {[(o, g[o].dtype, g[o].shape) for o in g.outputs]}")
    for op, c in Counter(n.op for n in g.nodes).most_common():
        print(f"  {op:<24} {c}")


def cmd_tune(args):
    """Tune every GEMM and conv workload of the fused graph on `--device`;
    the records append to `--db`.  With --budget, the cross-workload
    scheduler spends that many trials by expected gain (tune/schedule.py);
    without it, every workload's candidates are measured once."""
    import json

    from .ops.nn import _pad4, _pair
    from .runtime.fuse import fuse_qnn
    from .tune.database import TuneDatabase
    from .tune.tuner import matmul_workload, tune_conv_flat, tune_matmul

    if not args.db:
        raise SystemExit("tune: --db is required (the port has no packaged database to "
                         "append to)")
    g = fuse_qnn(_load_graph(args.graph))
    db = TuneDatabase(args.db)
    if args.budget:
        from .tune.schedule import graph_tasks, schedule_tune

        rep = schedule_tune(graph_tasks(g, device=args.device), db, total_trials=args.budget,
                            verbose=True)
        print(json.dumps(rep, indent=1))
        print(f"{len(db)} records in {db.path}")
        return
    done = set(db.workloads())
    seen = set()
    for n in g.nodes:
        if n.op in ("tk.dense_rq", "qnn.dense"):
            M = int(np.prod(g[n.inputs[0]].shape[:-1]))
            K, N = (int(v) for v in g[n.inputs[1]].shape)
            key = ("mm", M, K, N)
            if key in seen or matmul_workload(M, K, N, True) in done:
                continue
            seen.add(key)
            tune_matmul(M, K, N, db, fused=True, device=args.device)
        elif n.op in ("tk.conv2d_rq", "qnn.conv2d"):
            a = dict(n.attrs)
            key = ("cv", tuple(g[n.inputs[0]].shape), tuple(g[n.inputs[1]].shape),
                   _pair(tuple(a.get("strides", (1, 1)))), _pad4(a.get("padding", (0, 0, 0, 0))),
                   int(a.get("groups", 1)))
            if key in seen:
                continue
            seen.add(key)
            tune_conv_flat(*key[1:], db, device=args.device)
    print(f"{len(db)} records in {db.path}")


def cmd_profile(args):
    g = _load_graph(args.graph)
    inputs = _load_inputs(args, g)
    if args.mode == "ablate":
        from .runtime.profiler import ablate_graph

        rep = ablate_graph(g, inputs, repeats=args.repeats, fuse=not args.no_fuse,
                           device=args.device)
        print({"csv": rep.csv, "json": rep.json}.get(args.format, rep.table)())
        return
    from .runtime.profiler import profile_graph

    print("NOTE: isolated per-op times mispredict in-context cost (each op runs alone, "
          "its inputs warm); use --mode ablate for in-context attribution.", file=sys.stderr)
    rep = profile_graph(g, inputs, repeats=args.repeats, fuse=not args.no_fuse,
                        device=args.device)
    if args.format == "table":
        print(rep.table(top=args.top))
    elif args.format == "csv":
        print(rep.csv())
    else:
        print(rep.json())


def cmd_not_ported(args):
    raise SystemExit(f"{args.cmd}: not ported yet ({NOT_PORTED[args.cmd]})")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tachikoma_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize", help="calibrate + quantize a model to an integer graph")
    q.add_argument("model", help=f"zoo name ({'/'.join(ZOO)}) or a graph / model file "
                   "(.json, .tkmod, .onnx, .tflite, .pt, .pb, .keras, .h5)")
    q.add_argument("-o", "--output", required=True)
    q.add_argument("--batch", type=int, default=1)
    q.add_argument("--image-size", type=int, default=None)
    q.add_argument("--seq-len", type=int, default=None)
    q.add_argument("--calib-data", help=".npz of calibration inputs")
    q.add_argument("--calib-batches", type=int, default=2)
    q.add_argument("--calibrate-mode", default="max",
                   choices=["max", "minmax", "percentile", "kl"])
    q.add_argument("--transformer", action="store_true",
                   help="use the integer-attention preset (TRANSFORMER_INT8)")
    q.set_defaults(fn=cmd_quantize)

    c = sub.add_parser("compile", help="quantize + bundle into a .tkmod artifact")
    c.add_argument("model", help=f"zoo name ({'/'.join(ZOO)}) or a graph / model file "
                   "(.json, .tkmod, .onnx, .tflite, .pt, .pb, .keras, .h5)")
    c.add_argument("-o", "--output", required=True)
    c.add_argument("--batch", type=int, default=1)
    c.add_argument("--image-size", type=int, default=None)
    c.add_argument("--seq-len", type=int, default=None)
    c.add_argument("--calib-batches", type=int, default=2)
    c.add_argument("--transformer", action="store_true",
                   help="use the integer-attention preset (TRANSFORMER_INT8)")
    c.set_defaults(fn=cmd_compile)

    r = sub.add_parser("run", help="execute a graph")
    r.add_argument("graph")
    r.add_argument("--backend", default="torch", choices=["torch", "oracle"])
    r.add_argument("--device", default="cuda", help="torch device (default cuda)")
    r.add_argument("--input", help=".npy/.npz input file (random if omitted)")
    r.add_argument("-o", "--output", help="save outputs to .npz")
    r.add_argument("--no-fuse", action="store_true")
    r.add_argument("--segmented", action="store_true",
                   help="run through SegmentedExecutor (per-segment programs, a scan over "
                        "stacked layers)")
    r.set_defaults(fn=cmd_run)

    t = sub.add_parser("trace", help="emit a tachikoma-standard trace binary")
    t.add_argument("graph")
    t.add_argument("-o", "--output", required=True)
    t.add_argument("--backend", default="torch", choices=["torch", "torch-segmented", "oracle"])
    t.add_argument("--device", default="cuda", help="torch device (default cuda)")
    t.add_argument("--input", help=".npy/.npz input file")
    t.add_argument("--native", action="store_true",
                   help="write record by record with the C++ writer")
    t.add_argument("--require-integer", action="store_true",
                   help="reject graphs with float computational records: "
                        "every record then carries the bitwise == guarantee")
    t.set_defaults(fn=cmd_trace)

    v = sub.add_parser("verify", help="verify a trace binary")
    v.add_argument("trace")
    v.add_argument("--graph", help="graph .json to check the hash against")
    v.add_argument("--crc-only", action="store_true")
    v.set_defaults(fn=cmd_verify)

    i = sub.add_parser("info", help="describe a graph")
    i.add_argument("graph")
    i.set_defaults(fn=cmd_info)

    e = sub.add_parser("evaluate", help="quantization quality: per-layer SNR, or "
                                         "dataset-scale accuracy with --dataset")
    e.add_argument("float_graph", help="graph file or zoo name")
    e.add_argument("quant_graph", nargs="?")
    e.add_argument("--input", help=".npy/.npz input file (random if omitted)")
    e.add_argument("--worst", type=int, default=15)
    e.add_argument("--dataset", help="'digits' | 'synthetic' | 'synthetic-labeled' | path.npz: "
                                     "run the accuracy harness instead of the SNR report")
    e.add_argument("--modes", default="max,percentile,kl",
                   help="calibration modes compared when no quantized graph is given")
    e.add_argument("--samples", type=int, default=200)
    e.add_argument("--calib-samples", type=int, default=32)
    e.add_argument("--batch", type=int, default=32)
    e.add_argument("--backend", default="torch", choices=["torch", "oracle"])
    e.add_argument("--device", default="cuda", help="torch device (default cuda)")
    e.set_defaults(fn=cmd_evaluate)

    tu = sub.add_parser("tune", help="tune the kernels' tiles and layouts for a graph")
    tu.add_argument("graph")
    tu.add_argument("--db", help="tuning database .jsonl to append to (required)")
    tu.add_argument("--budget", type=int, default=None,
                    help="total trials, spent across workloads by expected gain")
    tu.add_argument("--device", default="cuda", help="torch device (default cuda)")
    tu.set_defaults(fn=cmd_tune)

    pr = sub.add_parser("profile", help="timing report: --mode ablate (cumulative latency of "
                                         "the graph cut at the segmented executor's cut points, "
                                         "the default) or --mode isolated (each op alone)")
    pr.add_argument("graph")
    pr.add_argument("--mode", default="ablate", choices=["ablate", "isolated"])
    pr.add_argument("--input", help=".npy/.npz input file (random if omitted)")
    pr.add_argument("--repeats", type=int, default=5)
    pr.add_argument("--top", type=int, default=None)
    pr.add_argument("--format", default="table", choices=["table", "csv", "json"])
    pr.add_argument("--no-fuse", action="store_true")
    pr.add_argument("--device", default="cuda", help="torch device (default cuda)")
    pr.set_defaults(fn=cmd_profile)

    for name, where in NOT_PORTED.items():
        n = sub.add_parser(name, help=f"not ported yet ({where})")
        n.add_argument("rest", nargs=argparse.REMAINDER)
        n.set_defaults(fn=cmd_not_ported)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
