"""The port's evaluation modules on the CPU, against the JAX package's:
`quantize/dataset.py` (arrays ==), `quantize/accuracy.py` (`eval_topk` and
`compare_calibrations`: the port's "torch" backend on the CPU and its
"oracle" give the JAX package's agreements and accuracies exactly) and
`quantize/evaluate.py` (`quantization_report`: every output's and layer's
SNR within 1e-6 dB, their max |err| within 1e-6 relative), on sklearn's
digits with the trained digits CNN (tests/fixtures/digits_cnn.npz) and on
`synthetic_images` with ResNet-18 at 32^2; the CLI's `evaluate` with
`--device cpu`."""

import os
import sys

import numpy as np
import pytest

import tachikoma_tpu.quantize.accuracy as j_accuracy
import tachikoma_tpu.quantize.dataset as j_dataset
from tachikoma_tpu.models import digits_cnn as j_digits_cnn
from tachikoma_tpu.models import resnet as j_resnet
from tachikoma_tpu.quantize.evaluate import quantization_report as j_report
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.models.vision import digits_cnn, resnet
from tachikoma_tpu_torch.quantize import accuracy, dataset
from tachikoma_tpu_torch.quantize.evaluate import quantization_report
from tachikoma_tpu_torch.quantize.quantizer import quantize
from torch_import_cases import same_graph

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "digits_cnn.npz")
SNR_TOL_DB = 1e-6


def _same_dataset(a, b):
    assert a.name == b.name and a.data.dtype == b.data.dtype
    np.testing.assert_array_equal(a.data, b.data)
    if b.labels is None:
        assert a.labels is None
    else:
        assert a.labels.dtype == b.labels.dtype
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW", "flat"])
def test_digits_as_the_reference(layout):
    _same_dataset(dataset.digits(layout), j_dataset.digits(layout))


def test_digits_without_sklearn_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="sklearn"):
        dataset.digits()


@pytest.mark.parametrize("n,shape,seed", [(3, (16, 16, 3), 0), (2, (9, 7), 5),
                                          (4, (24, 20, 1), 11)])
def test_synthetic_images_as_the_reference(n, shape, seed):
    _same_dataset(dataset.synthetic_images(n, shape, seed=seed),
                  j_dataset.synthetic_images(n, shape, seed=seed))


@pytest.mark.parametrize("shape,classes", [((16, 16, 3), 8), ((12, 12, 1), 32)])
def test_synthetic_labeled_as_the_reference(shape, classes):
    _same_dataset(dataset.synthetic_labeled(6, shape, classes, seed=2),
                  j_dataset.synthetic_labeled(6, shape, classes, seed=2))


@pytest.mark.parametrize("spec,shape", [("digits", (4, 64)), ("digits", (4, 1, 8, 8)),
                                        ("digits", (4, 8, 8, 1)), ("synthetic", (2, 12, 12, 3)),
                                        ("synthetic-labeled", (2, 3, 12, 12)),
                                        ("synthetic-labeled", (2, 12, 12, 3)), ("npz", (1, 2))])
def test_get_dataset_batches_and_split_as_the_reference(spec, shape, tmp_path):
    if spec == "npz":
        spec = str(tmp_path / "d.npz")
        np.savez(spec, data=np.arange(10, dtype=np.float32).reshape(5, 2), labels=np.arange(5))
    ds, jds = dataset.get_dataset(spec, shape, samples=7), j_dataset.get_dataset(spec, shape,
                                                                                 samples=7)
    _same_dataset(ds, jds)
    for (a, va), (b, vb) in zip(ds.batches(3, limit=5), jds.batches(3, limit=5), strict=True):
        assert va == vb
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ds.split(2), jds.split(2)):
        _same_dataset(a, b)


@pytest.fixture(scope="module")
def digits_graphs():
    head, jhead = dataset.digits().split(512)[0], j_dataset.digits().split(512)[0]
    g, jg = digits_cnn(FIXTURE, batch_size=64), j_digits_cnn(FIXTURE, batch_size=64)
    assert same_graph(g, jg)
    calib = [c for c, _ in head.batches(64, limit=64)]
    q, jq = quantize(g, calib), j_quantize(jg, calib)
    assert same_graph(q, jq)
    return g, jg, q, jq, head, jhead


def _same_report(a, b):
    assert (a.name, a.n) == (b.name, b.n)
    for key in ("top1_agree", "top5_agree", "top1_float", "top1_quant", "top5_float",
                "top5_quant"):
        assert getattr(a, key) == getattr(b, key), (key, a.row(), b.row())
    assert a.row() == b.row()


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_eval_topk_on_digits_as_the_reference(digits_graphs, backend):
    g, jg, q, jq, head, jhead = digits_graphs
    rep = accuracy.eval_topk(g, q, head, executor=backend, limit=256, device="cpu")
    want = j_accuracy.eval_topk(jg, jq, jhead, executor="oracle", limit=256)
    _same_report(rep, want)
    assert rep.top1_float >= 0.93 and rep.top1_agree >= 0.95


def test_compare_calibrations_on_digits_as_the_reference(digits_graphs):
    g, jg, _, _, head, jhead = digits_graphs
    reps = accuracy.compare_calibrations(g, head, modes=("max", "percentile"), calib_samples=64,
                                         limit=128, device="cpu")
    wants = j_accuracy.compare_calibrations(jg, jhead, modes=("max", "percentile"),
                                            calib_samples=64, executor="oracle", limit=128)
    for rep, want in zip(reps, wants, strict=True):
        _same_report(rep, want)
    assert accuracy.table(reps) == j_accuracy.table(wants)


def test_unknown_backend_is_refused(digits_graphs):
    g, _, q, _, head, _ = digits_graphs
    with pytest.raises(ValueError, match="'torch' or 'oracle'"):
        accuracy.eval_topk(g, q, head, executor="jax", limit=64)


def _same_quant_report(rep, want):
    assert len(rep.outputs) == len(want.outputs) and len(rep.layers) == len(want.layers) >= 4
    for (n1, s1, e1, a1), (n2, s2, e2, a2) in zip(rep.outputs, want.outputs):
        assert n1 == n2 and a1 == a2 and abs(s1 - s2) <= SNR_TOL_DB
        assert e1 == pytest.approx(e2, rel=1e-6)
    for a, b in zip(rep.layers, want.layers):
        assert (a.name, a.op, a.scale) == (b.name, b.op, b.scale)
        assert abs(a.snr_db - b.snr_db) <= SNR_TOL_DB or a.snr_db == b.snr_db, a.name
        assert a.max_abs_err == pytest.approx(b.max_abs_err, rel=1e-6, abs=1e-12)
    assert rep.table(worst=5).splitlines()[0] == "outputs:"


def test_quantization_report_on_digits_as_the_reference(digits_graphs):
    g, jg, q, jq, head, _ = digits_graphs
    x = next(head.batches(64))[0]
    _same_quant_report(quantization_report(g, q, x), j_report(jg, jq, x))


def test_quantization_report_and_eval_topk_on_synthetic_images():
    """ResNet-18 (the zoo's, NHWC) b4 32^2 on synthetic_images: the report's
    SNRs and the top-k agreements of 16 images as the JAX package's."""
    g, jg = (resnet(18, batch_size=4, image_size=32, seed=1),
             j_resnet(18, batch_size=4, image_size=32, seed=1))
    ds, jds = (dataset.synthetic_images(16, (32, 32, 3), seed=4),
               j_dataset.synthetic_images(16, (32, 32, 3), seed=4))
    calib = [ds.data[:4]]
    q, jq = quantize(g, calib), j_quantize(jg, calib)
    assert same_graph(q, jq)
    _same_quant_report(quantization_report(g, q, ds.data[4:8]), j_report(jg, jq, jds.data[4:8]))
    _same_report(accuracy.eval_topk(g, q, ds, device="cpu"),
                 j_accuracy.eval_topk(jg, jq, jds, executor="oracle"))


def test_cli_evaluate(tmp_path, capsys, digits_graphs):
    """`evaluate` with --device cpu: the dataset harness's row per mode and
    the SNR report, each as the JAX package's functions print them."""
    g, jg, q, jq, head, jhead = digits_graphs
    cli_main(["evaluate", "digits_cnn", "--dataset", "digits", "--modes", "max", "--samples",
              "128", "--calib-samples", "64", "--batch", "64", "--device", "cpu"])
    out = capsys.readouterr().out.strip()
    want = j_accuracy.table(j_accuracy.compare_calibrations(
        jg, j_dataset.digits(), modes=("max",), calib_samples=64, executor="oracle", limit=128))
    assert out == want
    fpath, qpath, xin = (str(tmp_path / n) for n in ("f.json", "q.json", "x.npy"))
    with open(fpath, "w") as f:
        f.write(g.to_json())
    with open(qpath, "w") as f:
        f.write(q.to_json())
    x = next(head.batches(64))[0]
    np.save(xin, x)
    cli_main(["evaluate", fpath, qpath, "--input", xin, "--worst", "5", "--device", "cpu"])
    assert capsys.readouterr().out.strip() == j_report(jg, jq, x).table(worst=5)
    cli_main(["evaluate", fpath, qpath, "--dataset", "digits", "--samples", "128",
              "--backend", "oracle"])
    row = capsys.readouterr().out.strip()
    assert row == j_accuracy.eval_topk(jg, jq, j_dataset.digits(), executor="oracle",
                                       limit=128).row()
    with pytest.raises(SystemExit, match="needs a quantized graph"):
        cli_main(["evaluate", fpath, "--device", "cpu"])


@pytest.mark.parametrize("izp,big", [(-128, False), (3, False), (0, True)])
def test_integer_oracle_products_are_the_references(izp, big):
    """The port's qnn.conv2d / qnn.dense oracles sum in float64 BLAS where
    every partial sum is an integer below 2^53 (ops/nn.py exact_int_acc:
    `quantization_report` and `verify_trace` run on them), else in int64 as
    the JAX package's do: == the JAX oracle at the int8 extremes, and on
    int32 operands large enough to need the int64 sum (wrapping into the
    int32 output as the JAX oracle's does)."""
    from tachikoma_tpu.ir.graph import Node as JNode
    from tachikoma_tpu.ir.registry import get_op as j_get_op
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op
    from tachikoma_tpu_torch.ops.nn import exact_int_acc

    rng = np.random.default_rng(7)
    dtype, lo, hi = (np.int32, -2 ** 30, 2 ** 30) if big else (np.int8, -128, 128)
    x = rng.integers(lo, hi, (2, 6, 5, 16)).astype(dtype)
    w = rng.integers(lo, hi, (3, 3, 16, 8)).astype(dtype)
    x.flat[:4], w.flat[:4] = lo, lo
    assert exact_int_acc(x, w, 144) == (np.int64 if big else np.float64)
    cases = [("qnn.conv2d", (x, w), dict(input_zero_point=izp, padding=(1, 1, 1, 1),
                                         strides=(2, 1))),
             ("qnn.dense", (x.reshape(-1, 16), w[0, 0]), dict(input_zero_point=izp))]
    for op, args, attrs in cases:
        got = get_op(op).np_impl(*args, node=Node("y", op, ("a", "b"), attrs))
        want = j_get_op(op).np_impl(*args, node=JNode("y", op, ("a", "b"), attrs))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
