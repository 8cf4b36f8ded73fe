"""The ops the rest of the vision zoo brings to the port (qnn.avg_pool2d,
nn.avg_pool2d, nn.batch_norm, nn.relu, sigmoid, exp, split, max, mean,
nn.conv2d_transpose, nn.conv3d, vision.non_max_suppression) and the CLI's
zoo, on the CPU, against the JAX package.

Each op case builds the same one-op graph in both packages (equal JSON) and
runs the JAX package's oracle, `JaxExecutor`, the port's oracle and the
port's torch impl on the same inputs: integer outputs with ==; the port's
nn.batch_norm and nn.relu bit-equal to the oracle (they are written op for
op; XLA's batch norm is an ulp off it, within 1e-6); the transcendental
outputs within rtol 1e-6, atol 1e-6 of the oracle, the convolutions' within
1e-4 (another sum order)."""

import inspect
import json

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.runtime.executor import JaxExecutor
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ir.graph import Graph, Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.runtime.executor import TorchExecutor


def _r(*shape, seed=0, lo=-128, hi=128, dtype=np.int8):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _f(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _avg(pool, strides, padding, cip=False, ceil=False):
    return dict(pool_size=pool, strides=strides, padding=padding, count_include_pad=cip,
                ceil_mode=ceil)


def _qavg(rounding, izp, ozp, iscale=0.05, oscale=0.05, **pool):
    return dict(input_scale=iscale, input_zero_point=izp, output_scale=oscale,
                output_zero_point=ozp, rounding=rounding, out_dtype="int8", **_avg(**pool))


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    lo = rng.random((1, n, 2)).astype(np.float32) * 0.7
    hw = (0.1 + rng.random((1, n, 2)) * 0.3).astype(np.float32)
    return np.concatenate([lo, lo + hw], axis=-1)


_TIED = np.array([[0.9, 0.5, 0.9, 0.3, 0.5, 0.05, 0.05, 0.9]], np.float32)
_SAME = np.repeat(np.array([[[0.1, 0.1, 0.5, 0.5]]], np.float32), 8, axis=1)
_SAME[0, 4:] += 0.3  # two clusters of four identical boxes

# (id, op, inputs, attrs, exact: == against the oracle, else the float tolerance)
OP_CASES = [
    # qnn.avg_pool2d: Inception's 3x3 s1 pad 1 (count_include_pad), DenseNet's
    # 2x2 s2, windows the padding cuts, nonzero zero points, both roundings
    *((f"qavg_{nm}_{rnd.lower()}", "qnn.avg_pool2d", [_r(2, 7, 7, 5, seed=i)],
       _qavg(rnd, izp, ozp, oscale=os_, **pool), True)
      for i, (nm, izp, ozp, os_, pool) in enumerate((
          ("3x3s1_cip", 3, -2, 0.05, dict(pool=(3, 3), strides=(1, 1), padding=(1, 1, 1, 1),
                                          cip=True)),
          ("3x3s1_nocip", -7, 5, 0.07, dict(pool=(3, 3), strides=(1, 1), padding=(1, 1, 1, 1))),
          ("2x2s2", 0, 0, 0.05, dict(pool=(2, 2), strides=(2, 2), padding=(0, 0, 0, 0))),
          ("3x3s2_asym_ceil", 11, -9, 0.031, dict(pool=(3, 3), strides=(2, 2),
                                                  padding=(0, 1, 1, 0), ceil=True))))
      for rnd in ("UPWARD", "TONEAREST")),
    ("avg_pool_int8_pad", "nn.avg_pool2d", [_r(2, 6, 6, 3)],
     _avg((3, 3), (2, 2), (1, 1, 1, 1)), True),
    ("avg_pool_int32_cip", "nn.avg_pool2d", [_r(1, 5, 5, 4, lo=-1000, hi=1000, dtype=np.int32)],
     _avg((2, 2), (1, 1), (1, 0, 0, 1), cip=True), True),
    ("avg_pool_float", "nn.avg_pool2d", [_f(2, 6, 6, 3)], _avg((3, 3), (1, 1), (1, 1, 1, 1)),
     1e-6),
    ("split_sections", "split", [_r(2, 12, 3)], dict(indices_or_sections=4, axis=1), True),
    ("split_indices", "split", [_f(3, 10)], dict(indices_or_sections=(2, 7), axis=-1), True),
    ("split_lstm_gates", "split", [_f(1, 512)], dict(indices_or_sections=4, axis=1), True),
    ("batch_norm", "nn.batch_norm",
     [_f(2, 5, 5, 8, scale=3), np.abs(_f(8, seed=1)) + 0.5, _f(8, seed=2, scale=0.1),
      _f(8, seed=3, scale=0.1), np.abs(_f(8, seed=4)) + 0.5], {}, True),
    ("batch_norm_ndhwc", "nn.batch_norm",
     [_f(1, 2, 3, 3, 4, scale=2), np.abs(_f(4, seed=1)) + 0.5, _f(4, seed=2), _f(4, seed=3),
      np.abs(_f(4, seed=4)) + 1e-3], dict(epsilon=1e-3), True),
    ("relu_float", "nn.relu", [_f(3, 7)], {}, True),
    ("relu_int8", "nn.relu", [_r(3, 7)], {}, True),
    ("sigmoid", "sigmoid", [_f(4, 64, scale=4)], {}, 1e-6),
    ("exp", "exp", [_f(4, 64, scale=3)], {}, 1e-6),
    ("max_last_axis", "max", [_f(1, 40, 20)], dict(axis=2), True),
    ("max_int8_axes", "max", [_r(2, 3, 4, 5)], dict(axis=(1, 3), keepdims=True), True),
    ("max_all", "max", [_r(3, 4, dtype=np.int32)], {}, True),
    ("mean_float_video", "mean", [_f(1, 2, 3, 3, 16)], dict(axis=(1, 2, 3)), 1e-6),
    ("mean_int8_axes", "mean", [_r(2, 3, 4, 5)], dict(axis=(0, 2)), True),
    ("mean_int32_keepdims", "mean", [_r(3, 7, lo=-10**6, hi=10**6, dtype=np.int32)],
     dict(axis=-1, keepdims=True), True),
    ("conv2d_transpose_dcgan", "nn.conv2d_transpose", [_f(1, 4, 4, 8), _f(4, 4, 8, 6, seed=1)],
     dict(strides=(2, 2), padding=(1, 1, 1, 1)), 1e-4),
    ("conv2d_transpose_asym", "nn.conv2d_transpose", [_f(2, 3, 5, 4), _f(3, 2, 4, 5, seed=1)],
     dict(strides=(2, 3), padding=(0, 1, 2, 0), output_padding=(1, 2)), 1e-4),
    ("conv3d_s1_pad1", "nn.conv3d", [_f(1, 3, 5, 5, 4), _f(3, 3, 3, 4, 6, seed=1)],
     dict(strides=(1, 1, 1), padding=(1,) * 6), 1e-4),
    ("conv3d_s2_1x1", "nn.conv3d", [_f(2, 4, 6, 6, 3), _f(1, 1, 1, 3, 5, seed=1)],
     dict(strides=(2, 2, 2), padding=(0,) * 6), 1e-4),
    ("conv3d_asym", "nn.conv3d", [_f(1, 4, 5, 6, 2), _f(2, 3, 2, 2, 3, seed=1)],
     dict(strides=(1, 2, 2), padding=(1, 0, 1, 0, 1, 1)), 1e-4),
    ("nms_ties_threshold", "vision.non_max_suppression", [_SAME, _TIED],
     dict(max_output_size=8, iou_threshold=0.5, score_threshold=0.05), True),
    ("nms_max_output_below_count", "vision.non_max_suppression", [_boxes(60, 1), _f(1, 60)],
     dict(max_output_size=5, iou_threshold=0.3, score_threshold=-0.5), True),
    ("nms_batch_no_threshold", "vision.non_max_suppression",
     [np.concatenate([_boxes(40, 2), _boxes(40, 3)]), np.abs(_f(2, 40, seed=4))],
     dict(max_output_size=40, iou_threshold=0.2), True),
    ("nms_ssd_scores", "vision.non_max_suppression",
     [_boxes(300, 5), (1 / 21 + _f(1, 300, seed=6, scale=0.01)).astype(np.float32)],
     dict(max_output_size=100, iou_threshold=0.5, score_threshold=0.05), True),
]


def _one_op(builder, infer, op, inputs, attrs):
    b = builder("t")
    names = [b.var(f"x{i}", x.shape, str(x.dtype)) for i, x in enumerate(inputs)]
    y = b.call(op, *names, name="y", **attrs)
    if op == "split":
        parts = attrs["indices_or_sections"]
        n = parts if isinstance(parts, int) else len(parts) + 1
        return infer(b.build([b.get_item(y, i) for i in range(n)]))
    return infer(b.build(y))


def _held(got, want, exact, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if exact is True:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=exact, atol=exact, err_msg=what)


@pytest.mark.parametrize("op,inputs,attrs,exact", [c[1:] for c in OP_CASES],
                         ids=[c[0] for c in OP_CASES])
def test_op_matches_reference_oracle_and_jax_impl(op, inputs, attrs, exact):
    g = _one_op(GraphBuilder, infer_types, op, inputs, attrs)
    jg = _one_op(JGraphBuilder, j_infer_types, op, inputs, attrs)
    assert g.to_json() == jg.to_json()
    feeds = {f"x{i}": x for i, x in enumerate(inputs)}
    wants = j_run_graph(jg, feeds)
    for nm, want in zip(g.outputs, wants):
        assert (want.shape, str(want.dtype)) == (g[nm].shape, g[nm].dtype)
    for key, outs in (("JaxExecutor", JaxExecutor(jg, fuse=False).run(feeds)),
                      ("port oracle", run_graph(g, feeds)),
                      ("port torch", TorchExecutor(g, device="cpu").run(feeds))):
        for got, want in zip(outs, wants):
            # XLA's float batch norm is not the oracle's sequence (an ulp off)
            tol = 1e-6 if exact is True and key == "JaxExecutor" and want.dtype.kind == "f" \
                else exact
            _held(np.asarray(got), want, tol, f"{op} {key}")


def test_batch_norm_torch_is_the_oracle_bit_for_bit():
    """The torch impl's float32 sequence is the oracle's: bit-equal on
    inputs spread over many binades, a tiny variance and a large epsilon."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 9, 9, 32)) * np.exp(rng.uniform(-8, 8, (3, 9, 9, 32)))).astype(
        np.float32)
    params = [np.abs(rng.standard_normal(32)).astype(np.float32) + 1e-3,
              rng.standard_normal(32).astype(np.float32),
              rng.standard_normal(32).astype(np.float32),
              (np.abs(rng.standard_normal(32)) * 1e-4).astype(np.float32)]
    for eps in (1e-5, 1e-3, 0.1):
        node = Node("bn", "nn.batch_norm", ("x", "g", "b", "m", "v"), {"epsilon": eps})
        want = get_op("nn.batch_norm").np_impl(x, *params, node=node)
        got = get_op("nn.batch_norm").torch_impl(
            torch.from_numpy(x), *map(torch.from_numpy, params), node=node).numpy()
        assert got.tobytes() == want.tobytes()


def test_nms_fixed_point_equals_the_greedy_oracle_on_chains():
    """Boxes that overlap their neighbour in a long chain (each suppresses
    the next): the greedy set alternates, the fixed-point loop needs one step
    a link and stops only when a step changes nothing."""
    n = 23
    y = np.arange(n, dtype=np.float32) * 0.03
    boxes = np.stack([y, np.zeros(n, np.float32), y + 0.1, np.ones(n, np.float32)], -1)[None]
    scores = np.linspace(1, 0.5, n, dtype=np.float32)[None]
    node = Node("nms", "vision.non_max_suppression", ("b", "s"),
                dict(max_output_size=n, iou_threshold=0.5, score_threshold=0.0))
    want = get_op("vision.non_max_suppression").np_impl(boxes, scores, node=node)
    got = get_op("vision.non_max_suppression").torch_impl(
        torch.from_numpy(boxes), torch.from_numpy(scores), node=node).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[0, :12] == np.arange(0, n, 2)).all() and (want[0, 12:] == -1).all()


def test_nms_reads_no_box_on_the_host():
    """The torch impl makes no host read per box: on meta tensors (no values)
    the loop fails at its first flag read, after NMS_CHECK_EVERY steps, not
    at the first box."""
    from tachikoma_tpu_torch.ops import tail

    node = Node("nms", "vision.non_max_suppression", ("b", "s"), dict(max_output_size=10))
    steps = []
    real_bmm = torch.bmm

    def counting_bmm(*a, **k):
        steps.append(1)
        return real_bmm(*a, **k)

    torch.bmm = counting_bmm
    try:
        with pytest.raises(Exception):
            tail._nms_torch(torch.empty((1, 50, 4), device="meta"),
                            torch.empty((1, 50), device="meta"), node=node)
    finally:
        torch.bmm = real_bmm
    assert len(steps) == tail.NMS_CHECK_EVERY


# ---------------------------------------------------------------------------
# the CLI's zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["lenet5"], ["lstm", "--seq-len", "4"], ["digits_cnn"],
                                  ["mlp", "--batch", "2"]],
                         ids=["lenet5", "lstm_seq4", "digits_cnn", "mlp_b2"])
def test_cli_quantizes_zoo_models_as_the_jax_cli(tmp_path, argv):
    from tachikoma_tpu import cli as j_cli
    from tachikoma_tpu_torch import cli

    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    cli.main(["quantize", *argv, "-o", str(ours)])
    j_cli.main(["quantize", *argv, "-o", str(theirs)])
    assert ours.read_text() == theirs.read_text()
    g = Graph.from_json(ours.read_text())
    assert any(n.op.startswith("qnn.") for n in g.nodes)
    if argv[0] == "lstm":
        assert json.loads(ours.read_text())["nodes"][0]["shape"] == [1, 4, 64]


def test_cli_zoo_is_the_jax_clis():
    """The port's zoo has the JAX CLI's names; each name this slice added
    builds the JAX CLI's graph (the others are held in
    tests/test_torch_port_{resnet,mobilenet,vgg,transformer}.py); a name the
    JAX CLI lacks is refused by both."""
    from tachikoma_tpu import cli as j_cli
    from tachikoma_tpu_torch import cli

    added = {"lenet5": None, "mlp": None, "digits_cnn": None, "squeezenet": 48,
             "densenet": 32, "resnet3d18": 16, "lstm": None}
    assert set(added) <= set(cli.ZOO)
    for name, image in added.items():
        seq = 8 if name == "lstm" else None
        g, jg = cli._zoo(name, 1, image, seq), j_cli._zoo(name, 1, image, seq)
        assert g.structural_hash(include_params=True) == jg.structural_hash(include_params=True), \
            name
    served = inspect.getsource(j_cli._zoo)
    for name in cli.ZOO:  # every name of the port's zoo is one the JAX CLI serves
        assert f'"{name}"' in served, name
    for name in ("dqn", "ssd_lite", "alexnet"):
        with pytest.raises(SystemExit, match="unknown zoo model"):
            cli._zoo(name, 1, None, None)
        with pytest.raises(SystemExit, match="unknown zoo model"):
            j_cli._zoo(name, 1, None, None)
