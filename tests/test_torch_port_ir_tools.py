"""The port's IR tools (ir/text.py, ir/passes.py, ir/patterns.py, ir/viz.py)
against the JAX package's, on the CPU: the same graphs (built by both
packages' zoo builders, quantized by both quantizers) give the same text,
the same pass-pipeline graph, the same matches and rewrites and the same
DOT and terminal strings.
"""

import numpy as np
import pytest

from tachikoma_tpu import GraphBuilder as JGraphBuilder
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu.ir import passes as jpasses
from tachikoma_tpu.ir import patterns as jpat
from tachikoma_tpu.ir.text import parse_text as j_parse_text
from tachikoma_tpu.ir.text import to_text as j_to_text
from tachikoma_tpu.ir.viz import render_text as j_render_text
from tachikoma_tpu.ir.viz import to_dot as j_to_dot
from tachikoma_tpu.models import vision as jv
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ir import passes, patterns
from tachikoma_tpu_torch.ir.text import parse_text, to_text
from tachikoma_tpu_torch.ir.viz import render_text, to_dot
from tachikoma_tpu_torch.models import vision as pv
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor

ZOO = {"lenet5": {"batch_size": 2}, "resnet18": {"batch_size": 1, "image_size": 32},
       "mobilenet_v2": {"batch_size": 1, "image_size": 32},
       "densenet": {"image_size": 32, "blocks": (2, 2, 2, 2), "growth": 8},
       "squeezenet": {"image_size": 64}}


def _build(pkg, name):
    if name == "resnet18":
        return pkg.resnet(18, **ZOO[name])
    return getattr(pkg, name)(**ZOO[name])


@pytest.fixture(scope="module", params=list(ZOO))
def zoo(request):
    """(name, port float, JAX float, port int8, JAX int8)."""
    name = request.param
    g, jg = _build(pv, name), _build(jv, name)
    rng = np.random.default_rng(3)
    calib = {n.name: rng.standard_normal(n.shape).astype(np.float32) for n in g.inputs}
    return name, g, jg, quantize(g, [calib]), j_quantize(jg, [calib])


@pytest.mark.parametrize("quantized", [False, True])
def test_to_text_equals_reference(zoo, quantized):
    _, g, jg, q, jq = zoo
    a, b = (q, jq) if quantized else (g, jg)
    assert to_text(a) == j_to_text(b)


@pytest.mark.parametrize("quantized", [False, True])
def test_parse_text_round_trips(zoo, quantized):
    _, g, _, q, jq = zoo
    a = q if quantized else g
    text = to_text(a)
    back = parse_text(text, params=dict(a.params))
    assert back.structural_bytes(include_params=True) == a.structural_bytes(include_params=True)
    assert to_text(back) == text
    jback = j_parse_text(text)
    bare = parse_text(text)
    assert bare.structural_bytes() == jback.structural_bytes()
    assert [(n.name, n.shape, n.dtype) for n in bare.consts] == \
        [(n.name, n.shape, n.dtype) for n in jback.consts]


def test_parsed_text_runs_like_the_graph(zoo):
    _, _, _, q, _ = zoo
    back = parse_text(to_text(q), params=dict(q.params))
    rng = np.random.default_rng(4)
    x = {n.name: rng.standard_normal(n.shape).astype(np.float32) for n in q.inputs}
    for a, b in zip(TorchExecutor(q, device="cpu").run(x),
                    TorchExecutor(back, device="cpu").run(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("opt_level,disabled", [(3, ()), (2, ()), (1, ()), (0, ()),
                                                 (3, ("fold_batch_norm",))])
def test_default_pipeline_equals_reference(zoo, opt_level, disabled):
    name, g, jg, _, _ = zoo
    timer, jtimer = passes.PassTimingInstrument(), jpasses.PassTimingInstrument()
    with passes.PassContext(opt_level=opt_level, disabled_pass=set(disabled),
                            instruments=[timer]):
        out = passes.default_pipeline()(g)
    with jpasses.PassContext(opt_level=opt_level, disabled_pass=set(disabled),
                             instruments=[jtimer]):
        jout = jpasses.default_pipeline()(jg)
    assert out.structural_bytes(include_params=True) == \
        jout.structural_bytes(include_params=True)
    assert set(timer.times) == set(jtimer.times)
    assert timer.render().splitlines()[0] == jtimer.render().splitlines()[0]


def test_pass_context_and_instruments():
    logs, jlogs = [], []
    g, jg = pv.lenet5(batch_size=1), jv.lenet5(batch_size=1)
    with passes.PassContext(instruments=[passes.PrintBeforeAfter({"fold_constant"},
                                                                 logs.append)]):
        passes.default_pipeline()(g)
    with jpasses.PassContext(instruments=[jpasses.PrintBeforeAfter({"fold_constant"},
                                                                   jlogs.append)]):
        jpasses.default_pipeline()(jg)
    assert logs == jlogs and len(logs) == 2
    calls = []

    @passes.module_pass(opt_level=3)
    def heavy(graph):
        calls.append("heavy")
        return graph

    assert passes.PassContext.current().opt_level == 2
    with passes.PassContext(opt_level=2):
        heavy(g)
        with passes.PassContext(opt_level=3, config={"k": 1}):
            assert passes.PassContext.current().config["k"] == 1
            heavy(g)
        assert passes.PassContext.current().opt_level == 2
    assert calls == ["heavy"]
    seq = passes.Sequential([lambda x: x, heavy], "s")
    assert [p.info.name for p in seq.passes] == ["<lambda>", "heavy"]


def _small(builder, infer):
    b = builder()
    x = b.var("x", (2, 4), "float32")
    w = b.const(np.eye(4, dtype=np.float32), "w")
    d = b.call("nn.dense", x, w)
    r = b.call("nn.relu", d)
    q = b.call("qnn.quantize", r, scale=0.1, zero_point=0, out_dtype="int8")
    dq = b.call("qnn.dequantize", q, scale=0.1, zero_point=0)
    return infer(b.build(dq))


def _patterns(m):
    """The same patterns built from module `m` (the port's or the JAX one)."""
    return {
        "relu": m.is_op("nn.relu", m.wildcard()),
        "dense_var_const": m.is_op("nn.dense", m.is_var(), m.is_const()),
        "dense_const_const": m.is_op("nn.dense", m.is_const(), m.is_const()),
        "dq_of_q": m.is_op("qnn.dequantize", m.is_op("qnn.quantize", m.wildcard())),
        "bound": m.is_op("qnn.quantize", m.wildcard().bind("src")).with_attrs(
            out_dtype="int8"),
        "alt": m.is_op("nn.relu", m.wildcard()) | m.is_op("nn.dense", m.wildcard(),
                                                           m.wildcard()),
        "conv_const": m.is_op("qnn.conv2d", m.wildcard(), m.is_const(lambda a: a.ndim == 4)),
        "requant_of_clip": m.is_op("qnn.requantize", m.is_op("clip", m.wildcard().bind("c"))),
        "add_extra": m.is_op("qnn.add", m.wildcard(), allow_extra_args=True),
        "stride2": m.is_op("qnn.conv2d", m.wildcard(), m.wildcard()).with_attrs(
            strides=lambda s: tuple(s or (1, 1)) == (2, 2)),
    }


def _matches(ms):
    return [(m.root, dict(m.binds)) for m in ms]


@pytest.mark.parametrize("pattern", list(_patterns(patterns)))
def test_find_matches_equal_reference(zoo, pattern):
    _, _, _, q, jq = zoo
    assert _matches(patterns.find_matches(q, _patterns(patterns)[pattern])) == \
        _matches(jpat.find_matches(jq, _patterns(jpat)[pattern]))


@pytest.mark.parametrize("pattern", list(_patterns(patterns)))
def test_find_matches_small_graph(pattern):
    g, jg = _small(GraphBuilder, infer_types), _small(JGraphBuilder, j_infer_types)
    assert _matches(patterns.find_matches(g, _patterns(patterns)[pattern])) == \
        _matches(jpat.find_matches(jg, _patterns(jpat)[pattern]))


def test_rewrite_and_partition_equal_reference(zoo):
    _, _, _, q, jq = zoo

    def cb(b, old_g, match, mapping):  # requantize(clip(c)) -> requantize(c)
        n = old_g[match.root]
        return b.call(n.op, mapping[match.binds["c"]], name=n.name, **dict(n.attrs))

    out = patterns.rewrite(q, _patterns(patterns)["requant_of_clip"], cb)
    jout = jpat.rewrite(jq, _patterns(jpat)["requant_of_clip"], cb)
    assert out.structural_bytes(include_params=True) == \
        jout.structural_bytes(include_params=True)
    part = patterns.partition(q, _patterns(patterns)["conv_const"], "tk.byoc_conv")
    jpart = jpat.partition(jq, _patterns(jpat)["conv_const"], "tk.byoc_conv")
    assert part.structural_bytes(include_params=True) == \
        jpart.structural_bytes(include_params=True)
    assert to_text(part) == j_to_text(jpart)


def test_rewrite_cancels_quant_roundtrip():
    g = _small(GraphBuilder, infer_types)
    pat = patterns.is_op("qnn.dequantize",
                         patterns.is_op("qnn.quantize", patterns.wildcard().bind("src")))
    g2 = patterns.rewrite(g, pat, lambda b, old_g, match, mapping: mapping[match.binds["src"]])
    assert not {"qnn.dequantize", "qnn.quantize"} & {n.op for n in g2.nodes}
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    np.testing.assert_allclose(run_graph(infer_types(g2), x)[0], np.maximum(x, 0), rtol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("show_consts", [False, True])
def test_to_dot_equals_reference(zoo, quantized, show_consts):
    _, g, jg, q, jq = zoo
    a, b = (q, jq) if quantized else (g, jg)
    assert to_dot(a, show_consts=show_consts) == j_to_dot(b, show_consts=show_consts)
    assert to_dot(a, name="m") == j_to_dot(b, name="m")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("max_nodes", [None, 3])
def test_render_text_equals_reference(zoo, quantized, max_nodes):
    _, g, jg, q, jq = zoo
    a, b = (q, jq) if quantized else (g, jg)
    assert render_text(a, max_nodes) == j_render_text(b, max_nodes)
