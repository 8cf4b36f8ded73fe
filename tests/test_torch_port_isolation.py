"""The port stands alone: importing it pulls in neither jax nor the JAX
package, no file of it (the CLI and the trace modules included, and
chip_smoke.py) imports them, its executor never falls back to the CPU when
asked for the card, and the native trace writer builds inside the port."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tachikoma_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tachikoma_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_no_jax():
    modules = sorted(
        p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".").removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'tachikoma_tpu')"
              " or m.startswith(('jax.', 'jaxlib.', 'tachikoma_tpu.'))]\n"
              "assert not bad, bad\n"
              "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) > 15
    assert {"tachikoma_tpu_torch.ops.kernels.depthwise",
            "tachikoma_tpu_torch.runtime.artifact",
            "tachikoma_tpu_torch.ops.kernels.flash_attention",
            "tachikoma_tpu_torch.ops.attention",
            "tachikoma_tpu_torch.models.transformer",
            "tachikoma_tpu_torch.ops.kernels.conv_layouts",
            "tachikoma_tpu_torch.utils.timing",
            "tachikoma_tpu_torch.tune.database", "tachikoma_tpu_torch.tune.tuner",
            "tachikoma_tpu_torch.tune.model", "tachikoma_tpu_torch.tune.schedule",
            "tachikoma_tpu_torch.tune.evolutionary",
            "tachikoma_tpu_torch.models.decoding", "tachikoma_tpu_torch.ops.tail3",
            "tachikoma_tpu_torch.ops.tail", "tachikoma_tpu_torch.models.vision",
            "tachikoma_tpu_torch.runtime.segmented", "tachikoma_tpu_torch.runtime.bucketed",
            "tachikoma_tpu_torch.runtime.placement",
            "tachikoma_tpu_torch.runtime.profiler",
            "tachikoma_tpu_torch.utils.logging", "tachikoma_tpu_torch.parallel.mesh",
            "tachikoma_tpu_torch.parallel.shard", "tachikoma_tpu_torch.parallel.gather",
            "tachikoma_tpu_torch.parallel.pipeline", "tachikoma_tpu_torch.parallel.moe",
            "tachikoma_tpu_torch.parallel.ring_attention",
            "tachikoma_tpu_torch.exec.trace_collector", "tachikoma_tpu_torch.ir.text",
            "tachikoma_tpu_torch.ir.passes", "tachikoma_tpu_torch.ir.patterns",
            "tachikoma_tpu_torch.ir.viz", "tachikoma_tpu_torch.ops.kernels.wide"} <= set(modules)


def test_the_port_never_opens_the_tpu_tuning_database():
    """The port's default database is $TK_TUNE_DB only: no source of it
    names the JAX package's packaged TPU records."""
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "tophub" not in path.read_text(), path


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "tools" / "wide_probe.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_file_imports_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


def test_executor_without_a_card_raises(monkeypatch):
    from tachikoma_tpu_torch import GraphBuilder
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = GraphBuilder()
    g = b.build(b.call("clip", b.var("x", (2, 3), "float32"), a_min=0.0, a_max=1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchExecutor(g)
    out = TorchExecutor(g, device="cpu").run(np.array([[-1.0, 2.0, 0.5]] * 2, np.float32))
    np.testing.assert_array_equal(out[0], [[0.0, 1.0, 0.5]] * 2)


def test_native_trace_writer_builds_into_the_port_build_dir():
    """The port reads the shared writer source as it is and builds it into
    its own git-ignored `_build/`, never into the JAX package's
    `native/build/`."""
    from tachikoma_tpu_torch.trace import native

    shared = ROOT / "native" / "build"
    before = sorted((p.name, p.stat().st_mtime_ns) for p in shared.iterdir()) \
        if shared.is_dir() else []
    assert native.SOURCE == ROOT / "native" / "trace_writer.cpp"
    assert native.library_path().parent == PKG / "_build" != shared
    if native.native_available():
        assert native.library_path().is_file()
    after = sorted((p.name, p.stat().st_mtime_ns) for p in shared.iterdir()) \
        if shared.is_dir() else []
    assert after == before


TF_MODULES = ("tensorflow", "keras")
# the only functions of the port that import TensorFlow or Keras (to trace and
# freeze a model); a frozen .pb is read by frontend/tf_proto.py without them
TF_ENTRY_POINTS = {"from_tf_function", "from_saved_model", "from_keras"}


def test_import_pulls_in_no_tensorflow_or_keras():
    modules = sorted(
        p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".").removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    assert {"tachikoma_tpu_torch.frontend.tensorflow", "tachikoma_tpu_torch.frontend.tf_proto",
            "tachikoma_tpu_torch.frontend.keras",
            "tachikoma_tpu_torch.models.keras_resnet"} <= set(modules)
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('tensorflow', 'keras',"
              " 'tf_keras', 'jax', 'tachikoma_tpu')]\n"
              "assert not bad, bad[:10]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(node, where="<module>"):
    """(innermost enclosing function, imported module names) of every
    absolute import under `node`."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from _imports(child, child.name)
            continue
        if isinstance(child, ast.Import):
            yield where, [a.name for a in child.names]
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield where, [child.module or ""]
        yield from _imports(child, where)


def test_tensorflow_is_imported_only_inside_the_tracing_entry_points():
    found = set()
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for where, names in _imports(ast.parse(path.read_text())):
            if any(n.split(".")[0] in TF_MODULES for n in names):
                assert where in TF_ENTRY_POINTS, f"{path}: {where} imports {names}"
                found.add(where)
    assert found == TF_ENTRY_POINTS
