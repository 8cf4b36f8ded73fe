"""Deployable artifact bundles: save/load a quantized model as one `.tkmod`
file (port of `tachikoma_tpu/runtime/artifact.py`).

A `.tkmod` is a gzip'd tar holding `manifest.json` (format, hashes, inputs,
outputs, meta), `graph.json` (the structure), one `params/<name>.npy` per
parameter and, in files the JAX package wrote with its TPU tuning database,
`tune.jsonl`.  The format string, member names and hashes are the JAX
package's, so a file written by either package loads in the other to the
same graph, and the port writes the same bytes.  `save_artifact` bundles the
tuning database file it is given (the CLI's `compile` passes `$TK_TUNE_DB`);
a `tune.jsonl` found in a file comes back as the manifest's `_tune_jsonl`, as
the JAX package returns it, and nothing here dispatches by it.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import tarfile

import numpy as np

from ..ir.graph import Graph
from ..utils import dtypes as dt

FORMAT = "tachikoma_tpu.artifact.v1"


def _add_bytes(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    info.mtime = 0  # deterministic archives
    tar.addfile(info, io.BytesIO(data))


def save_artifact(path: str, graph: Graph, tune_db_path: str | None = None,
                  meta: dict | None = None) -> None:
    """Write `graph` with its params (and the tuning database file
    `tune_db_path`, when it exists) to `path`; the bytes depend on nothing
    but the arguments and that file."""
    manifest = {
        "format": FORMAT,
        "graph_hash": graph.structural_hash(include_params=True),
        "name": graph.name,
        "num_nodes": len(graph),
        "inputs": [(n.name, n.dtype, list(n.shape or ())) for n in graph.inputs],
        "outputs": list(graph.outputs),
        "meta": meta or {},
    }
    with open(path, "wb") as raw, \
            gzip.GzipFile(filename="", mode="wb", fileobj=raw, mtime=0) as gz, \
            tarfile.open(fileobj=gz, mode="w", format=tarfile.USTAR_FORMAT) as tar:
        _add_bytes(tar, "manifest.json", json.dumps(manifest, sort_keys=True).encode())
        _add_bytes(tar, "graph.json", graph.to_json(include_params=False).encode())
        # one .npy per param (np.savez embeds zip timestamps)
        for k in sorted(graph.params):
            buf = io.BytesIO()
            np.save(buf, dt.c_contig(graph.params[k]), allow_pickle=False)
            _add_bytes(tar, f"params/{k}.npy", buf.getvalue())
        if tune_db_path and os.path.exists(tune_db_path):
            with open(tune_db_path, "rb") as f:
                _add_bytes(tar, "tune.jsonl", f.read())


def load_artifact(path: str) -> tuple[Graph, dict]:
    """(graph, manifest); raises unless the params hash to the manifest's."""
    with tarfile.open(path, "r:gz") as tar:
        def read(name):
            f = tar.extractfile(name)
            if f is None:
                raise ValueError(f"missing {name} in artifact")
            return f.read()

        manifest = json.loads(read("manifest.json"))
        if manifest.get("format") != FORMAT:
            raise ValueError(f"unknown artifact format {manifest.get('format')!r}")
        gjson = read("graph.json").decode()
        params = {}
        for member in tar.getmembers():
            if member.name.startswith("params/") and member.name.endswith(".npy"):
                key = member.name[len("params/"):-len(".npy")]
                params[key] = np.load(io.BytesIO(read(member.name)), allow_pickle=False)
        graph = Graph.from_json(gjson, params=params)
        got = graph.structural_hash(include_params=True)
        if got != manifest["graph_hash"]:
            raise ValueError(f"artifact hash mismatch: manifest {manifest['graph_hash'][:16]} "
                             f"vs content {got[:16]}")
        if "tune.jsonl" in tar.getnames():
            manifest["_tune_jsonl"] = read("tune.jsonl").decode()
    return graph, manifest
