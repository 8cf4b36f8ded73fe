"""The port's trace collector (exec/trace_collector.py) and logging
(utils/logging.py) on the CPU, with an in-process localhost server and
worker threads: records uploaded out of order by several workers merge into
a file byte-equal to a single emitter's trace (the port's and the JAX
package's), a chunk with a bad hash is rejected, liveness follows the
heartbeats, and the port's uploader and the JAX package's collector speak
the same wire protocol.
"""

import logging
import threading
import time

import numpy as np
import pytest

from tachikoma_tpu.exec.trace_collector import TraceCollector as JTraceCollector
from tachikoma_tpu.models.vision import lenet5 as j_lenet5
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.trace.emitter import TraceEmitter as JTraceEmitter
from tachikoma_tpu_torch.exec import trace_collector as tc
from tachikoma_tpu_torch.exec.trace_collector import TraceCollector, TraceUploader
from tachikoma_tpu_torch.models.vision import lenet5, resnet
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.trace.emitter import (TraceEmitter, _build_records, _graph_hash,
                                               verify_trace)
from tachikoma_tpu_torch.utils import logging as tk_logging


@pytest.fixture(scope="module")
def traced():
    """(port int8 LeNet-5 b1, its records, its trace bytes, the JAX trace):
    the port's oracle backend, whose bytes equal the JAX package's in the
    float records too."""
    rng = np.random.default_rng(0)
    data = [rng.standard_normal((1, 28, 28, 1)).astype(np.float32) for _ in range(2)]
    q = quantize(lenet5(batch_size=1), data)
    em = TraceEmitter(q, backend="oracle")
    values = em._values(data[0])
    recs = list(_build_records(em.graph, values))
    jq = j_quantize(j_lenet5(batch_size=1), data)
    return q, recs, em.emit_bytes(data[0]), JTraceEmitter(jq, backend="oracle").emit_bytes(data[0])


def _upload(host, port, worker, items):
    up = TraceUploader(host, port, worker)
    for rec in items:
        up.send_record(rec.node_id, rec.encode())
    up.finish()


@pytest.mark.parametrize("workers,order", [(2, "reversed"), (3, "shuffled"), (1, "shuffled"),
                                           (4, "forward")])
def test_out_of_order_merge_equals_single_bytes(tmp_path, traced, workers, order):
    q, recs, single, jsingle = traced
    assert single == jsingle
    coll = TraceCollector(expected_workers=workers)
    try:
        parts = [recs[w::workers] for w in range(workers)]
        rng = np.random.default_rng(workers)
        if order == "reversed":
            parts = [list(reversed(p)) for p in parts]
        elif order == "shuffled":
            parts = [[p[i] for i in rng.permutation(len(p))] for p in parts]
        threads = [threading.Thread(target=_upload, args=(coll.host, coll.port, f"w{w}", p))
                   for w, p in enumerate(parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert coll.wait(10)
        assert not coll.errors
        path = str(tmp_path / "merged.tktrace")
        assert coll.write_trace(path, _graph_hash(q)) == len(recs)
        blob = open(path, "rb").read()
        assert blob == single
        res = verify_trace(path, q)
        assert res["verified"] == res["records"] == len(recs)
    finally:
        coll.close()


def test_port_uploader_to_reference_collector(tmp_path, traced):
    """The wire protocol is the JAX package's: its collector merges the
    port's uploads into the same bytes."""
    q, recs, single, _ = traced
    coll = JTraceCollector(expected_workers=2)
    try:
        threads = [threading.Thread(target=_upload, args=(coll.host, coll.port, f"w{w}",
                                                          list(reversed(recs[w::2]))))
                   for w in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert coll.wait(10) and not coll.errors
        path = str(tmp_path / "merged.tktrace")
        coll.write_trace(path, _graph_hash(q))
        assert open(path, "rb").read() == single
    finally:
        coll.close()


def test_resnet_trace_merge(tmp_path):
    """A larger trace (int8 ResNet-18 b1 32^2, the torch backend on the CPU)
    merged from two workers."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    q = quantize(resnet(18, batch_size=1, image_size=32), [x])
    em = TraceEmitter(q, backend="torch", device="cpu")
    recs = list(_build_records(em.graph, em._values(x)))
    coll = TraceCollector(expected_workers=2)
    try:
        threads = [threading.Thread(target=_upload, args=(coll.host, coll.port, f"w{w}",
                                                          recs[w::2][::-1]))
                   for w in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert coll.wait(10) and not coll.errors
        path = str(tmp_path / "r18.tktrace")
        coll.write_trace(path, _graph_hash(q))
        assert open(path, "rb").read() == em.emit_bytes(x)
    finally:
        coll.close()


def test_corrupt_chunk_rejected(traced):
    import socket

    _, recs, _, _ = traced
    coll = TraceCollector(expected_workers=1)
    try:
        sock = socket.create_connection((coll.host, coll.port))
        try:
            tc._send_frame(sock, {"type": "hello", "host": "evil"})
            tc._recv_frame(sock)
            enc = recs[0].encode()
            tc._send_frame(sock, {"type": "chunk", "host": "evil", "node_id": 1,
                                  "sha256": "0" * 64, "size": len(enc)}, enc)
            resp, _ = tc._recv_frame(sock)
            assert resp["type"] == "reject"
            assert coll.errors and not coll.records
        finally:
            sock.close()
        up = TraceUploader(coll.host, coll.port, "w0")
        up.send_record(recs[0].node_id, recs[0].encode())
        resp = up._rpc({"type": "chunk", "host": "w0", "node_id": 2, "sha256": "0" * 64,
                        "size": 3}, b"abc")
        assert resp["type"] == "reject" and sorted(coll.records) == [recs[0].node_id]
        up.close()
    finally:
        coll.close()


def test_conflicting_chunk_recorded(traced):
    _, recs, _, _ = traced
    coll = TraceCollector(expected_workers=1)
    try:
        up = TraceUploader(coll.host, coll.port, "w0")
        up.send_record(7, recs[0].encode())
        up.send_record(7, recs[1].encode())
        up.finish()
        assert coll.wait(5)
        assert any("conflicting" in e for e in coll.errors)
    finally:
        coll.close()


def test_heartbeat_liveness():
    coll = TraceCollector(expected_workers=1, heartbeat_timeout=0.2)
    try:
        up = TraceUploader(coll.host, coll.port, "w0")
        up.heartbeat()
        time.sleep(0.05)
        assert coll.dead_workers() == []
        time.sleep(0.4)
        assert coll.dead_workers() == ["w0"]
        up.close()
    finally:
        coll.close()


def test_uploader_retries_then_fails():
    """A collector that is gone: the uploader retries, then raises."""
    coll = TraceCollector(expected_workers=1)
    host, port = coll.host, coll.port
    coll.close()
    up = TraceUploader(host, port, "w0", retries=2)
    with pytest.raises(RuntimeError, match="after 2 tries"):
        up.send_record(0, b"x" * 16)


def test_main_reports_an_incomplete_collection(capsys):
    tc.main(["--host", "127.0.0.1", "--port", "0", "--workers", "1", "--timeout", "0.05"])
    out = capsys.readouterr().out
    assert "waiting for 1 workers" in out and "complete=False" in out


def test_logging_spec_sets_levels():
    tk_logging.configure("trace_collector=DEBUG;gather=ERROR;default=INFO;bogus;x=NOPE")
    root = logging.getLogger("tachikoma_tpu_torch")
    try:
        assert tk_logging.get_logger("trace_collector").level == logging.DEBUG
        assert tk_logging.get_logger("gather").level == logging.ERROR
        assert root.level == logging.INFO and not root.propagate
        n = len(root.handlers)
        tk_logging.configure("")
        assert len(root.handlers) == n  # one handler, however often configured
    finally:
        tk_logging.configure("trace_collector=NOTSET;gather=NOTSET;default=WARNING")
