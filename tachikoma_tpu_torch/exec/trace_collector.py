"""Trace collection service — host-side coordination for distributed runs
(port of `tachikoma_tpu/exec/trace_collector.py`, the same wire protocol).

The control-plane role of the reference's RPC subsystem (tracker matchmaking
`python/tvm/rpc/tracker.py:93-148`, endpoint server loop
`src/runtime/rpc/rpc_endpoint.cc:624`), re-scoped to what this framework
needs: worker hosts upload per-op trace records out of band (e.g. when DCN
allgather is undesirable for huge traces), the collector verifies content
hashes, tracks worker liveness by heartbeat, and merges records into one
deterministic tachikoma-standard trace file ordered by node id — regardless
of arrival order.

Wire protocol (length-prefixed frames over TCP):
    u32 header_len | header JSON | payload bytes (header["size"])
Header types: hello, chunk {node_id, sha256, size}, heartbeat, finish.
Run standalone:  python -m tachikoma_tpu_torch.exec.trace_collector --port 9191 \\
                     --out trace.tktrace --graph-hash <hex> --workers 2
"""

from __future__ import annotations

import argparse
import hashlib
import json
import socket
import socketserver
import struct
import threading
import time

from ..utils.logging import get_logger

log = get_logger("trace_collector")


def _send_frame(sock: socket.socket, header: dict, payload: bytes = b""):
    h = json.dumps(header, sort_keys=True).encode()
    sock.sendall(struct.pack("<I", len(h)) + h + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> tuple[dict, bytes]:
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen).decode())
    payload = _recv_exact(sock, header.get("size", 0)) if header.get("size") else b""
    return header, payload


class TraceCollector:
    """Threaded TCP collector; merge() returns records sorted by node id."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 expected_workers: int = 1, heartbeat_timeout: float = 60.0):
        self.expected_workers = expected_workers
        self.heartbeat_timeout = heartbeat_timeout
        self.records: dict[int, bytes] = {}     # node_id -> encoded record
        self.hashes: dict[int, str] = {}
        self.finished: set[str] = set()
        self.last_seen: dict[str, float] = {}
        self.errors: list[str] = []
        self._lock = threading.Lock()
        self._done = threading.Event()

        collector = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                worker = None
                try:
                    while True:
                        header, payload = _recv_frame(self.request)
                        kind = header.get("type")
                        now = time.monotonic()
                        if kind == "hello":
                            worker = header["host"]
                            with collector._lock:
                                collector.last_seen[worker] = now
                            _send_frame(self.request, {"type": "ok"})
                        elif kind == "heartbeat":
                            with collector._lock:
                                collector.last_seen[header["host"]] = now
                        elif kind == "chunk":
                            digest = hashlib.sha256(payload).hexdigest()
                            if digest != header["sha256"]:
                                with collector._lock:
                                    collector.errors.append(
                                        f"hash mismatch for node {header['node_id']}"
                                    )
                                _send_frame(self.request, {"type": "reject"})
                                continue
                            with collector._lock:
                                nid = int(header["node_id"])
                                prev = collector.hashes.get(nid)
                                if prev is not None and prev != digest:
                                    collector.errors.append(
                                        f"conflicting chunk for node {nid}"
                                    )
                                collector.records[nid] = payload
                                collector.hashes[nid] = digest
                                collector.last_seen[header["host"]] = now
                            _send_frame(self.request, {"type": "ok"})
                        elif kind == "finish":
                            with collector._lock:
                                collector.finished.add(header["host"])
                                if len(collector.finished) >= collector.expected_workers:
                                    collector._done.set()
                            _send_frame(self.request, {"type": "ok"})
                            return
                        else:
                            _send_frame(self.request, {"type": "error"})
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        log.info("trace collector listening on %s:%d", self.host, self.port)

    def dead_workers(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [
                w for w, t in self.last_seen.items()
                if w not in self.finished and now - t > self.heartbeat_timeout
            ]

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def merge(self) -> list[bytes]:
        """Records sorted by node id — deterministic regardless of arrival."""
        with self._lock:
            return [self.records[k] for k in sorted(self.records)]

    def write_trace(self, path: str, graph_hash: bytes, meta: dict | None = None) -> int:
        """Write the merged records (uploaded as OpRecord.encode() bytes,
        which carry an 8-byte length prefix) as one standard trace file."""
        from ..trace.format import OpRecord, TraceWriter

        recs = self.merge()
        with open(path, "wb") as f:
            w = TraceWriter(f, graph_hash, meta)
            w.begin(len(recs))
            for enc in recs:
                w.write(OpRecord.decode(enc[8:]))
            w.finish()
        return len(recs)

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class TraceUploader:
    """Worker-side client with retry."""

    def __init__(self, host: str, port: int, worker_id: str, retries: int = 3):
        self.addr = (host, port)
        self.worker_id = worker_id
        self.retries = retries
        self._sock: socket.socket | None = None

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, timeout=30)
            _send_frame(self._sock, {"type": "hello", "host": self.worker_id})
            _recv_frame(self._sock)

    def _rpc(self, header: dict, payload: bytes = b"") -> dict:
        last = None
        for _ in range(self.retries):
            try:
                self._connect()
                _send_frame(self._sock, header, payload)
                resp, _ = _recv_frame(self._sock)
                return resp
            except (ConnectionError, OSError) as e:
                last = e
                self.close()
                time.sleep(0.2)
        raise RuntimeError(f"upload failed after {self.retries} tries") from last

    def send_record(self, node_id: int, encoded: bytes) -> None:
        resp = self._rpc(
            {
                "type": "chunk", "host": self.worker_id, "node_id": node_id,
                "sha256": hashlib.sha256(encoded).hexdigest(), "size": len(encoded),
            },
            encoded,
        )
        if resp.get("type") != "ok":
            raise RuntimeError(f"collector rejected node {node_id}: {resp}")

    def heartbeat(self):
        self._connect()
        _send_frame(self._sock, {"type": "heartbeat", "host": self.worker_id})

    def finish(self):
        self._rpc({"type": "finish", "host": self.worker_id})
        self.close()

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9191)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--timeout", type=float, default=3600)
    args = p.parse_args(argv)
    c = TraceCollector(args.host, args.port, expected_workers=args.workers)
    print(f"listening on {c.host}:{c.port}; waiting for {args.workers} workers")
    ok = c.wait(args.timeout)
    print(f"collected {len(c.records)} records; complete={ok}; errors={c.errors}")
    c.close()


if __name__ == "__main__":
    main()
