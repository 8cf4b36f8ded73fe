"""Tuning database: append-only JSONL records of measured kernel configs
(port of `tachikoma_tpu/tune/database.py`).

Tuning resumes by reloading the log, and the best config of a workload is a
pure function of it (`apply_history_best`).  A record's JSON line is the JAX
package's, byte for byte.  The port's database holds H100 measurements only:
`default_database()` reads `$TK_TUNE_DB` and nothing else; the port has no
packaged database and never opens the JAX package's TPU one.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field

# Error taxonomy; failed trials are data.  WRONG_ANSWER: the trial's output
# differed from the plain version on the same inputs (never best).
NO_ERROR = 0
COMPILE_ERROR = 1
RUNTIME_ERROR = 2
TIMEOUT = 3
WRONG_ANSWER = 4


@dataclass
class TuneRecord:
    workload: str            # e.g. "qmatmul_int8/M4096_K4096_N4096/fused"
    config: dict             # e.g. {"blocks": [512, 512, 1024]}
    time_ms: float           # measured kernel time (inf on error)
    error_no: int = NO_ERROR
    error_msg: str = ""
    meta: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "workload": self.workload, "config": self.config,
                "time_ms": self.time_ms, "error_no": self.error_no,
                "error_msg": self.error_msg, "meta": self.meta,
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, line: str) -> "TuneRecord":
        d = json.loads(line)
        return cls(d["workload"], d["config"], d["time_ms"],
                   d.get("error_no", 0), d.get("error_msg", ""), d.get("meta", {}))


class TuneDatabase:
    """Append-only JSONL store with in-memory best index."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self.records: list[TuneRecord] = []
        self._best: dict[str, TuneRecord] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._ingest(TuneRecord.from_json(line))

    # physical throughput ceiling for measurement sanity: the H100's dense
    # int8 tensor-core peak, 1979 TOP/s (NVIDIA data sheet).  A reading above
    # it is a corrupted measurement (an output never written, a timing of
    # nothing), never a real kernel: it is recorded, never served as best.
    MAX_CREDIBLE_TOPS = 1979.0

    def _ingest(self, rec: TuneRecord):
        self.records.append(rec)
        if rec.error_no == NO_ERROR:
            tops = float(rec.meta.get("tops", 0.0) or 0.0)
            if tops > self.MAX_CREDIBLE_TOPS:
                return  # recorded for forensics, never served as best
            cur = self._best.get(rec.workload)
            if cur is None or rec.time_ms < cur.time_ms:
                self._best[rec.workload] = rec

    def add(self, rec: TuneRecord):
        with self._lock:
            self._ingest(rec)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(rec.to_json() + "\n")

    def best(self, workload: str) -> TuneRecord | None:
        return self._best.get(workload)

    def best_config(self, workload: str) -> dict | None:
        rec = self._best.get(workload)
        return rec.config if rec else None

    def workloads(self) -> list[str]:
        return sorted(self._best)

    def __len__(self):
        return len(self.records)


# Global dispatch context: the database `apply_history_best` installs.
_CURRENT_DB: TuneDatabase | None = None


class apply_history_best:
    """Context manager installing a database for kernel config dispatch."""

    def __init__(self, db: TuneDatabase | str):
        self.db = TuneDatabase(db) if isinstance(db, str) else db
        self._prev: TuneDatabase | None = None

    def __enter__(self):
        global _CURRENT_DB
        self._prev = _CURRENT_DB
        _CURRENT_DB = self.db
        return self.db

    def __exit__(self, *exc):
        global _CURRENT_DB
        _CURRENT_DB = self._prev


_DEFAULT_DB: TuneDatabase | None = None
_DEFAULT_DB_LOADED = False


def default_database() -> TuneDatabase | None:
    """The fallback database: the file `$TK_TUNE_DB` names, loaded once per
    process (`reset_default_database` forgets it); None when it is unset or
    the file does not exist."""
    global _DEFAULT_DB, _DEFAULT_DB_LOADED
    if not _DEFAULT_DB_LOADED:
        _DEFAULT_DB_LOADED = True
        path = os.environ.get("TK_TUNE_DB")
        if path and os.path.exists(path):
            _DEFAULT_DB = TuneDatabase(path)
    return _DEFAULT_DB


def reset_default_database() -> None:
    """Forget the loaded default database: the next lookup reads
    `$TK_TUNE_DB` again."""
    global _DEFAULT_DB, _DEFAULT_DB_LOADED
    _DEFAULT_DB, _DEFAULT_DB_LOADED = None, False


def current_database() -> TuneDatabase | None:
    """The active dispatch database: the apply_history_best context if one
    is entered, else the default ($TK_TUNE_DB)."""
    return _CURRENT_DB if _CURRENT_DB is not None else default_database()


def lookup_config(workload: str) -> dict | None:
    db = _CURRENT_DB if _CURRENT_DB is not None else default_database()
    if db is None:
        return None
    return db.best_config(workload)
