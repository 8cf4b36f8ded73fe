"""Logging configuration with per-module env-controlled verbosity (port of
`tachikoma_tpu/utils/logging.py`).

`TK_LOG="trace_collector=DEBUG;gather=INFO;default=WARNING"` sets
per-subsystem levels under the `tachikoma_tpu_torch` logger namespace, as
the JAX package's spec does under `tachikoma_tpu`.
"""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def configure(spec: str | None = None) -> None:
    """Apply a TK_LOG-style spec (idempotent; `get_logger` calls it)."""
    global _CONFIGURED
    spec = spec if spec is not None else os.environ.get("TK_LOG", "")
    root = logging.getLogger("tachikoma_tpu_torch")
    if not _CONFIGURED:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(levelname)s %(name)s] %(message)s")
        )
        root.addHandler(handler)
        root.setLevel(logging.WARNING)
        root.propagate = False
        _CONFIGURED = True
    if not spec:
        return
    for part in spec.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, level = part.partition("=")
        level_no = getattr(logging, level.strip().upper(), None)
        if level_no is None:
            continue
        if name.strip() == "default":
            root.setLevel(level_no)
        else:
            logging.getLogger(f"tachikoma_tpu_torch.{name.strip()}").setLevel(level_no)


def get_logger(subsystem: str) -> logging.Logger:
    configure()
    return logging.getLogger(f"tachikoma_tpu_torch.{subsystem}")
