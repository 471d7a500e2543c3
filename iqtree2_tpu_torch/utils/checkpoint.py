"""Checkpoint/resume: gzip JSON key-value store.

Reference analog: Checkpoint (utils/checkpoint.h:65) — a gzip'd string map
with hierarchical keys and phase guards ("finished", "finishedModelFinal",
...). Here: JSON values, same hierarchical-key discipline, periodic dumps.

Copied from iqtree2_tpu/utils/checkpoint.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import json
import time
from pathlib import Path


class Checkpoint:
    def __init__(self, path: str | Path | None = None,
                 dump_interval: float = 30.0):
        self.path = Path(path) if path else None
        self.data: dict = {}
        self.dump_interval = dump_interval
        self._last_dump = 0.0
        self._prefix: list[str] = []

    # ------------------------------------------------------ struct scoping
    def start_struct(self, name: str) -> None:
        self._prefix.append(name)

    def end_struct(self) -> None:
        self._prefix.pop()

    def _key(self, key: str) -> str:
        return ".".join(self._prefix + [key])

    # -------------------------------------------------------------- access
    def put(self, key: str, value) -> None:
        self.data[self._key(key)] = value

    def get(self, key: str, default=None):
        return self.data.get(self._key(key), default)

    def has(self, key: str) -> bool:
        return self._key(key) in self.data

    def __contains__(self, key: str) -> bool:
        return self.has(key)

    # ---------------------------------------------------------------- I/O
    def load(self) -> bool:
        if self.path is None or not self.path.exists():
            return False
        with gzip.open(self.path, "rt") as f:
            self.data = json.load(f)
        return True

    def dump(self, force: bool = False) -> None:
        if self.path is None:
            return
        now = time.time()
        if not force and now - self._last_dump < self.dump_interval:
            return
        self._last_dump = now
        tmp = self.path.with_suffix(".tmp")
        with gzip.open(tmp, "wt") as f:
            json.dump(self.data, f)
        tmp.replace(self.path)
