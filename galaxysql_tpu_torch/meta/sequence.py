"""Sequences: metadb-backed monotonic id generators.

Reference analog: `sequence/impl` (SURVEY.md §2.6) — `GroupSequence` grabs value ranges
from the metadb and serves them from memory (crash burns at most one range, uniqueness
preserved); `TimeBasedSequence` packs a timestamp + counter.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple


class GroupSequence:
    def __init__(self, metadb, schema: str, name: str, cache: int = 1000):
        self.metadb = metadb
        self.schema = schema
        self.name = name
        self.cache = cache
        self._lock = threading.Lock()
        self._next = 0
        self._limit = 0

    def next_value(self) -> int:
        with self._lock:
            if self._next >= self._limit:
                self._next, self._limit = self.metadb.sequence_next_range(
                    self.schema, self.name, self.cache)
            v = self._next
            self._next += 1
            return v


class TimeBasedSequence:
    """(millis << 22 | node << 12 | counter) — unique without coordination."""

    def __init__(self, node_id: int = 0):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._counter = 0

    def next_value(self) -> int:
        with self._lock:
            ms = int(time.time() * 1000)
            if ms == self._last_ms:
                self._counter += 1
                if self._counter >= (1 << 12):
                    while ms <= self._last_ms:
                        ms = int(time.time() * 1000)
                    self._counter = 0
            else:
                self._counter = 0
            self._last_ms = ms
            return (ms << 22) | (self.node_id << 12) | self._counter


class SequenceManager:
    def __init__(self, metadb):
        self.metadb = metadb
        self._seqs: Dict[Tuple[str, str], GroupSequence] = {}
        self._lock = threading.Lock()

    def get(self, schema: str, name: str) -> GroupSequence:
        key = (schema.lower(), name.lower())
        with self._lock:
            s = self._seqs.get(key)
            if s is None:
                s = GroupSequence(self.metadb, schema, name)
                self._seqs[key] = s
            return s

    def next_value(self, schema: str, name: str) -> int:
        return self.get(schema, name).next_value()
