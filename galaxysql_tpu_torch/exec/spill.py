"""Disk spill framework.

Reference analog: `executor/operator/spill` + `SpillSpaceManager` (SURVEY.md §2.6,
§5.4) — operators under memory pressure serialize intermediate state to spill files and
stream it back; a global manager enforces a disk quota.  Spill files are npz bundles of
column lanes (the engine's native layout), written to a per-process temp dir.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from galaxysql_tpu_torch.utils import errors


class SpillQuotaExceeded(errors.TddlError):
    errno = 1041
    sqlstate = "HY000"


class SpillSpaceManager:
    def __init__(self, quota_bytes: int = 64 << 30, directory: Optional[str] = None):
        self.quota = quota_bytes
        self.used = 0
        self._lock = threading.Lock()
        self._dir = directory
        self._seq = 0

    @property
    def directory(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="galaxysql_spill_")
        return self._dir

    def allocate_path(self) -> str:
        with self._lock:
            self._seq += 1
            return os.path.join(self.directory, f"spill_{self._seq}.npz")

    def charge(self, nbytes: int):
        with self._lock:
            if self.used + nbytes > self.quota:
                raise SpillQuotaExceeded(
                    f"spill space quota exceeded ({self.used + nbytes} > "
                    f"{self.quota} bytes)")
            self.used += nbytes

    def refund(self, nbytes: int):
        with self._lock:
            self.used = max(self.used - nbytes, 0)


SPILL_MANAGER = SpillSpaceManager()


def _note_spill(nbytes: int):
    """Typed-registry spill observability (utils/metrics.py process-shared
    counters): SHOW METRICS / Prometheus see total spill volume, and the
    statement-summary counter bracket attributes per-query deltas to the
    digest — a regressed digest whose windows carry spill bytes explains
    itself (memory pressure, not a plan change)."""
    from galaxysql_tpu_torch.utils.metrics import SPILL_BYTES, SPILL_FILES
    SPILL_BYTES.inc(int(nbytes))
    SPILL_FILES.inc()


class Spiller:
    """Writes arrays-dicts to spill files; streams them back; cleans up on close."""

    def __init__(self, manager: SpillSpaceManager = SPILL_MANAGER):
        self.manager = manager
        self.files: List[tuple] = []  # (path, nbytes) npz bundles
        self.dirs: List[tuple] = []   # (dir, nbytes) mmap runs

    def spill(self, arrays: Dict[str, np.ndarray]) -> int:
        path = self.manager.allocate_path()
        np.savez(path, **arrays)
        nbytes = os.path.getsize(path)
        self.manager.charge(nbytes)
        self.files.append((path, nbytes))
        _note_spill(nbytes)
        return nbytes

    def read_all(self) -> Iterator[Dict[str, np.ndarray]]:
        for path, _ in self.files:
            with np.load(path, allow_pickle=False) as z:
                yield {k: z[k] for k in z.files}

    @property
    def spilled_files(self) -> int:
        return len(self.files) + len(self.dirs)

    # -- mmap runs -----------------------------------------------------------
    # npz bundles decompress whole arrays on read; consumers that must stay
    # bounded-memory over MANY runs at once (external-sort k-way merge) use
    # directory runs of raw .npy files instead and read them mmap-backed, so
    # only the pages a merge wave touches become resident.

    dirs: List[tuple]

    def spill_mmap(self, arrays: Dict[str, np.ndarray]) -> int:
        """Write a run as a directory of raw .npy files; returns the run index."""
        import json
        base = self.manager.allocate_path() + ".d"
        os.makedirs(base, exist_ok=True)
        manifest = {}
        total = 0
        for i, (k, a) in enumerate(arrays.items()):
            fn = f"a{i}.npy"
            np.save(os.path.join(base, fn), np.ascontiguousarray(a))
            manifest[k] = fn
            total += os.path.getsize(os.path.join(base, fn))
        with open(os.path.join(base, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self.manager.charge(total)
        self.dirs.append((base, total))
        _note_spill(total)
        return len(self.dirs) - 1

    def open_mmap(self, run_ix: int) -> Dict[str, np.ndarray]:
        """Lazily-paged views of one run (np.load mmap_mode='r')."""
        import json
        base, _ = self.dirs[run_ix]
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        return {k: np.load(os.path.join(base, fn), mmap_mode="r",
                           allow_pickle=False)
                for k, fn in manifest.items()}

    def close(self):
        for path, nbytes in self.files:
            try:
                os.unlink(path)
            except OSError:
                pass
            self.manager.refund(nbytes)
        self.files.clear()
        for base, nbytes in self.dirs:
            shutil.rmtree(base, ignore_errors=True)
            self.manager.refund(nbytes)
        self.dirs.clear()
