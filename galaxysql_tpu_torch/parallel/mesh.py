"""Device mesh and sharded-table plumbing (port of `galaxysql_tpu/parallel/mesh.py`).

The reference's mesh is a `jax.sharding.Mesh` over one `shard` axis, and its tables
are 1-D lanes of length S*R placed with `NamedSharding(P("shard"))`: shard s owns
slice [s*R, (s+1)*R).  The port is single-controller as the reference is: one host
loop runs every stage, and a `Mesh` is a list of `torch.device`s, one per shard.  A
device may carry several shards (8 shards on one card, or on the CPU in the tests):
that is the counterpart of the reference's virtual devices.  A sharded lane is a list
of S tensors of R rows each, tensor s on shard s's device; shard s holds the same rows
in the same order as the reference's slice s.

Loading is cached per (store, table version, shard count, devices, columns) in a
`MeshDataCache`, apart from the per-instance `DeviceCache`, as in the reference.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galaxysql_tpu_torch.chunk.batch import Column, as_tensor
from galaxysql_tpu_torch.exec.operators import MIN_BUCKET


class Mesh:
    """The MPP shard axis: `devices[s]` is shard s's device.  `shape` mirrors the
    reference's `mesh.shape` (`{"shard": S}`)."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.shape = {"shard": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where replicated results live (shard 0's device)."""
        return self.devices[0]

    def key(self) -> Tuple[str, ...]:
        return tuple(str(d) for d in self.devices)

    def cards(self) -> List[str]:
        """The distinct devices, in shard order."""
        return list(dict.fromkeys(self.key()))

    def __repr__(self) -> str:
        return f"Mesh(shards={self.size}, devices={self.cards()})"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over `devices` (default: every CUDA device), the first `n_devices`."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def shard_bucket(n: int) -> int:
    c = max(MIN_BUCKET // 8, 128)
    while c < n:
        c *= 2
    return c


class ShardedTable:
    """Column lanes sharded row-wise over the mesh: each `Column.data` (and a
    non-None `Column.valid`) is a list of S tensors of R rows; `live` is the list of
    S live masks."""

    def __init__(self, columns: Dict[str, Column], live: List[torch.Tensor], mesh: Mesh):
        self.columns = columns
        self.live = live
        self.mesh = mesh

    @property
    def nbytes(self) -> int:
        total = sum(int(t.nbytes) for t in self.live)
        for c in self.columns.values():
            total += sum(int(t.nbytes) for t in c.data)
            if c.valid is not None:
                total += sum(int(t.nbytes) for t in c.valid)
        return total


class MeshDataCache:
    """(store id, table version, shard count, devices, columns) -> ShardedTable."""

    def __init__(self):
        self._map: Dict[Tuple, ShardedTable] = {}
        self._lock = threading.Lock()

    def get(self, store, mesh: Mesh, columns: Sequence[str],
            snapshot_ts: Optional[int], txn_id: int = 0) -> ShardedTable:
        table = store.table
        has_pending = any(((p.begin_ts < 0).any() or
                           (p.end_ts != np.iinfo(np.int64).max).any())
                          for p in store.partitions)
        key = (store.uid, table.version, mesh.shape["shard"], mesh.key(),
               tuple(sorted(columns)),
               None if not has_pending else (snapshot_ts, txn_id))
        with self._lock:
            got = self._map.get(key)
            if got is not None:
                return got
        st = _load_sharded(store, mesh, columns, snapshot_ts, txn_id)
        with self._lock:
            if len(self._map) > 64:
                self._map.clear()
            self._map[key] = st
        return st

    @property
    def nbytes(self) -> int:
        """Bytes of every cached sharded lane (all devices together)."""
        with self._lock:
            return sum(st.nbytes for st in self._map.values())

    def clear(self):
        with self._lock:
            self._map.clear()


def _load_sharded(store, mesh: Mesh, columns: Sequence[str],
                  snapshot_ts: Optional[int], txn_id: int) -> ShardedTable:
    """Distribute storage partitions across shards (round-robin, `pid % S`), gather
    each shard's visible rows on the host, pad to R and copy once a shard and lane."""
    S = mesh.shape["shard"]
    table = store.table
    per_shard: List[List[int]] = [[] for _ in range(S)]
    for pid in range(len(store.partitions)):
        per_shard[pid % S].append(pid)

    shard_lanes: Dict[str, List[np.ndarray]] = {c: [] for c in columns}
    shard_valid: Dict[str, List[np.ndarray]] = {c: [] for c in columns}
    counts = []
    for s in range(S):
        datas = {c: [] for c in columns}
        valids = {c: [] for c in columns}
        n = 0
        for pid in per_shard[s]:
            p = store.partitions[pid]
            vis = p.visible_mask(snapshot_ts, txn_id)
            idx = np.nonzero(vis)[0]
            n += idx.shape[0]
            for c in columns:
                datas[c].append(p.lanes[c][idx])
                valids[c].append(p.valid[c][idx])
        counts.append(n)
        for c in columns:
            shard_lanes[c].append(
                np.concatenate(datas[c]) if datas[c] else
                np.zeros(0, dtype=table.column(c).dtype.lane))
            shard_valid[c].append(
                np.concatenate(valids[c]) if valids[c] else np.zeros(0, np.bool_))

    R = shard_bucket(max(max(counts), 1))
    live_np = np.zeros((S, R), dtype=np.bool_)
    for s in range(S):
        live_np[s, :counts[s]] = True

    cols: Dict[str, Column] = {}
    for c in columns:
        cm = table.column(c)
        lane = np.zeros((S, R), dtype=cm.dtype.lane)
        vmask = np.zeros((S, R), dtype=np.bool_)
        for s in range(S):
            k = counts[s]
            lane[s, :k] = shard_lanes[c][s]
            vmask[s, :k] = shard_valid[c][s]
        data = [as_tensor(lane[s], mesh.devices[s]) for s in range(S)]
        valid = None if bool(vmask[live_np].all()) else \
            [as_tensor(vmask[s], mesh.devices[s]) for s in range(S)]
        cols[c] = Column(data, valid, cm.dtype, table.dictionaries.get(c.lower()))
    live = [as_tensor(live_np[s], mesh.devices[s]) for s in range(S)]
    return ShardedTable(cols, live, mesh)


GLOBAL_MESH_CACHE = MeshDataCache()
