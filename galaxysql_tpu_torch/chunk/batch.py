"""Column batches over torch tensors — the port's Chunk/Block engine.

Counterpart of `galaxysql_tpu/chunk/batch.py`:

- `Column`  ~= Block: one fixed-dtype lane tensor + optional validity (null) mask.
- `ColumnBatch` ~= Chunk: dict of named Columns + a `live` row mask standing in for the
  selection vector.  A filter ANDs into `live`; compaction is explicit.

Lanes are torch tensors on whatever device the producer chose (the scan puts them on
the instance's device); every batch utility runs with torch ops on that device, so a
query on the card never round-trips its lanes through the host until the final rows.
Strings are dictionary-encoded (int32 code lanes); the Dictionary is host-side metadata.
A BIGINT UNSIGNED lane (numpy uint64 on the host) lives in a tensor as the same bits in
int64, since torch computes little on uint64: equality, hashing, `+ - *` and the casts
are the same on those bits, and every ordering op goes through `u64_ordered` (the sign
bit flipped, which maps unsigned order onto signed order).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.types import temporal

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.int64,  # the bits (module docstring)
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(d) -> torch.dtype:
    """numpy dtype (or dtype class) -> torch dtype; torch dtypes pass through."""
    if isinstance(d, torch.dtype):
        return d
    return _TORCH_DTYPES[np.dtype(d)]


_SIGN = -(1 << 63)


def u64_ordered(t):
    """int64 bits of uint64 values -> int64 in the same order (the sign bit flipped;
    its own inverse)."""
    return t ^ _SIGN


def u64_to_float(t, dtype=torch.float64):
    """int64 bits of uint64 values -> floats, rounded once as numpy's uint64 cast
    rounds: the high and low 32 bits convert exactly and only their sum rounds."""
    hi = torch.bitwise_right_shift(t, 32) & 0xFFFFFFFF
    lo = t & 0xFFFFFFFF
    return (hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)).to(dtype)


def as_tensor(a, device=None) -> torch.Tensor:
    """Host array / tensor -> tensor on `device` (no copy when already there).  A
    uint64 array or tensor becomes its int64 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.uint64:
            a = a.view(torch.int64)
        return a if device is None else a.to(device)
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    # np.ascontiguousarray would turn a 0-d array (a constant) into shape (1,)
    t = torch.from_numpy(a if a.flags.c_contiguous else np.ascontiguousarray(a))
    return t if device is None else t.to(device)


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class Dictionary:
    """Host-side string dictionary: code lane (int32) <-> Python strings."""

    __slots__ = ("values", "index", "_is_sorted", "uid")

    _next_uid = itertools.count(1)

    def __init__(self, values: Sequence[str] = ()):  # code i -> values[i]
        self.values: List[str] = list(values)
        self.index: Dict[str, int] = {v: i for i, v in enumerate(self.values)}
        self._is_sorted: Optional[bool] = None
        # process-unique, never-reused identity (id() can be recycled after GC)
        self.uid = next(Dictionary._next_uid)

    def __len__(self) -> int:
        return len(self.values)

    def encode_one(self, s: str, add: bool = True) -> int:
        code = self.index.get(s)
        if code is None:
            if not add:
                return -1
            code = len(self.values)
            self.values.append(s)
            self.index[s] = code
            self._is_sorted = None
        return code

    def decode(self, codes: np.ndarray) -> List[Optional[str]]:
        out: List[Optional[str]] = []
        for c in np.asarray(codes).tolist():
            out.append(self.values[c] if 0 <= c < len(self.values) else None)
        return out

    @property
    def is_sorted(self) -> bool:
        if self._is_sorted is None:
            self._is_sorted = all(self.values[i] <= self.values[i + 1]
                                  for i in range(len(self.values) - 1))
        return self._is_sorted

    def rank_array(self) -> np.ndarray:
        """rank[code] = position of code's string in sorted order (for <,> on dict lanes)."""
        order = np.argsort(np.array(self.values, dtype=object), kind="stable")
        rank = np.empty(len(self.values), dtype=np.int32)
        rank[order] = np.arange(len(self.values), dtype=np.int32)
        return rank

    def codes_matching(self, pred) -> np.ndarray:
        """All codes whose string satisfies `pred` (LIKE evaluates host-side once per
        dictionary, then becomes device-side set membership)."""
        return np.array([i for i, v in enumerate(self.values) if pred(v)], dtype=np.int32)

    def sorted_order(self) -> np.ndarray:
        """order[rank] = code whose string sorts at position `rank`."""
        return np.argsort(np.array(self.values, dtype=object), kind="stable").astype(np.int32)


def dictionary_translation(target: Dictionary, source: Dictionary) -> np.ndarray:
    """trans[source_code] = target_code (or -1 when the string is absent from target)."""
    return np.array([target.encode_one(v, add=False) for v in source.values] or [-1],
                    dtype=np.int32)


_UNION_TRANS_CACHE: Dict[Tuple[int, int, int], np.ndarray] = {}


def dictionary_union_translation(target: Dictionary,
                                 source: Dictionary) -> np.ndarray:
    """trans[source_code] = target_code, EXTENDING target with values it lacks
    (UNION semantics: every source string must exist in the output dictionary).

    Cached by (target uid, source uid, len(source)): codes never change once
    assigned, so a cached table stays valid as either dictionary grows."""
    key = (target.uid, source.uid, len(source))
    t = _UNION_TRANS_CACHE.get(key)
    if t is None:
        t = np.array([target.encode_one(v) for v in source.values] or [0],
                     dtype=np.int32)
        if len(_UNION_TRANS_CACHE) > 4096:
            _UNION_TRANS_CACHE.clear()
        _UNION_TRANS_CACHE[key] = t
    return t


_EXACT_FLOAT = 1 << 53  # integers below this convert to float64 exactly


@dataclasses.dataclass
class Column:
    """One column lane: `data` + optional validity mask (True = non-null)."""

    data: Any  # torch tensor [n]
    valid: Optional[Any]  # bool tensor [n] or None (all valid)
    dtype: dt.DataType = dataclasses.field(default=dt.BIGINT)
    dictionary: Optional[Dictionary] = None

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.valid

    def np_data(self) -> np.ndarray:
        """The lane on the host in the reference's dtype (BIGINT UNSIGNED bits back
        to uint64)."""
        out = to_numpy(self.data)
        if self.dtype.clazz == dt.TypeClass.UINT and out.dtype == np.int64:
            return out.view(np.uint64)
        return out

    def np_valid(self) -> np.ndarray:
        if self.valid is None:
            return np.ones(self.data.shape[0], dtype=np.bool_)
        return to_numpy(self.valid)

    def to_pylist(self) -> List[Any]:
        """Python values (None = NULL), those the reference's value-by-value loop
        gives, from whole-array numpy operations: a decimal lane below 2**53
        converts to float64 exactly and takes one correctly rounded division, as
        Python's int / int does; a date's text is formatted once per distinct day."""
        data = self.np_data()
        valid = self.np_valid()
        t = self.dtype
        if t.is_string and self.dictionary is not None:
            decoded = self.dictionary.decode(data)
            return [v if ok else None for v, ok in zip(decoded, valid.tolist())]
        if t.clazz == dt.TypeClass.DECIMAL:
            scale = 10 ** t.scale
            if scale < _EXACT_FLOAT and (data.size == 0 or
                                         np.abs(data.astype(np.int64)).max() < _EXACT_FLOAT):
                out = (data.astype(np.float64) / float(scale)).tolist()
            else:
                out = [int(v) / scale for v in data.tolist()]
        elif t.clazz in (dt.TypeClass.DATE, dt.TypeClass.DATETIME):
            fmt = temporal.format_date if t.clazz == dt.TypeClass.DATE \
                else temporal.format_datetime
            uniq, inverse = np.unique(data, return_inverse=True)
            text = [fmt(int(v)) for v in uniq.tolist()]
            out = [text[i] for i in inverse.reshape(-1).tolist()]
        elif t.clazz == dt.TypeClass.FLOAT:
            out = data.astype(np.float64).tolist()
        elif t.clazz == dt.TypeClass.BOOL:
            out = data.astype(np.bool_).tolist()
        elif data.dtype.kind in "iu":
            out = data.tolist()
        else:
            out = [int(v) for v in data.tolist()]
        if not valid.all():
            out = [v if ok else None for v, ok in zip(out, valid.tolist())]
        return out


def column_from_pylist(values: Sequence[Any], typ: dt.DataType,
                       dictionary: Optional[Dictionary] = None) -> Column:
    """Build a host (CPU tensor) Column from Python values (None = NULL)."""
    n = len(values)
    valid = np.array([v is not None for v in values], dtype=np.bool_)
    lane = np.zeros(n, dtype=typ.lane)
    if typ.is_string:
        dictionary = dictionary if dictionary is not None else Dictionary()
        codes = [dictionary.encode_one(v) if v is not None else 0 for v in values]
        lane = np.array(codes, dtype=np.int32)
    else:
        for i, v in enumerate(values):
            if v is None:
                continue
            if typ.clazz == dt.TypeClass.DECIMAL:
                lane[i] = round(float(v) * (10 ** typ.scale))
            elif typ.clazz == dt.TypeClass.DATE:
                lane[i] = temporal.parse_date(v) if isinstance(v, str) else int(v)
            elif typ.clazz == dt.TypeClass.DATETIME:
                lane[i] = temporal.parse_datetime(v) if isinstance(v, str) else int(v)
            else:
                lane[i] = v
    return Column(as_tensor(lane), None if bool(valid.all()) else as_tensor(valid),
                  typ, dictionary)


class ColumnBatch:
    """A batch of rows: named Columns of equal length + a `live` row mask.

    Rows with live=False exist physically (capacity buckets) but are logically
    deleted.  `None` means all rows live.

    `host` marks a host batch: CPU tensors that the reference would hold as numpy
    lanes (the host scan of a statement run without a device cache, a point get,
    VALUES).  It names the device the batch joins once it leaves the host tier
    (`to_device`); None for every other batch.  A CPU device cannot tell the two
    apart by the tensors' device, so the mark is explicit.  `compact`, `pad_to` and
    `rename` keep it.

    `nominal` is the capacity the reference gives a batch whose lanes the port sizes
    tighter: a hash join's output, whose pair capacity the reference counts from the
    probe rows before the probe prelude (its fused WHERE runs inside the pair
    program).  None where it is `capacity`.  Operators that keep a batch's rows keep
    it, and a GROUP BY above sizes its slots from it (`min(max_groups, n)`), so its
    output's capacity, which decides numpy or device above, is the reference's."""

    def __init__(self, columns: Dict[str, Column], live: Optional[Any] = None,
                 host: Optional[torch.device] = None, nominal: Optional[int] = None):
        self.columns = columns
        self.live = live
        self.host = host
        self.nominal = nominal

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return int(next(iter(self.columns.values())).data.shape[0])

    @property
    def nominal_capacity(self) -> int:
        return self.capacity if self.nominal is None else self.nominal

    @property
    def device(self) -> torch.device:
        if self.columns:
            return next(iter(self.columns.values())).data.device
        if isinstance(self.live, torch.Tensor):
            return self.live.device
        return torch.device("cpu")

    def live_mask(self) -> torch.Tensor:
        if self.live is None:
            return torch.ones(self.capacity, dtype=torch.bool, device=self.device)
        return self.live

    def np_live(self) -> np.ndarray:
        if self.live is None:
            return np.ones(self.capacity, dtype=np.bool_)
        return to_numpy(self.live)

    def num_live(self) -> int:
        if self.live is None:
            return self.capacity
        return int(self.live.sum())

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def names(self) -> List[str]:
        return list(self.columns.keys())

    def compact(self) -> "ColumnBatch":
        """Drop dead rows (gather on the batch's device)."""
        if self.live is None:
            return self
        idx = torch.nonzero(self.live).squeeze(1)
        cols = {}
        for name, c in self.columns.items():
            valid = None
            if c.valid is not None:
                valid = c.valid[idx]
                if bool(valid.all()):
                    valid = None
            cols[name] = Column(c.data[idx], valid, c.dtype, c.dictionary)
        return ColumnBatch(cols, None, self.host)

    def pad_to(self, capacity: int) -> "ColumnBatch":
        """Pad with dead rows up to `capacity` (capacity buckets)."""
        n = self.capacity
        dev = self.device
        if n == capacity:
            if self.live is None:
                return ColumnBatch(dict(self.columns),
                                   torch.ones(n, dtype=torch.bool, device=dev), self.host)
            return self
        if n > capacity:
            raise ValueError(f"cannot pad batch of {n} down to {capacity}")
        pad = capacity - n
        live = torch.zeros(capacity, dtype=torch.bool, device=dev)
        live[:n] = self.live_mask()
        cols = {}
        for name, c in self.columns.items():
            data = torch.cat([c.data, torch.zeros(pad, dtype=c.data.dtype, device=dev)])
            valid = torch.cat([c.valid_mask(),
                               torch.zeros(pad, dtype=torch.bool, device=dev)])
            cols[name] = Column(data, valid, c.dtype, c.dictionary)
        return ColumnBatch(cols, live, self.host)

    def to_pylist(self) -> List[Tuple]:
        """Live rows as tuples of Python values."""
        cb = self.compact()
        cols = [cb.columns[n].to_pylist() for n in cb.names()]
        return list(zip(*cols)) if cols else []

    def rename(self, mapping: Dict[str, str]) -> "ColumnBatch":
        return ColumnBatch({mapping.get(n, n): c for n, c in self.columns.items()},
                           self.live, self.host, self.nominal)


# The host tier's traffic: `pull_*` the aggregate finalize's copies of its lanes to
# the host (`exec/operators.HashAggOp._finalize`), `push_*` the copies of host batches
# onto their device (`to_device`), `numpy_runs` the Filter, Project and fused-segment
# runs on `ExprCompiler(np)`.  Bytes are the lanes handed over (on the CPU nothing is
# copied); ms the card's time for the copies alone (CUDA events, not the work queued
# before them), the host clock on the CPU.  Plain adds, as DISPATCH_STATS.
HOST_TIER_STATS = {"pull_bytes": 0, "pull_ms": 0.0, "push_bytes": 0, "push_ms": 0.0,
                   "numpy_runs": 0}


@contextlib.contextmanager
def copy_clock(kind: str, device: torch.device, nbytes: int):
    """Times the blocking copies inside the block into HOST_TIER_STATS[kind + "_ms"]
    and adds `nbytes` to HOST_TIER_STATS[kind + "_bytes"]."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        end.synchronize()  # the copies blocked already: no wait for other work
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        yield
        ms = (time.perf_counter() - t0) * 1000
    HOST_TIER_STATS[kind + "_bytes"] += nbytes
    HOST_TIER_STATS[kind + "_ms"] += ms


def to_device(b: ColumnBatch) -> ColumnBatch:
    """A host batch as a device batch on the device its mark names (on the CPU this
    only drops the mark); any other batch as it is.  Every operator that the
    reference runs on jnp takes its input through here."""
    if b.host is None:
        return b
    dev = b.host
    lanes = [t for c in b.columns.values() for t in (c.data, c.valid) if t is not None]
    if b.live is not None:
        lanes.append(b.live)
    with copy_clock("push", dev, sum(t.nbytes for t in lanes)):
        return ColumnBatch(
            {n: Column(c.data.to(dev), None if c.valid is None else c.valid.to(dev),
                       c.dtype, c.dictionary) for n, c in b.columns.items()},
            None if b.live is None else b.live.to(dev))


def batch_from_pydict(data: Dict[str, Sequence[Any]], schema: Dict[str, dt.DataType],
                      dictionaries: Optional[Dict[str, Dictionary]] = None) -> ColumnBatch:
    cols = {}
    for name, values in data.items():
        d = (dictionaries or {}).get(name)
        cols[name] = column_from_pylist(values, schema[name], d)
    return ColumnBatch(cols, None)


def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    """Concatenation of compacted batches on their device (dictionaries must be
    shared).  Host batches stay host batches; mixed with device batches, they join
    the device first."""
    batches = [b.compact() for b in batches if b.capacity]
    if not batches:
        return ColumnBatch({}, None, torch.device("cpu"))  # the reference's: all numpy
    if len(batches) == 1:
        return batches[0]
    host = batches[0].host
    if any(b.host != host for b in batches):
        batches = [to_device(b) for b in batches]
        host = None
    names = batches[0].names()
    cols = {}
    for n in names:
        ref = batches[0].columns[n]
        data = torch.cat([b.columns[n].data for b in batches])
        valid = None
        if any(b.columns[n].valid is not None for b in batches):
            valid = torch.cat([b.columns[n].valid_mask() for b in batches])
        cols[n] = Column(data, valid, ref.dtype, ref.dictionary)
    return ColumnBatch(cols, None, host)
