"""Column batches over torch tensors — the port's Chunk/Block engine.

Counterpart of `galaxysql_tpu/chunk/batch.py`:

- `Column`  ~= Block: one fixed-dtype lane tensor + optional validity (null) mask.
- `ColumnBatch` ~= Chunk: dict of named Columns + a `live` row mask standing in for the
  selection vector.  A filter ANDs into `live`; compaction is explicit.

Lanes are torch tensors on whatever device the producer chose (the scan puts them on
the instance's device); every batch utility runs with torch ops on that device, so a
query on the card never round-trips its lanes through the host until the final rows.
Strings are dictionary-encoded (int32 code lanes); the Dictionary is host-side metadata.
"""

from __future__ import annotations

import dataclasses
import itertools
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
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(d) -> torch.dtype:
    """numpy dtype (or dtype class) -> torch dtype; torch dtypes pass through."""
    if isinstance(d, torch.dtype):
        return d
    return _TORCH_DTYPES[np.dtype(d)]


def as_tensor(a, device=None) -> torch.Tensor:
    """Host array / tensor -> tensor on `device` (no copy when already there)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
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
        return to_numpy(self.data)

    def np_valid(self) -> np.ndarray:
        if self.valid is None:
            return np.ones(self.data.shape[0], dtype=np.bool_)
        return to_numpy(self.valid)

    def to_pylist(self) -> List[Any]:
        data = self.np_data()
        valid = self.np_valid()
        t = self.dtype
        out: List[Any] = []
        if t.is_string and self.dictionary is not None:
            decoded = self.dictionary.decode(data)
            return [decoded[i] if valid[i] else None for i in range(len(decoded))]
        for i in range(data.shape[0]):
            if not valid[i]:
                out.append(None)
            elif t.clazz == dt.TypeClass.DECIMAL:
                out.append(int(data[i]) / (10 ** t.scale))
            elif t.clazz == dt.TypeClass.DATE:
                out.append(temporal.format_date(int(data[i])))
            elif t.clazz == dt.TypeClass.DATETIME:
                out.append(temporal.format_datetime(int(data[i])))
            elif t.clazz == dt.TypeClass.FLOAT:
                out.append(float(data[i]))
            elif t.clazz == dt.TypeClass.BOOL:
                out.append(bool(data[i]))
            else:
                out.append(int(data[i]))
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
    deleted.  `None` means all rows live."""

    def __init__(self, columns: Dict[str, Column], live: Optional[Any] = None):
        self.columns = columns
        self.live = live

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return int(next(iter(self.columns.values())).data.shape[0])

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
        return ColumnBatch(cols, None)

    def pad_to(self, capacity: int) -> "ColumnBatch":
        """Pad with dead rows up to `capacity` (capacity buckets)."""
        n = self.capacity
        dev = self.device
        if n == capacity:
            if self.live is None:
                return ColumnBatch(dict(self.columns),
                                   torch.ones(n, dtype=torch.bool, device=dev))
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
        return ColumnBatch(cols, live)

    def to_pylist(self) -> List[Tuple]:
        """Live rows as tuples of Python values."""
        cb = self.compact()
        cols = [cb.columns[n].to_pylist() for n in cb.names()]
        return list(zip(*cols)) if cols else []

    def rename(self, mapping: Dict[str, str]) -> "ColumnBatch":
        return ColumnBatch({mapping.get(n, n): c for n, c in self.columns.items()}, self.live)


def batch_from_pydict(data: Dict[str, Sequence[Any]], schema: Dict[str, dt.DataType],
                      dictionaries: Optional[Dict[str, Dictionary]] = None) -> ColumnBatch:
    cols = {}
    for name, values in data.items():
        d = (dictionaries or {}).get(name)
        cols[name] = column_from_pylist(values, schema[name], d)
    return ColumnBatch(cols, None)


def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    """Concatenation of compacted batches on their device (dictionaries must be shared)."""
    batches = [b.compact() for b in batches if b.capacity]
    if not batches:
        return ColumnBatch({}, None)
    if len(batches) == 1:
        return batches[0]
    names = batches[0].names()
    cols = {}
    for n in names:
        ref = batches[0].columns[n]
        data = torch.cat([b.columns[n].data for b in batches])
        valid = None
        if any(b.columns[n].valid is not None for b in batches):
            valid = torch.cat([b.columns[n].valid_mask() for b in batches])
        cols[n] = Column(data, valid, ref.dtype, ref.dictionary)
    return ColumnBatch(cols, None)
