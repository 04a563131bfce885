"""CUDA kernel of the hash GROUP BY's group placement, with its plain version.

Port of `galaxysql_tpu/kernels/pallas_agg.py` `hash_place` (`_make_place_kernel`),
whose oracle is `relational._hash_place`: open-addressing placement in rounds of
elect (scatter-min on row id into slots empty at the round's start) and adopt
(identity-lane compare), at most `max_rounds` rounds.

The kernel is one cooperative launch per call (see `csrc/hash_place.cu`): the whole
round loop runs inside it, with grid-wide barriers between the phases.  Its election
is round-stamped (a 64-bit atomicMin of `round << 32 | row`, so an earlier round's
owner always wins, without the reference's occupancy snapshot), and rounds after the
first walk only a worklist of the rows still unresolved.

The wrapper takes the tensors' device as the route: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version.  `LAUNCHES` counts kernel
launches, one per call.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Sequence, Tuple

import torch

from galaxysql_tpu_torch.kernels import cuda_build as cb
from galaxysql_tpu_torch.kernels.cuda_join import check_lane, key_lane_args

LAUNCHES = {"hash_place": 0}

_VP = ctypes.c_void_p
_PLACE_ARGS = (ctypes.c_int, _VP, _VP, _VP, ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _VP)


def reset_launches():
    LAUNCHES["hash_place"] = 0


def hash_place_plain(ident: Sequence[Tuple[Any, Optional[Any]]], live, s0, step,
                     M: int, max_rounds: int):
    """Vectorized scatter-min election rounds with early exit — the reference
    `_hash_place`.  s0/step hold the uint64 probe walk as int64 bits."""
    n = live.shape[0]
    dev = live.device
    rowid = torch.arange(n, dtype=torch.int32, device=dev)
    sentinel = n
    rep = torch.full((M,), sentinel, dtype=torch.int32, device=dev)
    resolved = ~live
    gid = torch.zeros(n, dtype=torch.int32, device=dev)
    r = 0
    while r < max_rounds and bool((~resolved).any()):
        s = ((s0 + r * step) & (M - 1)).to(torch.int64)
        occupied = rep[s] != sentinel
        cand = torch.where(resolved | occupied, torch.full_like(rowid, sentinel), rowid)
        rep.scatter_reduce_(0, s, cand, reduce="amin", include_self=True)
        owner = rep[s]
        safe = torch.clamp(owner, 0, max(n - 1, 0)).to(torch.int64)
        same = owner != sentinel
        for d, valid in ident:
            same = same & (d[safe] == d)
            if valid is not None:
                same = same & (valid[safe] == valid)
        newly = ~resolved & same
        gid = torch.where(newly, s.to(torch.int32), gid)
        resolved = resolved | newly
        r += 1
    return rep, resolved, gid


def hash_place(ident: Sequence[Tuple[Any, Optional[Any]]], live, s0, step,
               M: int, max_rounds: int):
    """Slot placement for `hash_groupby`: (rep int32[M], resolved bool[n],
    gid int32[n]), bit-identical to the reference round loop."""
    if not live.is_cuda:
        return hash_place_plain(ident, live, s0, step, M, max_rounds)
    device = live.device
    n = int(live.shape[0])
    if not 1 <= M <= (1 << 30):
        raise ValueError(f"slot count {M} out of range")
    if n >= (1 << 31) - 1:
        raise ValueError(f"{n} rows exceed the kernel's int32 row ids")
    if not 0 <= max_rounds < (1 << 31):
        raise ValueError(f"round limit {max_rounds} out of range")
    check_lane(live, n, device, "live lane", torch.bool)
    check_lane(s0, n, device, "s0", torch.int64)
    check_lane(step, n, device, "step", torch.int64)
    data, valid, wide, hold = key_lane_args(ident, n, device)
    rep = torch.empty(M, dtype=torch.int32, device=device)
    resolved = torch.empty(n, dtype=torch.bool, device=device)
    gid = torch.empty(n, dtype=torch.int32, device=device)
    # the slot owners (uint64), two worklists and their lengths: 8M + 8n + 4(rounds+1)
    # bytes, the layout gx_hash_place carves
    scratch = torch.empty(M + n + max_rounds // 2 + 1, dtype=torch.int64, device=device)
    rc = cb.function("hash_place.cu", "gx_hash_place", _PLACE_ARGS)(
        cb.device_index(rep), ctypes.cast(data, _VP), ctypes.cast(valid, _VP),
        ctypes.cast(wide, _VP), len(ident), cb.ptr(live), cb.ptr(s0), cb.ptr(step),
        cb.ptr(rep), cb.ptr(resolved), cb.ptr(gid), cb.ptr(scratch), n, M, max_rounds,
        cb.stream_of(rep))
    cb.check(rc, "hash_place")
    LAUNCHES["hash_place"] += 1
    return rep, resolved, gid
