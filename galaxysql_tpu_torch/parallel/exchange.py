"""The exchange plane over per-shard tensors (port of
`galaxysql_tpu/parallel/exchange.py`).

The reference's exchanges are collectives inside one `shard_map` program: a hash
repartition is a bucketed `all_to_all`, a broadcast an `all_gather`.  The port is
single-controller, so an exchange is the host loop moving blocks between the shards'
tensors: a block bound for another device goes there with
`Tensor.to(device, non_blocking=True)` (a peer copy between cards), and on one device
it is a slice copy, or nothing for a broadcast, whose result every shard of that
device shares.

Shapes stay fixed as in the reference: each (source, destination) pair carries
`quota` slots, and a source with more rows for one destination reports overflow so
the host retries with a bigger quota.  Destination d receives its rows source shard
by source shard, each in source-row order (the reference's stable sort on
(destination, row)), so row order, and with it every result, matches the reference.

`EXCHANGE_STATS` counts the exchanges and the lane bytes they move (padding
included: the fixed-shape buffers are what moves).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from galaxysql_tpu_torch.kernels.hashing import lsr

EXCHANGE_STATS = {"repartitions": 0, "broadcasts": 0, "bytes": 0}


def reset_exchange_stats():
    for k in EXCHANGE_STATS:
        EXCHANGE_STATS[k] = 0


def _dest(hash_lane: torch.Tensor, S: int) -> torch.Tensor:
    """`hash % S` of the reference's uint64 hash, over its int64 bits."""
    if S & (S - 1) == 0:
        return hash_lane & (S - 1)
    # u = 2 * (u >> 1) + (u & 1), and u >> 1 is non-negative as an int64
    return (torch.remainder(lsr(hash_lane, 1), S) * 2 + (hash_lane & 1)) % S


def _send_slots(live: torch.Tensor, dest: torch.Tensor, S: int, quota: int):
    """(slot -> source row, or n for an empty slot; overflow) of one source shard:
    destination d's rows in source order fill slots [d*quota, (d+1)*quota)."""
    n = live.shape[0]
    dev = live.device
    key = torch.where(live, dest, torch.full_like(dest, S))
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    counts = torch.bincount(key_s, minlength=S + 1)[:S]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[torch.clamp(key_s, max=S - 1)]
    ok = (key_s < S) & (rank < quota)
    flat = torch.where(ok, key_s * quota + rank, torch.full_like(rank, S * quota))
    slots = torch.full((S * quota + 1,), n, dtype=torch.int64, device=dev)
    slots[flat] = order
    return slots[:S * quota], (counts > quota).any()


def _take(lane: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """lane[slots] with slot value len(lane) reading a zero."""
    padded = torch.cat([lane, torch.zeros(1, dtype=lane.dtype, device=lane.device)])
    return padded[slots]


def read_flags(*groups: Sequence[Any]) -> List[bool]:
    """For each group of per-shard flags (device tensors or bools), whether any is
    set: every tensor read back in one host read."""
    tensors = [f for g in groups for f in g if isinstance(f, torch.Tensor)]
    vals = iter(torch.stack([t.reshape(()).to(tensors[0].device) for t in tensors])
                .cpu().tolist() if tensors else [])
    out = []
    for g in groups:
        out.append(any([bool(next(vals)) if isinstance(f, torch.Tensor) else bool(f)
                        for f in g]))
    return out


def any_flag(flags: Sequence[Any]) -> bool:
    """OR of per-shard flags (tensors or bools) in one host read."""
    return read_flags(flags)[0]


def repartition_by_hash(lanes: Sequence[Sequence[torch.Tensor]],
                        live: Sequence[torch.Tensor],
                        hash_lane: Sequence[torch.Tensor],
                        quota: int, devices: Sequence[torch.device]
                        ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor], Any]:
    """Hash-repartition rows over the shards.

    lanes[s]: shard s's payload tensors [R]; live[s]: [R] bool; hash_lane[s]: the
    int64 bits of the uint64 hash [R].  Row r of shard s goes to shard hash % S.
    Returns (per destination, its lanes [S*quota]; its live masks; overflow), the
    overflow a device flag (any source had more than `quota` rows for one
    destination) for the caller to read with its other flags."""
    S = len(devices)
    slots, overs = [], []
    for s in range(S):
        sl, over = _send_slots(live[s], _dest(hash_lane[s], S), S, quota)
        slots.append(sl)
        overs.append(over)
    sent = [[_take(lane, slots[s]) for lane in lanes[s]] +
            [_take(live[s], slots[s])] for s in range(S)]
    out_lanes: List[List[torch.Tensor]] = []
    out_live: List[torch.Tensor] = []
    nbytes = 0
    for d in range(S):
        dev = devices[d]
        lo, hi = d * quota, (d + 1) * quota
        recv = [torch.cat([sent[s][i][lo:hi].to(dev, non_blocking=True)
                           for s in range(S)]) for i in range(len(sent[0]))]
        nbytes += sum(int(t.nbytes) for t in recv)
        out_lanes.append(recv[:-1])
        out_live.append(recv[-1])
    EXCHANGE_STATS["repartitions"] += 1
    EXCHANGE_STATS["bytes"] += nbytes
    home = devices[0]
    overflow = torch.stack([o.to(home) for o in overs]).any()
    return out_lanes, out_live, overflow


def broadcast_all(lanes: Sequence[Sequence[torch.Tensor]],
                  live: Sequence[torch.Tensor], devices: Sequence[torch.device]
                  ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor]]:
    """Replicate every shard's rows to all shards (the broadcast join's build side):
    shard d gets the concatenation of shards 0..S-1.  Shards on one device share one
    concatenation."""
    S = len(devices)
    by_device: Dict[str, Tuple[List[torch.Tensor], torch.Tensor]] = {}
    out_lanes: List[List[torch.Tensor]] = []
    out_live: List[torch.Tensor] = []
    for d in range(S):
        dev = devices[d]
        got = by_device.get(str(dev))
        if got is None:
            g = [torch.cat([lanes[s][i].to(dev, non_blocking=True) for s in range(S)])
                 for i in range(len(lanes[0]))]
            gl = torch.cat([live[s].to(dev, non_blocking=True) for s in range(S)])
            got = (g, gl)
            by_device[str(dev)] = got
            EXCHANGE_STATS["bytes"] += sum(int(t.nbytes) for t in g) + int(gl.nbytes)
        out_lanes.append(got[0])
        out_live.append(got[1])
    EXCHANGE_STATS["broadcasts"] += 1
    return out_lanes, out_live


def gather_concat(lanes: Sequence[Sequence[torch.Tensor]],
                  live: Sequence[torch.Tensor], devices: Sequence[torch.device]
                  ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor]]:
    """Every shard receives the concatenation (a replicated result)."""
    return broadcast_all(lanes, live, devices)
