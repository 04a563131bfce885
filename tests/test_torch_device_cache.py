"""The port's device cache against the reference's single-flight build claim
(`galaxysql_tpu/exec/device_cache.py` `_lookup_or_claim`): concurrent misses on one
key run the builder once and count the lane's bytes once, a failed build frees the
claim, and every miss adds to `TRANSFER_STATS`."""

import threading
import time

import numpy as np
import pytest
import torch

from galaxysql_tpu_torch.exec import device_cache as dc

pytestmark = pytest.mark.torch_port


class _Store:
    uid = 7


def test_concurrent_cold_misses_build_once():
    cache = dc.DeviceCache("cpu")
    lane = np.arange(4096, dtype=np.int64)
    builds = []
    start = threading.Barrier(8)
    got = [None] * 8

    def builder():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # every other thread misses while this one builds
        return lane

    def run(i):
        start.wait(timeout=30)
        got[i] = cache.get_lane_built(_Store, -1, "c", 1, lane.size, builder)

    x0 = dict(dc.TRANSFER_STATS)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(builds) == 1
    assert cache.nbytes == lane.nbytes
    assert all(g is got[0] for g in got)
    assert torch.equal(got[0], torch.from_numpy(lane))
    assert (cache.misses, cache.hits) == (1, 7)
    assert dc.TRANSFER_STATS["bytes"] - x0["bytes"] == lane.nbytes
    assert dc.TRANSFER_STATS["transfers"] - x0["transfers"] == 1


def test_failed_build_frees_the_claim():
    cache = dc.DeviceCache("cpu")

    def broken():
        raise RuntimeError("builder failed")

    with pytest.raises(RuntimeError):
        cache.get_lane_built(_Store, 0, "c", 1, 3, broken)
    assert cache.nbytes == 0
    t = cache.get_lane_built(_Store, 0, "c", 1, 3, lambda: np.ones(3, np.int32))
    assert cache.nbytes == 12 and t.tolist() == [1, 1, 1]


def test_waiter_takes_over_after_a_failed_build():
    cache = dc.DeviceCache("cpu")
    owner_in = threading.Event()
    calls = []

    def failing():
        calls.append("fail")
        owner_in.set()
        time.sleep(0.05)
        raise RuntimeError("builder failed")

    def good():
        calls.append("good")
        return np.zeros(5, np.int64)

    errs = []

    def owner():
        try:
            cache.get_lane_built(_Store, 0, "c", 1, 5, failing)
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=owner)
    t.start()
    owner_in.wait(timeout=30)
    out = cache.get_lane_built(_Store, 0, "c", 1, 5, good)
    t.join(timeout=30)
    assert len(errs) == 1 and calls == ["fail", "good"]
    assert out.tolist() == [0] * 5 and cache.nbytes == 40


def test_bytes_equal_the_resident_lanes_through_eviction_and_clear():
    cache = dc.DeviceCache("cpu", budget_bytes=200)
    for v in range(4):  # 64 bytes each: the fourth evicts the first
        cache.get_lane_built(_Store, 0, "c", v, 8, lambda: np.ones(8, np.int64))
    resident = sum(t.numel() * t.element_size() for t in cache._map.values())
    assert cache.nbytes == resident == 192 and len(cache._map) == 3
    cache.clear()
    assert cache.nbytes == 0
    cache.get_lane_built(_Store, 0, "c", 0, 8, lambda: np.ones(8, np.int64))
    assert cache.nbytes == 64
