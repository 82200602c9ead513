"""The port's ``ops/devtime.py``: ``tests/test_devtime_property.py``'s
cases on ``dampr_tpu_torch.ops.devtime``, plus the keyed hook.

Property tests for devtime's codec_wait interval union.

The bucket is defined as the WALL-CLOCK union of intervals during which
every live overlap slot is simultaneously stalled on its codec.  Under
arbitrary multithreaded enter/stall/unstall/exit churn that definition
implies two machine-checkable invariants:

- **wall bound**: the union of sub-intervals of [t0, t1] can never exceed
  t1 - t0;
- **monotonicity**: the bucket is cumulative, so successive snapshots
  never decrease (snapshot() folds the open interval in).

Plus the pinned ``reset()`` contract: resetting while the all-stalled
interval is OPEN restarts that interval at the reset point — the bucket
afterwards counts only post-reset stall time.
"""

import random
import threading
import time

from dampr_tpu_torch.ops import devtime


def _churn(seed, iters=120):
    """One slot's randomized lifecycle: enter, a random stall/unstall
    dance with tiny sleeps, exit.  All operations correctly paired."""
    rng = random.Random(seed)
    devtime.slot_enter()
    try:
        for _ in range(iters):
            if rng.random() < 0.6:
                devtime.slot_stall()
                if rng.random() < 0.5:
                    time.sleep(rng.random() * 0.002)
                devtime.slot_unstall()
            else:
                time.sleep(rng.random() * 0.001)
    finally:
        devtime.slot_exit()


class TestCodecWaitUnion:
    def test_never_exceeds_wall_and_monotone(self):
        devtime.reset()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_churn, args=(seed,))
                   for seed in range(6)]
        for t in threads:
            t.start()
        prev = 0.0
        snaps = 0
        while any(t.is_alive() for t in threads):
            cur = devtime.snapshot()["codec_wait"]
            wall = time.perf_counter() - t0
            assert cur <= wall + 1e-3, (cur, wall)
            assert cur >= prev - 1e-9, "codec_wait went backwards"
            prev = cur
            snaps += 1
            time.sleep(0.001)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        final = devtime.snapshot()["codec_wait"]
        assert final <= wall + 1e-3
        assert final >= prev - 1e-9
        assert snaps > 5, "churn finished before sampling anything"
        devtime.reset()

    def test_all_stalled_interval_accumulates(self):
        """One slot, stalled: the union interval is open and grows."""
        devtime.reset()
        devtime.slot_enter()
        devtime.slot_stall()
        try:
            time.sleep(0.02)
            got = devtime.snapshot()["codec_wait"]
            assert got >= 0.015, got
        finally:
            devtime.slot_unstall()
            devtime.slot_exit()
        closed = devtime.snapshot()["codec_wait"]
        time.sleep(0.005)
        assert devtime.snapshot()["codec_wait"] == closed, (
            "bucket must stop accumulating once the slot unstalls")
        devtime.reset()

    def test_partial_stall_does_not_count(self):
        """Two live slots, one stalled: NOT all-stalled, no accumulation."""
        devtime.reset()
        devtime.slot_enter()
        devtime.slot_enter()
        devtime.slot_stall()
        try:
            time.sleep(0.01)
            assert devtime.snapshot()["codec_wait"] == 0.0
        finally:
            devtime.slot_unstall()
            devtime.slot_exit()
            devtime.slot_exit()
        devtime.reset()

    def test_reset_restarts_open_interval(self):
        """Pinned: reset() during an OPEN all-stalled interval zeroes the
        bucket and restarts the interval at the reset point."""
        devtime.reset()
        devtime.slot_enter()
        devtime.slot_stall()
        try:
            time.sleep(0.02)  # pre-reset stall time, must be discarded
            devtime.reset()
            t0 = time.perf_counter()
            time.sleep(0.02)
            got = devtime.snapshot()["codec_wait"]
            elapsed = time.perf_counter() - t0
            assert got <= elapsed + 1e-3, (got, elapsed)
            assert got >= 0.015, (
                "post-reset stall time must still accumulate: %r" % got)
        finally:
            devtime.slot_unstall()
            devtime.slot_exit()
        devtime.reset()


class TestEpochDelta:
    def test_delta_is_run_scoped(self):
        """epoch()/delta() reads do not require (or perform) a reset, so
        they cannot clobber a concurrent reader's counters."""
        devtime.reset()
        devtime.add("device", 1.0)
        outer = devtime.epoch()
        devtime.add("device", 0.25)
        devtime.add("codec", 0.5)
        inner = devtime.epoch()
        devtime.add("codec", 0.125)
        d_inner = devtime.delta(inner)
        assert abs(d_inner["codec"] - 0.125) < 1e-9
        assert d_inner["device"] == 0.0
        d_outer = devtime.delta(outer)
        assert abs(d_outer["device"] - 0.25) < 1e-9
        assert abs(d_outer["codec"] - 0.625) < 1e-9
        # absolute counters still carry the pre-epoch history
        assert abs(devtime.snapshot()["device"] - 1.25) < 1e-9
        devtime.reset()

    def test_delta_clamps_after_interleaved_reset(self):
        devtime.reset()
        devtime.add("transfer", 2.0)
        ep = devtime.epoch()
        devtime.reset()  # a legacy caller clobbers the counters
        devtime.add("transfer", 0.5)
        d = devtime.delta(ep)
        assert d["transfer"] == 0.0  # clamped, never negative
        devtime.reset()


class _Store(object):
    def __init__(self):
        self.calls = []

    def count_keyed(self, name, seconds, h2d, d2h):
        self.calls.append((name, seconds, h2d, d2h))


class TestKeyedHook:
    def test_keyed_charges_the_bound_store_and_the_device_bucket(self):
        """A keyed device call adds its seconds to the ``device`` bucket
        and, inside ``charging``, to the run's store; outside, to none."""
        devtime.reset()
        ep = devtime.epoch()
        store = _Store()
        devtime.keyed("hash_sort", 0.5, 16, 4)
        with devtime.charging(store):
            devtime.keyed("fnv_lanes", 0.25, 32, 8)
            inner = _Store()
            with devtime.charging(inner):
                devtime.keyed("segment_fold", 0.125, 1, 2)
            devtime.keyed("mix_int", 0.0625, 8, 16)
        devtime.keyed("hash_sort", 1.0, 0, 0)
        assert store.calls == [("fnv_lanes", 0.25, 32, 8),
                               ("mix_int", 0.0625, 8, 16)]
        assert inner.calls == [("segment_fold", 0.125, 1, 2)]
        assert abs(devtime.delta(ep)["device"] - 1.9375) < 1e-9
        devtime.reset()

    def test_charging_is_per_thread(self):
        store = _Store()
        seen = []

        def other():
            devtime.keyed("x", 0.0, 0, 0)
            seen.append(True)

        with devtime.charging(store):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive() and seen == [True]
        assert store.calls == []
