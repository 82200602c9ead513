"""The mesh byte exchange (B8) and its schedule of dampr_tpu_torch against
dampr_tpu's.

The port versions of ``tests/test_mesh_exchange.py``'s 13 cases, the 5
``TestExchangeSchedule`` cases of ``tests/test_multiprocess.py`` and
``tests/test_pipeline.py::TestExchangeCodec``: the JAX package on its
8-device CPU rig (``mesh8``), the port on a mesh of 8 CPU shards
(``settings.mesh_devices``), on the same inputs.  Blobs and schedules
must be equal byte for byte and cell for cell; the engine's group_bys,
joins and sort_bys must give the JAX package's records, exactly, and
their mesh-off runs' records.  Added: an ``exchange_step`` fault in a
mesh group_by (the step raises in both packages; ``resume="auto"``
reruns it exactly), and the step watchdog (``exchange_timeout_ms``): an
expired step writes an ``exchange_timeout`` event and the next run under
the name routes that stage to the host shuffle, as in the JAX package.
"""

import os
import random
import threading
import time
import uuid

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import faults as ref_faults
from dampr_tpu import settings as ref_settings
from dampr_tpu.parallel import exchange as ref_px
from dampr_tpu.parallel import replan as ref_replan
from dampr_tpu.runner import MTRunner as RefRunner
from dampr_tpu_torch import faults, settings
from dampr_tpu_torch.io import codecs
from dampr_tpu_torch.parallel import exchange as px
from dampr_tpu_torch.parallel import mesh as port_mesh
from dampr_tpu_torch.parallel import replan
from dampr_tpu_torch.runner import MTRunner

_REF = ("partitions", "mesh_fold", "mesh_exchange", "exchange_codec",
        "exchange_timeout_ms", "job_retries", "exchange_chunk_bytes",
        "exchange_min_bytes")
_PORT = _REF + ("device", "mesh_devices", "scratch_root")


@pytest.fixture(autouse=True)
def exchange_on(tmp_path):
    old_ref = {n: getattr(ref_settings, n) for n in _REF}
    old = {n: getattr(settings, n) for n in _PORT}
    settings.device = "cpu"
    settings.mesh_devices = ["cpu"] * 8
    settings.scratch_root = str(tmp_path / "port-scratch")
    settings.partitions = ref_settings.partitions = 8
    # keep the associative fast path out of the way
    settings.mesh_fold = ref_settings.mesh_fold = "off"
    settings.mesh_exchange = ref_settings.mesh_exchange = "auto"
    try:
        yield
    finally:
        for n, v in old_ref.items():
            setattr(ref_settings, n, v)
        for n, v in old.items():
            setattr(settings, n, v)


@pytest.fixture
def pmesh8():
    return port_mesh.data_mesh()


def _name(prefix="mesh-exchange-test"):
    # a salted name: the shuffle's cost model reads the run history by
    # name, and a shared name would let one test's history pin another's
    return "%s-%s" % (prefix, uuid.uuid4().hex[:8])


def _run(build, **kw):
    """The pipeline ``build(Dampr)`` through each package's runner:
    ``((ref records, ref runner), (port records, port runner))``."""
    out = []
    for D, R in ((dampr_tpu.Dampr, RefRunner),
                 (dampr_tpu_torch.Dampr, MTRunner)):
        pipe = build(D)
        runner = R(_name(), pipe.pmer.graph, **kw)
        ds = runner.run([pipe.source])[0]
        out.append((list(ds.read()), runner))
    return out


def _random_blobs(rng, p=0.5, top=30000):
    blobs = {}
    for s in range(8):
        for d in range(8):
            if rng.random() < p:
                n = rng.randrange(0, top)
                blobs[(s, d)] = bytes(
                    rng.getrandbits(8) for _ in range(min(n, 512))
                ) * max(1, n // 512)
    return blobs


class TestBlobExchange:
    def test_blob_routing(self, mesh8, pmesh8):
        blobs = {(s, d): bytes([s * 16 + d]) * (s + d + 1)
                 for s in range(8) for d in range(8) if (s + d) % 3 == 0}
        out = px.mesh_blob_exchange(pmesh8, blobs)
        assert out == ref_px.mesh_blob_exchange(mesh8, blobs) == blobs
        assert px.last_info["steps"] == ref_px.last_info["steps"]
        for k in ("bytes", "peak_inflight_bytes", "sent_per_device",
                  "received_per_device", "pair_bytes", "clamped"):
            assert px.last_info[k] == ref_px.last_info[k], k

    def test_empty_and_large_blob(self, mesh8, pmesh8):
        big = bytes(range(256)) * 2000
        blobs = {(0, 7): big, (3, 3): b"x"}
        out = px.mesh_blob_exchange(pmesh8, blobs)
        assert out == ref_px.mesh_blob_exchange(mesh8, blobs) == blobs

    def test_shuffle_blocks_order_and_destination(self, mesh8, pmesh8):
        got = []
        for mesh, mod, blocks in ((mesh8, ref_px, dampr_tpu.blocks),
                                  (pmesh8, px, dampr_tpu_torch.blocks)):
            routed = []
            for seq, pid in enumerate((0, 3, 11, 3, 8)):
                routed.append((seq, seq % 8, pid,
                               blocks.Block.from_pairs([(pid, seq)])))
            received, moved = mod.mesh_shuffle_blocks(mesh, routed)
            assert moved > 0
            got.append([(pid, list(b.iter_pairs())) for pid, b in received])
        assert got[1] == got[0]
        assert [pid for pid, _ in got[1]] == [0, 3, 11, 3, 8]
        assert [pairs[0][1] for _, pairs in got[1]] == [0, 1, 2, 3, 4]


class TestEngineExchange:
    def test_nonassoc_group_by_rides_exchange(self):
        data = list(range(4000))
        (ref, rr), (port, pr) = _run(
            lambda D: D.memory(data, partitions=8).group_by(
                lambda x: x % 9).reduce(lambda k, vs: sorted(vs)[:2]))
        assert pr.mesh_exchanges >= 1 and rr.mesh_exchanges >= 1
        assert pr.mesh_exchange_bytes > 0
        want = {k: (k, sorted(x for x in data if x % 9 == k)[:2])
                for k in range(9)}
        assert dict(port) == dict(ref) == want
        assert port == ref

    def test_group_by_matches_host_path(self):
        data = [(i % 11, i * 3) for i in range(3000)]

        def build(D):
            return (D.memory(data, partitions=8)
                    .group_by(lambda x: x[0])
                    .reduce(lambda k, vs: sum(v[1] for v in vs)))

        (ref, _), (port, pr) = _run(build)
        assert pr.mesh_exchanges >= 1
        settings.mesh_exchange = "off"
        pipe = build(dampr_tpu_torch.Dampr)
        hr = MTRunner(_name(), pipe.pmer.graph)
        host = list(hr.run([pipe.source])[0].read())
        assert hr.mesh_exchanges == 0
        assert sorted(port) == sorted(host) == sorted(ref)

    def test_join_rides_exchange_and_matches_host(self):
        left = [(i % 7, i) for i in range(600)]
        right = [(i % 7, -i) for i in range(200) if i % 7 != 3]

        def build(D):
            lp = D.memory(left, partitions=8).group_by(lambda x: x[0])
            rp = D.memory(right, partitions=8).group_by(lambda x: x[0])
            return lp.join(rp).reduce(
                lambda l, r: (sorted(v[1] for v in l)[:2],
                              sorted(v[1] for v in r)[:2]))

        (ref, _), (port, pr) = _run(build)
        assert pr.mesh_exchanges >= 1
        settings.mesh_exchange = "off"
        pipe = build(dampr_tpu_torch.Dampr)
        host = list(MTRunner(_name(), pipe.pmer.graph).run(
            [pipe.source])[0].read())
        assert sorted(port) == sorted(host) == sorted(ref)

    def test_left_join_through_exchange(self):
        left = [(i % 5, i) for i in range(100)]
        right = [(0, "z"), (2, "y")]

        def build(D):
            lp = D.memory(left, partitions=8).group_by(lambda x: x[0])
            rp = D.memory(right, partitions=8).group_by(lambda x: x[0])
            return lp.join(rp).left_reduce(
                lambda l, r: (len(list(l)), len(list(r))))

        (ref, _), (port, pr) = _run(build)
        assert pr.mesh_exchanges >= 1
        assert dict(port) == dict(ref) == {
            0: (0, (20, 1)), 1: (1, (20, 0)), 2: (2, (20, 1)),
            3: (3, (20, 0)), 4: (4, (20, 0))}

    def test_windowed_exchange_small_budget(self):
        data = [(i % 3, i) for i in range(5000)]
        (ref, _), (port, pr) = _run(
            lambda D: D.memory(data, partitions=8).group_by(
                lambda x: x[0]).reduce(lambda k, vs: [v[1] for v in vs][:5]),
            memory_budget=1 << 16)
        assert pr.mesh_exchanges >= 1
        for k in range(3):
            assert dict(port)[k] == (k, [x for x in range(5000)
                                         if x % 3 == k][:5])
        assert port == ref

    def test_over_window_ref_streams_in_pieces(self):
        data = [(0, "x" * 50) for _ in range(20000)]  # one hot key
        (ref, _), (port, pr) = _run(
            lambda D: D.memory(data, partitions=8).group_by(
                lambda x: x[0]).reduce(lambda k, vs: len(list(vs))),
            memory_budget=1 << 18)
        assert pr.mesh_exchanges >= 1
        assert dict(port) == dict(ref) == {0: (0, 20000)}

    def test_empty_input_does_not_count_exchange(self):
        (ref, rr), (port, pr) = _run(
            lambda D: D.memory([], partitions=4).group_by(
                lambda x: x).reduce(lambda k, vs: len(list(vs))))
        assert port == ref == []
        assert pr.mesh_exchanges == rr.mesh_exchanges == 0

    def test_sort_by_redistributes_over_mesh(self):
        rng = random.Random(5)
        data = [rng.randrange(-10 ** 9, 10 ** 9) for _ in range(30000)]
        pipe = dampr_tpu_torch.Dampr.memory(data, partitions=8).sort_by(
            lambda x: x)
        runner = MTRunner(_name("mesh-range-sort"), pipe.pmer.graph,
                          memory_budget=1 << 16)
        out = runner.run([pipe.source])[0]
        before = px.total_exchanges
        got = [v for _k, v in out.read()]
        assert got == sorted(data)
        assert px.total_exchanges > before, "range sort never hit the mesh"
        after_first = px.total_exchanges
        assert [v for _k, v in out.read()] == got
        assert px.total_exchanges == after_first  # the buckets are cached
        next(iter(out.read()))
        out.delete()
        assert out._range_cache is None
        ref_pipe = dampr_tpu.Dampr.memory(data, partitions=8).sort_by(
            lambda x: x)
        ref_out = RefRunner(_name("mesh-range-sort"), ref_pipe.pmer.graph,
                            memory_budget=1 << 16).run([ref_pipe.source])[0]
        assert [v for _k, v in ref_out.read()] == got

    def test_sort_by_mesh_matches_host_path(self):
        data = [((i * 7919) % 10007) for i in range(20000)]

        def run_it(D, R):
            pipe = D.memory(data, partitions=8).sort_by(lambda x: x)
            runner = R(_name("range-sort-cmp"), pipe.pmer.graph,
                       memory_budget=1 << 16)
            return list(runner.run([pipe.source])[0].read())

        mesh_got = run_it(dampr_tpu_torch.Dampr, MTRunner)
        ref_got = run_it(dampr_tpu.Dampr, RefRunner)
        settings.mesh_exchange = "off"
        host_got = run_it(dampr_tpu_torch.Dampr, MTRunner)
        assert mesh_got == host_got == ref_got
        assert [v for _k, v in mesh_got] == sorted(data)

    def test_exchange_off_never_engages(self):
        settings.mesh_exchange = ref_settings.mesh_exchange = "off"
        (ref, rr), (port, pr) = _run(
            lambda D: D.memory(list(range(100)), partitions=4).group_by(
                lambda x: x % 2).reduce(lambda k, vs: len(list(vs))))
        assert pr.mesh_exchanges == rr.mesh_exchanges == 0
        assert port == ref


class TestExchangeSchedule:
    """The replan schedule, cell for cell against the JAX package's, on
    the random shapes and budgets of ``tests/test_multiprocess.py``."""

    def _random_sizes(self, rng, n_dev):
        sizes = {}
        for s in range(n_dev):
            for d in range(n_dev):
                if rng.random() < 0.6:
                    scale = rng.choice([10, 1000, 100000])
                    sizes[(s, d)] = rng.randrange(0, scale)
        return sizes

    @staticmethod
    def _cells(sched):
        return [(st.cells, st.capacity, st.inflight_bytes)
                for st in sched.steps]

    def test_schedule_never_exceeds_budget(self):
        rng = random.Random(42)
        for trial in range(200):
            n_dev = rng.choice([2, 4, 8, 16])
            gather = rng.random() < 0.5
            floor = replan.step_inflight_bytes(
                n_dev, replan.MIN_CAPACITY, gather)
            assert floor == ref_replan.step_inflight_bytes(
                n_dev, ref_replan.MIN_CAPACITY, gather)
            budget = rng.randrange(floor, 64 * floor)
            sizes = self._random_sizes(rng, n_dev)
            sched = replan.plan_exchange(n_dev, sizes, budget=budget,
                                         gather=gather)
            ref = ref_replan.plan_exchange(n_dev, sizes, budget=budget,
                                           gather=gather)
            assert self._cells(sched) == self._cells(ref)
            assert not sched.clamped
            assert sched.peak_inflight_bytes <= budget, trial
            for step in sched.steps:
                c = step.capacity
                assert c >= replan.MIN_CAPACITY and (c & (c - 1)) == 0

    def test_schedule_covers_every_byte_in_order(self):
        rng = random.Random(7)
        for _trial in range(100):
            n_dev = rng.choice([2, 4, 8])
            sizes = self._random_sizes(rng, n_dev)
            floor = replan.step_inflight_bytes(
                n_dev, replan.MIN_CAPACITY, False)
            budget = rng.randrange(floor, 32 * floor)
            sched = replan.plan_exchange(n_dev, sizes, budget=budget)
            assert self._cells(sched) == self._cells(
                ref_replan.plan_exchange(n_dev, sizes, budget=budget))
            seen = {sd: [] for sd in sizes}
            for step in sched.steps:
                for s, d, start, stop in step.cells:
                    assert stop - start <= step.capacity
                    seen[(s, d)].append((start, stop))
            for sd, n in sizes.items():
                at = 0
                for start, stop in seen[sd]:
                    assert start == at
                    at = stop
                assert at == n
            assert sched.total_bytes == sum(sizes.values())

    def test_tiny_budget_clamps_at_floor(self):
        sched = replan.plan_exchange(8, {(0, 1): 4096}, budget=1)
        ref = ref_replan.plan_exchange(8, {(0, 1): 4096}, budget=1)
        assert sched.clamped and ref.clamped
        assert sched.total_bytes == 4096
        assert all(s.capacity == replan.MIN_CAPACITY for s in sched.steps)
        assert self._cells(sched) == self._cells(ref)

    def test_explicit_chunk_knob_narrows_pieces(self):
        wide = replan.plan_exchange(4, {(0, 1): 1 << 20}, budget=1 << 26)
        narrow = replan.plan_exchange(4, {(0, 1): 1 << 20}, budget=1 << 26,
                                      chunk_bytes=4096)
        assert narrow.n_steps > wide.n_steps
        assert all(s.capacity <= 4096 for s in narrow.steps)
        odd = replan.plan_exchange(4, {(0, 1): 1 << 20}, budget=1 << 26,
                                   chunk_bytes=5000)
        assert max(s.capacity for s in odd.steps) == 4096
        assert self._cells(odd) == self._cells(ref_replan.plan_exchange(
            4, {(0, 1): 1 << 20}, budget=1 << 26, chunk_bytes=5000))
        settings.exchange_chunk_bytes = 4096
        via_setting = replan.plan_exchange(4, {(0, 1): 1 << 20},
                                           budget=1 << 26)
        assert via_setting.n_steps == narrow.n_steps

    def test_roundtrip_through_mesh_matches_naive(self, mesh8, pmesh8):
        blobs = _random_blobs(random.Random(3))
        want = {sd: b for sd, b in blobs.items() if b}
        for budget in (1 << 17, 1 << 20, 1 << 26):
            out = px.mesh_blob_exchange(pmesh8, blobs, budget=budget)
            assert out == want, budget
            assert out == ref_px.mesh_blob_exchange(mesh8, blobs,
                                                    budget=budget)
            assert px.last_info["steps"] == ref_px.last_info["steps"]
            assert px.last_info["peak_inflight_bytes"] <= budget


class TestExchangeCodec:
    def test_off_resolves_none(self):
        settings.exchange_codec = ref_settings.exchange_codec = "off"
        assert px.wire_codec() is None and ref_px.wire_codec() is None

    def test_unknown_resolves_none(self):
        settings.exchange_codec = "definitely-not-a-codec"
        assert px.wire_codec() is None

    def test_auto_never_picks_deflate(self):
        settings.exchange_codec = ref_settings.exchange_codec = "auto"
        c = px.wire_codec()
        assert c is None or c.name in ("zstd", "lz4")
        ref = ref_px.wire_codec()
        assert (c and c.name) == (ref and ref.name)

    def test_roundtrip(self):
        settings.exchange_codec = "zlib"
        c = px.wire_codec()
        data = bytes(range(256)) * 512
        wire = c.compress(data)
        assert len(wire) < len(data)
        assert bytes(codecs.decompress(c.cid, wire)) == data

    def test_blob_exchange_compresses_and_delivers_exactly(self, mesh8,
                                                           pmesh8):
        settings.exchange_codec = ref_settings.exchange_codec = "zlib"
        rng = random.Random(5)
        blobs = {(s, d): bytes([rng.randrange(4)] * (1000 + s * 100 + d))
                 for s in range(8) for d in range(8) if (s + d) % 3 == 0}
        raw0, wire0 = px.codec_raw_bytes, px.codec_wire_bytes
        out = px.mesh_blob_exchange(pmesh8, blobs)
        assert out == blobs == ref_px.mesh_blob_exchange(mesh8, blobs)
        raw_d = px.codec_raw_bytes - raw0
        wire_d = px.codec_wire_bytes - wire0
        assert raw_d == sum(len(b) for b in blobs.values())
        assert 0 < wire_d < raw_d
        assert px.last_info["codec"] == ref_px.last_info["codec"]

    def test_blob_exchange_codec_off_is_identity(self, pmesh8):
        settings.exchange_codec = "off"
        blobs = {(0, 7): bytes(range(256)) * 100, (3, 3): b"x"}
        raw0 = px.codec_raw_bytes
        assert px.mesh_blob_exchange(pmesh8, blobs) == blobs
        assert px.codec_raw_bytes == raw0


def _group_by(D):
    return (D.memory([(i % 7, i) for i in range(3000)], partitions=8)
            .group_by(lambda x: x[0])
            .reduce(lambda k, vs: sorted(v[1] for v in vs)[:3]))


class TestExchangeFaults:
    def test_exchange_step_fault_raises_and_auto_resume_is_exact(self):
        """An injected ``exchange_step`` fault fails the step in both
        packages (the exchange is a stage's, not a job's: no job retry
        covers it); ``resume="auto"`` reruns the run, exactly."""
        settings.job_retries = ref_settings.job_retries = 1
        got = []
        for D, F in ((dampr_tpu.Dampr, ref_faults),
                     (dampr_tpu_torch.Dampr, faults)):
            F.install(F.FaultPlan("exchange_step:nth=1"))
            try:
                with pytest.raises(Exception) as ei:
                    _group_by(D).run(name=_name("xstep"))
                assert type(ei.value).__name__ == "TransientInjectedFault"
                F.install(F.FaultPlan("exchange_step:nth=1"))
                em = _group_by(D).run(name=_name("xstep-auto"),
                                      resume="auto")
                got.append(list(em.read()))
                em.delete()
            finally:
                F.clear()
        assert got[1] == got[0]
        assert dict(got[1])[3] == [3, 10, 17]

    def test_watchdog_expiry_degrades_the_next_run(self, monkeypatch):
        """A step past ``exchange_timeout_ms`` (the collective held for
        0.4 s) records an ``exchange_timeout`` event with its stage and
        exits 70 (the exit recorded here instead); the next run under the
        name keeps that stage on the host shuffle, in both packages."""
        exits = []
        done = threading.Event()

        def fake_exit(code):
            exits.append(code)
            done.set()

        monkeypatch.setattr(os, "_exit", fake_exit)
        real_step = px._exchange_step

        def slow_step(mesh, buf, lens):
            time.sleep(0.4)
            return real_step(mesh, buf, lens)

        real_build = ref_px._build_exchange

        def slow_build(mesh, axis, capacity, gather=False):
            prog = real_build(mesh, axis, capacity, gather=gather)

            def run(bb, ln):
                time.sleep(0.4)
                return prog(bb, ln)

            return run

        monkeypatch.setattr(px, "_exchange_step", slow_step)
        monkeypatch.setattr(ref_px, "_build_exchange", slow_build)
        settings.exchange_timeout_ms = ref_settings.exchange_timeout_ms = 50
        # no byte floor: the first run's history alone would keep the
        # small shuffle on the host
        settings.exchange_min_bytes = ref_settings.exchange_min_bytes = 0
        seen = []
        for D, R, F in ((dampr_tpu.Dampr, RefRunner, ref_faults),
                        (dampr_tpu_torch.Dampr, MTRunner, faults)):
            name = _name("xwatch")
            done.clear()
            pipe = _group_by(D)
            runner = R(name, pipe.pmer.graph)
            first = list(runner.run([pipe.source])[0].read())
            assert done.wait(10)
            evs = [e for e in F.load_events(name)
                   if e["kind"] == "exchange_timeout"]
            assert evs and evs[0]["timeout_ms"] == 50
            sid = evs[0]["stage"]
            assert runner._shuffle_targets[sid] == "mesh"
            pipe = _group_by(D)
            again = R(name, pipe.pmer.graph)
            second = list(again.run([pipe.source])[0].read())
            row = [d for d in again.plan_report["shuffle"]["targets"]
                   if d["sid"] == sid][0]
            assert row["target"] == "host"
            assert "fault-history" in row["reason"]
            assert again.mesh_exchanges == 0
            assert second == first
            seen.append((first, sid))
            F.clear_events(name)
        assert exits == [70, 70]
        assert seen[1] == seen[0]
