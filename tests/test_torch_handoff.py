"""The device-resident handoff of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_handoff.py`` (less its ``price_handoff``
cases: the cost model is a later slice) and of the table program itself.
The JAX side runs as its own suite runs it (lowering forced, handoff
auto, the 8-device CPU rig); the port runs on the CPU (``device="cpu"``,
lowering forced, the kernels' plain versions).  Inputs are seeded with
numpy.  Every comparison is exact: records, sink bytes, integer lanes.

Each end-to-end case runs twice: with each package's CPU bootstrap (the
job's first window seeds the vocabulary through the host codec) and with
``handoff._host_bootstrap`` patched to False in both packages, so the
card's route (classic batches seed the vocabulary, later batches take the
table program) runs on the CPU too.
"""

import collections
import math
import operator
import os
import re
import zlib

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import handoff as ref_handoff
from dampr_tpu.ops import lower as ref_lower
from dampr_tpu.ops import text as ref_text
from dampr_tpu.parallel import shuffle as ref_shuffle
from dampr_tpu.parallel.mesh import data_mesh
from dampr_tpu.storage import RunStore as RefRunStore
from dampr_tpu_torch import interop, storage
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import handoff as port_handoff
from dampr_tpu_torch.ops import hashing as port_hashing
from dampr_tpu_torch.ops import lower as port_lower
from dampr_tpu_torch.ops import text as port_text
from dampr_tpu_torch.parallel import mesh as port_mesh
from dampr_tpu_torch.parallel import shuffle as port_shuffle
from dampr_tpu_torch.plan import passes as port_passes

import torch

from test_torch_pipeline import CORPORA, _write

_REF = ("lower", "handoff", "hbm_budget", "optimize", "analyze",
        "scan_window_bytes")
_PORT = ("device", "lower", "handoff", "hbm_budget", "scan_window_bytes",
         "lower_batch", "scratch_root")


@pytest.fixture(autouse=True)
def knobs(tmp_path):
    old_ref = {n: getattr(ref_settings, n) for n in _REF}
    old_port = {n: getattr(port_settings, n) for n in _PORT}
    ref_settings.lower = "1"
    ref_settings.handoff = "auto"
    ref_settings.optimize = True
    ref_settings.analyze = True
    port_settings.device = "cpu"
    port_settings.lower = "on"
    port_settings.handoff = "auto"
    # each test starts with an empty run history: a name's earlier runs
    # (in this test process or an earlier one) would price its handoff edge
    port_settings.scratch_root = str(tmp_path / "port-scratch")
    yield
    for n, v in old_ref.items():
        setattr(ref_settings, n, v)
    for n, v in old_port.items():
        setattr(port_settings, n, v)


@pytest.fixture(params=["host", "classic"])
def bootstrap(request, monkeypatch):
    """Each package's CPU bootstrap, or the card's classic bootstrap."""
    if request.param == "classic":
        monkeypatch.setattr(ref_handoff, "_host_bootstrap", lambda: False)
        monkeypatch.setattr(port_handoff, "_host_bootstrap", lambda: False)
    return request.param


PKGS = (("ref", dampr_tpu, ref_text, ref_settings),
        ("port", dampr_tpu_torch, port_text, port_settings))


def _corpus(tmp_path, seed=3, n_lines=900, vocab=140, name="corpus.txt"):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(vocab)] + ["Tok_1", "UPPER", "a"]
    lines = [" ".join(rng.choice(words, size=rng.randint(1, 10)))
             for _ in range(n_lines)]
    return _write(tmp_path, name, ("\n".join(lines) + "\n").encode())


def _scanner(text, kind):
    if kind == "docfreq":
        return text.DocFreq(mode="word", lower=True, pair_values=False)
    return text.TokenCounts(mode="word", lower=True, pair_values=False)


def _fold(pkg, text, corpus, kind="docfreq", chunks=3):
    docs = pkg.Dampr.text(corpus, os.path.getsize(corpus) // chunks + 1)
    return docs.custom_mapper(_scanner(text, kind)).fold_values(operator.add)


def _run(pkg, text, corpus, name, kind="docfreq", chunks=3, **kw):
    em = _fold(pkg, text, corpus, kind, chunks).run(name=name, **kw)
    got = sorted(em.read())
    stats = em.stats()
    em.delete()
    return got, stats


def _both(corpus, name, kind="docfreq", chunks=3):
    """{"ref": (records, stats), "port": (records, stats)}."""
    return {tag: _run(pkg, text, corpus, name, kind, chunks)
            for tag, pkg, text, _s in PKGS}


def _oracle(corpus, dedup=True):
    rx = re.compile(r"[^\w]+")
    c = collections.Counter()
    with open(corpus, encoding="utf-8") as f:
        for line in f:
            toks = [t for t in rx.split(line.lower()) if t]
            c.update(set(toks) if dedup else toks)
    return sorted(c.items())


def _edges(stats):
    return [(e["src"], e["dst"], e["handoff"], e["kind"])
            for e in stats["plan"]["lowering"]["handoff"]]


def _set_both(name, value):
    for _tag, _pkg, _text, s in PKGS:
        setattr(s, name, value)


# ---------------------------------------------------------------------------
# The edge decision
# ---------------------------------------------------------------------------


class TestEdgeDecision:
    def test_scanner_edge_marked_device(self, tmp_path):
        corpus = _corpus(tmp_path)
        runs = _both(corpus, "handoff-edge")
        assert runs["port"][0] == runs["ref"][0] == _oracle(corpus)
        port_stats = runs["port"][1]
        assert _edges(port_stats) == _edges(runs["ref"][1])
        assert [e[2:] for e in _edges(port_stats)] == [("device",
                                                        "resident")]
        edge = port_stats["plan"]["lowering"]["handoff"][0]
        assert edge["via"] == "scanner-program"
        assert "stay HBM-resident" in edge["reason"]
        assert port_stats["device"]["handoff_edges"] == 1
        assert port_stats["device"]["handoff_bytes"] > 0
        assert port_stats["device"]["mesh_folds"] == 1

    def test_handoff_off_declines_with_reason(self, tmp_path):
        _set_both("handoff", "off")
        corpus = _corpus(tmp_path)
        runs = _both(corpus, "handoff-off-edge")
        assert runs["port"][0] == runs["ref"][0] == _oracle(corpus)
        stats = runs["port"][1]
        assert _edges(stats) == _edges(runs["ref"][1])
        assert stats["device"]["handoff_edges"] == 0
        assert stats["device"]["handoff_bytes"] == 0
        edges = stats["plan"]["lowering"]["handoff"]
        assert edges and all(e["handoff"] == "spill" for e in edges)
        assert all("handoff off" in e["reason"] for e in edges)

    def test_zero_hbm_budget_declines_auto(self, tmp_path):
        """An explicit ``hbm_budget = 0`` means no device residency: auto
        declines it, as in the JAX package."""
        _set_both("hbm_budget", 0)
        corpus = _corpus(tmp_path)
        runs = _both(corpus, "handoff-zero-budget")
        assert runs["port"][0] == runs["ref"][0]
        assert _edges(runs["port"][1]) == _edges(runs["ref"][1])
        assert {e[3] for e in _edges(runs["port"][1])} == {"settings"}
        assert runs["port"][1]["device"]["handoff_bytes"] == 0

    def test_optimizer_off_declines_structurally(self, tmp_path,
                                                 monkeypatch):
        """Without the map->fold fusion an identity stage sits between the
        scanner and the fold: no edge goes device, and the run rides the
        spill path with equal records."""
        ref_settings.optimize = False
        monkeypatch.setattr(port_passes, "optimize", lambda graph, outputs:
                            (graph, port_passes.empty_report(graph)))
        corpus = _corpus(tmp_path)
        runs = _both(corpus, "handoff-noopt")
        assert runs["port"][0] == runs["ref"][0] == _oracle(corpus)
        stats = runs["port"][1]
        assert _edges(stats) == _edges(runs["ref"][1])
        assert stats["device"]["handoff_edges"] == 0
        assert stats["device"]["handoff_bytes"] == 0
        assert all(e["handoff"] == "spill"
                   for e in stats["plan"]["lowering"]["handoff"])

    def test_pair_values_scanner_declines(self, tmp_path):
        corpus = _corpus(tmp_path)
        got = {}
        for tag, pkg, text, _s in PKGS:
            docs = pkg.Dampr.text(corpus, os.path.getsize(corpus) + 1)
            pipe = (docs.custom_mapper(
                text.DocFreq(mode="word", lower=True, pair_values=True))
                .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1]))
            em = pipe.run(name="handoff-pairvalues")
            got[tag] = (sorted(em.read()), em.stats())
            em.delete()
        assert got["port"][0] == got["ref"][0]
        assert _edges(got["port"][1]) == _edges(got["ref"][1])
        assert got["port"][1]["device"]["handoff_bytes"] == 0


# ---------------------------------------------------------------------------
# Exactness
# ---------------------------------------------------------------------------


class TestExactness:
    def test_docfreq_on_off_fallback(self, tmp_path, bootstrap):
        corpus = _corpus(tmp_path)
        want = _oracle(corpus)
        legs = {}
        for mode, budget in (("on", "auto"), ("off", "auto"),
                             ("on", 4096)):
            _set_both("handoff", mode)
            _set_both("hbm_budget", budget)
            legs[mode, budget] = _both(corpus, "handoff-{}".format(mode))
        for leg in legs.values():
            assert leg["port"][0] == leg["ref"][0] == want
        on = legs["on", "auto"]["port"][1]["device"]
        assert on["handoff_edges"] >= 1 and on["handoff_bytes"] > 0
        if bootstrap == "classic":
            assert on["handoff"]["table_batches"] > 0
            assert on["handoff"]["classic_batches"] > 0
        else:
            assert on["handoff"]["host_bootstraps"] > 0
        assert legs["off", "auto"]["port"][1]["device"]["handoff_bytes"] == 0
        fb = legs["on", 4096]["port"][1]["device"]
        assert fb["handoff_degrades"] >= 1

    @pytest.mark.parametrize("kind", ["docfreq", "tokens"])
    @pytest.mark.parametrize("corpus", sorted(CORPORA))
    def test_corpora_match_reference(self, tmp_path, bootstrap, corpus,
                                     kind):
        """Invalid UTF-8 windows, a line wider than a batch, blank windows
        and long tokens go through the vocabulary's host absorb."""
        _set_both("lower_batch", 0)  # the 1024-token floor
        path = _write(tmp_path, "c.txt", CORPORA[corpus]())
        runs = _both(path, "handoff-corpora", kind)
        assert runs["port"][0] == runs["ref"][0]
        assert runs["port"][1]["device"]["handoff_edges"] == 1

    def test_tfidf_shape_records_and_sink_bytes(self, tmp_path, bootstrap):
        """The benchmark's pipeline (DocFreq -> fold -> idf cross ->
        sink_tsv), the handoff on and off: records and sink lines equal
        across both packages."""
        corpus = _corpus(tmp_path, seed=11)

        def tfidf(pkg, text, out):
            docs = pkg.Dampr.text(corpus, os.path.getsize(corpus) // 2 + 1)
            df = (docs.custom_mapper(
                text.DocFreq(mode="word", lower=True, pair_values=False))
                .fold_values(operator.add))
            idf = df.cross_right(
                docs.len(),
                lambda d, total: (d[0], d[1],
                                  math.log(1 + (float(total) / d[1]))),
                memory=True)
            em = idf.run(name="handoff-tfidf")
            records = sorted(em.read())
            em.delete()
            em = idf.sink_tsv(out).run(name="handoff-tfidf-sink")
            lines = []
            for part in sorted(os.listdir(out)):
                with open(os.path.join(out, part), "rb") as f:
                    lines.extend(f.read().splitlines())
            return records, sorted(lines), em.stats()

        legs = {}
        for mode in ("on", "off"):
            _set_both("handoff", mode)
            for tag, pkg, text, _s in PKGS:
                legs[tag, mode] = tfidf(pkg, text, str(
                    tmp_path / "{}-{}".format(tag, mode)))
        records, lines, _ = legs["ref", "off"]
        assert records and lines
        for key, (r, ln, _st) in legs.items():
            assert r == records, key
            assert ln == lines, key
        on = legs["port", "on"][2]["device"]
        assert on["handoff_edges"] >= 1 and on["mesh_folds"] >= 1

    def test_vocabulary_shift_reverts_and_stays_exact(self, tmp_path,
                                                      bootstrap):
        """A corpus whose vocabulary turns over mid-stream: table misses
        pass the revert bar, the job bootstraps again, results exact."""
        rng = np.random.RandomState(5)
        lines = []
        for phase in range(4):
            words = ["p%d_%d" % (phase, i) for i in range(150)]
            lines += [" ".join(rng.choice(words, size=rng.randint(1, 10)))
                      for _ in range(400)]
        path = _write(tmp_path, "shift.txt",
                      ("\n".join(lines) + "\n").encode())
        _set_both("handoff", "on")
        _set_both("scan_window_bytes", 4096)
        runs = _both(path, "handoff-shift")
        assert runs["port"][0] == runs["ref"][0] == _oracle(path)
        dev = runs["port"][1]["device"]
        assert dev["handoff_bytes"] > 0
        assert dev["handoff"]["table_batches"] > 0
        assert dev["handoff"]["misses"] > 0


# ---------------------------------------------------------------------------
# Degrade and kill
# ---------------------------------------------------------------------------


def _token_counter(blocks):
    got = collections.Counter()
    for blk in blocks:
        for k, v in zip(blk.keys, blk.values):
            got[k] += int(v)
    return got


class TestDegradeAndKill:
    def test_budget_exceeded_mid_stage_degrades_exactly(self, tmp_path,
                                                        bootstrap):
        corpus = _corpus(tmp_path, vocab=4000, n_lines=2500)
        _set_both("handoff", "on")
        _set_both("hbm_budget", 1 << 14)  # 16 KB: the vocabulary can't fit
        runs = _both(corpus, "handoff-degrade")
        assert runs["port"][0] == runs["ref"][0] == _oracle(corpus)
        assert runs["port"][1]["device"]["handoff_degrades"] >= 1

    def test_refused_miss_absorb_loses_no_token(self, monkeypatch):
        """A table batch whose miss absorb is refused re-emits its missed
        tokens through the exact host path (the degrade flush holds only
        the batch's hits).  Window 1 seeds the vocabulary; window 2 brings
        new tokens (sure misses) and every absorb is refused."""
        rng = np.random.RandomState(7)
        base = ["w%d" % i for i in range(120)]
        fresh = ["new%d" % i for i in range(80)]
        w1 = ("\n".join(" ".join(rng.choice(base, size=6))
                        for _ in range(300)) + "\n").encode()
        w2 = ("\n".join(" ".join(rng.choice(base + fresh, size=6))
                        for _ in range(300)) + "\n").encode()
        want = collections.Counter()
        for data in (w1, w2):
            for line in data.decode().splitlines():
                want.update(set(t for t in re.split(r"[^\w]+", line.lower())
                                if t))
        for handoff_mod, lower_mod, text, store in (
                (ref_handoff, ref_lower, ref_text,
                 RefRunStore("handoff-missdrop", budget=1 << 26)),
                (port_handoff, port_lower, port_text,
                 storage.RunStore("handoff-missdrop", budget=1 << 26))):
            monkeypatch.setattr(handoff_mod.HandoffVocab,
                                "_absorb_miss_tokens",
                                lambda self, *a, **kw: False)
            store.handoff_active = True
            try:
                sink = lower_mod.device_window_sink(
                    text.DocFreq(mode="word", lower=True,
                                 pair_values=False),
                    store=store, handoff=True)
                blocks = list(sink.add(w1) or ())
                assert sink._hv.table_mode
                blocks += list(sink.add(w2) or ())
                assert sink._hv.degraded
                fblocks, hmap = sink.finalize_handoff(store, 4)
                assert not hmap
                blocks += list(fblocks)
                assert _token_counter(blocks) == want
            finally:
                store.cleanup()

    def test_kill_mid_handoff_leaks_no_device_residents(self, tmp_path,
                                                        monkeypatch):
        """A run that fails mid-map, after a job has registered its device
        refs and another has dispatched table batches, leaves no device
        bytes charged: every ref is released."""
        corpus = _corpus(tmp_path, n_lines=1500)
        port_settings.handoff = "on"
        port_settings.scan_window_bytes = 4096
        registered = []
        real = port_handoff.HandoffVocab.dispatch

        def dispatch(self, *a, **kw):
            # the next job's table batch, once a job registered its refs
            if registered:
                raise RuntimeError("table program launch failed")
            return real(self, *a, **kw)

        monkeypatch.setattr(port_handoff.HandoffVocab, "dispatch", dispatch)
        stores = []
        real_init = storage.RunStore.__init__

        def spy(self, *a, **kw):
            real_init(self, *a, **kw)
            stores.append(self)

        monkeypatch.setattr(storage.RunStore, "__init__", spy)
        real_reg = storage.RunStore.register_device

        def reg(self, ref):
            registered.append(ref)
            return real_reg(self, ref)

        monkeypatch.setattr(storage.RunStore, "register_device", reg)
        with pytest.raises(RuntimeError, match="table program launch"):
            _run(dampr_tpu_torch, port_text, corpus, "handoff-kill",
                 n_maps=1)
        assert registered, "no job registered device refs before the kill"
        assert stores
        for store in stores:
            assert not [r for r in store._dev_resident if not r._dead]
            assert store._dev_bytes == 0
        assert all(r._dead and not r.is_device for r in registered)

    def test_long_token_does_not_widen_rows_or_degrade(self):
        """A multi-KB token in the vocabulary keeps its slot and counts but
        not its bytes past the widest row a batch can probe."""
        store = storage.RunStore("handoff-long", budget=1 << 26)
        store.handoff_active = True
        try:
            hv = port_handoff.HandoffVocab(store, dedup=False)
            long_key = "x" * 5000
            ks = np.empty(3, dtype=object)
            ks[:] = ["a", "b", long_key]
            h1, h2 = port_hashing.hash_keys(ks)
            ok, _frac = hv.absorb_drain(
                list(ks), np.array([2, 3, 7], dtype=np.int64), h1, h2, 12)
            assert ok and not hv.degraded
            assert hv.Lcap <= 2 * (port_text._SHORT_TOKEN + 1), hv.Lcap
            blk = hv.degrade("test flush")
            assert dict(zip(blk.keys, blk.values)) == {
                "a": 2, "b": 3, long_key: 7}
        finally:
            store.cleanup()

    def test_flush_block_returns_budget(self):
        """A degrade flushes every count into one hash-sorted block, equal
        to the JAX package's, and no device tensor survives."""
        keys = ["k%d" % i for i in range(100)]
        ks = np.empty(100, dtype=object)
        ks[:] = keys
        blocks = {}
        for tag, mod, store in (
                ("ref", ref_handoff, RefRunStore("handoff-flush",
                                                 budget=1 << 24)),
                ("port", port_handoff, storage.RunStore("handoff-flush",
                                                        budget=1 << 24))):
            store.handoff_active = True
            hv = mod.HandoffVocab(store, dedup=False)
            h1, h2 = port_hashing.hash_keys(ks)
            ok, _frac = hv.absorb_drain(keys, np.ones(100, dtype=np.int64),
                                        h1, h2, 100)
            assert ok
            blocks[tag] = hv.degrade("test degrade")
            assert hv.acc is None and hv.nslots == 0
            assert store.handoff_degrades == 1
            store.cleanup()
        ref, port = blocks["ref"], blocks["port"]
        assert len(port) == 100 and sorted(port.keys) == sorted(keys)
        assert list(port.keys) == list(ref.keys)
        assert np.array_equal(port.values, np.asarray(ref.values))
        assert np.array_equal(port.h1, ref.h1)
        assert np.array_equal(port.h2, ref.h2)


# ---------------------------------------------------------------------------
# Accounting and compaction
# ---------------------------------------------------------------------------


class TestAccounting:
    def test_h2d_idempotent_on_reregistration(self, monkeypatch):
        """A device ref entered again (after a fallback) charges its h2d
        bytes once: the charge is per transfer."""
        port_settings.hbm_budget = 64 << 20
        monkeypatch.setattr(storage, "HBM_MIN_RECORDS", 1)
        from dampr_tpu_torch.blocks import Block

        blk = Block(np.arange(8192, dtype=np.int64) % 31,
                    np.arange(8192, dtype=np.int64) % 7)
        store = storage.RunStore("handoff-h2d")
        ref = store.register(blk, device=True)
        assert ref.is_device
        once = store.h2d_bytes
        assert once == ref.dev_bytes == 8192 * 16
        store._enter_ref(ref)
        assert store.h2d_bytes == once, "h2d double-counted"
        store.cleanup()

    def test_register_device_charges_hash_lanes_only(self):
        """A ref built on the device charges only its uploaded hash lanes
        as h2d, and its device bytes count as handoff bytes."""
        port_settings.hbm_budget = 64 << 20
        store = storage.RunStore("handoff-dev-reg")
        store.handoff_active = True
        n = 1024
        keys = np.empty(n, dtype=object)
        keys[:] = ["k%d" % i for i in range(n)]
        h1 = np.arange(n, dtype=np.uint32)
        h2 = np.arange(n, dtype=np.uint32)[::-1].copy()
        ref = storage.BlockRef.from_device_lanes(
            keys, h1, h2, torch.ones(n, dtype=torch.int64),
            torch.from_numpy(h1.view(np.int32)),
            torch.from_numpy(h2.view(np.int32)), store=store,
            value_dtype=np.int64, lane_abs=n, lane_min=1,
            h2d_bytes=h1.nbytes + h2.nbytes)
        store.register_device(ref)
        assert store.h2d_bytes == h1.nbytes + h2.nbytes
        assert store.handoff_bytes == ref.dev_bytes == 16 * n
        store._enter_ref(ref)
        assert store.h2d_bytes == h1.nbytes + h2.nbytes
        got = ref.get()
        assert list(got.keys) == list(keys)
        assert got.values.dtype == np.int64
        assert store.d2h_bytes == 8 * n
        store.cleanup()

    def test_finalized_refs_own_their_lanes(self):
        """Each partition's ref holds its own lanes, not views into the
        job's: offloading one frees what the store uncharges for it."""
        port_settings.hbm_budget = 64 << 20
        store = storage.RunStore("handoff-own", budget=1 << 26)
        store.handoff_active = True
        try:
            hv = port_handoff.HandoffVocab(store, dedup=False)
            keys = ["k%d" % i for i in range(500)]
            ks = np.empty(len(keys), dtype=object)
            ks[:] = keys
            h1, h2 = port_hashing.hash_keys(ks)
            ok, _frac = hv.absorb_drain(
                keys, np.arange(1, 501, dtype=np.int64), h1, h2, 500)
            assert ok
            _blocks, mapping = hv.finalize(store, 4)
            refs = [r for rs in mapping.values() for r in rs]
            assert len(refs) == 4 and sum(len(r) for r in refs) == 500
            for ref in refs:
                for t in ref._dev:
                    assert (t.untyped_storage().nbytes()
                            == t.numel() * t.element_size())
            owned = refs[0].dev_bytes
            freed, _host = refs[0].offload()
            assert freed == owned > 0 and not refs[0].is_device
            got = {}
            for r in refs:
                blk = r.get()
                got.update(zip(blk.keys, blk.values.tolist()))
            assert got == {k: i + 1 for i, k in enumerate(keys)}
        finally:
            store.cleanup()

    def test_d2h_avoided_and_drain_fetches_counted(self, tmp_path,
                                                   bootstrap):
        """Table batches credit the classic drain they skipped, and the
        fold's one fetch of its result (16 bytes a key) is counted."""
        corpus = _corpus(tmp_path)
        got, stats = _run(dampr_tpu_torch, port_text, corpus,
                          "handoff-acct")
        dev = stats["device"]
        assert got == _oracle(corpus)
        assert dev["d2h_avoided_bytes"] > 0
        assert dev["d2h_bytes"] >= 16 * len(got)
        _set_both("handoff", "off")
        _got, off = _run(dampr_tpu_torch, port_text, corpus, "handoff-acct")
        assert off["device"]["d2h_avoided_bytes"] == 0


class TestCompaction:
    def test_compact_partial_preserves_live_rows(self):
        """The live (h1, h2, v) rows survive a compaction, equal to the
        JAX package's; dead pad goes, down to a power of two."""
        import jax

        rng = np.random.RandomState(9)
        n = 4096
        h1 = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(
            np.uint32)
        h2 = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(
            np.uint32)
        v = rng.randint(0, 100, size=n).astype(np.int32)
        ok = np.zeros(n, dtype=np.uint32)
        live_idx = rng.choice(n, size=300, replace=False)
        ok[live_idx] = 1
        want = set(zip(h1[live_idx].tolist(), h2[live_idx].tolist(),
                       v[live_idx].tolist()))
        ref = ref_shuffle.compact_partial(
            tuple(jax.device_put(x) for x in (h1, h2, v, ok)))
        port = port_shuffle.compact_partial((
            torch.from_numpy(h1.view(np.int32)),
            torch.from_numpy(h2.view(np.int32)),
            torch.from_numpy(v.astype(np.int64)),
            torch.from_numpy(ok.astype(np.int32))))
        for (ch1, ch2, cv, cok), view in ((ref, np.asarray),
                                          (port, lambda t: t.numpy())):
            assert int(ch1.shape[0]) == 512
            m = view(cok) == 1
            assert m.sum() == 300
            got = set(zip(view(ch1)[m].view(np.uint32).tolist(),
                          view(ch2)[m].view(np.uint32).tolist(),
                          view(cv)[m].tolist()))
            assert got == want

    def test_compact_partial_noop_when_dense(self):
        n = 64
        part = tuple(torch.from_numpy(x) for x in (
            np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32),
            np.ones(n, dtype=np.int64), np.ones(n, dtype=np.int32)))
        assert port_shuffle.compact_partial(part) is part


# ---------------------------------------------------------------------------
# The single-device fold
# ---------------------------------------------------------------------------


def _live_rows(h1, h2, v, ok, view):
    m = view(ok) == 1
    return sorted(zip(view(h1)[m].view(np.uint32).tolist(),
                      view(h2)[m].view(np.uint32).tolist(),
                      view(v)[m].tolist()))


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("signed", [False, True])
def test_refold_matches_reference(kind, signed):
    """``mesh_keyed_refold`` over ``mesh_keyed_fold`` partials:
    the port's live rows on a mesh of one shard (the local fold alone)
    equal the JAX package's as sorted sets (the nonneg sum takes K2's
    scan, the rest the scatter folds)."""
    rng = np.random.RandomState(17)
    mesh = data_mesh()
    pmesh = port_mesh.data_mesh(["cpu"])
    ref_parts, port_parts = [], []
    for n in (3000, 1, 777):
        h1 = rng.randint(0, 50, size=n).astype(np.uint32) * np.uint32(
            0x9E3779B1)
        h2 = (h1 ^ np.uint32(0xDEADBEEF)).astype(np.uint32)
        v = rng.randint(-40 if signed else 0, 100, size=n).astype(np.int64)
        ref_parts.append(ref_shuffle.mesh_keyed_fold(mesh, h1, h2, v, kind,
                                                     raw=True))
        port_parts.append(port_shuffle.mesh_keyed_fold(pmesh, h1, h2, v,
                                                       kind, raw=True))
    nonneg = kind == "sum" and not signed
    ref = ref_shuffle.mesh_keyed_refold(mesh, ref_parts, kind,
                                        nonneg=nonneg)
    port = port_shuffle.mesh_keyed_refold(pmesh, port_parts, kind,
                                          nonneg=nonneg)
    want = _live_rows(*ref, view=np.asarray)
    assert want
    assert _live_rows(*port, view=lambda t: t.numpy()) == want


# ---------------------------------------------------------------------------
# The table program
# ---------------------------------------------------------------------------


def _fnv1(rows, lens):
    h1, _h2 = port_hashing._fnv_numpy(rows, lens)
    return h1


def _table_case(rng, n, L, cap, Lcap, vocab_n, dup_h1=True, collide=True,
                empty=False, all_miss=False, max_line=6, hot=0.0, run=0):
    """A table state and a padded batch, both packages' inputs as numpy:
    vocabulary tokens of random bytes (lengths up to min(L, Lcap)), rows
    padded with zeros; the batch mostly vocabulary tokens, with new ones,
    pad rows and lines of up to ``max_line`` tokens.  ``dup_h1`` gives two
    slots the same h1 (the second one's tokens must miss); ``collide``
    puts a slot under another token's h1 with different bytes; ``hot``
    makes that share of the tokens one vocabulary token; ``run`` puts that
    many lanes, centred on lane 2048 of the sorted table, under the h1 of
    their smallest slot (a run of equal lanes across a power-of-two
    boundary: that slot, leftmost, must win; the others miss)."""
    W = min(L, Lcap)
    vocab_n = 0 if empty else vocab_n
    vlens = rng.randint(1, W + 1, size=vocab_n).astype(np.int32)
    vrows = np.zeros((vocab_n, Lcap), dtype=np.uint8)
    for i, ln in enumerate(vlens):
        vrows[i, :ln] = rng.randint(97, 123, size=ln)
    vh1 = _fnv1(vrows, vlens)
    slot_h1 = vh1.copy()
    if dup_h1 and vocab_n > 4:
        slot_h1[3] = slot_h1[2]  # slot 3 hides behind slot 2
    if collide and vocab_n > 6:
        slot_h1[5] = vh1[6]  # slot 5's bytes under slot 6's hash
        vlens[5] = vlens[6]
        vrows[5, vlens[5]:] = 0
        vrows[5, :vlens[5]] = vrows[6, :vlens[5]] ^ 1
    if run:
        sorted_slots = np.argsort(slot_h1, kind="stable")
        group = sorted_slots[2048 - run // 2:2048 + run - run // 2]
        slot_h1[group] = slot_h1[group.min()]  # stays where it sorts
    order = np.argsort(slot_h1, kind="stable")
    tab_h1 = np.full(cap, 0xFFFFFFFF, dtype=np.uint32)
    tab_h1[:vocab_n] = slot_h1[order]
    tab_slot = np.zeros(cap, dtype=np.int32)
    tab_slot[:vocab_n] = order
    tab_mat = np.zeros((cap, Lcap), dtype=np.uint8)
    tab_mat[:vocab_n] = vrows
    tab_lens = np.full(cap, -1, dtype=np.int32)
    tab_lens[:vocab_n] = vlens
    acc = rng.randint(0, 5, size=cap + 1).astype(np.int32)

    n_tok = n - n // 8  # the rest are pad rows
    mat = np.zeros((n, L), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    pick = rng.randint(0, max(vocab_n, 1), size=n_tok)
    if hot:
        pick[rng.rand(n_tok) < hot] = 7
    fresh = (rng.rand(n_tok) < 0.1) | (vocab_n == 0) | all_miss
    for i in range(n_tok):
        if fresh[i]:
            ln = rng.randint(1, L + 1)
            mat[i, :ln] = rng.randint(48, 58, size=ln)  # digits: never vocab
            lens[i] = ln
        else:
            j = pick[i]
            ln = vlens[j]
            mat[i, :min(ln, L)] = vrows[j, :min(ln, L)]
            lens[i] = ln
    lines = np.zeros(n, dtype=np.int32)
    line, left = 0, rng.randint(1, max_line + 1)
    for i in range(n_tok):
        lines[i] = line
        left -= 1
        if not left:
            line, left = line + 1, rng.randint(1, max_line + 1)
    return (mat, lens, lines, tab_h1, tab_slot, tab_mat, tab_lens, acc)


TABLE_CASES = {
    # name: (n, L, cap, Lcap, vocab, options)
    "L8": (4096, 8, 4096, 8, 900, {}),
    "L16-Lcap8": (2048, 16, 4096, 8, 500, {}),
    "L8-Lcap32": (2048, 8, 4096, 32, 500, {}),
    "L256": (1024, 256, 4096, 256, 300, {}),
    "empty-table": (1024, 8, 4096, 8, 0, {"empty": True}),
    "all-miss": (1024, 8, 4096, 8, 300, {"all_miss": True}),
    "long-lines": (2048, 8, 4096, 8, 200, {"max_line": 40}),
    # the redesigned kernel's edges: one slot in 60% of the tokens (its
    # block-aggregated count), an equal-h1 run across lane 2048 (its
    # sampled index), a table of 2^16 slots (16 lanes a sample), batches
    # that fill no whole tile, fewer rows than the window and one row
    "hot-slot": (4096, 8, 4096, 8, 900, {"hot": 0.6}),
    "run-across-2048": (4096, 8, 4096, 8, 3000, {"run": 40}),
    "cap-2^16": (4096, 8, 1 << 16, 8, 5000, {}),
    "n-off-tile": (4096 - 777, 8, 4096, 8, 900, {}),
    "n-below-k": (10, 8, 4096, 8, 900, {}),
    "n-one": (1, 8, 4096, 8, 900, {}),
}


@pytest.mark.parametrize("case,dedup,dedup_k", [
    (case, dedup, dedup_k) for case in sorted(TABLE_CASES)
    for dedup, dedup_k in ((False, 0), (True, 16), (True, 0))
    # the windowed variant is exact only for lines within its window
    if not (dedup_k and TABLE_CASES[case][5].get("max_line", 6) > dedup_k)])
def test_table_program_matches_reference(case, dedup, dedup_k):
    """The plain version of the table program against JAX's
    ``_table_program`` with its default int32 accumulator, on identical
    table state and batches: equal acc, miss and n_miss."""
    n, L, cap, Lcap, vocab, opts = TABLE_CASES[case]
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    mat, lens, lines, tab_h1, tab_slot, tab_mat, tab_lens, acc = \
        _table_case(rng, n, L, cap, Lcap, vocab, **opts)
    prog = ref_handoff._table_program(n, L, cap, Lcap, dedup, "int32",
                                      dedup_k)
    r_acc, r_miss, r_n = (np.asarray(x) for x in prog(
        mat, lens, lines, tab_h1, tab_slot, tab_mat, tab_lens, acc))
    p_acc = torch.from_numpy(acc.astype(np.int64))
    p_miss, p_n = port_handoff.table_probe(
        torch.from_numpy(mat), torch.from_numpy(lens),
        torch.from_numpy(lines), torch.from_numpy(tab_h1.view(np.int32)),
        torch.from_numpy(tab_slot), torch.from_numpy(tab_mat),
        torch.from_numpy(tab_lens), p_acc, dedup, dedup_k)
    assert np.array_equal(p_acc.numpy(), r_acc.astype(np.int64))
    assert np.array_equal(p_miss.numpy(), r_miss)
    assert int(p_n) == int(r_n)
    if case == "all-miss":
        assert int(p_n) == n - n // 8
    if vocab > 6 and not opts:
        # slot 3 (behind slot 2's h1) never hits; slot 5 (slot 6's hash,
        # other bytes) never hits
        assert p_acc[3] == acc[3] and p_acc[5] == acc[5]
    if case == "run-across-2048":
        assert tab_h1[2048 - 20] == tab_h1[2048 + 19]
    if case == "hot-slot" and not dedup:
        assert int(p_acc[7]) - int(acc[7]) > (n - n // 8) // 3


@pytest.mark.cuda
@pytest.mark.parametrize("case,dedup,dedup_k", [
    (case, dedup, dedup_k)
    for case in ("hot-slot", "run-across-2048", "cap-2^16", "n-off-tile",
                 "n-below-k", "n-one")
    for dedup, dedup_k in ((False, 0), (True, 16), (True, 0))])
def test_table_kernel_matches_plain_version_on_card(case, dedup, dedup_k):
    """On a CUDA card: the kernel (csrc/handoff.cu) against its plain
    version on the same card tensors, bit for bit, on the cases the
    redesign could break (chip_smoke.py runs these and more on the H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    n, L, cap, Lcap, vocab, opts = TABLE_CASES[case]
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    mat, lens, lines, tab_h1, tab_slot, tab_mat, tab_lens, acc = \
        _table_case(rng, n, L, cap, Lcap, vocab, **opts)
    dev = torch.device("cuda", torch.cuda.current_device())
    args = [torch.from_numpy(x).to(dev) for x in (
        mat, lens, lines, tab_h1.view(np.int32), tab_slot, tab_mat,
        tab_lens)]
    want_acc = torch.from_numpy(acc.astype(np.int64)).to(dev)
    got_acc = want_acc.clone()
    want = port_handoff.table_probe_reference(*args, want_acc, dedup,
                                              dedup_k)
    got = port_handoff.table_probe(*args, got_acc, dedup, dedup_k)
    torch.cuda.synchronize()
    assert torch.equal(got_acc, want_acc)
    assert torch.equal(got[0], want[0])
    assert int(got[1]) == int(want[1])


def test_reference_vocabulary_probes_equal_through_interop(tmp_path):
    """A JAX ``HandoffVocab`` seeded from a window, its state taken out as
    numpy into the port's (``interop.handoff_vocab_from_arrays``): both
    probe one batch alike, and both flush the same counts after it."""
    rng = np.random.RandomState(31)
    words = ["v%d" % i for i in range(300)]
    win = ("\n".join(" ".join(rng.choice(words, size=rng.randint(1, 9)))
                     for _ in range(400)) + "\n").encode()
    store = RefRunStore("handoff-interop", budget=1 << 26)
    store.handoff_active = True
    try:
        sink = ref_lower.device_window_sink(
            ref_text.DocFreq(mode="word", lower=True, pair_values=False),
            store=store, handoff=True)
        sink.add(win)
        hv = sink._hv
        assert hv.table_mode and hv.nslots
        hv._sync_table()
        state = {"tab_h1": np.asarray(hv.tab_h1),
                 "tab_slot": np.asarray(hv.tab_slot),
                 "tab_mat": np.asarray(hv.tab_mat),
                 "tab_lens": np.asarray(hv.tab_lens),
                 "acc": np.asarray(hv.acc), "cap": hv.cap, "Lcap": hv.Lcap,
                 "keys": list(hv.keys), "slot_bytes": list(hv.slot_bytes),
                 "h1": list(hv.h1), "h2": list(hv.h2),
                 "total_added": hv.total_added,
                 "table_mode": hv.table_mode,
                 "tab_dirty": hv._tab_dirty,
                 "lanes_deferred": hv._lanes_deferred}
        pv = interop.handoff_vocab_from_arrays(state, dedup=True)
        words2 = words[:250] + ["fresh%d" % i for i in range(40)]
        toks = rng.choice(words2, size=3000)
        n, L = 4096, 8
        mat = np.zeros((n, L), dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        lines = np.zeros(n, dtype=np.int32)
        for i, t in enumerate(toks):
            b = t.encode()
            mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
            lens[i] = len(b)
            lines[i] = i // 5
        prog = ref_handoff._table_program(n, L, hv.cap, hv.Lcap, True,
                                          "int32", 16)
        r_acc, r_miss, r_n = (np.asarray(x) for x in prog(
            mat, lens, lines, hv.tab_h1, hv.tab_slot, hv.tab_mat,
            hv.tab_lens, hv.acc))
        p_miss, p_n = port_handoff.table_probe(
            torch.from_numpy(mat), torch.from_numpy(lens),
            torch.from_numpy(lines), pv.tab_h1, pv.tab_slot, pv.tab_mat,
            pv.tab_lens, pv.acc, True, 16)
        assert 0 < int(r_n) < len(toks)
        assert int(p_n) == int(r_n)
        assert np.array_equal(p_miss.numpy(), r_miss)
        assert np.array_equal(pv.acc.numpy(), r_acc.astype(np.int64))
        blk = pv.flush_block()
        assert len(blk) == hv.nslots
    finally:
        store.cleanup()
