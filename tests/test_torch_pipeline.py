"""The ported slice end to end against the JAX package.

``Dampr.text(...).custom_mapper(DocFreq|TokenCounts).fold_values(add)``
through dampr_tpu_torch (device="cpu", lowering forced on and off) must
read back the same records as dampr_tpu with lowering forced on (the
CPU-JAX jit leg) and off, and ``sink_tsv`` must write the same lines —
including the invalid-UTF-8, wide-line and empty-window fallbacks.
Tolerance: exact.
"""

import operator
import os

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import text as ref_text
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import text as port_text


@pytest.fixture(autouse=True)
def knobs():
    old_ref = (ref_settings.lower, ref_settings.lower_batch)
    old_port = (port_settings.device, port_settings.lower,
                port_settings.lower_batch, port_settings.handoff)
    port_settings.device = "cpu"
    # the classic lowered program; the handoff's parity on these corpora
    # is tests/test_torch_handoff.py's
    port_settings.handoff = "off"
    yield
    ref_settings.lower, ref_settings.lower_batch = old_ref
    (port_settings.device, port_settings.lower,
     port_settings.lower_batch, port_settings.handoff) = old_port


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _corpus(seed, n_lines=600):
    rng = np.random.RandomState(seed)
    words = (["w%d" % i for i in range(150)]
             + ["Tok_1", "UPPER", "a", "naïve", "日本語", "x" * 300])
    lines = [" ".join(rng.choice(words, size=rng.randint(0, 11)))
             for _ in range(n_lines)]
    return ("\n".join(lines) + "\n").encode()


CORPORA = {
    "text": lambda: _corpus(21),
    "invalid_utf8": lambda: (b"alpha \xff\xfe beta\nbeta \xff gamma\n"
                             + _corpus(22, 50)),
    "wide_line": lambda: ((" ".join("t%d" % (i % 7) for i in range(3000))
                           + "\n").encode() + _corpus(23, 50)),
    "blank_windows": lambda: b"\n\n  \t \n" + _corpus(24, 20) + b"\n\n",
    "no_trailing_newline": lambda: _corpus(25, 40).rstrip(b"\n"),
}


def _scanner(pkg, kind):
    if kind == "docfreq":
        return pkg.DocFreq(mode="word", lower=True, pair_values=False)
    if kind == "tokens":
        return pkg.TokenCounts(mode="word", lower=True, pair_values=False)
    return pkg.TokenCounts(mode="whitespace", lower=False, pair_values=False)


def _run(pkg, text, path, kind, chunks=3, sink_dir=None):
    """(records read back, sink lines or None, stats summary)."""
    pipe = (pkg.Dampr.text(path, max(1, os.path.getsize(path) // chunks + 1))
            .custom_mapper(_scanner(text, kind)).fold_values(operator.add))
    if sink_dir is None:
        em = pipe.run(name="torch-port-parity")
        got = em.read()
        stats = em.stats()
        em.delete()
        return got, None, stats
    em = pipe.sink_tsv(sink_dir).run(name="torch-port-parity-sink")
    lines = sorted(str(v) for v in em.read())
    return None, lines, em.stats()


def _reference(path, kind, lower, sink_dir=None):
    ref_settings.lower = lower
    return _run(dampr_tpu, ref_text, path, kind, sink_dir=sink_dir)


def _port(path, kind, lower, sink_dir=None):
    port_settings.lower = lower
    return _run(dampr_tpu_torch, port_text, path, kind, sink_dir=sink_dir)


class TestSliceParity:
    @pytest.mark.parametrize("kind", ["docfreq", "tokens", "ws_tokens"])
    @pytest.mark.parametrize("corpus", sorted(CORPORA))
    def test_read_matches_reference_both_legs(self, tmp_path, corpus, kind):
        port_settings.lower_batch = ref_settings.lower_batch = 0
        path = _write(tmp_path, "c.txt", CORPORA[corpus]())
        ref_on, _, s_ref = _reference(path, kind, "1")
        ref_off, _, _ = _reference(path, kind, "0")
        assert ref_on == ref_off
        got_on, _, s_on = _port(path, kind, "1")
        got_off, _, s_off = _port(path, kind, "0")
        assert got_on == ref_on
        assert got_off == ref_on
        assert s_on["device"]["device_stages"] >= 1
        assert s_on["device"]["batches"] >= 1
        assert s_off["device"]["device_stages"] == 0
        assert s_off["device"]["batches"] == 0
        targets = [(s["kind"], s["target"]) for s in s_on["stages"]]
        assert ("map", "device") in targets

    @pytest.mark.parametrize("kind", ["docfreq", "tokens"])
    def test_sink_tsv_lines_match(self, tmp_path, kind):
        path = _write(tmp_path, "c.txt", CORPORA["text"]())
        _, ref_lines, _ = _reference(path, kind, "1",
                                     sink_dir=str(tmp_path / "ref"))
        _, got_lines, _ = _port(path, kind, "1",
                                sink_dir=str(tmp_path / "port"))
        _, off_lines, _ = _port(path, kind, "0",
                                sink_dir=str(tmp_path / "port_off"))
        assert got_lines == ref_lines
        assert off_lines == ref_lines

        def part_lines(d):
            out = []
            for part in sorted(os.listdir(d)):
                with open(os.path.join(d, part), "rb") as f:
                    out.extend(f.read().splitlines())
            return sorted(out)

        assert part_lines(str(tmp_path / "port")) == part_lines(
            str(tmp_path / "ref"))

    @pytest.mark.parametrize("corpus,expect", [("invalid_utf8", 1),
                                               ("wide_line", 1),
                                               ("text", 0)])
    def test_fallbacks_are_counted(self, tmp_path, corpus, expect):
        port_settings.lower_batch = 0  # the 1024 floor: wide line > batch
        path = _write(tmp_path, "c.txt", CORPORA[corpus]())
        port_settings.lower = "1"
        em = (dampr_tpu_torch.Dampr.text(path, os.path.getsize(path) + 1)
              .custom_mapper(_scanner(port_text, "docfreq"))
              .fold_values(operator.add).run(name="torch-fallbacks"))
        fallbacks = em.stats()["device"]["fallbacks"]
        em.delete()
        assert (fallbacks >= 1) == bool(expect)

    def test_cpu_run_launches_no_kernel(self, tmp_path):
        """On the CPU the wrappers run the plain versions: the kernel
        launch counters stay put."""
        path = _write(tmp_path, "c.txt", CORPORA["text"]())
        _, _, stats = _port(path, "docfreq", "1")
        assert stats["device"]["kernels"] == {"fnv": 0, "segfold": 0,
                                              "handoff": 0, "rows": 0}
        assert stats["device"]["h2d_bytes"] > 0

    def test_memory_budget_spill_keeps_results(self, tmp_path):
        path = _write(tmp_path, "c.txt", CORPORA["text"]())
        ref, _, _ = _reference(path, "docfreq", "0")
        port_settings.lower = "1"
        em = (dampr_tpu_torch.Dampr.text(path, 2000)
              .custom_mapper(_scanner(port_text, "docfreq"))
              .fold_values(operator.add)
              .run(name="torch-spill", memory_budget=4096))
        got = em.read()
        spills = em.stats()["spill"]["count"]
        em.delete()
        assert spills > 0
        assert got == ref
