"""dampr_tpu_torch's lowered token-fold program and window sink against
the JAX package.

``token_fold`` (on CPU tensors: the kernels' plain versions) must give the
same six outputs as ``dampr_tpu.ops.lower._token_fold_jit`` — position by
position, on the same padded inputs — for dedup and no-dedup, on natural
text, multibyte tokens and a forced collision.  The port's
``DeviceTokenFoldSink`` must emit the same counts as the reference's sink
and the host scanners, through every exactness fallback.  Tolerance: exact.
"""

import numpy as np
import pytest

from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import lower as ref_lower
from dampr_tpu.ops import text as ref_text
from dampr_tpu_torch import interop
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import lower as port_lower
from dampr_tpu_torch.ops import text as port_text


@pytest.fixture(autouse=True)
def cpu_device():
    old = (port_settings.device, port_settings.lower_batch,
           ref_settings.lower_batch, ref_settings.lower_pallas_segfold)
    port_settings.device = "cpu"
    yield
    (port_settings.device, port_settings.lower_batch,
     ref_settings.lower_batch, ref_settings.lower_pallas_segfold) = old


def _corpus(seed, n_lines=300, exotic=False):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(120)] + ["Tok_1", "UPPER", "a"]
    if exotic:
        words += ["émoji", "naïve", "日本語", "mixedÉcase", "x" * 40]
    lines = [" ".join(rng.choice(words, size=rng.randint(1, 10)))
             for _ in range(n_lines)]
    return ("\n".join(lines) + "\n").encode()


def _padded(data, mode, lower, dedup):
    """One program batch padded by the REFERENCE sink (and checked equal
    to the port sink's padding)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if lower:
        buf = ref_text._LOWER[buf]
    starts, lens = ref_text._token_bounds(buf, mode)
    keep = lens <= ref_text._SHORT_TOKEN
    starts, lens = starts[keep], lens[keep]
    lines = port_text.line_ids(buf, starts) if dedup else None
    params = {"mode": mode, "lower": lower, "dedup": dedup,
              "pair_values": False}
    mat, lens_p, lines_p = ref_lower.DeviceTokenFoldSink(
        params)._pad_batch(buf, starts, lens, lines)
    pm, pl, pli = port_lower.DeviceTokenFoldSink(params)._pad_batch(
        buf, starts, lens, lines)
    np.testing.assert_array_equal(pm.numpy(), mat)
    np.testing.assert_array_equal(pl.numpy(), lens_p)
    np.testing.assert_array_equal(pli.numpy(), lines_p)
    return mat, lens_p, lines_p


def _assert_six_equal(mat, lens, lines, dedup, pallas=False):
    n, L = mat.shape
    ref = [np.asarray(x) for x in ref_lower._token_fold_jit(
        n, L, dedup, pallas, True)(mat, lens, lines)]
    got = port_lower.token_fold(
        *interop.program_inputs(mat, lens, lines, "cpu"), dedup)
    sh1, sh2, tot, live, rep_orig, collisions = (t.numpy() for t in got)
    np.testing.assert_array_equal(sh1.view(np.uint32), ref[0])
    np.testing.assert_array_equal(sh2.view(np.uint32), ref[1])
    np.testing.assert_array_equal(tot, ref[2])
    np.testing.assert_array_equal(live, ref[3])
    np.testing.assert_array_equal(rep_orig, ref[4].astype(np.int64))
    assert int(collisions) == int(ref[5])
    return int(collisions)


def _reference_stages(mat, lens, lines, dedup):
    """The reference program's sort, dedup and segment-start expressions
    (dampr_tpu/ops/lower.py:117-149), evaluated with JAX as written
    there, on its own FNV lanes."""
    import jax.numpy as jnp
    from jax import lax

    from dampr_tpu.ops import hashing as ref_hashing

    n = mat.shape[0]
    h1, h2 = (jnp.asarray(x) for x in ref_hashing._fnv_jit()(mat, lens))
    lens, lines = jnp.asarray(lens), jnp.asarray(lines)
    inv = jnp.where(lens > 0, 0, 1).astype(jnp.int32)
    iota = jnp.arange(n, dtype=jnp.int32)
    if dedup:
        sorted_ = lax.sort((inv, h1, h2, lines.astype(jnp.int32), iota),
                           num_keys=4, is_stable=True)
    else:
        sorted_ = lax.sort((inv, h1, h2, iota), num_keys=3, is_stable=True)
    sinv, sh1, sh2 = sorted_[0], sorted_[1], sorted_[2]

    def adj_new(*lanes):
        out = jnp.ones((n,), dtype=bool)
        neq = jnp.zeros((n - 1,), dtype=bool)
        for lane in lanes:
            neq = neq | (lane[1:] != lane[:-1])
        return out.at[1:].set(neq)

    starts = adj_new(sinv, sh1, sh2)
    if dedup:
        v = jnp.where(adj_new(sinv, sh1, sh2, sorted_[3]) & (sinv == 0),
                      1, 0).astype(jnp.int32)
    else:
        v = jnp.where(sinv == 0, 1, 0).astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)
    start_pos = lax.cummax(jnp.where(starts, pos, -1), axis=0)
    return {"perm": np.asarray(sorted_[-1]), "sinv": np.asarray(sinv),
            "v": np.asarray(v), "start_pos": np.asarray(start_pos)}


CASES = [("word", True, 1, False), ("whitespace", False, 2, False),
         ("word", True, 3, True), ("whitespace", True, 4, True)]


class TestTokenFoldParity:
    @pytest.mark.parametrize("dedup", [True, False])
    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_six_outputs_equal(self, case, dedup):
        mode, lower, seed, exotic = CASES[case]
        data = _corpus(seed, exotic=exotic)
        mat, lens, lines = _padded(data, mode, lower, dedup)
        assert _assert_six_equal(mat, lens, lines, dedup) == 0

    @pytest.mark.parametrize("dedup", [True, False])
    def test_forced_collision_counts_equal(self, dedup):
        """Bytes past a row's length don't enter the hash but do enter
        the byte check: junk there makes equal-hash rows differ — a
        collision both programs must count identically."""
        mat, lens, lines = _padded(_corpus(5), "word", True, dedup)
        mat = mat.copy()
        rows = np.flatnonzero((lens > 0) & (lens < mat.shape[1]))[::7]
        mat[rows, lens[rows]] = 0xEE
        assert _assert_six_equal(mat, lens, lines, dedup) > 0

    def test_matches_reference_pallas_segfold_leg(self):
        """The reference's opt-in Pallas segfold leg (one 8192-row tile in
        interpret mode) gives the same outputs as the port too."""
        ref_settings.lower_pallas_segfold = True
        data = _corpus(6, n_lines=1200)
        mat, lens, lines = _padded(data, "word", True, False)
        assert mat.shape[0] == 8192
        _assert_six_equal(mat, lens, lines, False, pallas=True)

    @pytest.mark.parametrize("dedup", [True, False])
    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_sort_stage_matches_reference_expressions(self, case, dedup):
        """perm, sinv, the contribution v, start_pos and the representatives
        of the port's fused stages equal the reference program's
        expressions (dampr_tpu/ops/lower.py:117-149), evaluated with JAX on
        the same batch; the replica is tied to ``_token_fold_jit`` through
        the rep_orig it gives."""
        mode, lower, seed, exotic = CASES[case]
        mat, lens, lines = _padded(_corpus(seed, exotic=exotic), mode, lower,
                                   dedup)
        ref = _reference_stages(mat, lens, lines, dedup)
        n, L = mat.shape
        prog = ref_lower._token_fold_jit(n, L, dedup, False, True)(
            mat, lens, lines)
        np.testing.assert_array_equal(ref["perm"][ref["start_pos"]],
                                      np.asarray(prog[4]))

        from dampr_tpu_torch.ops import fnv as port_fnv
        from dampr_tpu_torch.ops import segfold as port_segfold

        m, ln, li = interop.program_inputs(mat, lens, lines, "cpu")
        low, high = port_fnv.fnv_sort_keys(m, ln, li if dedup else None)
        perm, shigh = port_lower.sort_segments(low, high)
        rep_orig = port_segfold.segfold_gather(perm, shigh, low, m, ln,
                                               dedup)[4]
        starts, v = port_segfold.segment_marks(shigh, low[perm], dedup)
        start_pos = port_segfold.start_positions(starts)
        np.testing.assert_array_equal(perm.numpy(), ref["perm"])
        np.testing.assert_array_equal((shigh >> 32).numpy(), ref["sinv"])
        np.testing.assert_array_equal(v.numpy(), ref["v"])
        np.testing.assert_array_equal(start_pos.numpy(), ref["start_pos"])
        np.testing.assert_array_equal(rep_orig.numpy(), np.asarray(prog[4]))

    def test_custom_kernels_are_injected(self):
        """hash_fn/fold_fn select what runs (the card check passes the
        plain versions explicitly)."""
        mat, lens, lines = _padded(_corpus(8), "word", True, True)
        calls = []

        def hash_fn(*a):
            calls.append("hash")
            from dampr_tpu_torch.ops.fnv import fnv_sort_keys_reference
            return fnv_sort_keys_reference(*a)

        def fold_fn(*a):
            calls.append("fold")
            from dampr_tpu_torch.ops.segfold import segfold_gather_reference
            return segfold_gather_reference(*a)

        port_lower.token_fold(*interop.program_inputs(mat, lens, lines,
                                                      "cpu"),
                              True, hash_fn=hash_fn, fold_fn=fold_fn)
        assert calls == ["hash", "fold"]


def _dict_of(blocks, pair_values):
    d = {}
    for b in blocks:
        for k, v in zip(b.keys, b.values):
            d[k] = d.get(k, 0) + (v[1] if pair_values else int(v))
    return d


def _port_sink(mapper, data):
    sink = port_lower.device_window_sink(mapper)
    blks = list(sink.add(data)) + list(sink.finish())
    return _dict_of(blks, mapper.pair_values), sink


def _ref_sink(mapper, data):
    sink = ref_lower.device_window_sink(mapper)
    blks = list(sink.add(data)) + list(sink.finish())
    return _dict_of(blks, mapper.pair_values)


def _scanners(pkg):
    return [pkg.TokenCounts(mode="whitespace", lower=False, pair_values=False),
            pkg.TokenCounts(mode="word", lower=True, pair_values=True),
            pkg.DocFreq(mode="word", lower=True, pair_values=False),
            pkg.DocFreq(mode="whitespace", lower=False, pair_values=True)]


class TestWindowSinkParity:
    @pytest.mark.parametrize("case", range(4))
    def test_counts_match_reference_sink(self, case):
        for seed in (1, 2):
            data = _corpus(10 * case + seed, exotic=(seed == 2))
            got, sink = _port_sink(_scanners(port_text)[case], data)
            assert got == _ref_sink(_scanners(ref_text)[case], data)
            assert sink.batches >= 1 and sink.fallbacks == 0

    def test_batches_cut_at_line_boundaries(self):
        data = _corpus(7, n_lines=400)
        port_settings.lower_batch = 64  # the 1024 floor applies
        ref_settings.lower_batch = 64
        for case in (1, 2):
            got, sink = _port_sink(_scanners(port_text)[case], data)
            assert sink.batches > 1
            assert got == _ref_sink(_scanners(ref_text)[case], data)

    def test_hash_lanes_match_engine_hash(self):
        from dampr_tpu.ops import hashing as ref_hashing

        sink = port_lower.device_window_sink(
            port_text.DocFreq(mode="word", lower=True, pair_values=False))
        for b in sink.add(_corpus(3, exotic=True)):
            h1, h2 = ref_hashing.hash_keys(b.keys)
            np.testing.assert_array_equal(b.h1, h1)
            np.testing.assert_array_equal(b.h2, h2)

    @pytest.mark.parametrize("data", [
        b"alpha \xff\xfe beta\nbeta \xff gamma\n",
        ("y" * 300 + " t1 " + "z" * 300 + "\nt1 t2\n").encode(),
        b"", b"  \t \n \n", b"\n\n"])
    def test_fallback_and_edge_windows(self, data):
        for case in range(4):
            got, _sink = _port_sink(_scanners(port_text)[case], data)
            assert got == _ref_sink(_scanners(ref_text)[case], data)

    def test_invalid_utf8_window_counts_a_fallback(self):
        _got, sink = _port_sink(_scanners(port_text)[2],
                                b"alpha \xff\xfe beta\nbeta \xff gamma\n")
        assert sink.fallbacks == 1 and sink.batches == 0

    def test_line_wider_than_batch_falls_back_whole(self):
        port_settings.lower_batch = 0  # the 1024 floor applies
        ref_settings.lower_batch = 0
        big = "y" * 300
        wide = ((big + " " + " ".join("t%d" % (i % 5) for i in range(3000))
                 + " " + big) + "\n").encode()
        for case in (2, 1):
            got, sink = _port_sink(_scanners(port_text)[case], wide)
            assert got == _ref_sink(_scanners(ref_text)[case], wide)
            # only per-line dedup needs the whole-window fallback
            assert sink.fallbacks == (1 if case == 2 else 0)

    def test_forced_collision_regroups_exactly(self, monkeypatch):
        real = port_lower.token_fold

        def lying(*a, **kw):
            out = list(real(*a, **kw))
            out[-1] = out[-1] + 1  # claim a collision happened
            return tuple(out)

        monkeypatch.setattr(port_lower, "token_fold", lying)
        data = _corpus(11)
        for case in (1, 2):
            got, sink = _port_sink(_scanners(port_text)[case], data)
            assert sink.fallbacks >= 1
            assert got == _ref_sink(_scanners(ref_text)[case], data)

    def test_claims_rejects_subclasses_and_unknown(self):
        class Odd(port_text.TokenCounts):
            pass

        assert port_lower.claims(Odd()) is None
        assert port_lower.claims(object()) is None
        assert port_lower.claims(port_text.TokenCounts(mode="chars")) is None
        for pm, rm in zip(_scanners(port_text), _scanners(ref_text)):
            assert port_lower.claims(pm) == ref_lower.claims(rm)
