"""The run-history CLI of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_history_cli.py``: over one corpus
directory (both packages' ``scratch_root``), the port's
``obs.history.main`` prints what the JAX one prints and returns the same
exit code for every verb (the listing of all corpora, a run's records,
``--fingerprint``, ``--gc``, ``--vacuum``, ``--json``, a missing run),
and a verb that rewrites a corpus leaves the same bytes on disk.  The
v2 -> v3 upgrade, the health block and ``vacuum`` are held against the
JAX functions too.
"""

import json
import os

import pytest

from dampr_tpu import settings as ref_settings
from dampr_tpu.obs import history as ref_history
from dampr_tpu_torch import cli, settings
from dampr_tpu_torch.obs import history


def _v2_record(i, fp="cafecafecafecafe"):
    """A minimal valid v2-era corpus line (before the health block)."""
    return {
        "schema": "dampr-tpu-history/2",
        "run": "old-run", "ts": 1000.0 + i, "fingerprint": fp,
        "wall_seconds": 1.0 + i / 10.0,
        "stages": [{"shape": "scan>map", "spill_bytes": 0}],
        "settings": {}, "throughput": {"mbps": 10.0},
    }


@pytest.fixture
def scratch(tmp_path):
    old = (settings.scratch_root, ref_settings.scratch_root,
           settings.history_entries, ref_settings.history_entries)
    settings.scratch_root = ref_settings.scratch_root = str(tmp_path)
    yield tmp_path
    (settings.scratch_root, ref_settings.scratch_root,
     settings.history_entries, ref_settings.history_entries) = old


def _write_corpus(name, records, extra_lines=()):
    path = history.corpus_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        for line in extra_lines:
            f.write(line)
    return path


def _corpora():
    """run-a: one record and a torn line; run-b: two shapes; old-run:
    eight records, one of another fingerprint."""
    _write_corpus("run-a", [_v2_record(0)], extra_lines=["garbage\n"])
    _write_corpus("run-b", [_v2_record(0),
                            _v2_record(1, fp="deadbeefdeadbeef")])
    recs = [_v2_record(i) for i in range(8)]
    recs[3]["fingerprint"] = "deadbeefdeadbeef"
    recs[5]["rank"] = 2
    _write_corpus("old-run", recs)


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name, history.FILE)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


ARGVS = [
    [], ["--json"], ["--list"], ["old-run"], ["old-run", "--json"],
    ["old-run", "--fingerprint", "deadbeefdeadbeef"],
    ["old-run", "--fingerprint", "deadbeefdeadbeef", "--json"],
    ["old-run", "--gc"], ["old-run", "--gc", "--json"], ["--gc"],
    ["--vacuum"], ["run-a", "--vacuum", "--json"], ["nonesuch"],
    ["nonesuch", "--vacuum"],
]


class TestCLI:
    @pytest.mark.parametrize("argv", ARGVS, ids=" ".join)
    def test_prints_what_jax_prints(self, scratch, capsys, argv):
        settings.history_entries = ref_settings.history_entries = 5
        _corpora()
        rc = history.main(argv)
        out = capsys.readouterr().out
        port_files = _files(str(scratch))
        _corpora()
        assert ref_history.main(argv) == rc
        assert capsys.readouterr().out == out
        assert _files(str(scratch)) == port_files

    def test_through_the_cli_module(self, scratch, capsys):
        _corpora()
        assert cli.main(["history", "old-run"]) == 0
        out = capsys.readouterr().out
        assert "old-run — 8 record(s)" in out and "rank=2" in out
        assert cli.main(["history", "nonesuch"]) == 1

    def test_empty_root(self, scratch, capsys):
        assert history.main([]) == ref_history.main([]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0] == out[1] == "no history corpora under {}".format(
            scratch)


class TestSchemaAndVacuum:
    def test_upgrade_equals_jax(self):
        for rec in (_v2_record(0), {"schema": "dampr-tpu-history/1",
                                    "run": "r", "stages": [{"shape": "s"}]}):
            assert history.upgrade(dict(rec)) == ref_history.upgrade(
                dict(rec))

    def test_compact_record_health_block(self):
        summary = {
            "run": "r", "started_at": 1.0, "wall_seconds": 2.0,
            "stages": [{"kind": "map", "jobs": 1, "records_out": 10,
                        "bytes_out": 100, "spill_bytes": 0,
                        "seconds": 1.0}],
            "faults": {"retries": 2, "quarantined": [3]},
            "reuse": {"hits": 3, "misses": 1},
        }
        assert history.compact_record(summary)["health"] == \
            ref_history.compact_record(summary)["health"]
        assert history._health_section({"run": "r", "stages": []}) == {}

    @pytest.mark.parametrize("cap", [None, 4])
    def test_vacuum_equals_jax(self, scratch, cap):
        extra = ["torn {line\n", "\n",
                 json.dumps({"schema": "foreign/9", "stages": []}) + "\n"]
        path = _write_corpus("old-run", [_v2_record(i) for i in range(10)],
                             extra_lines=extra)
        got = history.vacuum(path, cap=cap)
        with open(path, "rb") as f:
            port_bytes = f.read()
        _write_corpus("old-run", [_v2_record(i) for i in range(10)],
                      extra_lines=extra)
        assert ref_history.vacuum(path, cap=cap) == got
        with open(path, "rb") as f:
            assert f.read() == port_bytes
