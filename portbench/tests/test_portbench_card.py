"""A short traced run of each cell on the card (skips where there is no
card; run on the chip with ``python3 -m pytest portbench/tests -m cuda``)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tfidf-20x", "wc-1x",
                                      "tfidf-bgzf-20x"])
def test_traced_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert 0 < r["metrics"]["device.idle_pct"]["value"] < 100
    if workload != "wc-1x":
        assert 0 < r["metrics"]["kernels_roofline"]["value"] < 100
