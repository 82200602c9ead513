"""The row builder's kernel (``csrc/fnv.cu``, ``dampr_rows``) against its
plain torch version on a CUDA card, bit for bit, at the main path's batch
(2^18 rows) with L = 32 (the `tfidf-20x` corpus's bucket) and L = 256
(the widest), with and without lines.  Skips where there is no card."""

import numpy as np
import pytest
import torch

from dampr_tpu_torch.ops import fnv as port_fnv

NPAD = 1 << 18


def _compact_batch(rng, n, L, dev):
    """A compact upload of ``n`` tokens of 1..L bytes, a separator after
    each, as the sink stages it."""
    lens = rng.randint(1, L + 1, size=n).astype(np.uint8)
    offs = np.zeros(n, dtype=np.int64)
    offs[1:] = np.cumsum(lens.astype(np.int64) + 1)[:-1]
    span = rng.randint(0, 256, size=int(offs[-1]) + int(lens[-1])).astype(
        np.uint8)
    lines = (np.arange(n) // 9).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (
        span, offs.astype(np.int32), lens, lines)]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [32, 256])
@pytest.mark.parametrize("with_lines", [True, False])
def test_row_kernel_matches_plain_version_on_card(L, with_lines):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.RandomState(L)
    n = NPAD - 1000  # pad rows at the end
    span, offs, lens, lines = _compact_batch(rng, n, L, dev)
    if not with_lines:
        lines = None
    before = port_fnv.ROWS_KERNEL.launches
    got = port_fnv.build_rows(span, offs, lens, lines, NPAD, L)
    want = port_fnv.build_rows_reference(span, offs, lens, lines, NPAD, L)
    torch.cuda.synchronize()
    assert port_fnv.ROWS_KERNEL.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
