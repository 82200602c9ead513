"""Published peaks of the chip, for shares of a roofline.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): HBM3 at 3.35 TB/s, at the
card's full power limit of 700 W; a card set below it runs slower under
load, so each run prints its ``power.limit`` beside the shares.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind):
    """The card's HBM peak; raises for a card this table does not hold."""
    try:
        return PEAKS[kind]["hbm_bytes_per_s"]
    except KeyError:
        raise KeyError("no published peak for {!r}; add it to "
                       "portbench/peaks.py".format(kind))
