"""The measured window: whole jobs, back to back, over the whole time.

A closed loop runs one job at a time from the window's start.  The window
ends when the first job that finishes after ``seconds`` have elapsed
finishes, so it holds only whole jobs, and a rate is the bytes of all of
them over all of its time, the harness's own steps between jobs included.
"""

import time


def run_window(job, seconds, clock=time.perf_counter):
    """Run ``job(i)`` until ``seconds`` have elapsed and the job running
    then has finished.  Returns ``(start, end, walls, results)`` in the
    clock's seconds, one wall and one result per job."""
    walls, results = [], []
    start = clock()
    while True:
        a = clock()
        results.append(job(len(walls)))
        b = clock()
        walls.append(b - a)
        if b - start >= seconds:
            return start, b, walls, results
