from portbench import registry, run, window


class Clock(object):
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_holds_whole_jobs_only():
    clock = Clock()
    walls = [4.0, 4.5, 3.0, 5.0, 4.0]

    def job(i):
        clock.t += 0.25  # the harness's own step before the job
        clock.t += walls[i]
        return i

    start, end, got, results = window.run_window(job, 10.0, clock=clock)
    # ends at 4.25, 9.0, 12.25 s: the third ends past 10 s and closes it
    assert results == [0, 1, 2]
    assert start == 100.0 and end == 112.25
    assert got == [4.25, 4.75, 3.25]
    reader = registry.load_module("metrics", "pipeline.corpus_mb_s")
    ctx = run.Context(total_bytes=3 * 50e6, window_s=end - start)
    assert reader.read(ctx) == 150 / 12.25


def test_one_long_job_is_the_whole_window():
    clock = Clock()

    def job(i):
        clock.t += 30.0

    start, end, walls, _ = window.run_window(job, 10.0, clock=clock)
    assert len(walls) == 1 and end - start == 30.0
