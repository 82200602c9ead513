"""Upstream Dampr's ``examples/wc.py`` on the port's public API: every
line split on whitespace, and each token counted by ``fold_by``.  The job
reads its records back, as the example does.  Each job runs unnamed:
no run history, so no plan adapted from an earlier job."""


def job(corpus, chunk_size, out_dir):
    """One run of the pipeline; returns ``(records, stats)``."""
    from dampr_tpu_torch import Dampr

    em = (Dampr.text(corpus, chunk_size)
          .flat_map(lambda line: line.split())
          .fold_by(lambda w: w, binop=lambda x, y: x + y,
                   value=lambda w: 1)).run()
    records = em.read()
    em.delete()
    return records, em.stats()
