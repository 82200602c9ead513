"""Upstream Dampr's ``benchmarks/tf-idf-dampr.py`` on the port's public
API: the document frequency of lower-cased ``[^\\w]+`` tokens
(``DocFreq``), its sum fold, idf = log(1 + lines / df) through a
broadcast cross with the line count, and a TSV sink.  Each job runs
unnamed: no run history, so no plan adapted from an earlier job."""

import math
import operator


def _idf(df, total):
    return df[0], df[1], math.log(1 + float(total) / df[1])


def job(corpus, chunk_size, out_dir):
    """One run of the pipeline; returns ``(output, stats)``: the sink's
    directory, read by the reference after the window, and the run's
    ``em.stats()``."""
    from dampr_tpu_torch import Dampr
    from dampr_tpu_torch.ops.text import DocFreq

    docs = Dampr.text(corpus, chunk_size)
    doc_freq = (docs.custom_mapper(
        DocFreq(mode="word", lower=True, pair_values=False))
        .fold_values(operator.add))
    idf = doc_freq.cross_right(docs.len(), _idf, memory=True)
    em = idf.sink_tsv(out_dir).run()
    return out_dir, em.stats()
