"""Compositions of the DSL (port of ``dampr_tpu/utils``)."""

from .common import filter_by_count
from .indexer import Indexer

__all__ = ["Indexer", "filter_by_count"]
