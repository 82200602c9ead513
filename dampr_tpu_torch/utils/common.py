"""Composed-DSL utilities (port of ``dampr_tpu/utils/common.py``)."""


def filter_by_count(pipe, key_func, filter_func):
    """Keep the items whose key's global count passes ``filter_func``:
    count, filter the counts, join back to the items."""
    item_count = (pipe.map(key_func)
                  .count()
                  .filter(lambda count: filter_func(count[1])))

    return (item_count.group_by(lambda x: x[0], lambda x: x[1])
            .join(pipe.group_by(key_func))
            .reduce(lambda _lit, rit: rit, many=True)
            .map(lambda x: x[1]))
