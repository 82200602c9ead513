"""Plan-level views over a Graph (port of ``dampr_tpu/plan/ir.py``).

The graph stays a plain ordered stage list; what the passes need to know
about it (who consumes which Source, what a mapper chain is made of,
which stages are rewrite barriers) lives here as pure functions.  After
fusion a stage's mapper may be a composed chain: :func:`flatten_mapper`
gives its leaves in stream order.
"""

from .. import base
from ..graph import GInput, GMap, GReduce, GSink, Graph

#: Record ops whose presence makes a stage a fusion barrier.  ``Sample``
#: draws from a per-thread RNG in stream order, so moving it across a
#: materialization changes which records each RNG stream sees; ``Inspect``
#: is the user asking to see the records at that exact point.
BARRIER_OPS = (base.Sample, base.Inspect)


# -- mapper chains -----------------------------------------------------------

def flatten_mapper(m):
    """A (possibly fused) mapper -> its leaf parts in stream order."""
    if type(m) in (base.ComposedMapper, base.ComposedStreamable):
        return flatten_mapper(m.left) + flatten_mapper(m.right)
    return [m]


def _is_identity_leaf(p):
    return type(p) is base.Map and p.mapper is base._identity


def is_identity_mapper(m):
    """True when the mapper chain is pure identity (a combiner, checkpoint
    or sink head)."""
    return all(_is_identity_leaf(p) for p in flatten_mapper(m))


def is_record_chain(m):
    """A fusable mapper: a pure per-record chain (``Map`` and typed record
    ops, composed) with no barrier op."""
    if not base.is_pure_record_stream(m):
        return False
    return not any(isinstance(p, BARRIER_OPS) for p in flatten_mapper(m))


def compose_mappers(*mappers):
    """One fused mapper from mapper chains, identity leaves dropped."""
    parts = []
    for m in mappers:
        parts.extend(p for p in flatten_mapper(m) if not _is_identity_leaf(p))
    if not parts:
        return base.Map(base._identity)
    return base.fuse(parts)


# -- stage predicates --------------------------------------------------------

def has_barrier_ops(stage):
    """Does the stage's mapper chain hold a Sample or an Inspect?  Such a
    stage neither absorbs its producer nor dissolves into its consumer."""
    m = getattr(stage, "mapper", None)
    return m is not None and any(isinstance(p, BARRIER_OPS)
                                 for p in flatten_mapper(m))


def stage_is_barrier(stage):
    """Must this stage's output stay materialized as constructed?  True
    for ``checkpoint()`` (``options["barrier"]``), ``cached()``
    (``memory``) and Sample/Inspect chains.  Such a stage never dissolves
    into its consumer, but a checkpoint may still absorb its producer."""
    opts = getattr(stage, "options", None) or {}
    if opts.get("barrier") or opts.get("memory"):
        return True
    return has_barrier_ops(stage)


def has_combiner(stage):
    return (getattr(stage, "combiner", None) is not None
            or "binop" in (getattr(stage, "options", None) or {}))


def merge_options(head_opts, tail_opts):
    """A fused stage's options: the tail's win; ``n_maps`` takes the
    smaller of the two."""
    out = dict(head_opts or {})
    out.update(tail_opts or {})
    if head_opts and tail_opts and "n_maps" in head_opts \
            and "n_maps" in tail_opts:
        out["n_maps"] = min(head_opts["n_maps"], tail_opts["n_maps"])
    return out


# -- graph views -------------------------------------------------------------

def consumer_counts(stages, outputs=()):
    """{Source: consumers}, every requested output charged one more (the
    final read), so it never looks private to its one graph consumer."""
    counts = {}
    for stage in stages:
        for src in stage.inputs:
            counts[src] = counts.get(src, 0) + 1
    for src in outputs:
        counts[src] = counts.get(src, 0) + 1
    return counts


def producer_index(stages):
    """{output Source: stage index}."""
    return {stage.output: i for i, stage in enumerate(stages)}


def executed_stage_count(graph):
    """Stages the runner executes (input taps are free)."""
    return sum(1 for s in graph.stages if not isinstance(s, GInput))


def stage_kind(stage):
    if isinstance(stage, GInput):
        return "input"
    if isinstance(stage, GMap):
        return "map"
    if isinstance(stage, GReduce):
        return "reduce"
    if isinstance(stage, GSink):
        return "sink"
    return type(stage).__name__


def part_name(p):
    """An operator's label: its type, with the name of the function it
    wraps when that has one."""
    fn = None
    for attr in ("mapper", "f", "key_f", "streamer_f", "reducer",
                 "stream_f", "crosser", "joiner_f", "sinker"):
        fn = getattr(p, attr, None)
        if fn is not None:
            break
    label = type(p).__name__
    name = getattr(fn, "__name__", None)
    if name and name != "<lambda>":
        return "{}({})".format(label, name)
    return label


def chain_name(m):
    """A (possibly fused) mapper's label: its leaves' labels in order."""
    return " . ".join(part_name(p) for p in flatten_mapper(m))


def describe_stage(stage):
    """A one-line description of a stage."""
    if isinstance(stage, GInput):
        return "input[{}]".format(type(stage.tap).__name__)
    if isinstance(stage, GMap):
        extra = ""
        if has_combiner(stage):
            extra += " +combiner"
        if stage.options.get("memory"):
            extra += " +pinned"
        if stage.options.get("barrier"):
            extra += " +barrier"
        return "map[{}]{}".format(chain_name(stage.mapper), extra)
    if isinstance(stage, GReduce):
        return "reduce[{}]".format(part_name(stage.reducer))
    if isinstance(stage, GSink):
        return "sink[{} -> {}]".format(chain_name(stage.sinker), stage.path)
    return repr(stage)


def stage_provenance(stage):
    """The descriptions of the original stages a fused node was built
    from, or None for a stage never fused."""
    return getattr(stage, "_provenance", None)


def clone_with_options(stage, options):
    """A fresh node with replaced options (shared nodes are never
    mutated: graphs are copy-on-write).  Provenance survives."""
    if isinstance(stage, GMap):
        out = GMap(stage.inputs, stage.output, stage.mapper, stage.combiner,
                   options)
    elif isinstance(stage, GReduce):
        out = GReduce(stage.inputs, stage.output, stage.reducer, options)
    elif isinstance(stage, GSink):
        out = GSink(stage.inputs, stage.output, stage.sinker, stage.path,
                    options)
    else:
        raise TypeError("cannot clone {!r}".format(stage))
    out._provenance = stage_provenance(stage)
    return out


def rebuilt(stages):
    return Graph(stages)
