"""Plan-level views over a Graph (port of the helpers of
``dampr_tpu/plan/ir.py`` that the lowering pass, the combiner hoist and
the run's stage stats use).  The port does not fuse mappers yet, so a
stage's mapper is always one leaf."""

from .. import base
from ..graph import GInput, GMap, GReduce, GSink


def is_identity_mapper(m):
    """True for the identity record map (a combiner or sink head)."""
    return type(m) is base.Map and m.mapper is base._identity


def has_combiner(stage):
    return (getattr(stage, "combiner", None) is not None
            or "binop" in (getattr(stage, "options", None) or {}))


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


def clone_with_options(stage, options):
    """A fresh node with replaced options (shared nodes are never
    mutated: graphs are copy-on-write)."""
    if isinstance(stage, GMap):
        return GMap(stage.inputs, stage.output, stage.mapper,
                    stage.combiner, options)
    if isinstance(stage, GReduce):
        return GReduce(stage.inputs, stage.output, stage.reducer, options)
    if isinstance(stage, GSink):
        return GSink(stage.inputs, stage.output, stage.sinker, stage.path,
                     options)
    raise TypeError("cannot clone {!r}".format(stage))
