"""Static pipeline analysis: checked preconditions for the machinery that
would otherwise trust the user (port of ``dampr_tpu/analyze``).

Map fusion assumes purity, ``a_group_by``/``fold_by`` assume associative
folds, and device lowering needs to know which UDFs compute on lanes.
This package turns each assumption into a static verdict with evidence:

- :mod:`.props` — UDF property classifier: bytecode inspection (global/
  closure writes, I/O, ``time``/``random``/``uuid`` calls, unseeded RNG)
  giving purity and determinism verdicts with the offending
  instructions as evidence.  A callable with no visible hazard
  classifies pure/deterministic (the zero-false-positive direction).
- :mod:`.pickleprobe` — dispatch-safety probe: every closure cell and
  operator attribute must pickle; a failure names the closure variable.
- :mod:`.assoc` — fold associativity: recognized ``AssocOp`` kinds are
  associative by construction; opaque Python binops get a seeded
  algebraic probe that hunts counterexample triples.
- :mod:`.torchtrace` — the traceability probe (the JAX package's
  ``jaxtrace``): numeric map/filter chains run on ``meta`` tensors;
  chains that trace are *certified*, :mod:`..plan.lower` lowers them to
  the device, and the runner executes them as one lane program.
- :mod:`.validate` — the pre-flight plan validator: coded diagnostics
  (``DTA...``, error/warn/info) over the stage IR.
- :mod:`.lint` — ``python -m dampr_tpu_torch.analyze.lint`` and the
  ``PBase.validate()`` surface.

Master switch: ``settings.analyze`` (env ``DAMPR_TPU_TORCH_ANALYZE``;
default on).  Off, every hook is a single flag check: plans and results
are those of an engine without the analyzer.
"""

from .. import settings


def enabled():
    """Is the analysis layer in force (settings.analyze)?"""
    return settings.analyze


from .assoc import classify_binop  # noqa: E402
from .pickleprobe import probe_operator  # noqa: E402
from .props import classify_callable, stage_verdict  # noqa: E402
from .validate import (Diagnostic, PreflightError,  # noqa: E402
                       preflight_dispatch_check, report_section,
                       validate_graph)

__all__ = [
    "enabled", "classify_callable", "stage_verdict", "probe_operator",
    "classify_binop", "Diagnostic", "PreflightError", "validate_graph",
    "preflight_dispatch_check", "report_section",
]
