"""Fold-function associativity recognition (port of
``dampr_tpu/analyze/assoc.py``).

``a_group_by``/``fold_by`` decompose every fold into map-side partial
combine -> shuffle -> reduce-side final combine; the decomposition is
only correct for associative binops, and a non-associative one produces
*silently wrong* results that depend on chunking.  Three tiers:

1. **known ops**: :class:`~dampr_tpu_torch.ops.segment.AssocOp` descriptors
   with a recognized ``kind`` (sum/min/max/first/pair_sum) are
   associative by construction — the segment kernels are built on it.
2. **algebraic probe** (opaque Python binops): a randomized search for
   counterexample triples ``f(f(a,b),c) != f(a,f(b,c))`` over small int,
   float, and string samples.  A found counterexample is a *proof* of
   non-associativity (the verdict carries it); survival is only
   evidence, so the verdict stays ``"probably"`` — the validator maps
   that to an info diagnostic, never an error.
3. **unknown**: binops that reject every probe domain (they need
   user-typed operands) stay ``"unknown"``.

The probe is deterministic (fixed seed) so lint output is stable.
"""

import random


def _probe_domains():
    rnd = random.Random(0xDA17)
    ints = [rnd.randint(-40, 40) for _ in range(9)]
    floats = [rnd.uniform(-8.0, 8.0) for _ in range(9)]
    strs = ["a", "bc", "", "d", "ee", "f", "gh", "i", "jk"]
    return [ints, floats, strs]


def probe_binop(fn, triples=12):
    """Randomized associativity probe over one opaque binop.

    Returns ``(verdict, evidence)`` where verdict is ``"probably"`` (no
    counterexample over any accepting domain), ``"no"`` (counterexample
    found — evidence carries the triple), or ``"unknown"`` (every probe
    domain raised: the binop needs operand types we cannot guess)."""
    any_domain_ok = False
    for domain in _probe_domains():
        tried = 0
        for i in range(len(domain)):
            for j in range(len(domain)):
                for k in range(len(domain)):
                    if tried >= triples:
                        break
                    a, b, c = domain[i], domain[j], domain[k]
                    try:
                        left = fn(fn(a, b), c)
                        right = fn(a, fn(b, c))
                    except Exception:
                        tried = -1
                        break
                    tried += 1
                    eq = (left == right) or (
                        isinstance(left, float) and isinstance(right, float)
                        and abs(left - right) <= 1e-9 * max(
                            1.0, abs(left), abs(right)))
                    if not eq:
                        return "no", (
                            "counterexample: f(f({a!r}, {b!r}), {c!r}) = "
                            "{l!r} but f({a!r}, f({b!r}, {c!r})) = {r!r}"
                            .format(a=a, b=b, c=c, l=left, r=right))
                if tried < 0 or tried >= triples:
                    break
            if tried < 0 or tried >= triples:
                break
        if tried > 0:
            any_domain_ok = True
    if any_domain_ok:
        return "probably", ("no counterexample over {} sampled triples "
                            "(probabilistic — not a proof)".format(triples))
    return "unknown", ("binop rejected every probe domain (int/float/str) "
                      "— needs user-typed operands")


def classify_binop(binop):
    """Associativity verdict for a fold binop (raw callable or AssocOp).

    Returns ``{"assoc": "yes"|"probably"|"no"|"unknown", "kind",
    "evidence"}``."""
    from ..ops import segment

    op = segment.as_assoc_op(binop)
    if op.kind is not None:
        return {"assoc": "yes", "kind": op.kind,
                "evidence": "recognized associative kind {!r} (segment "
                            "kernel contract)".format(op.kind)}
    fn = getattr(op, "fn", None) or binop
    name = getattr(fn, "__name__", type(fn).__name__)
    # The probe EXECUTES the binop on synthetic operands — an
    # evidence-impure binop (writes an audit line, mutates external
    # state) must not perform those effects under a "static" lint.
    from . import props

    v = props.classify_callable(fn)
    if not v.pure:
        return {"assoc": "unknown", "kind": None,
                "evidence": "opaque binop {}: classified impure ({}) — "
                            "the randomized probe executes the binop and "
                            "is skipped for impure ones".format(
                                name, "; ".join(v.impure_evidence[:1]))}
    verdict, evidence = probe_binop(fn)
    return {"assoc": verdict, "kind": None,
            "evidence": "opaque binop {}: {}".format(name, evidence)}
