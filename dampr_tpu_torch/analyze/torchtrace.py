"""The traceability probe on torch: certify numeric map/filter chains as
device lane programs.  Port of ``dampr_tpu/analyze/jaxtrace.py``, whose
name it cannot keep: it traces with torch.

``chain_claims`` inspects a (possibly fused) mapper chain: every leaf
must be a value-wise RecordOp (``ValueMap``/``Filter``, an optional
trailing ``Rekey``; identity links drop out), every UDF must classify
pure + deterministic (:mod:`.props`), and every UDF must *trace*: called
on an ``(8,)`` tensor on torch's ``meta`` device (shapes and dtypes, no
data), it must return an elementwise result (same shape; numeric out for
maps, bool/integer out for filters) without a data-dependent branch or
a conversion to a Python number.  The JAX package abstract-evaluates
with ``jax.eval_shape`` over a ``ShapeDtypeStruct`` lane to the same
end.  A chain that passes is **certified**: :mod:`..plan.lower` assigns
it ``exec_target="device"`` and the runner executes it as one vectorized
lane program instead of per-record Python.

Execution semantics (the exactness contract, the JAX package's):

- The authoritative result is the **vectorized host evaluation** of the
  same certified program in numpy over the lane upcast to 64-bit —
  element-for-element what the per-record Python path computes (records
  box to Python int/float, i.e. 64-bit, on the host path).  Masks apply
  at the end: a certified elementwise op applied to a record a prior
  filter dropped cannot change surviving records.
- The **device dispatch** runs the same chain, the user's own functions,
  on a tensor on ``settings.resolve_device()`` and is *verified per
  batch* against the host evaluation; a mismatch keeps the host result
  and counts ``device_mismatch``.  The card computes int64 and float64
  natively, so every integer and float lane dispatches (the JAX package
  dispatches int32 lanes that fit, and no float lane, with x64 off).
  The lane goes unpadded: eager torch has no compiled shape buckets.
- Residual risk, documented: Python ints are arbitrary-precision and
  int64 lane arithmetic wraps where per-record Python would grow a
  bignum.  The first batch of every lowered stage's job is additionally
  differential-tested against the per-record path by the runner.

A UDF written against the NumPy/JAX array API (``.astype``, ``jnp.*``,
``round()`` of the lane) certifies in the JAX package and not here: a
torch tensor has none of them, so the port keeps that chain on the host,
with equal results.

The report strings (``chain_claims``' reasons, the ``DTA501`` evidence)
are the JAX package's word for word, so the two packages' plan reports
and diagnostics compare equal.
"""

import collections
import itertools
import logging
import threading
import weakref

import numpy as np

from .. import settings

log = logging.getLogger("dampr_tpu_torch.analyze.torchtrace")

_CERT_LOCK = threading.Lock()
_CERT_CACHE = weakref.WeakKeyDictionary()  # f -> {"map": ok, "filter": ok,
#                                                "why_map": str, ...}

#: Lane dtypes the vectorized executor accepts (what Python-built blocks
#: actually carry, plus the narrow lanes block mappers emit).
_LANE_DTYPES = ("int64", "int32", "float64", "float32")


def _numpy_kind(dtype):
    """numpy's one-letter kind of a torch dtype ('b', 'i', 'u', 'f', 'c')."""
    import torch

    if dtype == torch.bool:
        return "b"
    if dtype.is_complex:
        return "c"
    if dtype.is_floating_point:
        return "f"
    return "u" if dtype == torch.uint8 else "i"


def _eval_ok(f, dtype, kind):
    """Call ``f`` on an (8,) meta tensor of ``dtype``; returns None on
    success or the reason string.  A ``"value"`` UDF may also return a
    Python or numpy scalar (``count()``'s ``lambda v: 1``), taken as a 0-d
    result as JAX's ``()`` shape is."""
    import torch

    try:
        out = f(torch.empty(8, dtype=dtype, device="meta"))
    except Exception as e:  # noqa: BLE001 - any trace failure is the answer
        return "{}: {}".format(type(e).__name__, str(e)[:160])
    if isinstance(out, torch.Tensor):
        shape, okind = tuple(out.shape), _numpy_kind(out.dtype)
        oname = str(out.dtype).replace("torch.", "")
    elif kind == "value" and isinstance(out, (bool, int, float, np.generic)):
        arr = np.asarray(out)
        shape, okind, oname = arr.shape, arr.dtype.kind, str(arr.dtype)
    else:
        return "not elementwise: input (8,) -> output {!r}".format(
            getattr(out, "shape", type(out).__name__))
    ok_shapes = (((8,), ()) if kind == "value" else ((8,),))
    if shape not in ok_shapes:
        return "not elementwise: input (8,) -> output {!r}".format(shape)
    if kind == "filter":
        if okind not in ("b", "i", "u"):
            return "filter predicate traced to dtype {} (need bool/int)" \
                .format(oname)
    elif okind not in ("i", "u", "f", "b"):
        return "map traced to non-numeric dtype {}".format(oname)
    return None


def certify_callable(f, kind):
    """Is ``f`` traceable as an elementwise lane ``kind`` ("map" /
    "filter" / "value")?  Returns ``(ok, why)``; cached per function
    object."""
    import torch

    with _CERT_LOCK:
        try:
            hit = _CERT_CACHE.get(f)
        except TypeError:
            hit = None  # unweakrefable callable (e.g. __slots__)
        if hit is not None and kind in hit:
            return hit[kind], hit.get("why_" + kind, "")
    reasons = []
    ok = False
    for dt in (torch.int32, torch.float32):
        why = _eval_ok(f, dt, kind)
        if why is None:
            ok = True
        else:
            reasons.append(why)
    why = "" if ok else "; ".join(reasons[:1])
    try:
        with _CERT_LOCK:
            entry = _CERT_CACHE.setdefault(f, {})
            entry[kind] = ok
            entry["why_" + kind] = why
    except TypeError:
        pass  # unweakrefable callable: skip the cache
    return ok, why


class ChainSpec(object):
    """A certified chain: ordered ``(kind, f)`` lane ops, plus an
    optional trailing re-key — ``rekey`` is ``(key_f, value_f_or_None)``
    when the chain ends in a certified ``Rekey`` (the re-key every
    ``fold_by``/``count``/``a_group_by`` plants), so a numeric chain can
    feed a keyed fold without leaving the lane program."""

    __slots__ = ("ops", "names", "rekey")

    def __init__(self, ops, names, rekey=None):
        self.ops = ops
        self.names = names
        self.rekey = rekey

    def describe(self):
        return " . ".join(self.names)


def chain_claims(mapper, classify=True):
    """``(ChainSpec, reason)`` when the mapper chain is a certified
    numeric chain, else ``(None, reason)``.

    ``classify=False`` skips the purity/determinism gate (callers that
    already ran :func:`props.stage_verdict`)."""
    from .. import base
    from ..plan import ir
    from . import props

    def _gate(f, kind):
        """Classify + certify one UDF; returns the reason or None."""
        if classify:
            v = props.classify_callable(f)
            if not v.pure:
                return "UDF {} impure: {}".format(
                    props.callable_name(f), "; ".join(v.impure_evidence))
            if not v.deterministic:
                return "UDF {} nondeterministic: {}".format(
                    props.callable_name(f), "; ".join(v.nondet_evidence))
        ok, why = certify_callable(f, kind)
        if not ok:
            return "UDF {} not traceable: {}".format(
                props.callable_name(f), why)
        return None

    ops = []
    names = []
    rekey = None
    for leaf in ir.flatten_mapper(mapper):
        if type(leaf) is base.Map and leaf.mapper is base._identity:
            continue
        if rekey is not None:
            return None, "op {} follows the re-key — only a TRAILING " \
                "Rekey certifies (records leave the value lane there)" \
                .format(type(leaf).__name__)
        if type(leaf) is base.ValueMap:
            kind = "map"
        elif type(leaf) is base.Filter:
            kind = "filter"
        elif type(leaf) is base.Rekey:
            # Trailing re-key (fold_by/count/a_group_by): the key fn —
            # and the value fn when present — certify as elementwise
            # numeric maps over the value lane, so (key_f(v),
            # value_f(v)) records build from two lanes of one program.
            why = _gate(leaf.key_f, "map")
            if why is not None:
                return None, "re-key " + why
            if leaf.value_f is not None:
                # "value" admits scalar outputs too (count()'s constant
                # ``lambda v: 1`` broadcasts over the lane).
                why = _gate(leaf.value_f, "value")
                if why is not None:
                    return None, "re-key value " + why
            rekey = (leaf.key_f, leaf.value_f)
            names.append("Rekey[{}]".format(
                props.callable_name(leaf.key_f)))
            continue
        else:
            return None, "op {} outside the certified lane vocabulary " \
                "(ValueMap/Filter + trailing Rekey)".format(
                    type(leaf).__name__)
        f = leaf.f
        why = _gate(f, kind)
        if why is not None:
            return None, why
        ops.append((kind, f))
        names.append("{}[{}]".format(type(leaf).__name__,
                                     props.callable_name(f)))
    if not ops and rekey is None:
        return None, "identity chain (nothing to lower)"
    return ChainSpec(ops, names, rekey=rekey), \
        "certified jax-traceable numeric chain: " + " . ".join(names)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

class ChainProgram(object):
    """Executable form of a certified chain, with per-program counters
    (surfaced in stats / tests).  One program is shared by every
    concurrent map job of its stage."""

    def __init__(self, spec):
        self.spec = spec
        self.counters = {"batches": 0, "device_dispatched": 0,
                         "device_verified": 0, "device_mismatch": 0,
                         "host_vectorized": 0, "fallback": 0,
                         "diff_checked": 0, "diff_diverged": 0}
        self._lock = threading.Lock()
        self._local = threading.local()  # this thread's CUDA stream

    def count(self, key, n=1):
        """Locked counter bump: ``+=`` is a lost-update race across the
        stage's job threads."""
        with self._lock:
            self.counters[key] += n

    # -- host (authoritative) evaluation ------------------------------------
    def run_host(self, vals):
        """Vectorized 64-bit evaluation: ``(keys_or_None, out_vals,
        mask_or_None)``.  ``vals`` is a 1-D numeric numpy array; ``keys``
        is the re-key lane when the chain ends in a certified Rekey."""
        if vals.dtype.kind == "i":
            cur = vals.astype(np.int64, copy=False)
        else:
            cur = vals.astype(np.float64, copy=False)
        mask = None
        keys = None
        # divide/invalid RAISE: numpy would silently emit inf/nan where
        # the authoritative per-record Python path raises
        # ZeroDivisionError — the FloatingPointError lands in
        # run_batch's fallback except, so the batch re-runs per-record
        # and surfaces the genuine exception.  Overflow/underflow stay
        # IEEE-silent, matching Python floats.
        with np.errstate(divide="raise", invalid="raise",
                         over="ignore", under="ignore"):
            for kind, f in self.spec.ops:
                if kind == "map":
                    cur = np.asarray(f(cur))
                else:
                    m = np.asarray(f(cur))
                    m = m if m.dtype == bool else (m != 0)
                    mask = m if mask is None else (mask & m)
            if self.spec.rekey is not None:
                key_f, value_f = self.spec.rekey
                keys = np.asarray(key_f(cur))
                if value_f is not None:
                    cur = np.asarray(value_f(cur))
                    if cur.ndim == 0:  # constant value fn (count())
                        cur = np.broadcast_to(cur, keys.shape).copy()
        return keys, cur, mask

    # -- device dispatch -----------------------------------------------------
    def device_program(self, lane):
        """The chain on a tensor ``lane``: ``(keys_or_None, values,
        mask)``, all on ``lane``'s device.  The ops are the user's own
        functions, each an eager torch call (the counterpart of the JAX
        package's ``jax.jit`` of the same functions)."""
        import torch

        cur = lane
        mask = None
        for kind, f in self.spec.ops:
            if kind == "map":
                cur = f(cur)
            else:
                m = f(cur)
                m = m if m.dtype == torch.bool else m != 0
                mask = m if mask is None else mask & m
        if mask is None:
            mask = torch.ones(lane.shape, dtype=torch.bool,
                              device=lane.device)
        keys = None
        if self.spec.rekey is not None:
            key_f, value_f = self.spec.rekey
            keys = key_f(cur)
            if value_f is not None:
                cur = torch.as_tensor(value_f(cur), device=lane.device) \
                    .broadcast_to(keys.shape)
        return keys, cur, mask

    def _stream(self, dev):
        """This thread's side stream on ``dev`` (None off CUDA): a
        dispatch never queues behind, or on, another thread's stream (the
        device sink's among them)."""
        if dev.type != "cuda":
            return None
        import torch

        held = getattr(self._local, "stream", None)
        if held is None or held[0] != dev:
            held = (dev, torch.cuda.Stream(dev))
            self._local.stream = held
        return held[1]

    def run_device(self, vals, ddt):
        """Copy ``vals`` (as ``ddt``) to the device, run the chain there
        and copy the three lanes back: ``(keys_or_None, values, mask)`` as
        numpy arrays.  One stream per thread; the copy back is the only
        synchronisation."""
        import contextlib

        import torch

        dev = settings.resolve_device()
        s = self._stream(dev)
        with (torch.cuda.stream(s) if s is not None
              else contextlib.nullcontext()):
            lane = torch.from_numpy(vals.astype(ddt, copy=False)).to(dev)
            okeys, out, omask = self.device_program(lane)
            out = out.cpu().numpy()
            omask = omask.cpu().numpy()
            if okeys is not None:
                okeys = okeys.cpu().numpy()
        return okeys, out, omask

    @staticmethod
    def _device_dtype(vals):
        """The dtype the device program computes in, or None when the lane
        has none: int64 for integers and float64 for floats, which the
        card computes natively (the JAX package's gate on x64 and the
        int32 range has no counterpart here)."""
        k = vals.dtype.kind
        if k == "i":
            return np.dtype(np.int64)
        if k == "f":
            return np.dtype(np.float64)
        return None

    def run_batch(self, ks, vs):
        """Execute the chain over one record batch (parallel Python
        lists — the batched-UDF protocol).  Returns ``(keys_out,
        values_out)`` as plain Python lists with the filter mask
        applied, or None when the batch is outside the vectorized
        contract (non-numeric lane, a UDF that rejects array input,
        non-elementwise output) — the caller falls back to the
        per-record path, which is always authoritative."""
        try:
            vals = np.asarray(vs)
        except Exception:  # noqa: BLE001 - mixed/unconvertible values
            self.count("fallback")
            return None
        if vals.ndim != 1 or vals.dtype.name not in _LANE_DTYPES \
                or vals.dtype.hasobject:
            self.count("fallback")
            return None
        try:
            host_keys, host_vals, mask = self.run_host(vals)
            host_vals = np.asarray(host_vals)
        except Exception:  # noqa: BLE001 - the UDF rejected the lane form
            self.count("fallback")
            return None
        if host_vals.ndim != 1 or len(host_vals) != len(vals) \
                or host_vals.dtype.hasobject:
            self.count("fallback")
            return None
        if self.spec.rekey is not None and (
                host_keys is None or host_keys.ndim != 1
                or len(host_keys) != len(vals)
                or host_keys.dtype.hasobject):
            self.count("fallback")
            return None
        self.count("batches")
        ddt = (self._device_dtype(vals)
               if settings.use_device_for(len(vals)) else None)
        if ddt is not None:
            try:
                self._dispatch_and_verify(vals, ddt, host_keys,
                                          host_vals, mask)
            except Exception as e:  # noqa: BLE001 - host result stands
                self.count("device_mismatch")
                log.debug("device chain dispatch failed (%s); host "
                          "vectorized result stands", e)
        else:
            self.count("host_vectorized")
        out_vals = host_vals.tolist()
        out_ks = (host_keys.tolist() if host_keys is not None
                  else list(ks))
        if mask is None:
            return out_ks, out_vals
        keep = mask.tolist()
        return (list(itertools.compress(out_ks, keep)),
                list(itertools.compress(out_vals, keep)))

    def _dispatch_and_verify(self, vals, ddt, host_keys, host_vals,
                             mask):
        from ..obs import trace as _trace
        from ..ops import devtime

        n = len(vals)
        with _trace.span("device", "numeric-chain", records=n):
            with devtime.track("device"):
                okeys, out, omask = self.run_device(vals, ddt)
        self.count("device_dispatched")
        hmask = (np.ones(n, dtype=bool) if mask is None else mask)

        def _up(a, ref):
            return a.astype(np.int64 if ref.dtype.kind == "i"
                            else np.float64)

        verified = (np.array_equal(omask, hmask) and np.array_equal(
            _up(out, host_vals)[hmask], host_vals[hmask]))
        if verified and host_keys is not None:
            verified = okeys is not None and np.array_equal(
                _up(okeys, host_keys)[hmask], host_keys[hmask])
        if verified:
            self.count("device_verified")
        else:
            self.count("device_mismatch")
            log.debug("device chain result mismatched the 64-bit host "
                      "evaluation; host result stands (exactness gate)")


#: Chain-identity -> ChainProgram.  Stage nodes are slotted (no weakrefs)
#: so programs key on the ordered (kind, id(f)) chain identity; each
#: entry holds strong refs to its UDFs (via the spec), which keeps the
#: ids valid for exactly as long as the entry lives.  LRU-bounded: a
#: long-lived process constructing fresh lambdas per run cannot grow it
#: without bound, and an evicted entry only costs fresh counters.
_PROGRAMS = collections.OrderedDict()
_PROGRAMS_CAP = 256
_PROG_LOCK = threading.Lock()


def _chain_key(spec):
    """Cache key for one certified chain.  The trailing re-key is part
    of the program identity: two bare ``fold_by``/``count`` chains have
    identical (empty) lane ops but different key/value functions — an
    ops-only key would hand the second stage the first one's program."""
    key = tuple((kind, id(f)) for kind, f in spec.ops)
    if spec.rekey is not None:
        key_f, value_f = spec.rekey
        key += (("rekey", id(key_f),
                 id(value_f) if value_f is not None else None),)
    return key


def stage_program(stage):
    """Cached :class:`ChainProgram` for a certified stage (None when the
    stage's chain does not certify — the runner re-checks so a stale
    ``exec_target`` annotation can never dispatch an unknown op)."""
    spec, _why = chain_claims(stage.mapper)
    if spec is None:
        return None
    key = _chain_key(spec)
    with _PROG_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = ChainProgram(spec)
            _PROGRAMS[key] = prog
        else:
            _PROGRAMS.move_to_end(key)
        while len(_PROGRAMS) > _PROGRAMS_CAP:
            _PROGRAMS.popitem(last=False)
    return prog
