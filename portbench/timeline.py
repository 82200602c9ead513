"""The card's timeline in a window, from a ``torch.profiler`` Chrome trace.

Adapted from ``chip_smoke.py``'s ``card_timeline``, kept here so that the
yardstick does not move with the program.  Clocks: a profiler event's
``ts`` plus the trace's ``baseTimeNanoseconds`` / 1000 is the realtime
clock in microseconds; a span of the port's tracer (its ``trace.json``)
maps to the same clock by its ``otherData.wall_start``.  The window is
``[w0, w1]`` on that clock.
"""

import json

#: Profiler categories of work on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_events(doc):
    """``(start_us, end_us, name, cat)`` of every operation on the card,
    on the realtime clock."""
    if "baseTimeNanoseconds" not in doc:
        raise ValueError("the profiler trace has no baseTimeNanoseconds: "
                         "its clock cannot be aligned")
    base = doc["baseTimeNanoseconds"] / 1e3
    out = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        if cat in DEVICE_CATS:
            t0 = float(ev["ts"]) + base
            out.append((t0, t0 + float(ev.get("dur", 0)),
                        str(ev.get("name", "?")), cat))
    return out


def host_spans(tracer_doc):
    """``(label, start_us, end_us)`` of a port ``trace.json``'s spans on
    the realtime clock (stage spans left out: they cover everything)."""
    w0 = float(tracer_doc["otherData"]["wall_start"]) * 1e6
    return [("{}:{}".format(ev.get("cat"), ev.get("name")),
             w0 + float(ev["ts"]), w0 + float(ev["ts"]) + float(ev["dur"]))
            for ev in tracer_doc.get("traceEvents", ())
            if ev.get("ph") == "X" and ev.get("cat") != "stage"]


def reduce(events, w0, w1, spans=(), top=10):
    """The window's busy time, compute-kernel time, top operations and
    longest idle gaps (each named by the host span that overlaps it
    most)."""
    inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in events
              if min(b, w1) > max(a, w0)]
    busy = _union((a, b) for a, b, _n, _c in inside)
    busy_us = sum(b - a for a, b in busy)
    kernel_us = sum(b - a for a, b, _n, c in inside if c == "kernel")
    ops = {}
    for a, b, name, _c in inside:
        ops[name] = ops.get(name, 0.0) + (b - a)
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        over = {}
        for label, a, b in spans:
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                over[label] = over.get(label, 0.0) + ov
        label = max(over.items(), key=lambda kv: kv[1])[0] if over \
            else "no-span"
        named.append([label, (g1 - g0) / 1e6])
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": busy_us / 1e6,
            "kernel_s": kernel_us / 1e6,
            "events": len(inside),
            "device_ops": [[n[:64], us / 1e6] for n, us in top_ops],
            "idle_gaps": named}


def load(path):
    with open(path) as f:
        return json.load(f)
