"""The program's spans in a traced slice, matched to the device operations
launched inside their host interval from any thread.

`program_spans.py` matches a span to the runtime calls made on its own
thread. The training step's backward runs on autograd's own thread, so its
launches fall outside that match although they happen inside the span's
host interval (the span waits for them: `backward()` returns once they
are launched). Here a device operation belongs to a span when the runtime
call that launched it (matched by `args.correlation`) starts inside the
span's host interval, on any thread; and a runtime call belongs to it when
it starts there. Spans of one name must not overlap in time, and a range
of another thread that overlaps them would be counted with them, so this
is for spans that run one at a time, as the training step's do.
"""

from __future__ import annotations

import bisect
import functools
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from benchmark.program_spans import DEVICE, LAUNCHERS, SYNCS


class Span(NamedTuple):
    start: float
    end: float
    calls: List[dict]        # runtime calls started inside, any thread
    device_ops: List[dict]   # the device operations they launched


@functools.lru_cache(maxsize=1)
def _index(sl) -> Dict[str, List[Span]]:
    events = sl._events
    t0, t1 = sl._bounds
    by_corr: Dict[int, List[dict]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat", "").lower() in DEVICE \
                and "correlation" in e.get("args", {}):
            by_corr[e["args"]["correlation"]].append(e)
    calls = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat", "").lower() in LAUNCHERS),
                   key=lambda e: e["ts"])
    starts = [e["ts"] for e in calls]
    out: Dict[str, List[Span]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or \
                e.get("cat", "").lower() != "user_annotation" or \
                not t0 <= e["ts"] <= t1:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        inside = calls[bisect.bisect_left(starts, a):
                       bisect.bisect_right(starts, b)]
        ops = [d for c in inside
               for d in by_corr.get(c.get("args", {}).get("correlation"), ())]
        out[e["name"]].append(Span(a, b, inside, ops))
    return dict(out)


def spans(ctx, name: str) -> List[Span]:
    """The slice's spans `name` (none without a slice)."""
    sl = ctx.get("slice")
    if sl is None:
        return []
    return _index(sl).get(name, [])


def device_ms_per_call(ctx, name: str) -> Optional[float]:
    """Summed device time (ms) of the operations launched inside the
    span's ranges, per call of the slice; None where no range launched
    anything."""
    rs = spans(ctx, name)
    ops = [d for r in rs for d in r.device_ops]
    if not ops:
        return None
    return sum(d.get("dur", 0) for d in ops) * 1e-3 / ctx["slice"].calls


def syncs_per_call(ctx, names) -> Optional[float]:
    """Host-blocking runtime calls started inside the ranges of `names`,
    per call of the slice; None where none of them has a range."""
    rs = [r for n in names for r in spans(ctx, n)]
    if not rs:
        return None
    n = sum(c["name"] in SYNCS for r in rs for c in r.calls)
    return n / ctx["slice"].calls
