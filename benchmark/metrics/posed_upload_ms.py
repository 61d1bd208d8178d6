"""The posed bases' upload a call: the median, over the program's
outermost ``session.*`` spans wholly inside the traced window, of the
summed ``posed.upload`` spans inside each, in ms: the bases' cast and
copy to the device.  Bases handed in from the host take a pageable upload,
which waits for the card's queue, so it would hold the wait for the
previous calls' kernels; bases already on the device in float32 take no
copy.  None when the window holds no such span (a program without it)."""

from statistics import median

from benchmark.metrics.entry_self_ms import ENTRY

UPLOAD = "posed.upload"


def read(run):
    t = run.trace
    if t is None:
        return None
    a, b = t.window
    whole = sorted(((s.start, s.end, s.name) for s in t.spans if a <= s.start and s.end <= b),
                   key=lambda s: (s[0], -s[1]))
    uploads = [(s, e) for s, e, n in whole if n == UPLOAD]
    if not uploads:
        return None
    per_call, end = [], float("-inf")
    for s, e, n in whole:
        if n.startswith(ENTRY) and s >= end:  # an outermost entry span
            per_call.append(sum(ue - us for us, ue in uploads if s <= us and ue <= e))
            end = e
    return 1e3 * median(per_call) if per_call else None
