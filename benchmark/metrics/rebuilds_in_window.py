"""Rebuilds inside the traced window: the number of the program's
``build.*`` spans (a lensmap, a kernel object, host tables, a library) that
start in it, nested ones each counted.  None when the window holds none of
the program's ``session.*`` spans (a program without spans)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    a, b = t.window
    starts = [s.name for s in t.spans if a <= s.start < b]
    if not any(n.startswith("session.") for n in starts):
        return None
    return sum(n.startswith("build.") for n in starts)
