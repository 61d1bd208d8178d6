"""The closed loop of the batch cells: one caller renders the ring's seeded
batches in turn, no sync between calls but at the window's end, and a
seeded sample of the window's outputs is kept for the check."""

from __future__ import annotations

from benchmark import sources


def step(run):
    st = run.state
    if run.calls == 0:
        st["sample"] = sources.Reservoir(run.mix["check_sample"], run.seed)
    slot = run.calls % len(st["src"])
    with run.spans("bench.render"):
        out = st["render"](st["src"][slot])
    st["sample"].offer((slot, out))
    run.calls += 1
    run.screens += out.shape[-1]


def drain(run):
    run.synchronize()


def release(run) -> list:
    """Free the program's state before the reference runs; returns the kept
    (ring slot, output) pairs."""
    st = run.state
    st.pop("session", None)
    st.pop("render", None)
    kept = list(st.pop("sample").items.values())
    if run.device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    return kept
