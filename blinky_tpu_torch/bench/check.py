"""The performance regression gate: compare a run of the config suite with
the committed baseline.

The port of :mod:`blinky_tpu.bench.check`, with its tolerances, its
``DEVICE_MS_KEYS`` and its field policy (keys walked recursively through
each config dict):

* ``fps`` / ``*_fps`` tokens: higher is better; fail below
  ``(1 - fps_tol) * baseline``.
* ``*_ms`` / ``ms_per_*`` tokens: lower is better; fail above
  ``(1 + ms_tol) * baseline``, or ``(1 + DEVICE_MS_TOL) * baseline`` for
  the device-resident figures of ``DEVICE_MS_KEYS``.
* ``exact``: must not flip from True to False.
* ``first_*`` keys are not gated (a first call's cost is the process's
  set-up); a baseline field missing from the run, or measured as an
  ``*_error``, fails; a new field passes.

The baseline is ``bench_baseline.json`` beside this module (``{"mode":
"full"|"quick", "card": ..., "results": [...]}``), captured on the card by
``python -m blinky_tpu_torch.bench --check-update``; the JAX package's
``bench_baseline.json`` at the repository root holds TPU numbers and is
never read here.  The baseline is loaded and its mode checked before the
suite runs, so a refusal costs no measurement.
"""

from __future__ import annotations

import json
from pathlib import Path

FPS_TOL = 0.12
MS_TOL = 0.75
#: device-resident ms figures, with their own tighter ceiling
DEVICE_MS_TOL = 0.25
DEVICE_MS_KEYS = frozenset({
    "device_ms",            # config 1: the device rebuild loop
    "per_frame_ms",         # config 5: the static-ray posed loop
    "per_frame_ms_scale2",
    "ms_per_batch",         # config 7: the equirect chain
})

BASELINE_PATH = Path(__file__).resolve().parent / "bench_baseline.json"


def _walk(d, prefix=""):
    """Yield (dotted_key, leaf) for every leaf in a nested dict."""
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _walk(v, key)
        else:
            yield key, v


def _kind(key: str):
    """Classify a metric key: 'fps' (higher better), 'ms' or 'ms_device'
    (lower better), 'bool', or None (not gated).  Tokens, not suffixes:
    ``per_frame_fps_scale2`` and ``chunked_fps_1024`` are gated too."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf.startswith("first_"):
        return None
    tokens = leaf.split("_")
    if "fps" in tokens:
        return "fps"
    if leaf in DEVICE_MS_KEYS:
        return "ms_device"
    if "ms" in tokens:
        return "ms"
    if leaf == "exact":
        return "bool"
    return None


def compare_results(baseline, current, fps_tol=FPS_TOL, ms_tol=MS_TOL):
    """Compare two ``run_all`` result lists; return a list of failure
    strings (empty = the gate passes).  Configs are matched by their
    ``config`` field; a baseline value of None gates nothing."""
    failures = []
    cur_by_id = {r.get("config"): r for r in current}
    for base in baseline:
        cid = base.get("config")
        name = base.get("name", str(cid))
        cur = cur_by_id.get(cid)
        if cur is None:
            failures.append(f"config {cid} ({name}): missing from run")
            continue
        cur_leaves = dict(_walk(cur))
        for key, bval in _walk(base):
            if key in ("config", "name") or bval is None:
                continue
            kind = _kind(key)
            if kind is None:
                continue
            cval = cur_leaves.get(key)
            if cval is None:
                err = cur_leaves.get(key.replace("_fps", "_error"), "absent")
                failures.append(
                    f"config {cid} ({name}): {key} not measured ({err}); "
                    f"baseline {bval}")
                continue
            if kind == "bool":
                if bool(bval) and not bool(cval):
                    failures.append(
                        f"config {cid} ({name}): {key} flipped True -> {cval}")
            elif kind == "fps":
                floor = (1.0 - fps_tol) * float(bval)
                if float(cval) < floor:
                    failures.append(
                        f"config {cid} ({name}): {key} regressed "
                        f"{bval} -> {cval} (floor {floor:.1f}, "
                        f"-{(1 - float(cval) / float(bval)) * 100:.1f}%)")
            else:
                tol = DEVICE_MS_TOL if kind == "ms_device" else ms_tol
                ceil = (1.0 + tol) * float(bval)
                if float(cval) > ceil:
                    failures.append(
                        f"config {cid} ({name}): {key} regressed "
                        f"{bval} -> {cval} ms (ceiling {ceil:.1f}"
                        f"{', device-resident tier' if kind == 'ms_device' else ''})")
    return failures


def load_baseline(path=None):
    """``(mode, results)`` of the committed baseline."""
    path = Path(path or BASELINE_PATH)
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not committed: capture it with "
            "`python -m blinky_tpu_torch.bench --check-update` on the card")
    data = json.loads(path.read_text())
    return data["mode"], data["results"]


def save_baseline(results, mode, path=None, card=None):
    """Write the baseline; *card* is the card's name and power limit
    (``bench.card_line``), recorded beside the numbers."""
    path = Path(path or BASELINE_PATH)
    path.write_text(json.dumps({"mode": mode, "card": card, "results": results},
                               indent=1) + "\n")
    return path


def _mismatch(base_mode, mode, hint):
    print(json.dumps({"metric": "bench_check", "status": "mode-mismatch",
                      "baseline_mode": base_mode, "run_mode": mode, "hint": hint}))
    return 2


def run_check(quick=False, update=False, fps_tol=FPS_TOL, ms_tol=MS_TOL, only=None, *,
              device="cuda"):
    """Entry of ``--check[-update] [--configs 0,2,5-7]``.  Returns the
    process's exit code; prints one JSON line a config and the verdict.

    ``only`` restricts the run to a subset of configs: the comparison then
    gates only those, and an update merges them into the committed baseline
    (the others kept as they are).  A full update replaces the baseline.
    The baseline is read, and its mode checked, before any measurement."""
    from blinky_tpu_torch.bench import card_line, configs

    mode = "quick" if quick else "full"
    baseline = None
    if not update or only is not None:
        base_mode, baseline = load_baseline()
        if base_mode != mode:
            hint = ("a partial --check-update merges into the committed baseline; "
                    "modes must match" if update
                    else "re-run with the baseline's mode or --check-update")
            return _mismatch(base_mode, mode, hint)
    results = configs.run_all(quick=quick, only=only, device=device)
    for r in results:
        print(json.dumps(r))
    if update:
        if only is not None:
            new_by_id = {r.get("config"): r for r in results}
            results = [new_by_id.pop(b.get("config"), b) for b in baseline]
            results.extend(new_by_id.values())  # brand-new configs append
        path = save_baseline(results, mode, card=card_line())
        print(json.dumps({"metric": "bench_check", "status": "updated",
                          "baseline": str(path), "mode": mode,
                          "configs": sorted(r.get("config") for r in results)}))
        return 0
    if only is not None:
        sel = set(only)
        baseline = [b for b in baseline if b.get("config") in sel]
    failures = compare_results(baseline, results, fps_tol=fps_tol, ms_tol=ms_tol)
    print(json.dumps({
        "metric": "bench_check",
        "status": "fail" if failures else "pass",
        "failures": failures,
        "fps_tol": fps_tol, "ms_tol": ms_tol,
    }))
    return 1 if failures else 0
