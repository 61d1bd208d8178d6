"""The system under test, as the benchmark drives it: ``blinky_tpu_torch``'s
public entry points and nothing else of it."""

from __future__ import annotations


def session(cfg: dict, device):
    """A ``Session`` on *device* at the configuration's screen and plate
    size, with its lens, globe and zoom set by console commands."""
    from blinky_tpu_torch.api import Session

    sess = Session(cfg["width"], cfg["height"], platesize=cfg["platesize"], device=device)
    for line in ("fisheye 1", f"f_globe {cfg['globe']}", f"f_lens {cfg['lens']}",
                 f"f_fov {cfg['fov']}"):
        sess.cmd(line)
    return sess

