"""Benchmark harness (the ``timedemo`` analog): ``python -m
blinky_tpu_torch.bench`` (``__main__.py``) on the card."""

import shutil
import subprocess


def card_line():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for
    the first card, recorded beside every number the bench writes; None
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
