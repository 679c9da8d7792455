"""The card a run measures: the check that it is there, the build and
kernel caches kept inside the checkout, and the description each result
carries."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

import torch

from portbench.harness.spec import ROOT


class NoCard(Exception):
    """The run asked for more cards than this machine has."""


def require_cards(n: int) -> None:
    """Raise unless ``n`` CUDA devices are visible: a measurement never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: no card to measure")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} cards, torch sees {have}")


def cache_dirs(root: Path = ROOT) -> None:
    """Keep every kernel cache at a fixed path inside the checkout, so that
    only the first run of a cell there builds. The port's nvcc builds go to
    ``build/repro_torch_kernels`` (fixed by ``repro_torch/kernels/_build.py``
    relative to the checkout); Triton's and inductor's caches, should any
    library reach them, go beside it."""
    base = root / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(base / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")


def describe(chips: int, memory_peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak_bytes)}


def power_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them, for
    the record beside every number (None where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None
