"""The device an entry point runs on: the card unless the caller asks for
the CPU, and an error, not a quiet move to the CPU, when a card is asked
for and there is none."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(name)!r} asked for, but "
                           "torch.cuda.is_available() is False")
    return device


def synchronize(device: torch.device):
    """Wait for the card, so a host clock read after this sees finished work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
