"""The JAX package's leaves over the port's parameter names.

The JAX package stacks every leaf of a layer stack (``layers``; the
encoder-decoder's ``enc_layers`` and ``dec_layers``) on a leading axis of
its depth; the port keeps one tensor per layer, named
``layers.<i>.<rest>``. ``leaves`` groups the port's names into the
reference's leaves. Elementwise updates (AdamW) need none of this;
Adafactor and block quantization see a whole leaf (the RMS clip, the
factoring of a stacked [L, D] vector, blocks of 256 across layer
boundaries), and use ``gather``/``scatter`` where a leaf must be one
tensor. ``models/convert.py`` uses the same grouping to carry trees across.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch


def leaves(names: Iterable[str]) -> List[Tuple[str, bool, List[str]]]:
    """(leaf key, stacked over layers, the port's names in layer order) of
    every leaf of the reference's tree: ``layers.<i>.<rest>`` (likewise
    ``enc_layers``, ``dec_layers``) go to leaf ``layers.<rest>``."""
    stacks: Dict[str, List[Tuple[int, str]]] = {}
    out = []
    for name in names:
        parts = name.split(".")
        if len(parts) > 2 and parts[1].isdigit():
            key = ".".join(parts[:1] + parts[2:])
            if key not in stacks:
                stacks[key] = []
                out.append((key, True, stacks[key]))
            stacks[key].append((int(parts[1]), name))
        else:
            out.append((name, False, [(0, name)]))
    return [(key, stacked, [n for _, n in sorted(group)])
            for key, stacked, group in out]


def gather(named: Dict[str, torch.Tensor], stacked: bool,
           names: List[str]) -> torch.Tensor:
    """A leaf's tensor: the layers' tensors stacked on axis 0 (a copy)."""
    return torch.stack([named[n] for n in names]) if stacked else named[names[0]]


def scatter(leaf: torch.Tensor, stacked: bool,
            names: List[str]) -> Dict[str, torch.Tensor]:
    """Inverse of ``gather``: the leaf's slices by the port's names."""
    return dict(zip(names, leaf.unbind(0))) if stacked else {names[0]: leaf}
