"""JSON structural parsing as a vectorized torch kernel (paper §IV-B).

The port of ``src/repro/tasks/jsonparse.py``. The paper parses the json.org
"widget" example (~600 bytes) with RapidJSON, a ~1.1 µs task. The vector
translation is simdjson's stage 1: classify bytes, resolve in-string spans
with a prefix parity over unescaped quotes, extract structural characters,
and validate nesting depth with a prefix sum.

The reference finds escaped bytes with a sequential ``lax.scan`` over
backslash runs. Here it is one vectorised pass: a running maximum of the
last position that is not a backslash gives, at every byte, the length of
the backslash run ending there, and a byte is escaped when the run just
before it is odd. Every operation takes leading batch dimensions.

``parse_structural`` returns (structural mask, depth array, ok flag); the
oracle is Python's json module on the same bytes (``oracle_counts``,
unchanged from the reference).
"""

from __future__ import annotations

import json

import numpy as np
import torch

# The json.org example document the paper uses (its "widget" sample).
WIDGET_JSON = json.dumps({
    "widget": {
        "debug": "on",
        "window": {
            "title": "Sample Konfabulator Widget",
            "name": "main_window", "width": 500, "height": 500},
        "image": {
            "src": "Images/Sun.png", "name": "sun1",
            "hOffset": 250, "vOffset": 250, "alignment": "center"},
        "text": {
            "data": "Click Here", "size": 36, "style": "bold",
            "name": "text1", "hOffset": 250, "vOffset": 100,
            "alignment": "center",
            "onMouseUp": "sun1.opacity = (sun1.opacity / 100) * 90;"},
    }
})


def to_bytes(doc: str, *, device="cuda") -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(doc.encode("utf-8"), np.uint8).copy(),
                           device=device)


def escaped_bytes(backslash: torch.Tensor) -> torch.Tensor:
    """escaped[i]: an odd run of backslashes ends just before i."""
    idx = torch.arange(backslash.shape[-1], device=backslash.device)
    last_plain = torch.where(backslash, -1, idx).cummax(dim=-1).values
    run = idx - last_plain          # backslashes ending at i (0 if none)
    escaped = torch.zeros_like(backslash)
    escaped[..., 1:] = (run[..., :-1] % 2) == 1
    return escaped


def parse_structural(buf: torch.Tensor):
    """buf: uint8[..., n] -> (structural bool[..., n], depth int32[..., n],
    ok bool[...])."""
    bs = buf
    quote = bs == ord('"')
    real_quote = quote & ~escaped_bytes(bs == ord("\\"))

    # in-string mask: prefix parity of real quotes, exclusive.
    rq = real_quote.to(torch.int32)
    qcum = torch.cumsum(rq, dim=-1, dtype=torch.int32)
    in_string = ((qcum - rq) % 2) == 1

    structural_chars = (
        (bs == ord("{")) | (bs == ord("}")) |
        (bs == ord("[")) | (bs == ord("]")) |
        (bs == ord(":")) | (bs == ord(","))
    )
    structural = (structural_chars & ~in_string) | real_quote

    opens = ((bs == ord("{")) | (bs == ord("["))) & ~in_string
    closes = ((bs == ord("}")) | (bs == ord("]"))) & ~in_string
    depth = torch.cumsum(opens.to(torch.int32) - closes.to(torch.int32),
                         dim=-1, dtype=torch.int32)

    balanced = depth[..., -1] == 0
    non_negative = torch.all(depth >= 0, dim=-1)
    quotes_closed = (qcum[..., -1] % 2) == 0
    ok = balanced & non_negative & quotes_closed
    return structural, depth, ok


def oracle_counts(doc: str) -> dict:
    """Reference structural statistics computed with Python's json + a
    character walk (test oracle)."""
    json.loads(doc)  # raises if invalid
    in_str = False
    esc = False
    structural = 0
    max_depth = 0
    depth = 0
    for ch in doc:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
                structural += 1
            continue
        if ch == '"':
            in_str = True
            structural += 1
        elif ch in "{}[]:,":
            structural += 1
            if ch in "{[":
                depth += 1
                max_depth = max(max_depth, depth)
            elif ch in "}]":
                depth -= 1
    return {"structural": structural, "max_depth": max_depth}
