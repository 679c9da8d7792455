"""The paper's JSON structural-parse workload (§IV-B).

The port of ``src/repro/workloads/jsondoc.py``.

Each instance runs :func:`repro_torch.tasks.jsonparse.parse_structural` (the
simdjson-stage-1 translation) on its own copy of the json.org "widget"
document. The oracle cross-checks against
:func:`repro_torch.tasks.jsonparse.oracle_counts` — Python's ``json`` module
plus a character walk, fully independent of the kernel.

Like every workload, inherits the skewed power-law cost dimension
(``skew=``/``skew_seed=``) from :class:`repro_torch.workloads.base.Workload`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tasks import jsonparse
from repro_torch.workloads.base import (Workload, WorkloadOracleError,
                                        register_workload, to_numpy)


@register_workload
class JsonParseWorkload(Workload):
    name = "json"
    doc = jsonparse.WIDGET_JSON
    #: byte-chunk granularity of the streamed variant (~600-byte doc ->
    #: ~10 chunks per instance)
    stream_chunk = 64

    def _input(self) -> torch.Tensor:
        return jsonparse.to_bytes(self.doc, device="cpu")

    def _kernel(self, buf: torch.Tensor) -> Any:
        return jsonparse.parse_structural(buf)

    def _stream_stages(self, stages=None):
        """The jsondoc byte-chunk stream: each instance's document is cut
        into ``stream_chunk``-byte chunks flowing through two stages —

        1. **classify** (stateless, vectorized): per-byte class masks
           (quote / backslash / open / close / structural-char), NumPy on
           the chunk.
        2. **scan** (stateful, sequential): the simdjson stage-1 carries —
           backslash run parity, real-quote prefix parity, nesting depth,
           depth-nonnegativity — threaded across chunks exactly as
           :func:`repro_torch.tasks.jsonparse.parse_structural` computes them on
           the whole buffer. The carry lives in the stage and resets at
           each instance's chunk 0, so correctness *requires* the linear
           pipeline's FIFO order — which is the property worth testing.

        Items are instance-major ``(instance, chunk_idx, n_chunks,
        bytes)``; ``_stream_collect`` concatenates each instance's chunks
        back into the ``(structural, depth, ok)`` triple the standard
        oracle checks. Ignores ``skew`` (the decomposition replaces the
        repeat knob). Never run the scan stage inside a Farm: workers
        would race the carry and break chunk order."""
        if stages not in (None, 2):
            raise ValueError(
                f"workload {self.name!r} streams as classify->scan (2 "
                f"stages); got stages={stages}")
        data = self.doc.encode("utf-8")
        chunk = self.stream_chunk
        chunks = [data[o:o + chunk] for o in range(0, len(data), chunk)]
        nc = len(chunks)
        items = [(i, c, nc, payload)
                 for i in range(self.n_instances)
                 for c, payload in enumerate(chunks)]

        def classify(item):
            i, c, nc, payload = item
            bs = np.frombuffer(payload, np.uint8)
            return (i, c, nc, {
                "quote": bs == ord('"'),
                "backslash": bs == ord("\\"),
                "opens": (bs == ord("{")) | (bs == ord("[")),
                "closes": (bs == ord("}")) | (bs == ord("]")),
                "structural_chars": ((bs == ord("{")) | (bs == ord("}")) |
                                     (bs == ord("[")) | (bs == ord("]")) |
                                     (bs == ord(":")) | (bs == ord(","))),
            })

        carry = {"run": 0, "qpar": 0, "depth": 0, "neg": False}

        def scan(item):
            i, c, nc, m = item
            if c == 0:       # new instance: reset the cross-chunk carries
                carry.update(run=0, qpar=0, depth=0, neg=False)
            quote = m["quote"]
            backslash = m["backslash"]
            opens = m["opens"]
            closes = m["closes"]
            schars = m["structural_chars"]
            n = len(quote)
            structural = np.zeros(n, bool)
            depth = np.empty(n, np.int32)
            run, qpar = carry["run"], carry["qpar"]
            d, neg = carry["depth"], carry["neg"]
            for j in range(n):
                esc = (run % 2) == 1           # odd backslash run before j
                run = run + 1 if backslash[j] else 0
                rq = quote[j] and not esc      # real (unescaped) quote
                in_str = qpar == 1             # parity of real quotes < j
                if rq:
                    qpar ^= 1
                structural[j] = (schars[j] and not in_str) or rq
                if opens[j] and not in_str:
                    d += 1
                elif closes[j] and not in_str:
                    d -= 1
                    if d < 0:
                        neg = True
                depth[j] = d
            carry.update(run=run, qpar=qpar, depth=d, neg=neg)
            ok = None
            if c == nc - 1:                    # document verdict on the tail
                ok = (d == 0) and (not neg) and (qpar == 0)
            return (i, c, structural, depth, ok)

        return items, [classify, scan]

    def _stream_collect(self, outputs):
        nc = len(outputs) // self.n_instances
        results = []
        for i in range(self.n_instances):
            recs = outputs[i * nc:(i + 1) * nc]
            assert all(r[0] == i for r in recs), "chunk stream misordered"
            structural = np.concatenate([r[2] for r in recs])
            depth = np.concatenate([r[3] for r in recs])
            results.append((structural, depth, np.bool_(recs[-1][4])))
        return results

    def check_one(self, result: Any) -> None:
        structural, depth, ok = result
        expected = jsonparse.oracle_counts(self.doc)
        if not bool(ok):
            raise WorkloadOracleError("json: kernel flagged a valid document")
        got_structural = int(to_numpy(structural).sum())
        if got_structural != expected["structural"]:
            raise WorkloadOracleError(
                f"json: {got_structural} structural chars, oracle says "
                f"{expected['structural']}")
        depth_np = to_numpy(depth)
        if int(depth_np.max()) != expected["max_depth"]:
            raise WorkloadOracleError(
                f"json: max depth {int(depth_np.max())}, oracle says "
                f"{expected['max_depth']}")
        if int(depth_np[-1]) != 0:
            raise WorkloadOracleError("json: document does not close at depth 0")
