"""The readings a cell's check limits are set from, on the card at the
cell's own size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --out <file.jsonl>

For every seed, the numbers the check compares for the program (the lower
reading: the largest over the seeds); for each control seed, the same
numbers for the control (scoring: the reference in fp8, ``reference/
control.py``; training: the program's own bf16-weight path) and for the
faults a run can have, planted in the program: a document's input token
altered, half the batch scored and its results repeated for the other
half (scoring); half the batch left out of a step, the mean taken over the
rest (training). The upper reading is the smallest the control gives.
The benchmark's own runs never run this; ``PERF.md`` records the readings
and the limits set from them.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

from portbench.harness import card, program  # noqa: E402
from portbench.harness.runner import Run  # noqa: E402
from portbench.harness.spec import find_cell  # noqa: E402


def free():
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def score_seed(cell, seed: int, control: bool, device: str = "cuda") -> dict:
    from portbench.reference.control import fp8_matmul

    kind = cell.kind_module()
    run = Run(cell, seed, 0.0, False, device, time.perf_counter())
    tr = kind.Traffic(run)
    tr.setup()
    while len(tr.kept) < cell.traffic["check_batches"]:
        i, ll, sums, _, _ = tr._one()
        tr.kept[i] = (ll, sums)
    sample = tr.sample()
    faults = {}
    if control:
        half = tr.batch // 2
        altered, halved = {}, {}
        for i in sample:
            toks = tr.batch_tokens(i)
            bad = toks.clone()
            bad[0, tr.length // 2] = (bad[0, tr.length // 2] + 1) % tr.m["vocab_size"]
            ll = tr.score(bad)
            altered[i] = (ll, ll.sum(-1).cpu())
            ll = tr.score(toks[:half]).repeat(-(-tr.batch // half), 1)[:tr.batch]
            halved[i] = (ll, ll.sum(-1).cpu())
        faults = {"token_altered": altered, "half_batch": halved}
    tr.release()
    free()
    t0 = time.perf_counter()
    _, w = program.reference_weights(tr.m, tr.reference, seed, device,
                                     cell.init_rules)
    refs = {i: tr.reference_ll(i, w) for i in sample}
    out = {"seed": seed, "program": tr.gaps(tr.kept, refs),
           "reference_s": time.perf_counter() - t0}
    if control:
        ctl = {}
        for i in sample:
            ll = tr.reference_ll(i, w, mm=fp8_matmul)
            ctl[i] = (ll, ll.sum(-1).cpu())
        out["control"] = tr.gaps(ctl, refs)
        for name, outputs in faults.items():
            out[name] = tr.gaps(outputs, refs)
    del w
    free()
    return out


def train_seed(cell, seed: int, control: bool, device: str = "cuda") -> dict:
    kind = cell.kind_module()

    class Bf16Weights(kind.Traffic):
        """The program's own lower-precision path: the same weights held in
        bfloat16, updated in bfloat16."""

        def build(self):
            from repro_torch.models import build_model
            from portbench.harness import weights

            params = super().build()
            self.flat = self.flat.to(torch.bfloat16)
            meta = build_model(program.model_config(
                {**self.m, "param_dtype": "bfloat16"}), "meta").init(torch.Generator())
            return weights.lay_into(meta, weights.views_of(self.flat, self.shapes),
                                    requires_grad=True)

    class HalfBatch(kind.Traffic):
        """A step that leaves half of the batch out, the mean taken over the
        rest."""

        def make_step(self):
            step = super().make_step()
            return lambda state, b: step(
                state, {k: v[:v.shape[0] // 2] for k, v in b.items()})

    def readings(cls, ref=None):
        tr = cls(Run(cell, seed, 0.0, False, device, time.perf_counter()))
        tr.setup()
        tr.release()
        free()
        t0 = time.perf_counter()
        if ref is None:
            ref = tr.reference_steps()
            free()
        gaps = tr.gaps(ref)
        gaps.update(worst_grad=tr.worst_grad, worst_change=tr.worst_change,
                    left_out=tr.left_out, seconds=time.perf_counter() - t0)
        return gaps, ref

    program_gaps, ref = readings(kind.Traffic)
    out = {"seed": seed, "program": program_gaps}
    if control:
        out["control"] = readings(Bf16Weights, ref)[0]
        out["half_batch"] = readings(HalfBatch, ref)[0]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = find_cell(args.workload)
    card.cache_dirs()
    card.require_cards(cell.chips)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fn = score_seed if cell.kind == "score" else train_seed
    with open(args.out, "a") as f:
        for s in args.seeds.split(","):
            t0 = time.perf_counter()
            rec = fn(cell, int(s), int(s) in controls)
            rec.update(cell=cell.name, seconds=time.perf_counter() - t0)
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")
            f.flush()


if __name__ == "__main__":
    main()
