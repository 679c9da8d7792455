"""Streaming dataflow demo: compose SPSC lanes into a pipeline and a farm.
The JAX package's ``examples/stream_stages.py`` as a module of
``repro_torch``, on its copy of the streaming layer (``repro_torch.stream``);
host threads only, no device.

Three networks over the same toy work (docs/streaming.md):

1. A 3-stage ``Pipeline`` (parse -> square -> tag), one Relic assistant
   per stage, bounded 1P1C rings between them.
2. The same pipeline on the ``serial`` substrate — degrades to inline
   execution on this thread, same results, zero threads (the A/B).
3. A ``Farm`` inside a pipeline: pre -> Farm(work, workers=3) -> post,
   with in-order release despite skewed per-item cost.

Run:  PYTHONPATH=src python -m repro_torch.stream_stages [--items 64]
"""

import argparse
import time

from repro_torch.stream import Farm, Pipeline


def parse(s):
    return int(s)


def square(x):
    return x * x


def tag(x):
    return {"value": x}


def skewed_work(x):
    # Item cost varies 5x: in-order release must reorder at the collector.
    time.sleep((x % 5) * 20e-6)
    return x * x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=64)
    args = ap.parse_args(argv)
    items = [str(i) for i in range(args.items)]
    expect = [{"value": i * i} for i in range(args.items)]

    # 1. Threaded pipeline: one assistant per stage.
    with Pipeline([parse, square, tag], substrate="relic") as pipe:
        t0 = time.perf_counter()
        outs = pipe.run(items)
        dt = time.perf_counter() - t0
    assert outs == expect
    print(f"pipeline/relic    {len(outs)} items in {dt * 1e3:7.2f} ms "
          f"(stages={len(pipe.nodes)})")

    # 2. Same network, workers=0 substrate: inline on this thread.
    with Pipeline([parse, square, tag], substrate="serial") as pipe:
        t0 = time.perf_counter()
        outs = pipe.run(items)
        dt = time.perf_counter() - t0
    assert outs == expect
    print(f"pipeline/inline   {len(outs)} items in {dt * 1e3:7.2f} ms "
          f"(inline={pipe.inline})")

    # 3. Farm in a pipeline: round-robin deal, in-order release.
    with Pipeline([parse, Farm(skewed_work, workers=3, ordered=True),
                   tag]) as pipe:
        t0 = time.perf_counter()
        outs = pipe.run(items)
        dt = time.perf_counter() - t0
    assert outs == expect
    print(f"farm/workers3     {len(outs)} items in {dt * 1e3:7.2f} ms "
          f"(ordered release)")


if __name__ == "__main__":
    main()
