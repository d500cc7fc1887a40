"""Readings of the numbers that decide ``correct``, over many seeds in one
process: of the program as it runs (the lower readings of each limit) or
of the cell's control (the upper readings). The benchmark's own runs never
run this; the limits in ``benchmark/limits/`` are set from its output.

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 \
        --seconds 8 [--control] [--out readings.jsonl]

The serving cell's control is the program's own lower-precision path, the
int8 weights-and-activations kernels (``quantize="a8"``); the training
cell's is the reference computed with every dense product's operands
rounded to fp8 (e4m3, a scale a tensor).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness as H  # noqa: E402


def half_batch(pool_step, mix):
    """The fault of half the batch left out, the mean taken over the
    rest: the step sees the first half of its rows and draws."""
    def broken(params, opt_state, pool, idx, k, scalars, draws=None):
        n = idx.shape[0] // 2
        return pool_step(params, opt_state, pool, idx[:n], k, scalars,
                         None if draws is None else
                         tuple(d[:n] for d in draws))
    return broken


FAULTS = {"half_batch": half_batch}


def readings(workload: str, seed: int, seconds: float, control: bool,
             fault=None, device="cuda:0") -> dict:
    cell = H.resolve(H.load_spec(), workload)
    gen = H.generator(cell.traffic["generator"])
    kw = {"control": control}
    if fault:
        kw["fault"] = FAULTS[fault]
    t = time.time()
    rec = gen.run(cell, seed=seed, seconds=seconds, trace=False,
                  t_start=t, device=device, **kw)
    return {"workload": workload, "seed": seed, "control": control,
            "fault": fault,
            "seconds": time.time() - t, "attempted": rec.attempted,
            "readings": rec.facts.get("readings"),
            "compared": rec.facts.get("compared_counts")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    try:
        for s in args.seeds.split(","):
            line = json.dumps(readings(args.workload, int(s), args.seconds,
                                       args.control, args.fault))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
