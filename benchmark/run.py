"""The benchmark's one command.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Resolves the workload in ``BENCHMARK.json`` to its configuration file
(``benchmark/configs/``), traffic mix (``benchmark/traffic/<mix>.json``,
which names its generator in ``benchmark/generators/``), limits
(``benchmark/limits/<workload>.json``) and per-layer readers
(``benchmark/metrics/<metric>.py``), runs the generator on the cards of this
machine, and prints one JSON line: ``--trace 0`` the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a traced run. Every run
compares what the timed path produced with the plain reference; the numbers
compared and their limits are the last lines on standard error and the last
key of the line. No CUDA card, fewer cards than the cell needs, or JAX or
the JAX package loaded by the time the window has closed: exit 1, no line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness as H  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell: H.Cell, rec: H.Record, trace: bool) -> dict:
    metrics = {}
    if trace:
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        metrics = {n: {"value": v, "unit": units[n]}
                   for n, v in per_layer(cell, rec).items()}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(rec.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": rec.correct, "attempted": rec.attempted,
            "failed": rec.failed, "metrics": metrics,
            "device": dict(rec.device)}
    if trace and rec.trace is not None:
        line["device"]["busy_s"] = rec.trace.busy_s
        line["device"]["window_s"] = rec.trace.window_s
        line["breakdown"] = rec.trace.breakdown()
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in rec.checks}
    return line


def per_layer(cell: H.Cell, rec: H.Record) -> dict:
    """The cell's per-layer readings that the record gives: a reader that
    finds nothing to read gives nothing."""
    out = {}
    for m in cell.per_layer:
        value = H.metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = float(value)
    return out


#: Keeps ``transformers``, where anything loads it, from loading JAX. The
#: thread pools stay as the port sets them: the clients are threads of
#: this one process, as they are in the server.
THREAD_ENV = {"USE_FLAX": "0"}


def main(argv=None) -> int:
    args = parse(argv)
    t_start = H.process_start_s()
    os.environ.update(THREAD_ENV)
    try:
        spec = H.load_spec()
        cell = H.resolve(spec, args.workload)
        import torch

        if not torch.cuda.is_available():
            raise H.RunError("no CUDA device: the benchmark runs on cards "
                             "only")
        if torch.cuda.device_count() < cell.chips:
            raise H.RunError(f"{cell.name} needs {cell.chips} cards, this "
                             f"machine has {torch.cuda.device_count()}")
        gen = H.generator(cell.traffic["generator"])
        rec = gen.run(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=t_start)
    except H.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    found = H.forbidden_loaded()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 1
    limit = H.power_limit()
    rec.device.update({"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips})
    if limit:
        rec.device["name_power_limit"] = limit
    line = result_line(cell, rec, bool(args.trace))
    print(f"set-up phases {json.dumps(rec.facts.get('setup_phases'))}",
          file=sys.stderr)
    if args.trace:
        costs = rec.facts.get("trace_costs")
        print(f"profiler costs {json.dumps(costs)}", file=sys.stderr)
        if rec.trace is not None:
            print(f"idle % by fifth of the slice "
                  f"{json.dumps(rec.trace.idle_parts(5))}", file=sys.stderr)
    else:
        # The per-layer readings that need no trace, for the record.
        print(f"untraced per-layer {json.dumps(per_layer(cell, rec))}",
              file=sys.stderr)
    counts = rec.facts.get("compared_counts")
    if counts:
        print(f"compared over {json.dumps(counts)}", file=sys.stderr)
    for c in rec.checks:
        print(f"compared {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
