"""What every cell shares: the benchmark's files found by name, the checks
on the device and on what the process has loaded, the run's record, the
reduction of a profiler trace to busy time, idle gaps and kernel time, and
the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level modules that may not be loaded in the process that prints the
#: result: JAX, its libraries and the JAX package. Names compare whole, so
#: the port (``omnilingual_asr_torch``) is not among them.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "omnilingual_asr",
                     "omnilingual_asr_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


def process_start_s() -> float:
    """The process's start on the ``time.time()`` clock, from /proc (the
    interpreter's own start-up counts as set-up); the import time of this
    module where /proc is not there."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + start_ticks / ticks
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


class Phases:
    """Marks of a run's set-up, in seconds since the process started; the
    run prints them on standard error, so that a set-up that swings shows
    where."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.marks: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        self.marks[name] = time.time() - self.t_start


def forbidden_loaded() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# Files by name
# ---------------------------------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(f"{path} is missing")
    return json.loads(path.read_text())


def read_json(rel: str, root: Path = ROOT) -> dict:
    path = root / rel
    if not path.is_file():
        raise RunError(f"{rel} is missing")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One workload with what its name resolves to."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell's configuration file, traffic mix, limits and metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(configs[w["config"]]["file"], root)
    traffic = read_json(f"benchmark/traffic/{w['traffic']}.json", root)
    limits = read_json(f"benchmark/limits/{workload}.json", root)
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in spec["end_to_end"] if _reports(m, workload)],
                [m for m in spec["per_layer"] if _reports(m, workload)])


def load_module(path: Path, name: str):
    """A module from its file (names may hold dots)."""
    mod_name = "benchmark_file_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise RunError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pipeline_config(c: dict):
    """The port's ``PipelineConfig`` from a configuration file: its
    frontend, encoder, vocabulary and decoding groups, and the ASR weights
    by path where the file names them."""
    from omnilingual_asr_torch.config import (DecodeConfig, EncoderConfig,
                                              FrontendConfig, PipelineConfig,
                                              VocabConfig)

    w = c.get("weights")
    extra = ({"checkpoint_path": str(ROOT / w["asr"])}
             if isinstance(w, dict) and "asr" in w else {})
    return PipelineConfig(frontend=FrontendConfig(**c["frontend"]),
                          encoder=EncoderConfig(**c["encoder"]),
                          vocab=VocabConfig(**c["vocab"]),
                          decode=DecodeConfig(**c.get("decode", {})),
                          **extra)


def generator(name: str, root: Path = ROOT):
    path = root / "benchmark" / "generators" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no generator {path}")
    return load_module(path, f"generator.{name}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader {path}")
    return load_module(path, f"metric.{name}").read


# ---------------------------------------------------------------------------
# The run's record
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(readings: Dict[str, float], limits: Dict[str, float]
           ) -> List[Check]:
    """The cell's limits (``benchmark/limits/<cell>.json``) choose the
    readings compared, each beside its limit."""
    return [Check(k, readings[k], float(v)) for k, v in limits.items()]


def free_device(device) -> None:
    """Frees what the program held, before the reference runs: the
    process's memory peak has been read, and the reference fits beside
    nothing."""
    import gc

    gc.collect()
    if str(device) != "cpu":
        import torch

        torch.cuda.empty_cache()


@dataclasses.dataclass
class Record:
    """What a generator hands back: the end-to-end numbers it timed, the
    spans and trace that the per-layer readers read, the cell's shapes, and
    the comparison with the reference."""
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    #: Per request or step: whatever the generator records (dicts).
    spans: List[dict] = dataclasses.field(default_factory=list)
    #: Facts of the cell: shapes, FLOPs, the window's seconds.
    facts: Dict[str, object] = dataclasses.field(default_factory=dict)
    trace: Optional["DeviceTrace"] = None
    device: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


# ---------------------------------------------------------------------------
# Device trace
# ---------------------------------------------------------------------------

class DeviceTrace:
    """The device's operations in a traced slice: (name, start_s, end_s)
    on the host's clock, the slice's bounds on that clock, and host
    activity spans (label, start_s, end_s) that name idle gaps. A traced
    second of serving holds some 300 000 operations, so the reductions
    run on arrays, by operation name where they can."""

    def __init__(self, ops: Sequence[Tuple[str, float, float]],
                 start_s: float, end_s: float,
                 host: Sequence[Tuple[str, float, float]] = ()):
        import numpy as np

        self.ops, self.start_s, self.end_s = ops, start_s, end_s
        self.host = list(host)
        ids: Dict[str, int] = {}
        idx = np.fromiter((ids.setdefault(n, len(ids)) for n, _, _ in ops),
                          np.int64, len(ops))
        a0 = np.fromiter((o[1] for o in ops), np.float64, len(ops))
        b0 = np.fromiter((o[2] for o in ops), np.float64, len(ops))
        a, b = np.maximum(a0, start_s), np.minimum(b0, end_s)
        keep = b > a
        self._names = list(ids)
        self._idx, self._a, self._b = idx[keep], a[keep], b[keep]
        # Whole operations that start in the slice: their calls and
        # seconds come from one set of events.
        whole = (a0 >= start_s) & (a0 < end_s)
        self._idx_w, self._len_w = idx[whole], (b0 - a0)[whole]

    @property
    def window_s(self) -> float:
        return self.end_s - self.start_s

    def busy_intervals(self):
        """(starts, ends): the union of every operation's interval within
        the slice; an instant when two streams overlap counts once."""
        import numpy as np

        order = np.argsort(self._a, kind="stable")
        a, b = self._a[order], np.maximum.accumulate(self._b[order])
        if a.size == 0:
            return a, b
        new = np.flatnonzero(a[1:] > b[:-1]) + 1
        first = np.concatenate([[0], new])
        last = np.concatenate([new - 1, [a.size - 1]])
        return a[first], b[last]

    @property
    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum())

    def _gaps(self):
        """(starts, ends) of the slice's idle gaps."""
        import numpy as np

        s, e = self.busy_intervals()
        lo = np.concatenate([[self.start_s], e])
        hi = np.concatenate([s, [self.end_s]])
        keep = hi > lo
        return lo[keep], hi[keep]

    def _by_name(self, weights=None):
        import numpy as np

        return np.bincount(self._idx, weights=weights,
                           minlength=len(self._names))

    def _matching(self, patterns: Sequence[str]) -> List[int]:
        rx = [re.compile(p) for p in patterns]
        return [i for i, n in enumerate(self._names)
                if any(r.search(n) for r in rx)]

    def calls(self, patterns: Sequence[str]) -> Tuple[int, float]:
        """(count, device seconds) of the operations that start in the
        slice and whose names match any of the regular expressions
        ``patterns``, each with its whole duration."""
        import numpy as np

        ids = self._matching(patterns)
        n = np.bincount(self._idx_w, minlength=len(self._names))
        secs = np.bincount(self._idx_w, weights=self._len_w,
                           minlength=len(self._names))
        return int(sum(n[i] for i in ids)), float(sum(secs[i] for i in ids))

    def idle_parts(self, n: int) -> List[float]:
        """The idle share, in %, of each of ``n`` equal parts of the
        slice: how far the slice's idle share swings within one run."""
        import numpy as np

        s, e = self.busy_intervals()
        edges = np.linspace(self.start_s, self.end_s, n + 1)
        out = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            busy = np.clip(np.minimum(e, hi) - np.maximum(s, lo), 0.0,
                           None).sum()
            out.append(float(100.0 * (1.0 - busy / (hi - lo))))
        return out

    def count(self, predicate: Callable[[str], bool]) -> int:
        n = self._by_name()
        return int(sum(n[i] for i, name in enumerate(self._names)
                       if predicate(name)))

    def _idle_by_label(self) -> Dict[str, float]:
        """Idle seconds by the host activity open at each gap's middle:
        the labels of the spans open then, joined by ``+``, or ``none``."""
        import numpy as np

        lo, hi = self._gaps()
        mids = 0.5 * (lo + hi)
        labels = sorted({lab for lab, _, _ in self.host})
        code = np.zeros(len(mids), np.int64)
        for bit, lab in enumerate(labels):
            spans = sorted((a, b) for l, a, b in self.host
                           if l == lab and b > a)
            merged: List[List[float]] = []
            for a, b in spans:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            if not merged:
                continue
            s = np.array([m[0] for m in merged])
            e = np.array([m[1] for m in merged])
            j = np.searchsorted(s, mids, side="right") - 1
            inside = (j >= 0) & (mids < e[np.maximum(j, 0)])
            code |= inside.astype(np.int64) << bit
        codes, inv = np.unique(code, return_inverse=True)
        secs = np.bincount(inv, weights=hi - lo, minlength=len(codes))
        return {"+".join(lab for bit, lab in enumerate(labels)
                         if int(c) >> bit & 1) or "none": float(t)
                for c, t in zip(codes, secs)}

    def breakdown(self, top: int = 10) -> dict:
        secs = self._by_name(self._b - self._a)
        ops = sorted(((n, float(secs[i])) for i, n in
                      enumerate(self._names) if secs[i] > 0),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self._idle_by_label().items(),
                      key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps]}


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


# ---------------------------------------------------------------------------
# Readers that several per-layer metrics share
# ---------------------------------------------------------------------------

def idle_share(rec: Record) -> Optional[float]:
    """The device's idle share of the traced slice, in %: 1 - (the union
    of every kernel's, copy's and set's interval) / the slice's wall time.
    An instant when two streams overlap counts once."""
    t = rec.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(rec: Record) -> Optional[float]:
    """The useful model FLOPs the window completed (``useful_flops``),
    over the window's seconds, over the bf16 peak of one H100 SXM, in %."""
    from benchmark import roofline

    flops, secs = rec.facts.get("useful_flops"), rec.facts.get("window_s")
    if not flops or not secs:
        return None
    return 100.0 * flops / secs / roofline.MFU_PEAK


def roofline_share(rec: Record, parts: Sequence[Tuple[str, str]],
                   kernels: Sequence[str]) -> Optional[float]:
    """An operation against its roofline, in %. ``parts``: (the regular
    expression of the kernel that marks one call, the fact that holds one
    call's (flops, bytes) at the cell's shapes). The bound is each part's
    calls in the traced slice times its bound; the time is the device
    seconds of the kernels (``kernels``) that implement the operation. Calls
    and seconds are read from the same events of the trace. Nothing where
    the trace holds no call."""
    from benchmark import roofline

    t = rec.trace
    if t is None:
        return None
    bound_s = 0.0
    for marker, fact in parts:
        op = rec.facts.get(fact)
        n, _ = t.calls([marker])
        if not n or op is None:
            return None
        bound_s += n * roofline.call_bound_ms(op) * 1e-3
    _, secs = t.calls(kernels)
    return 100.0 * bound_s / secs if secs > 0 else None


@contextlib.contextmanager
def device_profile(out: dict):
    """Traces the device's kernels, copies and sets under
    ``torch.profiler`` (CUDA activity only); on exit ``out['ops']`` holds
    (name, start_s, end_s) on the ``time.perf_counter`` clock and
    ``out['start_s']``/``out['end_s']`` the slice (the caller may move
    ``start_s`` later, past the profiler's own start-up), and
    ``out['overhead_s']`` the seconds the profiler's start and its
    processing took. The profiler's clock is anchored by a marker kernel
    on a stream of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_begin = time.perf_counter()
    side = torch.cuda.Stream()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    out["start_cost_s"] = time.perf_counter() - t_begin
    torch.cuda.synchronize()
    t_anchor = time.perf_counter()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1000)
    out["start_s"] = time.perf_counter()
    try:
        yield
    finally:
        out["end_s"] = time.perf_counter()
        torch.cuda.synchronize()
        prof.stop()
        out["stop_cost_s"] = time.perf_counter() - out["end_s"]
        out["overhead_s"] = out["start_s"] - t_begin + out["stop_cost_s"]
        # The raw device events: the profiler's own FunctionEvent tree
        # over a serving slice's million events takes minutes to build.
        ops = [(e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        anchors = [a for n, a, _ in ops if "spin_kernel" in n]
        if not anchors:
            raise RunError("the profiler traced no device operation")
        anchor_ns = min(anchors)
        out["ops"] = [(n, t_anchor + (a - anchor_ns) * 1e-9,
                       t_anchor + (b - anchor_ns) * 1e-9)
                      for n, a, b in ops if "spin_kernel" not in n]
        out["read_cost_s"] = time.perf_counter() - out["end_s"] \
            - out["stop_cost_s"]


# ---------------------------------------------------------------------------
# Statistics and output
# ---------------------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics."""
    xs = sorted(values)
    if not xs:
        raise RunError("no values for a percentile")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
