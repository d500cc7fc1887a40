"""What the kernel sweeps share (``ops/conv_quant_sweep.py``,
``ops/flash_bwd_sweep.py``): a copy of one CUDA source with some of its
``constexpr int`` constants set, built by :func:`cuda_build.build` beside
``common.cu`` and the headers, several such copies at once, and a
kernel's device time as ``chip_smoke.py`` takes it.
"""

from __future__ import annotations

import re
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Tuple, Union

from . import cuda_build

CONST = r"(constexpr int {name} = )(\d+);"


def parse(spec: str) -> dict:
    """``NAME=VALUE[,NAME=VALUE...]`` -> {NAME: int(VALUE)}."""
    return {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}


def source_values(source: str, names) -> dict:
    """The values that ``csrc/<source>`` gives the constants ``names``."""
    text = (cuda_build.CSRC_DIR / source).read_text()
    out = {}
    for n in names:
        m = re.search(CONST.format(name=n), text)
        if m is None:
            raise ValueError(f"{source} has no constant {n}")
        out[n] = int(m[2])
    return out


def variant_dir(source: str, values: dict, group: str) -> Path:
    """common.cu, ``source`` with ``values`` set, and the headers, in
    ``_build/sweep/<group>/<values>``."""
    text = (cuda_build.CSRC_DIR / source).read_text()
    for k, v in values.items():
        text, n = re.subn(CONST.format(name=k), rf"\g<1>{v};", text)
        if n != 1:
            raise ValueError(f"{source} has no constant {k}")
    tag = "_".join(f"{k}{v}" for k, v in sorted(values.items())) or "source"
    out = cuda_build.BUILD_ROOT / "sweep" / group / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for p in cuda_build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(p, out)
    shutil.copy(cuda_build.CSRC_DIR / "common.cu", out)
    (out / source).write_text(text)
    return out


def build_variants(jobs: Sequence[Tuple[str, dict, str]]
                   ) -> List[Union[cuda_build.BuildInfo, List[str]]]:
    """Build each (source, values, group) of ``jobs`` with
    :func:`variant_dir` and :func:`cuda_build.build`, all at once (one build
    for each distinct source and values); a copy that nvcc refuses (a
    static_assert on the values) gives the error's last lines instead."""
    def build(key):
        source, values, group = keys[key]
        try:
            return cuda_build.build(variant_dir(source, values, group))
        except RuntimeError as e:
            return str(e).splitlines()[-3:]

    keys = {}
    for source, values, group in jobs:
        keys.setdefault((source, tuple(sorted(values.items()))),
                        (source, values, group))
    with ThreadPoolExecutor(max(len(keys), 1)) as pool:
        built = dict(zip(keys, pool.map(build, keys)))
    return [built[(s, tuple(sorted(v.items())))] for s, v, _ in jobs]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def device_ms(fn, n: int = 20, reps: int = 5, stream=None) -> float:
    """Median device ms of one ``fn()`` over ``reps`` replays of a CUDA
    graph of ``n`` calls. ``stream``: warm up and capture on it (a
    backward pass runs on the stream of its forward)."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)
