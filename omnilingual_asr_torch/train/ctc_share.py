"""Share of CTC rows whose labels cannot be aligned in their frames, in the
synthetic training batches of the PyTorch port.

Draws batches from ``SynthBatcher`` as ``train_synth`` builds it by default
(``PipelineConfig()``, batch 16 of 8 s windows, frames padded for the
kernel mode, seed 0) and counts, per row, whether label count plus adjacent
repeats exceeds the subsampled frame count (``train.step.ctc_rows``). On
such a row ``F.ctc_loss`` gives +inf and the port's ``ctc_loss`` takes
optax's recursion. CPU only:

    python -m omnilingual_asr_torch.train.ctc_share --batches 200
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..config import PipelineConfig
from ..ops.attention import REFERENCE_BLOCK_Q
from .step import ctc_rows
from .synth import SynthBatcher


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = PipelineConfig()
    batcher = SynthBatcher(
        cfg, batch_size=args.batch_size, window_seconds=8.0, seed=args.seed,
        frame_multiple=REFERENCE_BLOCK_Q * cfg.encoder.subsample_factor,
        n_threads=2, snr_range=(15.0, 40.0), reuse_pool=6144, reuse_p=0.8)
    t0 = time.perf_counter()
    rows = bad = batches_with = 0
    slack = []
    try:
        it = iter(batcher)
        for _ in range(args.batches):
            batch = next(it)
            n = len(ctc_rows(batch, cfg))
            rows += len(batch["labels"])
            bad += n
            batches_with += int(n > 0)
            lm = batch["label_mask"]
            sub = cfg.encoder.subsample_factor
            frames = batch["mask"][:, ::sub].sum(axis=1)
            slack.extend((frames - lm.sum(axis=1)).tolist())
    finally:
        batcher.close()
    print(json.dumps({
        "batches": args.batches, "rows": rows, "infeasible_rows": bad,
        "row_share": bad / rows, "batches_with_one": batches_with,
        "batch_share": batches_with / args.batches,
        "min_frames_minus_labels": int(np.min(slack)),
        "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
