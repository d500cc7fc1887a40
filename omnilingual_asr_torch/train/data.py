"""Training data pipeline: JSONL manifests -> fixed-shape batches.

The PyTorch port of ``omnilingual_asr_tpu/train/data.py``: it feeds the
manifest trainer (``train/cli.py``). Manifest lines (the shape the eval
harness reads, ``eval/harness.py``):

    {"audio": "x.wav", "text": "transcript", "language": "en",
     "emotion": "neutral"}            # language/emotion optional

- every batch has identical static shapes (windows padded to the engine's
  frame geometry);
- decode/resample happen on a host worker thread that runs ahead of the
  card (a prefetch queue); samples go out as f32;
- byte labels need no tokenizer for any of the 1600+ languages.

The numpy shuffle draws in the reference's order, so a seeded loader
yields the reference's batches.
"""

from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from ..audio.decode import decode_audio
from ..audio.resample import resample
from ..config import PipelineConfig
from ..models import languages as lang_table
from ..ops.ctc import text_to_byte_labels
from ..types import EMOTIONS


def load_manifest(path: str | Path) -> List[dict]:
    items = []
    root = Path(path).parent
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        item = json.loads(line)
        audio = Path(item["audio"])
        if not audio.is_absolute():
            item["audio"] = str(root / audio)
        items.append(item)
    return items


class BatchLoader:
    """Shuffled, prefetching batch iterator with static shapes."""

    def __init__(self, manifest: str | Path, cfg: PipelineConfig, *,
                 batch_size: int, window_seconds: float = 15.0,
                 max_label_len: int = 512, seed: int = 0,
                 prefetch: int = 2, loop: bool = True):
        self.items = load_manifest(manifest)
        if not self.items:
            raise ValueError(f"empty manifest: {manifest}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_label_len = max_label_len
        self.loop = loop
        fe = cfg.frontend
        self.window_samples = int(window_seconds * fe.sample_rate)
        n_frames = fe.frames_for_samples(self.window_samples)
        sub = cfg.encoder.subsample_factor
        self.window_frames = ((n_frames + sub - 1) // sub) * sub
        self.rng = np.random.default_rng(seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- host-side example prep -------------------------------------------

    def _example(self, item: dict):
        samples, sr = decode_audio(item["audio"])
        if sr != self.cfg.frontend.sample_rate:
            samples = resample(samples, sr, self.cfg.frontend.sample_rate)
        n = min(len(samples), self.window_samples)
        x = np.zeros(self.window_samples, np.float32)
        x[:n] = samples[:n]
        n_valid = self.cfg.frontend.frames_for_samples(n)
        labels, lmask = text_to_byte_labels(item.get("text", ""),
                                            self.cfg.vocab,
                                            self.max_label_len)
        lid = lang_table.id_for_language(item.get("language", "")) or 0
        lid = max(lid, 0)
        emo = item.get("emotion", "neutral")
        emo_id = (EMOTIONS.index(emo) if emo in EMOTIONS
                  else EMOTIONS.index("neutral"))
        return x, n_valid, labels, lmask, lid, emo_id

    def _producer(self):
        order = np.arange(len(self.items))
        while not self._stop.is_set():
            self.rng.shuffle(order)
            for b0 in range(0, len(order) - self.batch_size + 1,
                            self.batch_size):
                if self._stop.is_set():
                    return
                idx = order[b0:b0 + self.batch_size]
                exs = [self._example(self.items[i]) for i in idx]
                self._q.put(self._collate(exs))
            if not self.loop:
                self._q.put(None)
                return

    def _collate(self, exs) -> Dict[str, np.ndarray]:
        xs, nvs, labels, lmasks, lids, emos = zip(*exs)
        frame_idx = np.arange(self.window_frames)[None, :]
        return {
            "samples": np.stack(xs),
            "mask": frame_idx < np.asarray(nvs)[:, None],
            "labels": np.stack(labels),
            "label_mask": np.stack(lmasks),
            "lid_label": np.asarray(lids, np.int32),
            "emotion_label": np.asarray(emos, np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
