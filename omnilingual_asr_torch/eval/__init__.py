"""The port's evaluation layer: the corpus harness, manifest writers and
the quality, diarization, long-file and latency drivers, each run as
``python -m omnilingual_asr_torch.eval.<name>`` (the card unless
``--device cpu``)."""
