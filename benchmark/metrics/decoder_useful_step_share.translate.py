"""The decoders' useful share of the row-steps they ran, in %: over the
``decode.translate`` and ``decode.summary`` spans in the traced slice, the
steps each real row needed (up to and including its EOS; the summarizer's
forced prefix counts) over batch rows x steps run."""

from benchmark.program_spans import in_slice, recorded


def read(rec):
    spans = recorded(rec)
    if spans is None:
        return None
    useful = run = 0
    for s in in_slice(rec, spans):
        c = s.counts
        if s.name.startswith("decode.") and "row_steps_useful" in c:
            useful += c["row_steps_useful"]
            run += c["rows_run"] * c["steps_run"]
    return 100.0 * useful / run if run else None
