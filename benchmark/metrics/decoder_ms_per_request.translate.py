"""The decoders' seconds a request, in ms: StageTrace
``assemble.translate`` + ``assemble.summary`` (the translator's and the
summarizer's greedy decodes, each under the engine's device lock and
including the wait for it), averaged over the requests that completed in
the window. The engine rounds these sub-stages to 10 ms."""


def read(rec):
    vals = [1e3 * (s["stages"].get("assemble.translate", 0.0)
                   + s["stages"].get("assemble.summary", 0.0))
            for s in rec.spans if s.get("stages")]
    return sum(vals) / len(vals) if vals else None
