"""Host stages of the engine, in ms per minute of audio served: each
window request's StageTrace ``decode`` + ``extract`` + ``assemble`` less
``assemble.translate`` and ``assemble.summary`` (the decoders), summed over
the requests that completed in the window, over their audio minutes."""


def read(rec):
    ms, minutes = 0.0, 0.0
    for s in rec.spans:
        st = s.get("stages")
        if not st or "assemble" not in st:
            continue
        ms += 1e3 * (st.get("decode", 0.0) + st.get("extract", 0.0)
                     + st["assemble"] - st.get("assemble.translate", 0.0)
                     - st.get("assemble.summary", 0.0))
        minutes += s["audio_s"] / 60.0
    return ms / minutes if minutes > 0 else None
