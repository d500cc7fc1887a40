from .formats import (
    EXPORTERS,
    build_eaf,
    build_json,
    build_plain_text,
    build_srt,
    build_textgrid,
    export_transcript,
)

__all__ = [
    "EXPORTERS",
    "build_eaf",
    "build_json",
    "build_plain_text",
    "build_srt",
    "build_textgrid",
    "export_transcript",
]
