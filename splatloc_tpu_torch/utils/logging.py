"""Styled logging: a copy of ``splatloc_tpu.utils.logging`` (reference
utils/logging_utils.py:3-18)."""
from __future__ import annotations


def Log(*args, tag: str = "SplatLoc-TPU"):
    try:
        from rich import print as rprint
        styles = {"SplatLoc-TPU": "bold green", "Eval": "bold magenta",
                  "Warning": "bold yellow"}
        style = styles.get(tag, "bold blue")
        rprint(f"[{style}]{tag}:[/{style}]", *args)
    except ImportError:
        print(f"{tag}:", *args)
