"""Logging (reference common.cpp)."""

from __future__ import annotations

import time


def log(msg: str) -> None:
    """Timestamped stdout log (LOG, common.cpp:17-28)."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"[{stamp}] {msg}", flush=True)
