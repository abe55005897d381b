"""Small utilities: progress bars, dynamic module loading, shape checks.

Equivalents of the reference's `second/utils/progress_bar.py` (CLI progress),
`second/utils/loader.py` (import a module from a file path), and
`second/utils/check.py` (`shape_mergeable`).
"""

from __future__ import annotations

import importlib.util
import pathlib
import shutil
import sys
import time
from typing import Iterable, Optional


class ProgressBar:
    """Minimal CLI progress bar with rate + ETA."""

    def __init__(self, total: int, width: Optional[int] = None,
                 stream=sys.stdout):
        self._total = max(1, total)
        self._width = width or max(
            20, min(50, shutil.get_terminal_size().columns - 40))
        self._stream = stream
        self._start = time.time()
        self._count = 0

    def update(self, n: int = 1):
        self._count += n
        frac = min(1.0, self._count / self._total)
        filled = int(self._width * frac)
        elapsed = time.time() - self._start
        rate = self._count / max(elapsed, 1e-9)
        eta = (self._total - self._count) / max(rate, 1e-9)
        bar = "#" * filled + "-" * (self._width - filled)
        self._stream.write(
            f"\r[{bar}] {self._count}/{self._total} "
            f"{rate:.1f}/s eta {eta:.0f}s")
        self._stream.flush()
        if self._count >= self._total:
            self._stream.write("\n")


def progress_iter(iterable: Iterable, total: Optional[int] = None):
    items = list(iterable) if total is None else iterable
    total = total if total is not None else len(items)
    bar = ProgressBar(total)
    for item in items:
        yield item
        bar.update()


def import_file(path, name: Optional[str] = None):
    """Import a python file as a module (reference loader.py)."""
    path = pathlib.Path(path)
    name = name or path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def shape_mergeable(shape1, shape2) -> bool:
    """True if two shapes broadcast/merge (reference check.py)."""
    if len(shape1) != len(shape2):
        return False
    return all(a == b or a == -1 or b == -1 or a is None or b is None
               for a, b in zip(shape1, shape2))
