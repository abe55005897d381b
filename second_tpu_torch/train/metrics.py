"""Streaming training metrics + structured logging.

Equivalents of `torchplus/metrics.py` (streaming Scalar/Accuracy/
PrecisionRecall buffers wired at `voxelnet.py:214-226`) and the reference's
structured step logs (`train.py:48-65,359-433`: nested dicts flattened to
dotted keys, appended to log.json, pretty-printed to log.txt/stdout).
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional, Sequence

import numpy as np


class Scalar:
    """Running mean of a scalar."""

    def __init__(self):
        self.clear()

    def clear(self):
        self._total = 0.0
        self._count = 0

    def update(self, value) -> float:
        self._total += float(value)
        self._count += 1
        return self.value

    @property
    def value(self) -> float:
        return self._total / max(1, self._count)


class PrecisionRecall:
    """Streaming precision/recall at fixed score thresholds for the RPN
    classifier (sigmoid scores; labels -1 ignore / 0 bg / >0 fg)."""

    def __init__(self, thresholds: Sequence[float] = (
            0.1, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95)):
        self.thresholds = list(thresholds)
        self.clear()

    def clear(self):
        n = len(self.thresholds)
        self._tp = np.zeros(n)
        self._fp = np.zeros(n)
        self._fn = np.zeros(n)

    def update(self, scores: np.ndarray, labels: np.ndarray):
        """scores: [..., num_class] sigmoid scores; labels [...]."""
        scores = np.asarray(scores)
        labels = np.asarray(labels)
        top = scores.max(-1) if scores.ndim > labels.ndim else scores
        cared = labels >= 0
        pos = labels > 0
        for i, t in enumerate(self.thresholds):
            pred_pos = (top > t) & cared
            self._tp[i] += float((pred_pos & pos).sum())
            self._fp[i] += float((pred_pos & ~pos).sum())
            self._fn[i] += float((~pred_pos & pos).sum())

    @property
    def precision(self) -> np.ndarray:
        return self._tp / np.maximum(self._tp + self._fp, 1.0)

    @property
    def recall(self) -> np.ndarray:
        return self._tp / np.maximum(self._tp + self._fn, 1.0)


def flatten_metrics(metrics: Dict, prefix: str = "") -> Dict[str, float]:
    """Nested dict → dotted scalar keys (reference `flat_nested_json_dict`)."""
    out = {}
    for k, v in metrics.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_metrics(v, key))
        else:
            try:
                out[key] = float(v)
            except (TypeError, ValueError):
                out[key] = v
    return out


class MetricsLogger:
    """Appends flattened step metrics to log.json + pretty text to
    log.txt/stdout; optional TensorBoard via torch.utils.tensorboard."""

    def __init__(self, model_dir, use_tensorboard: bool = True,
                 echo: bool = True):
        self._dir = pathlib.Path(model_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._json = open(self._dir / "log.json", "a")
        self._txt = open(self._dir / "log.txt", "a")
        self._echo = echo
        self._tb = None
        # the TensorBoard writer is made at the first record: importing it
        # takes seconds, which a run that logs nothing does not pay
        self._want_tb = use_tensorboard

    def _writer(self):
        if self._want_tb:
            self._want_tb = False
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=str(self._dir / "summary"))
            except Exception:
                self._tb = None
        return self._tb

    def log(self, step: int, metrics: Dict, prefix: str = ""):
        flat = flatten_metrics(metrics, prefix)
        record = {"step": int(step), "time": time.time(), **flat}
        self._json.write(json.dumps(record) + "\n")
        self._json.flush()
        parts = [f"step={step}"]
        for k, v in flat.items():
            parts.append(f"{k}={v:.4g}" if isinstance(v, float) else
                         f"{k}={v}")
        line = " ".join(parts)
        self._txt.write(line + "\n")
        self._txt.flush()
        if self._echo:
            print(line, flush=True)
        if self._writer() is not None:
            for k, v in flat.items():
                if isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def log_text(self, step: int, tag: str, text: str):
        self._txt.write(text + "\n")
        self._txt.flush()
        if self._echo:
            print(text, flush=True)
        if self._writer() is not None:
            self._tb.add_text(tag, text, step)

    def close(self):
        self._json.close()
        self._txt.close()
        if self._tb is not None:
            self._tb.close()


class StageTimer:
    """Named stage timing with averages (reference `voxelnet.py:233-263`).

    Use around host-blocking calls; for jitted stages wrap with
    jax.block_until_ready (or a host fetch on runtimes where that is a no-op).
    """

    def __init__(self, enabled: bool = True):
        self._enabled = enabled
        self._start: Dict[str, float] = {}
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    def start(self, *names: str):
        if not self._enabled:
            return
        now = time.perf_counter()
        for n in names:
            self._start[n] = now

    def end(self, name: str):
        if not self._enabled or name not in self._start:
            return
        dt = time.perf_counter() - self._start.pop(name)
        self._total[name] = self._total.get(name, 0.0) + dt
        self._count[name] = self._count.get(name, 0) + 1

    def averages(self) -> Dict[str, float]:
        return {n: self._total[n] / max(1, self._count[n])
                for n in self._total}

    def clear(self):
        self._start.clear()
        self._total.clear()
        self._count.clear()
