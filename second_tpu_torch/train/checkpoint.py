"""Checkpoint store with the reference's manifest semantics — the port of
`second_tpu/train/checkpoint.py`, with `torch.save` in place of orbax.

Equivalent of `torchplus/train/checkpoint.py`: a JSON manifest
(`checkpoints.json`) tracking latest + all checkpoints per model name,
step-suffixed names (`model-<step>`, stored as `model-<step>.pt`),
max_to_keep GC, restore-latest, and crash-safe resume
(`train.py:212,305,434-438`). A state is anything with `state_dict()` and
`load_state_dict()` (the `TrainState`: model, optimizer and step).
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Optional

import torch


_MANIFEST = "checkpoints.json"


class CheckpointManager:
    def __init__(self, model_dir, name: str = "model", max_to_keep: int = 8):
        self._dir = pathlib.Path(model_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._name = name
        self._max_to_keep = max_to_keep

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> pathlib.Path:
        return self._dir / _MANIFEST

    def _read_manifest(self) -> dict:
        path = self._manifest_path()
        if path.exists():
            with open(path) as f:
                return json.load(f)
        return {"latest": {}, "all": {}}

    def _write_manifest(self, manifest: dict) -> None:
        tmp = self._manifest_path().with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        tmp.replace(self._manifest_path())

    def _path(self, ckpt_name: str) -> pathlib.Path:
        return self._dir / f"{ckpt_name}.pt"

    # -- save / restore ----------------------------------------------------
    def save(self, state: Any, step: int) -> pathlib.Path:
        ckpt_name = f"{self._name}-{step}"
        path = self._path(ckpt_name)
        tmp = path.with_suffix(".tmp")
        torch.save(state.state_dict(), tmp)
        tmp.replace(path)
        manifest = self._read_manifest()
        manifest["latest"][self._name] = ckpt_name
        entries = manifest["all"].setdefault(self._name, [])
        if ckpt_name not in entries:
            entries.append(ckpt_name)
        # GC oldest beyond max_to_keep (keep-latest policy)
        while len(entries) > self._max_to_keep:
            victim = self._path(entries.pop(0))
            if victim.exists():
                victim.unlink()
        self._write_manifest(manifest)
        return path

    def latest_step(self) -> Optional[int]:
        manifest = self._read_manifest()
        latest = manifest["latest"].get(self._name)
        if latest is None:
            return None
        return int(latest.rsplit("-", 1)[1])

    def all_steps(self) -> list:
        """All retained checkpoint steps, oldest→newest (manifest 'all')."""
        manifest = self._read_manifest()
        return [int(name.rsplit("-", 1)[1])
                for name in manifest["all"].get(self._name, [])]

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Load checkpoint `step` (default the latest) into `target` and
        return it; None where there is no latest checkpoint."""
        raw = self.restore_raw(step)
        if raw is None:
            return None
        target.load_state_dict(raw)
        return target

    def restore_raw(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved state dict of checkpoint `step` (default the latest), on
        the CPU, without a target; None where there is no latest one."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        path = self._path(f"{self._name}-{step}")
        if not path.exists():
            raise FileNotFoundError(path)
        return torch.load(path, map_location="cpu", weights_only=True)

    def try_restore_latest(self, target: Any) -> Any:
        """Restore-latest-or-None (reference try_restore_latest_checkpoints)."""
        try:
            return self.restore(target)
        except FileNotFoundError:
            return None
