"""Integrity-checked checkpointing with elastic restore (torch twin of
``repro.train.checkpoint``, in the reference's on-disk format).

Format: one ``.npz`` per checkpoint (flattened ``/``-joined path -> array,
e.g. ``params/blocks/attn/wq``, ``opt/step``) + a JSON sidecar with step,
content hash and the device count it was saved under.  Writes are atomic
(tmp + ``os.replace``); ``CheckpointManager`` keeps the newest ``keep`` and
restores the newest *valid* one (corrupt/partial checkpoints are skipped —
the node-failure-during-save case).  The format is the reference's, so a
checkpoint crosses between the two packages in both directions and
``_tree_hash`` of a carried tree is the same.

Restore loads the arrays on the host and puts each on the template leaf's
device at its dtype, so restoring onto another device is the same code
path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import tree_leaves_with_path, \
    tree_unflatten

#: what a partial or corrupt checkpoint raises while it is read
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _np(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


def _tree_hash(flat: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def _device_count(tree) -> int:
    """The device count of the tree's device type (1 on the CPU, as jax's
    CPU backend counts it)."""
    for _, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return torch.cuda.device_count()
    return 1


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _paths(self, step: int) -> Tuple[str, str]:
        base = os.path.join(self.directory, f"ckpt_{step:08d}")
        return base + ".npz", base + ".json"

    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        flat = _flatten(tree)
        npz_path, meta_path = self._paths(step)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, npz_path)          # atomic
        meta = {"step": step, "hash": _tree_hash(flat),
                "n_arrays": len(flat), "extra": extra or {},
                "mesh_devices": _device_count(tree)}
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)
        self._prune()
        return npz_path

    def _prune(self):
        steps = self.available_steps()
        for s in steps[:-self.keep]:
            for p in self._paths(s):
                if os.path.exists(p):
                    os.remove(p)

    def available_steps(self):
        steps = []
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".json"):
                steps.append(int(f[5:13]))
        return sorted(steps)

    def restore_latest(self, template) -> Optional[Tuple[int, Any, dict]]:
        """Newest checkpoint that passes integrity; None if none valid."""
        for step in reversed(self.available_steps()):
            out = self.restore(step, template)
            if out is not None:
                return out
        return None

    def restore(self, step: int, template
                ) -> Optional[Tuple[int, Any, dict]]:
        npz_path, meta_path = self._paths(step)
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            with np.load(npz_path) as z:
                flat = {k: z[k] for k in z.files}
            if _tree_hash(flat) != meta["hash"]:
                return None                       # corrupt payload
        except _UNREADABLE:
            return None
        # rebuild in template order, each leaf on its template's device
        leaves = []
        for path, leaf in tree_leaves_with_path(template):
            arr = flat["/".join(path)]
            if isinstance(leaf, torch.Tensor):
                leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                       dtype=leaf.dtype))
            else:
                leaves.append(arr)
        return meta["step"], tree_unflatten(template, leaves), meta["extra"]
