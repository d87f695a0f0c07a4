"""Checkpoint/resume with the reference's semantic payload.

Saves model params + optimizer state as one ``.npz`` of array leaves
keyed by their pytree path, alongside the host-side training state
(epoch, iteration, best_valid_loss, LR-scheduler and rate-logger state)
as JSON — the same payload the reference pickles (agents/base.py:83-100).
``save(..., is_best=True)`` additionally copies to ``model_best``
(reference base.py:98-100).  Restoring needs a target tree of the same
structure (fresh init): the file holds leaves, the target the structure.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Tuple

import jax
import numpy as np


def tree_to_arrays(tree) -> Dict[str, np.ndarray]:
    """Flatten a pytree to {path string: host array}."""
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in leaves}


def arrays_to_tree(arrays, target):
    """Rebuild ``target``'s structure from path-keyed leaves.  Leaves keep
    the target's sharding when it has one (mesh-sharded train state)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(target)
    leaves = []
    for path, ref in flat:
        key = jax.tree_util.keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint has no leaf {key}")
        arr = np.asarray(arrays[key])
        if arr.shape != np.shape(ref):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                             f"target {np.shape(ref)}")
        sharding = getattr(ref, "sharding", None)
        leaves.append(jax.device_put(arr, sharding) if sharding is not None
                      else jax.numpy.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, leaves)


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _paths(self, name: str) -> Tuple[str, str]:
        return (os.path.join(self.dir, name + ".npz"),
                os.path.join(self.dir, name + ".meta.json"))

    def save(self, name: str, state, meta: dict, is_best: bool = False) -> None:
        tree_path, meta_path = self._paths(name)
        tmp = tree_path + ".tmp.npz"
        np.savez(tmp, **tree_to_arrays(state))
        os.replace(tmp, tree_path)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        if is_best:
            best_tree, best_meta = self._paths("model_best")
            shutil.copyfile(tree_path, best_tree)
            shutil.copyfile(meta_path, best_meta)

    def load(self, name: str, target) -> Tuple[Any, dict]:
        """Restore (state_like_target, meta). Raises FileNotFoundError."""
        tree_path, meta_path = self._paths(name)
        if not os.path.exists(tree_path):
            raise FileNotFoundError(tree_path)
        with np.load(tree_path) as arrays:
            state = arrays_to_tree(arrays, target)
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return state, meta

    def exists(self, name: str) -> bool:
        return os.path.exists(self._paths(name)[0])
