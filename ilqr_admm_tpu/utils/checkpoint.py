"""Solver-state checkpoint / resume.

The reference never serializes state (SURVEY §5) — warm starts live in
memory only. For long batched runs this module persists any solver
pytree (nominal trajectories, ADMM duals/slacks, penalties, gains) with
orbax, falling back to a NumPy .npz archive when orbax is unavailable.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def _flatten_with_paths(tree: Any):
    flat, treedef = jax.tree_util.tree_flatten(tree)
    return flat, treedef


def save_state(path: str, state: Any) -> str:
    """Persist a solver-state pytree. Returns the path written."""
    try:
        import orbax.checkpoint as ocp
    except (ImportError, ModuleNotFoundError):
        # fallback ONLY when orbax is unavailable; a genuine orbax save
        # failure must surface, not leave a partial checkpoint dir
        # shadowing a silently-written .npz at a different path
        flat, _ = _flatten_with_paths(state)
        npz_path = path if path.endswith(".npz") else path + ".npz"
        np.savez(npz_path, **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(flat)})
        return npz_path

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, state, force=True)
    ckptr.wait_until_finished()
    return path


def restore_state(path: str, template: Any) -> Any:
    """Restore a solver-state pytree saved by `save_state`.

    `template` provides the pytree structure (and dtypes for orbax).
    """
    npz_path = path if path.endswith(".npz") else path + ".npz"
    if os.path.exists(npz_path) and not os.path.isdir(path):
        data = np.load(npz_path)
        flat, treedef = _flatten_with_paths(template)
        leaves = [jax.numpy.asarray(data[f"leaf_{i}"]) for i in range(len(flat))]
        return jax.tree_util.tree_unflatten(treedef, leaves)
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), template)
