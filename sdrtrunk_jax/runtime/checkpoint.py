"""Carry-state checkpoint/resume for streaming decode chains.

Every decoder/DSP stage in this framework carries its state as an
explicit pytree (the functional replacement for the reference's mutable
module fields), so checkpointing is exact by construction: snapshot the
pytree, restore it, and chunked decode continues bit-identically.  The
reference has no equivalent — resuming a capture there means replaying
from the start — so this is a capability win (SURVEY.md §5
checkpoint/resume row).

Format: a single ``.npz`` holding the flattened leaves in pytree order
plus a structure fingerprint.  Restoring requires a template state
(normally ``decoder.init_state()``) whose treedef must match; the
fingerprint guards against loading a checkpoint into the wrong decoder
or config.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import jax

__all__ = ["state_fingerprint", "save_state", "load_state",
           "StateCheckpointError"]


class StateCheckpointError(ValueError):
    pass


def _leaf_spec(leaf) -> list:
    a = np.asarray(leaf)
    return [str(a.dtype), list(a.shape)]


def state_fingerprint(state) -> str:
    """Hash of the pytree structure + leaf dtypes/shapes (not values)."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    desc = json.dumps([str(treedef)] + [_leaf_spec(l) for l in leaves])
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def save_state(path: str, state, metadata: dict | None = None) -> None:
    """Snapshot a carry-state pytree to ``path`` (.npz)."""
    leaves, _ = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i:04d}": np.asarray(l) for i, l in enumerate(leaves)}
    meta = dict(metadata or {})
    meta["fingerprint"] = state_fingerprint(state)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_state(path: str, template):
    """Restore a pytree saved by save_state.

    ``template`` supplies the tree structure (e.g. ``init_state()``);
    leaves are replaced by the checkpointed arrays.  Raises
    StateCheckpointError on a structure mismatch.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        t_leaves, treedef = jax.tree_util.tree_flatten(template)
        expected = state_fingerprint(template)
        if meta.get("fingerprint") != expected:
            raise StateCheckpointError(
                f"checkpoint fingerprint {meta.get('fingerprint')} does "
                f"not match template {expected} — wrong decoder/config?")
        keys = sorted(k for k in data.files if k.startswith("leaf_"))
        if len(keys) != len(t_leaves):
            raise StateCheckpointError(
                f"checkpoint has {len(keys)} leaves, template has "
                f"{len(t_leaves)}")
        leaves = [data[k] for k in keys]
    return jax.tree_util.tree_unflatten(treedef, leaves), meta
