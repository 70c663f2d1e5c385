"""Checkpointing: orbax for sharded TrainState, npz import/export shim.

Replaces the reference's tl.files.save_npz_dict / load_and_assign_npz_dict
(train.py checkpoint path [HIGH; empty mount — SURVEY.md §5]): orbax for
native sharded checkpoints with resume, plus a flat-npz shim so weights can
be exchanged with non-JAX tooling (and so released reference .npz files
could be mapped in for AP-parity testing if they ever become available).

orbax is an optional dependency (the `orbax` extra), imported only by the
orbax functions; the .npz shim (save_npz / load_npz) needs only numpy.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np


def _ocp():
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        raise ImportError(
            "orbax checkpoints need the optional orbax-checkpoint package "
            "(pip install 'openpose-plus[orbax]'); without it, save and "
            "load weights as .npz with checkpoint.save_npz / "
            "checkpoint.load_npz") from None
    return ocp


# One manager per directory for the process lifetime: rebuilding it per
# save re-pays setup + directory scans on every checkpoint.
_managers: dict = {}


def _manager(path: str, keep: int = 3):
    ocp = _ocp()
    key = (path, keep)
    if key not in _managers:
        _managers[key] = ocp.CheckpointManager(
            path, options=ocp.CheckpointManagerOptions(max_to_keep=keep))
    return _managers[key]


def save(path: str, state: Any, step: int, keep: int = 3) -> None:
    """Save a TrainState under path/<step> (atomic: orbax commits via
    rename, so an interrupted save never leaves a readable partial).
    Blocks until the write finishes — checkpoints here are small (CNN
    weights) and a completed-on-return save keeps resume semantics
    trivially correct."""
    mgr = _manager(os.path.abspath(path), keep)
    mgr.save(step, args=_ocp().args.StandardSave(state))
    mgr.wait_until_finished()


def latest_step(path: str) -> Optional[int]:
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    with _ocp().CheckpointManager(path) as mgr:
        return mgr.latest_step()


def restore(path: str, template: Any, step: Optional[int] = None) -> Any:
    """Restore into the sharding/structure of `template` (resume)."""
    ocp = _ocp()
    path = os.path.abspath(path)
    with ocp.CheckpointManager(path) as mgr:
        step = step if step is not None else mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return mgr.restore(step, args=ocp.args.StandardRestore(template))


# ------------------------------------------------------------- npz shim ---

def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save_npz(path: str, params: Any) -> str:
    """Flat 'scope/name' -> array npz (tl.files.save_npz_dict analogue).
    np.savez appends '.npz' to bare paths; the actual path is returned
    and load_npz accepts either spelling."""
    np.savez(path, **_flatten(jax.device_get(params)))
    return path if path.endswith(".npz") else path + ".npz"


def load_npz(path: str, template: Any) -> Any:
    """Load a flat npz back into the template pytree structure; shapes must
    match exactly (weight-import shim)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"   # np.savez appended the extension
    flat = dict(np.load(path))

    def rebuild(tree: Any, prefix: str = "") -> Any:
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        key = prefix.rstrip("/")
        if key not in flat:
            # ConvRelu once held its conv in an nn.Conv child ("Conv_0");
            # accept checkpoints from before the flattening rename.
            legacy = "/".join(key.split("/")[:-1]
                              + ["Conv_0", key.split("/")[-1]])
            if legacy in flat:
                key = legacy
            else:
                raise KeyError(f"npz missing parameter {key!r}")
        arr = flat[key]
        if arr.shape != tuple(np.shape(tree)):
            raise ValueError(
                f"shape mismatch for {key!r}: npz {arr.shape} vs "
                f"model {np.shape(tree)}")
        return arr
    return rebuild(jax.device_get(template))
