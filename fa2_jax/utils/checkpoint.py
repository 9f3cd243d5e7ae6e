"""Checkpoint / resume for training state (NumPy step directories).

The reference has no persistence at all (SURVEY.md §5.4); a production
training loop needs crash-resumable state. Layout: `<directory>/<step>/`
holds `state.npz` (one entry per pytree leaf, in flatten order) and
`dtypes.json` (each leaf's dtype name, so bf16/fp8 leaves stored as raw
bits come back exactly). A step directory is written under a temporary name
and renamed into place, so `latest_step` never sees a partial save. Only
NumPy and JAX are needed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _to_storable(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.type.__module__ != "numpy":
        # Extension dtypes (bfloat16, float8_*) round-trip as raw bits.
        a = a.view(np.dtype(f"u{a.dtype.itemsize}"))
    return a


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._pending: List[threading.Thread] = []

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit())

    def save(self, step: int, state: Any, wait: bool = True):
        """Write `state` as step `step`. With wait=False the file write runs
        in a background thread (arrays are immutable, so the caller may go
        on replacing its state); `close` or the next blocking save joins."""
        leaves = jax.tree_util.tree_leaves(state)
        dtypes = [str(jnp.asarray(x).dtype) for x in leaves]

        def write():
            tmp = os.path.join(self._dir, f".tmp-{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "state.npz"),
                     **{f"leaf_{i}": _to_storable(x)
                        for i, x in enumerate(leaves)})
            with open(os.path.join(tmp, "dtypes.json"), "w") as f:
                json.dump(dtypes, f)
            final = os.path.join(self._dir, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            for old in self._steps()[:-self._max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)

        if wait:
            self.wait_until_finished()
            write()
        else:
            t = threading.Thread(target=write)
            t.start()
            self._pending.append(t)

    def wait_until_finished(self):
        for t in self._pending:
            t.join()
        self._pending = []

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, abstract_state: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure/shardings of `abstract_state` (pass a
        pytree of like-shaped arrays, e.g. a freshly-initialized state).
        Shardings (mesh placement) of the given arrays are preserved, so a
        TP/DP-sharded train state restores sharded."""
        step = step if step is not None else self.latest_step()
        assert step is not None, "no checkpoint found"
        path = os.path.join(self._dir, str(step))
        with open(os.path.join(path, "dtypes.json")) as f:
            dtypes = json.load(f)
        leaves, treedef = jax.tree_util.tree_flatten(abstract_state)
        assert len(leaves) == len(dtypes), "checkpoint structure mismatch"
        out = []
        with np.load(os.path.join(path, "state.npz")) as data:
            for i, ref in enumerate(leaves):
                a = data[f"leaf_{i}"].view(jnp.dtype(dtypes[i]))
                sharding = getattr(ref, "sharding", None)
                out.append(jax.device_put(a, sharding) if sharding is not None
                           else jnp.asarray(a))
        return jax.tree_util.tree_unflatten(treedef, out)

    def close(self):
        self.wait_until_finished()
