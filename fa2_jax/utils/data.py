"""Training data pipeline: memory-mapped token corpus -> sharded device batches.

The reference is a kernel library with no input pipeline; this is the
framework's production loader, shaped for accelerator training:

- **Zero-copy corpus**: tokens live in a flat binary file (`np.memmap`) —
  nothing is loaded eagerly, epochs of any corpus size stream from the page
  cache. `encode_corpus` writes the file; dtype is chosen from vocab size.
- **Static-shape batches**: every batch is [batch, seq_len + 1] int32
  (inputs = [:, :-1], targets = [:, 1:] — the `loss_fn` convention), so jit
  compiles the train step exactly once.
- **Deterministic shuffling**: window order is a seeded permutation per
  epoch; resuming from (seed, epoch, step) reproduces the stream — the same
  counter-style contract the kernels use for dropout.
- **Device prefetch**: `prefetch_to_device` keeps N batches in flight
  (async `device_put` with the `data`-axis sharding) so host H2D overlaps
  the previous step's compute — the double-buffering XLA can't do for you.
"""
from __future__ import annotations

from typing import Iterator, Optional

import jax
import numpy as np


def encode_corpus(tokens, path: str, vocab_size: int) -> np.memmap:
    """Write a token sequence to a flat binary file (dtype sized to vocab)."""
    dtype = np.uint16 if vocab_size <= np.iinfo(np.uint16).max + 1 else np.uint32
    arr = np.asarray(tokens, dtype=dtype)
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=arr.shape)
    mm[:] = arr
    mm.flush()
    return mm


def open_corpus(path: str, vocab_size: int) -> np.memmap:
    dtype = np.uint16 if vocab_size <= np.iinfo(np.uint16).max + 1 else np.uint32
    return np.memmap(path, dtype=dtype, mode="r")


class TokenLoader:
    """Iterate [batch, seq_len + 1] windows over a flat token array.

    Windows tile the corpus end to end (stride seq_len, the +1 overlaps the
    next-token target); a seeded per-epoch permutation shuffles window
    order; trailing windows that don't fill a batch are dropped (static
    shapes).
    """

    def __init__(self, data, batch: int, seq_len: int, seed: int = 0):
        self.data = data
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_windows = (len(data) - 1) // seq_len
        assert self.n_windows >= batch, \
            f"corpus has {self.n_windows} windows < batch {batch}"
        self.steps_per_epoch = self.n_windows // batch

    def epoch(self, epoch: int) -> Iterator[np.ndarray]:
        order = np.random.RandomState(
            np.uint32(self.seed) + np.uint32(epoch)).permutation(self.n_windows)
        W = self.seq_len
        for step in range(self.steps_per_epoch):
            idx = order[step * self.batch:(step + 1) * self.batch]
            out = np.empty((self.batch, W + 1), np.int32)
            for i, w in enumerate(idx):
                out[i] = self.data[w * W: w * W + W + 1]
            yield out

    def __iter__(self) -> Iterator[np.ndarray]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1


def prefetch_to_device(it, size: int = 2, sharding=None):
    """Wrap a host-batch iterator: keep `size` batches already transferred
    (async `jax.device_put`, optionally with a NamedSharding for the data
    axis). Dispatch-ahead means the H2D for batch i+1 rides under the
    compute of batch i."""
    import collections

    buf = collections.deque()

    def put(b):
        return jax.device_put(b, sharding) if sharding is not None \
            else jax.device_put(b)

    for b in it:
        buf.append(put(b))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
