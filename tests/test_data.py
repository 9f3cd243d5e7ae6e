"""Data pipeline (`utils/data.py`): windowing, determinism, prefetch."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from fa2_jax.utils.data import (
    TokenLoader, encode_corpus, open_corpus, prefetch_to_device,
)


def test_corpus_roundtrip(tmp_path):
    toks = np.arange(1000) % 50000
    path = str(tmp_path / "corpus.bin")
    encode_corpus(toks, path, vocab_size=50000)
    back = open_corpus(path, vocab_size=50000)
    np.testing.assert_array_equal(np.asarray(back), toks.astype(np.uint16))


def test_windows_tile_and_target_overlap():
    data = np.arange(1 + 4 * 8, dtype=np.uint16)  # exactly 4 windows of 8
    dl = TokenLoader(data, batch=2, seq_len=8, seed=0)
    assert dl.n_windows == 4 and dl.steps_per_epoch == 2
    seen = []
    for b in dl.epoch(0):
        assert b.shape == (2, 9) and b.dtype == np.int32
        for row in b:
            # consecutive tokens: window w covers [w*8, w*8+8]
            assert (np.diff(row) == 1).all()
            seen.append(row[0] // 8)
    assert sorted(seen) == [0, 1, 2, 3]  # every window exactly once


def test_epoch_shuffle_deterministic():
    data = np.arange(1 + 64 * 16, dtype=np.uint16)
    a = [b.copy() for b in TokenLoader(data, 4, 16, seed=7).epoch(3)]
    b = [b.copy() for b in TokenLoader(data, 4, 16, seed=7).epoch(3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = [b.copy() for b in TokenLoader(data, 4, 16, seed=7).epoch(4)]
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_prefetch_preserves_stream_and_sharding():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fa2_jax.parallel import AXIS_DATA, make_mesh

    data = np.arange(1 + 16 * 8, dtype=np.uint16)
    dl = TokenLoader(data, batch=4, seq_len=8, seed=1)
    host = [b.copy() for b in dl.epoch(0)]
    mesh = make_mesh(data=4)
    sh = NamedSharding(mesh, P(AXIS_DATA, None))
    dev = list(prefetch_to_device(dl.epoch(0), size=2, sharding=sh))
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        assert d.sharding == sh
        np.testing.assert_array_equal(np.asarray(d), h)
