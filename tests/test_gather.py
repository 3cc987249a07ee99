"""accel/gather.py lookups against numpy: row and column gathers
(including ids packed as floats and the out-of-range clamp) and the
batched searchsorted-left."""

import jax.numpy as jnp
import numpy as np
import pytest

from pupiloptixlab_tpu.accel.gather import count_less, gather_cols, gather_rows


@pytest.mark.parametrize("t_rows", [7, 300, 2048, 5000])
def test_gather_cols_matches_numpy(t_rows):
    r = np.random.RandomState(t_rows)
    table = r.randn(t_rows, 24).astype(np.float32)
    table[:, 5] = r.randint(0, 300_000, t_rows)  # ids packed as floats
    idx = r.randint(0, t_rows, 3000).astype(np.int32)
    got = np.asarray(gather_cols(jnp.asarray(table), jnp.asarray(idx)))
    assert got.shape == (24, 3000)
    np.testing.assert_array_equal(got, table[idx].T)


@pytest.mark.parametrize("n,c", [(1024, 24), (5000, 12), (2048, 1), (3000, 128)])
def test_gather_rows_matches_numpy(n, c):
    r = np.random.RandomState(n + c)
    table = r.randn(777, c).astype(np.float32)
    idx = r.randint(0, 777, n).astype(np.int32)
    got = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert got.shape == (n, c)
    np.testing.assert_array_equal(got, table[idx])
    np.testing.assert_array_equal(
        np.asarray(gather_cols(jnp.asarray(table), jnp.asarray(idx))), got.T
    )


def test_gather_clamps_out_of_range():
    table = np.arange(30, dtype=np.float32).reshape(10, 3)
    idx = np.array([-5, -1, 0, 9, 10, 1000], np.int32)
    want = table[np.clip(idx, 0, 9)]
    np.testing.assert_array_equal(
        np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx))), want
    )
    np.testing.assert_array_equal(
        np.asarray(gather_cols(jnp.asarray(table), jnp.asarray(idx))), want.T
    )


@pytest.mark.parametrize("t_rows", [5, 512, 1300])
def test_count_less_matches_searchsorted(t_rows):
    r = np.random.RandomState(t_rows)
    table = np.sort(r.rand(t_rows).astype(np.float32))
    q = np.concatenate([
        r.rand(4000).astype(np.float32),
        table[r.randint(0, t_rows, 100)],  # exact hits: strictly-below
        np.array([-1.0, 0.0, 2.0], np.float32),
    ])
    got = np.asarray(count_less(jnp.asarray(table), jnp.asarray(q)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.searchsorted(table, q, side="left"))
