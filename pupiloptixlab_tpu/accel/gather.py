"""Row gathers + searchsorted for the scene tables.

Every per-ray table lookup (triangle attributes, materials, textures,
emitters, env CDFs, texture pixel pools) goes through these helpers so
that indexing conventions live in one place:

* ``gather_cols`` returns the transposed (C, N) layout: each attribute
  is a dense (N,) plane (see render/vec.py);
* ``gather_rows`` returns the row-major (N, C) rows;
* ``count_less`` is the batched searchsorted-left (env-map and emitter
  CDF inversion): the number of table entries strictly below each query.

Out-of-range indices clamp into the table (callers mask invalid lanes).
The lookups are native gathers: no matrix product is involved, so
values (including integer ids packed as floats) reproduce exactly.
"""

from __future__ import annotations

import jax.numpy as jnp


def gather_cols(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table (T, C) f32, idx (N,) int -> (C, N) f32 = table[idx].T."""
    return gather_rows(table, idx).T


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table (T, C) f32, idx (N,) int -> (N, C) f32 = table[idx]."""
    return table[jnp.clip(idx, 0, table.shape[0] - 1)]


def count_less(table: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """Number of ``table`` entries strictly below each query — equal to
    jnp.searchsorted(table, queries, side='left') for sorted tables."""
    return jnp.searchsorted(table, queries, side="left").astype(jnp.int32)
