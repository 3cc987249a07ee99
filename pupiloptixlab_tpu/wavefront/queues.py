"""Ray-queue primitives: stream compaction and key sorting.

The XLA analog of cuda::DynamicArray (cuda/util.h:68-139), the reference's
atomic-append wavefront queue. There are no device atomics to append with
under XLA; instead queues are static-capacity SoA pytrees and compaction
is a stable sort on the alive mask (alive lanes packed to the front) —
the "XLA sort/scan stream compaction" of the north-star design. Sorting
by material/primitive key is exposed for shading coherence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compaction_permutation(alive: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stable permutation packing alive lanes first; returns (perm, count)."""
    # stable argsort of (not alive): False (alive) sorts before True
    perm = jnp.argsort(~alive, stable=True)
    return perm.astype(jnp.int32), jnp.sum(alive).astype(jnp.int32)


def compact_queue(queue, alive: jnp.ndarray):
    """Apply the compaction permutation to every (N,)-leading leaf of a
    pytree queue. Returns (compacted_queue, live_count)."""
    perm, count = compaction_permutation(alive)
    packed = jax.tree_util.tree_map(lambda a: a[perm], queue)
    return packed, count


def sort_by_key(queue, key: jnp.ndarray):
    """Sort queue lanes by an int key (e.g. material id) for coherence."""
    perm = jnp.argsort(key, stable=True).astype(jnp.int32)
    return jax.tree_util.tree_map(lambda a: a[perm], queue), perm
