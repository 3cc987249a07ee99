"""Checkpoint / resume of progressive accumulation state (orbax).

The reference's nearest equivalents are the progressive accum buffer +
sample counter (reset on dirty, example/path_tracer/main.cu:187-192)
and the EXR screenshot export; a long offline accumulation that dies
loses everything. Here the renderer state checkpoints with orbax so
progressive renders survive restarts:

    from pupiloptixlab_tpu.utils.checkpoint import save_render_state, \\
        restore_render_state
    save_render_state(path, pt_pass)            # accum + sample_cnt (+ rng seed)
    restore_render_state(path, pt_pass)         # continue accumulating

Works for any pytree via the generic save_pytree/load_pytree pair
(multi-chip sharded accum buffers included — orbax handles shardings).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as exc:
        raise ImportError(
            "render-state checkpoints need the 'orbax-checkpoint' package"
        ) from exc
    return ocp


def _checkpointer():
    return _orbax().PyTreeCheckpointer()


def save_pytree(path: str | Path, tree) -> None:
    path = Path(path).resolve()
    _checkpointer().save(path, tree, force=True)


def load_pytree(path: str | Path, like=None):
    ocp = _orbax()

    path = Path(path).resolve()
    if like is not None:
        restore_args = jax.tree_util.tree_map(
            lambda a: ocp.ArrayRestoreArgs(
                sharding=getattr(a, "sharding", None)
            ),
            like,
        )
        return _checkpointer().restore(path, item=like, restore_args=restore_args)
    return _checkpointer().restore(path)


def save_render_state(path: str | Path, pt_pass) -> None:
    """Checkpoint a PTPass's progressive accumulation (accum buffer,
    sample count, seed)."""
    state = {
        "accum": pt_pass._accum,
        "sample_cnt": jnp.asarray(pt_pass.sample_cnt, jnp.int32),
        "seed": jnp.asarray(pt_pass.seed, jnp.uint32),
    }
    save_pytree(path, state)


def restore_render_state(path: str | Path, pt_pass) -> None:
    """Restore a checkpoint into a PTPass (shapes must match the loaded
    scene's film). Accumulation continues from the saved sample count."""
    like = {
        "accum": pt_pass._accum,
        "sample_cnt": jnp.asarray(0, jnp.int32),
        "seed": jnp.asarray(0, jnp.uint32),
    }
    state = load_pytree(path, like=like)
    if state["accum"].shape != pt_pass._accum.shape:
        raise ValueError(
            f"checkpoint film {state['accum'].shape} != "
            f"current film {pt_pass._accum.shape}"
        )
    pt_pass._accum = state["accum"]
    pt_pass.sample_cnt = int(np.asarray(state["sample_cnt"]))
    pt_pass.seed = int(np.asarray(state["seed"]))
    pt_pass._dirty = False
