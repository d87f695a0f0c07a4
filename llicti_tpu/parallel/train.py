"""Data/spatial-parallel training step via jit + GSPMD shardings.

The train step itself is the single-chip step from training/steps.py; we
only annotate shardings — batch split over the ``data`` (and optionally
``spatial``) mesh axes, params/opt-state replicated — and let XLA insert
the gradient psum and conv halo exchanges.  This is the GSPMD analog of
DDP + context parallelism (SURVEY.md §2.3.2-3).
"""
from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..training.steps import TrainState, make_train_step
from .mesh import batch_sharding, replicated


def shard_state(state: TrainState, mesh) -> TrainState:
    """Replicate params/opt-state across the mesh."""
    repl = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, repl), state)


def make_parallel_train_step(model, tx, mesh):
    """Compile the train step with explicit in/out shardings.

    batch: [acc, B, H, W, 3] with B sharded over 'data' and H over
    'spatial'.  Returns a jitted step(state, batch) -> (state, metrics).
    """
    step = make_train_step(model, tx)
    repl = replicated(mesh)
    bsh = batch_sharding(mesh, has_acc_axis=True)

    return jax.jit(
        step,
        in_shardings=(repl, bsh),
        out_shardings=(repl, repl),
    )
