"""Jitted train/eval steps: grad accumulation, value clipping, Adam.

Semantics match the reference agent (agents/llicti_agent.py:48-83):
per-microbatch grads of (loss / grad_acc_iters) are accumulated, gradient
values clipped at 5.0, then one Adam step.  Accumulation is a lax.scan
over a leading microbatch axis — one compiled program per optimizer step,
no host round-trips.

The learning rate is an optax injected hyperparam so the plateau
scheduler can update it without recompilation.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from .loss import rate_loss_list


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray


def make_optimizer(learning_rate: float, clip_value: float = 5.0):
    """Value-clip + Adam, with runtime-settable learning rate."""

    def factory(learning_rate):
        return optax.chain(
            optax.clip(clip_value),  # element-wise value clip (torch
            # clip_grad_value_(5.0), reference llicti_agent.py:65)
            optax.adam(learning_rate),
        )

    return optax.inject_hyperparams(factory)(learning_rate=learning_rate)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    opt_state = state.opt_state
    hyper = dict(opt_state.hyperparams)
    hyper["learning_rate"] = jnp.asarray(lr, jnp.float32)
    return state._replace(opt_state=opt_state._replace(hyperparams=hyper))


def get_learning_rate(state: TrainState) -> float:
    return float(state.opt_state.hyperparams["learning_rate"])


def init_state(model, cfg, rng, sample_batch, learning_rate: float,
               clip_value: float = 5.0) -> Tuple[TrainState, optax.GradientTransformation]:
    # jit the init: eager init is hundreds of tiny device dispatches
    params = jax.jit(model.init)(rng, sample_batch)
    tx = make_optimizer(learning_rate, clip_value)
    opt_state = tx.init(params)
    return TrainState(params, opt_state, jnp.zeros((), jnp.int32)), tx


def make_train_step(model, tx):
    """Returns step(state, batch) -> (state, metrics).

    batch: [acc, B, H, W, 3] — leading axis is the grad-accumulation
    microbatch; pass acc=1 for plain steps.
    metrics: {"loss": scalar mean rate, "breakdown": [S, 9] mean}.
    """

    def loss_fn(params, xb):
        si_list = model.apply(params, xb)
        total, breakdown = rate_loss_list(xb.size, si_list)
        return total, breakdown

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def step(state: TrainState, batch):
        acc = batch.shape[0]

        def micro(carry, xb):
            (loss, bd), g = grad_fn(state.params, xb)
            g = jax.tree.map(lambda a, b: a + b, carry[0], g)
            return (g, carry[1] + loss, carry[2] + bd), None

        zero_g = jax.tree.map(jnp.zeros_like, state.params)
        S = len(model.cfg.dwtlevels)
        # breakdown width: 3 bands x colors (9 for clrchs=3, 3 for the
        # single-channel clrchs<3 variants)
        width = 9 if model.cfg.clrchs == 3 else 3
        init = (zero_g, jnp.zeros(()), jnp.zeros((S, width)))
        (g, loss_sum, bd_sum), _ = jax.lax.scan(micro, init, batch)
        g = jax.tree.map(lambda a: a / acc, g)
        updates, opt_state = tx.update(g, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = {"loss": loss_sum / acc, "breakdown": bd_sum / acc}
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def make_eval_step(model):
    def eval_step(params, batch):
        si_list = model.apply(params, batch)
        total, breakdown = rate_loss_list(batch.size, si_list)
        return total, breakdown

    return eval_step
