"""Fully-factorized learned prior (lossless EntropyBottleneck analog).

The reference subclasses compressai's EntropyBottleneck with quantization
disabled (graphs/layers/entropy_layer_nets.py:12-56); it is vestigial in
the live model but part of the capability surface (SURVEY.md §2.2).  This
is the univariate monotone-MLP density of Balle et al. 2018, evaluated as
a discrete interval mass over the /255 grid.

Per channel c, the cumulative is
  c(x) = sigmoid(f_K(...f_1(x)))   with
  f_k(x) = x @ softplus(H_k) + b_k + tanh(a_k) * tanh(x @ softplus(H_k) + b_k)
which is monotone in x for any parameters.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.module import Module, path_key
from .bounds import lower_bound

HALF = 0.5 / 255.0
LIKELIHOOD_BOUND = 1e-9


class FactorizedPrior(Module):
    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9):
        self.channels = channels
        self.filters = tuple(filters)
        self.init_scale = init_scale
        self.tail_mass = tail_mass

    def init(self, rng, x=None):
        """Parameters: learned per-channel (lower-tail, median, upper-tail)
        quantile positions, pulled toward the tail_mass CDF levels by
        loss() — the EntropyBottleneck aux/quantile machinery the
        reference aggregates in aux_loss (LLICTI_nets.py:31-38) — and the
        monotone MLP's matrices H{k}, biases b{k} and factors a{k}."""
        C = self.channels
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1 / (len(self.filters) + 1))
        p = {"quantiles": jnp.tile(
            jnp.array([-self.init_scale, 0.0, self.init_scale]), (C, 1, 1))}
        for k in range(len(dims) - 1):
            init_m = jnp.log(jnp.expm1(1.0 / scale / dims[k + 1]))
            p[f"H{k}"] = jnp.full((C, dims[k + 1], dims[k]), init_m)
            # creation index of b{k}: after quantiles and H0/b0/a0/...
            p[f"b{k}"] = jax.random.uniform(
                path_key(rng, 3 * k + 3), (C, dims[k + 1], 1),
                minval=-0.5, maxval=0.5)
            if k < len(dims) - 2:
                p[f"a{k}"] = jnp.zeros((C, dims[k + 1], 1))
        return {"params": p}

    @property
    def quantiles(self):
        return self.p["quantiles"]

    def _logits_cumulative(self, x, stop_density: bool = False):
        """x: [C, 1, N] -> logits [C, 1, N]."""
        sg = jax.lax.stop_gradient if stop_density else (lambda a: a)
        v = x
        K = len(self.filters) + 1
        for k in range(K):
            H = jax.nn.softplus(sg(self.p[f"H{k}"]))
            v = jnp.einsum("cij,cjn->cin", H, v) + sg(self.p[f"b{k}"])
            if k < K - 1:
                v = v + jnp.tanh(sg(self.p[f"a{k}"])) * jnp.tanh(v)
        return v

    def likelihood(self, x):
        """Discrete interval mass of x: [..., C] in the /255 domain."""
        C = self.channels
        flat = jnp.moveaxis(x.reshape(-1, C), 0, 1)[:, None, :]  # [C,1,N]
        upper = jax.nn.sigmoid(self._logits_cumulative(flat + HALF))
        lower = jax.nn.sigmoid(self._logits_cumulative(flat - HALF))
        p = (upper - lower)[:, 0, :]
        p = jnp.moveaxis(p, 0, 1).reshape(x.shape)
        return lower_bound(p, LIKELIHOOD_BOUND)

    def __call__(self, x):
        """Self-information map: -log2 p(x)."""
        return -jnp.log2(self.likelihood(x))

    def cdf_table(self, points):
        """Cumulative evaluated on a [P] grid -> [C, P] (for coding)."""
        C = self.channels
        pts = jnp.broadcast_to(points[None, None, :], (C, 1, points.shape[0]))
        return jax.nn.sigmoid(self._logits_cumulative(pts))[:, 0, :]

    def loss(self):
        """Quantile aux loss (EntropyBottleneck.loss analog): pulls the
        learned quantiles to where the cumulative hits tail_mass/2, 0.5,
        and 1-tail_mass/2.  Density params are stopped so only the
        quantiles move (they only feed range estimation, not the rate)."""
        t = jnp.log(2.0 / self.tail_mass - 1.0)
        target = jnp.array([-t, 0.0, t])
        logits = self._logits_cumulative(self.quantiles, stop_density=True)
        return jnp.sum(jnp.abs(logits - target[None, None, :]))

    def medians(self):
        """Learned per-channel median positions [C]."""
        return self.quantiles[:, 0, 1]
