"""GDN1 activation (l1 generalized divisive normalization).

y_c = x_c / (beta_c + sum_k gamma_ck * |x_k|)

Parameters are stored through compressai's non-negative parametrization:
param = sqrt(value + pedestal), value = lower_bound(param, bound)^2 - pedestal
with pedestal = eps^2, bound = sqrt(minimum + pedestal).
Reference: compressai.layers.GDN1, used via graphs/models/LLICTI_nets.py:8,
activation option :690-691.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..models.module import Module
from .bounds import lower_bound


class _NonNegParam:
    def __init__(self, minimum: float = 0.0, eps: float = 2 ** -18):
        self.pedestal = eps ** 2
        self.bound = (minimum + self.pedestal) ** 0.5

    def init(self, value):
        return jnp.sqrt(jnp.maximum(value + self.pedestal, self.pedestal))

    def __call__(self, param):
        return lower_bound(param, self.bound) ** 2 - self.pedestal


class GDN1(Module):
    """l1-GDN over the channel (last) axis of an NHWC tensor."""

    def __init__(self, channels: int, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, precision=None):
        self.channels = channels
        self.beta_rep = _NonNegParam(minimum=beta_min)
        self.gamma_rep = _NonNegParam()
        self.gamma_init = gamma_init
        self.precision = precision

    def init(self, rng=None, x=None):
        C = self.channels
        return {"params": {
            "beta": self.beta_rep.init(jnp.ones((C,))),
            "gamma": self.gamma_rep.init(self.gamma_init * jnp.eye(C))}}

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        beta = self.beta_rep(self.p["beta"])
        gamma = self.gamma_rep(self.p["gamma"])
        norm = jnp.matmul(jnp.abs(x), gamma.T,
                          precision=self.precision) + beta
        return x / norm
