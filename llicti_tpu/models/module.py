"""The ``init``/``apply`` surface of the model classes, in plain JAX.

A model object holds only its configuration.  ``init(rng, *args)``
returns ``{"params": tree}``; ``apply(variables, *args, method=M)`` runs
``M`` (default ``__call__``) on a copy of the object bound to that tree,
so methods read their weights from ``self.p``.

Each parameter's key is derived from the root key and the parameter's
path (:func:`path_key`), the derivation of the Flax modules the trained
checkpoints were written with: a seed gives the same initial weights as
it did there.
"""
from __future__ import annotations

import copy
import hashlib
import math

import jax
import jax.numpy as jnp
from jax import lax


class Module:
    p = None  # parameter tree, set on a bound copy by apply()

    def bind(self, params):
        bound = copy.copy(self)
        bound.p = params
        return bound

    def apply(self, variables, *args, method=None):
        fn = type(self).__call__ if method is None else method
        return fn(self.bind(variables["params"]), *args)


def path_key(rng, *path):
    """Key of the parameter at ``path``: module names from the root, then
    the parameter's 1-based creation index within its module.  The SHA-1
    of the path is folded into ``rng``, so keys do not depend on the
    order in which parameters are made."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        rng, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


_kernel_init = jax.nn.initializers.variance_scaling(1.0 / 3.0, "fan_in",
                                                    "uniform")


def conv_init(rng, path, kernel, in_features: int, features: int,
              groups: int = 1, bias_fan_in: int = 0):
    """torch Conv2d default init (kaiming-uniform a=sqrt(5), i.e.
    U(+-1/sqrt(fan_in)) for kernel and bias) of the conv module at
    ``path``, in the ``{"Conv_0": {"kernel" HWIO, "bias"}}`` layout.
    ``bias_fan_in`` overrides the bias bound's fan-in where the reference
    declares another width."""
    kh, kw = kernel
    gin = in_features // groups
    bound = 1 / math.sqrt(bias_fan_in or kh * kw * gin)
    return {"Conv_0": {
        "kernel": _kernel_init(path_key(rng, *path, "Conv_0", 1),
                               (kh, kw, gin, features)),
        "bias": jax.random.uniform(path_key(rng, *path, "Conv_0", 2),
                                   (features,), jnp.float32, -bound,
                                   bound)}}


def conv(p, x, precision=None):
    """VALID NHWC conv.  The group count follows from the shapes, so a
    block-diagonal dense kernel (Codec) runs as one dense conv."""
    k = p["Conv_0"]["kernel"]
    y = lax.conv_general_dilated(
        x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=x.shape[-1] // k.shape[2], precision=precision)
    return y + p["Conv_0"]["bias"]
