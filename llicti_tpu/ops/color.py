"""YCoCg-R reversible lifting color transform (JVT-I014r3).

Two variants, as in the reference:
  * float train-time version with rounding to ``RNDFACTOR`` precision
    (reference: graphs/models/LLICTI_nets.py:40-59),
  * exact integer lifting for the codec path
    (reference: graphs/models/LLICTI_nets.py:61-88, floor-division lifting).

All functions use NHWC layout, channels last: [..., 3] = (R,G,B)
or (Y,Co,Cg).  Integer versions operate on int32 (values fit in 10 bits).
"""
from __future__ import annotations

import jax.numpy as jnp


def rgb_to_ycocg_r(x: jnp.ndarray, rndfactor: float = 255.0) -> jnp.ndarray:
    """Float YCoCg-R forward lifting. x: [..., 3] RGB in [0, 1].

    Reference: LLICTI_nets.py:40-49.  jnp.round matches torch.round
    (round-half-to-even).
    """
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + jnp.round(Co * rndfactor / 2) / rndfactor
    Cg = G - t
    Y = t + jnp.round(Cg * rndfactor / 2) / rndfactor
    return jnp.stack((Y, Co, Cg), axis=-1)


def ycocg_r_to_rgb(x: jnp.ndarray, rndfactor: float = 255.0) -> jnp.ndarray:
    """Float YCoCg-R inverse lifting. Reference: LLICTI_nets.py:51-59."""
    Y, Co, Cg = x[..., 0], x[..., 1], x[..., 2]
    t = Y - jnp.round(Cg * rndfactor / 2) / rndfactor
    G = Cg + t
    B = t - jnp.round(Co * rndfactor / 2) / rndfactor
    R = B + Co
    return jnp.stack((R, G, B), axis=-1)


def rgb_int_to_ycocg_r_int(x: jnp.ndarray) -> jnp.ndarray:
    """Exact integer YCoCg-R forward. x: [..., 3] int RGB in [0, 255].

    Uses floor-division lifting (``Co // 2``), exactly as the codec path of
    the reference (LLICTI_nets.py:61-74; also :570-582).  Output ranges:
    Y in [0, 255], Co in [-255, 255], Cg in [-255, 255].
    """
    x = x.astype(jnp.int32)
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + Co // 2  # jnp floor-division == python //, matches torch int //
    Cg = G - t
    Y = t + Cg // 2
    return jnp.stack((Y, Co, Cg), axis=-1)


def ycocg_r_int_to_rgb_int(x: jnp.ndarray) -> jnp.ndarray:
    """Exact integer YCoCg-R inverse. Reference: LLICTI_nets.py:76-88."""
    x = x.astype(jnp.int32)
    Y, Co, Cg = x[..., 0], x[..., 1], x[..., 2]
    t = Y - Cg // 2
    G = Cg + t
    B = t - Co // 2
    R = B + Co
    return jnp.stack((R, G, B), axis=-1)


def rgb_int_to_ycocg_r_int_np(x) -> "np.ndarray":
    """Host (numpy) twin of :func:`rgb_int_to_ycocg_r_int` — bit-exact
    (integer floor-division lifting is deterministic on both sides), so
    the encoder can derive the header minmax/raw band WITHOUT a device
    round-trip (one host sync per image saved)."""
    import numpy as np

    x = np.asarray(x, dtype=np.int32)
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + Co // 2  # numpy floor-division == jnp floor-division
    Cg = G - t
    Y = t + Cg // 2
    return np.stack((Y, Co, Cg), axis=-1)
