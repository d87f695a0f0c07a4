"""Top-level LLICTI model: color transform + lazy DWT + per-scale entropy.

Training/validation forward path (reference: graphs/models/LLICTI_nets.py:91-123
and LLICTIEntropyLayer.forward :318-342).  The codec (compress/decompress)
path lives in ``llicti_tpu/codec.py`` — it reuses these modules' params via
shared jitted functions to guarantee encoder/decoder bit-exactness.

Network sharing across scales/bands follows the reference:
* ``useprevlevNN[s]`` True reuses the previous scale's nets for scale s
  (the headline parameter-sharing feature; reference :282-316).
* ``combine_layers1toL`` shares one band=-1 net across the 3 bands of a
  scale (reference :308-314).
"""
from __future__ import annotations

from typing import List

import jax.numpy as jnp

from ..config import ModelConfig
from ..ops.color import rgb_to_ycocg_r
from ..ops.wavelet import lazy_dwt
from .interpolator import Interpolator
from .module import Module


def model_scales(cfg: ModelConfig) -> List[int]:
    """The scale owning each distinct interpolator model."""
    owners = []
    for s in range(cfg.num_scales):
        if cfg.model_index[s] == len(owners):
            owners.append(cfg.dwtlevels[s])
    return owners


class LLICTIModel(Module):
    """Per-scale self-information maps (plain JAX, see models/module.py).

    Input: RGB image [B, H, W, 3] in [0, 1]; H, W must be multiples of
    2**(max(dwtlevels)+1) (the caller pads, as the reference agent does at
    agents/llicti_agent.py:105-113).
    Output: list (per scale) of [B, h_s, w_s, 9] self-info maps
    (3 bands x 3 colors), suitable for the rate loss.

    ``dense_groups``: codec-path mode, grouped convs as dense
    block-diagonal convs (see Interpolator).  ``precision``: conv/matmul
    precision of the interpolators (None = XLA's default).
    Parameters: ``{"params": {"models_<m>_<b>": interpolator tree}}``.
    """

    def __init__(self, cfg: ModelConfig, dense_groups: bool = False,
                 precision=None):
        self.cfg = cfg
        self.dense_groups = dense_groups
        self.precision = precision
        models = []
        for scl in model_scales(cfg):
            bands = (-1,) if cfg.combine_layers1toL else (0, 1, 2)
            models.append(tuple(
                Interpolator(cfg, scl, b, dense_groups, precision)
                for b in bands))
        self.models = models

    def init(self, rng, x=None):
        """Fresh parameters.  Shapes come from the config; ``x`` is
        accepted for the ``init(rng, sample)`` call surface."""
        params = {}
        for m, bands in enumerate(self.models):
            for b, mdl in enumerate(bands):
                name = f"models_{m}_{b}"
                params[name] = mdl.init(rng, name)
        return {"params": params}

    def _net(self, scale: int, band: int):
        """(interpolator, its parameter subtree) serving (scale, band)."""
        m = self.cfg.model_index[scale]
        b = 0 if self.cfg.combine_layers1toL else band
        return self.models[m][b], self.p[f"models_{m}_{b}"]

    def transform(self, x: jnp.ndarray) -> List[jnp.ndarray]:
        """Color transform + zero-mean shift + lazy DWT (training numerics).

        Reference: LLICTI_nets.py:101-120.
        """
        cfg = self.cfg
        if cfg.ycocg:
            x = rgb_to_ycocg_r(x, cfg.rndfactor)
            x = x.at[..., 0].add(-cfg.mean_y_ycocg)
        else:
            x = x - cfg.mean_y_ycocg
        if cfg.clrchs == 3:
            if cfg.clr_joint_mode == 1:
                zrs = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
                x = jnp.concatenate([zrs, x], axis=-1)
            return lazy_dwt(x, cfg.dwtlevels)
        # single-channel variants (clrchs in 0,1,2): reference :196-216
        xc = x[..., cfg.clrchs:cfg.clrchs + 1]
        return lazy_dwt(xc, tuple(range(cfg.num_scales)))

    def entropy_forward(self, y_list: List[jnp.ndarray]) -> List[jnp.ndarray]:
        """Per-scale self-infos of bands 1..3 given earlier bands.

        Reference: LLICTIEntropyLayer.forward :318-342.
        """
        c = self.cfg.cond_channels
        out = []
        for s, y_lev in enumerate(y_list):
            sis = []
            for b in range(3):
                mdl, p = self._net(s, b)
                sis.append(mdl(p, y_lev[..., 0:c * (b + 1)],
                               y_lev[..., c * (b + 1):c * (b + 2)]))
            out.append(jnp.concatenate(sis, axis=-1))
        return out

    def __call__(self, x: jnp.ndarray) -> List[jnp.ndarray]:
        return self.entropy_forward(self.transform(x))

    # --- codec-path entry points (used via .apply with method=...) ---------
    def band_params(self, y_cond: jnp.ndarray, scale: int, band: int) -> jnp.ndarray:
        """GMM parameter map for one (scale, band) from conditioning bands."""
        mdl, p = self._net(scale, band)
        return mdl.get_params(p, y_cond)

    def band_base(self, y_cond: jnp.ndarray, scale: int, band: int) -> jnp.ndarray:
        """Pre-activation layer-0 map (clrjnt0seqmd codec path)."""
        mdl, p = self._net(scale, band)
        return mdl.band_base(p, y_cond)

    def band_params_seq(self, base: jnp.ndarray, y_seq: jnp.ndarray,
                        scale: int, band: int, clr: int) -> jnp.ndarray:
        """Per-color GMM params from a layer-0 base (clrjnt0seqmd)."""
        mdl, p = self._net(scale, band)
        return mdl.params_from_base(p, base, y_seq, clr)

    def aux_loss(self) -> jnp.ndarray:
        """Aggregated quantile aux loss over factorized-prior bottleneck
        submodules (reference LLICTIBaseNet.aux_loss, LLICTI_nets.py:31-38).

        Vestigial like the reference's: the live interpolator stack
        contains no EntropyBottleneck (ops.factorized.FactorizedPrior), so
        the sum is empty (0.0).
        """
        return jnp.zeros(())
