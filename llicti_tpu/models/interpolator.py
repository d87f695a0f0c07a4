"""Interpolator network: conditional-GMM parameter CNN for one (scale, band).

Re-design of the reference's ``LLICTIEntropyModel4``
(graphs/models/LLICTI_nets.py:585-952):

* NHWC layout, plain JAX (``models/module.py``), XLA grouped convs
  (feature_group_count).
* Layer 0 is band-geometry specific: small Ev/Od kernels with asymmetric
  replicate padding aligning receptive fields with polyphase sample
  positions (reference :650-682).
* Layers 1..L-1 are grouped 1x1 convs (batched matmuls).
* Output: GMM parameters; channel layouts per clr_joint_mode documented in
  :meth:`self_informations` (reference :827-935).

Weight init matches torch Conv2d defaults (kaiming-uniform a=sqrt(5), i.e.
U(+-1/sqrt(fan_in)) for both kernel and bias) so training dynamics are
comparable.  The parameter tree keeps the layout of the Flax modules the
trained checkpoints were written with: ``conv_*``/``seq_to*``/``trunk_i``
convs hold ``{"Conv_0": {"kernel", "bias"}}``, PReLU/GDN1 activations
hold ``{"PReLU_0": {"alpha"}}``/``{"GDN1_0": {"beta", "gamma"}}``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ModelConfig
from ..ops.gdn import GDN1
from ..ops.gmm import gmm_self_information
from .module import conv, conv_init


def _pad_edge(x, pad_lrtb):
    l, r, t, b = pad_lrtb
    return jnp.pad(x, ((0, 0), (t, b), (l, r), (0, 0)), mode="edge")


def _box_mean(x_padded, kh: int, kw: int) -> jnp.ndarray:
    """Frozen box-filter local mean (reference's _get_mean_filters,
    LLICTI_nets.py:714-719) as a VALID reduce_window — no parameters."""
    s = lax.reduce_window(x_padded, 0.0, lax.add, (1, kh, kw, 1),
                          (1, 1, 1, 1), "VALID")
    return s / (kh * kw)


class _Activation:
    """ReLU / LeakyReLU / per-channel PReLU (torch nn.PReLU(C), init
    0.25) / GDN1 / identity."""

    def __init__(self, kind: str, channels: int, precision=None):
        self.kind = kind
        self.channels = channels
        self.gdn = GDN1(channels, precision=precision)

    def init(self):
        """Parameters (constants: no key needed), None if parameter-free."""
        if self.kind == "PReLU":
            return {"PReLU_0": {"alpha": jnp.full((self.channels,), 0.25)}}
        if self.kind == "GDN1":
            return {"GDN1_0": self.gdn.init()["params"]}
        return None

    def __call__(self, p, x):
        if self.kind == "ReLU":
            return jax.nn.relu(x)
        if self.kind == "LeakyReLU":
            return jax.nn.leaky_relu(x, 0.01)  # torch default slope
        if self.kind == "PReLU":
            return jnp.where(x >= 0, x, p["PReLU_0"]["alpha"] * x)
        if self.kind == "GDN1":
            return self.gdn.apply({"params": p["GDN1_0"]}, x)
        return x


def interpolator_dims(cfg: ModelConfig, scale: int):
    """Compute (grps, Ch, Co, c, grp0) exactly as the reference
    (LLICTI_nets.py:622-649)."""
    M = cfg.num_mixtures
    ch = cfg.chs[scale]
    if cfg.clrchs == 3:
        if cfg.clr_joint_mode == 2:
            grps = 1 if cfg.mwsa_joint else 4
            Ch = grps * ch
            Co = 3 * M * 3 + 3 * M  # sigma/mu/w for 3 colors + (a,b,d)*M
        elif cfg.clr_joint_mode == 1:
            grps = 8
            Ch = grps * ch
            Co = M * 16
        elif cfg.clr_joint_mode == 0:
            grps = 3 if cfg.mwsa_joint else 9
            Ch = grps * ch
            Co = M * grps
        else:
            raise ValueError(cfg.clr_joint_mode)
    else:
        chs = [48, 32, 24, 24]
        if cfg.clrchs in (1, 2):
            chs = [int(i * 0.75) for i in chs]
        Ch = 3 * chs[scale]
        grps = 3
        Co = M * 3
    c = cfg.cond_channels
    grp0 = 1 if (cfg.clrchs < 3 or cfg.clr_joint_mode == 2) else (
        3 if cfg.clr_joint_mode == 0 else 2
    )
    return grps, Ch, Co, c, grp0


class Interpolator:
    """One conditional-GMM parameter network for a (scale, band).

    band in {0, 1, 2} or -1 (combine_layers1toL: one net serves all bands,
    dispatched on the conditioning channel count — reference :308-314).
    Methods take the network's parameter subtree ``p`` first.

    ``dense_groups`` (codec path) initializes the grouped convs as dense
    convs; the Codec instead expands trained grouped kernels to
    block-diagonal dense ones (``codec.dense_group_params``), whose
    zero blocks contribute exact 0.0 terms.  ``precision`` is the
    conv/matmul precision (None = XLA's default).
    """

    def __init__(self, cfg: ModelConfig, scale: int, band: int,
                 dense_groups: bool = False, precision=None):
        self.cfg, self.scale, self.band = cfg, scale, band
        self.dense_groups = dense_groups
        self.precision = precision
        grps, Ch, Co, c, grp0 = interpolator_dims(cfg, scale)
        self.grps, self.Ch, self.Co, self.c, self.grp0 = grps, Ch, Co, c, grp0
        Ev = cfg.evens[scale]
        Od = cfg.odds[scale]
        # layer-0 convs: name -> (kernel hw, pad (left, right, top, bottom),
        # conditioning unit), reference :650-682
        convs = {}
        if band in (0, -1):
            convs["conv_00_11"] = ((Ev, Ev), (Ev // 2 - 1, Ev // 2,
                                              Ev // 2 - 1, Ev // 2), 0)
        if band in (1, -1):
            convs["conv_00_01"] = ((Od, Ev), (Ev // 2 - 1, Ev // 2,
                                              Od // 2, Od // 2), 0)
            convs["conv_11_01"] = ((Ev, Od), (Od // 2, Od // 2,
                                              Ev // 2, Ev // 2 - 1), 1)
        if band in (2, -1):
            convs["conv_00_10"] = ((Ev, Od), (Od // 2, Od // 2,
                                              Ev // 2 - 1, Ev // 2), 0)
            convs["conv_11_10"] = ((Od, Ev), (Ev // 2, Ev // 2 - 1,
                                              Od // 2, Od // 2), 1)
            convs["conv_01_10"] = ((Ev, Ev), (Ev // 2, Ev // 2 - 1,
                                              Ev // 2 - 1, Ev // 2), 2)
        self.layer0 = convs
        # sequential-color conditioning on the *current* pixel's earlier
        # colors (reference :655-657, 666-668, 680-682)
        self.seq = (cfg.clrchs == 3 and cfg.clr_joint_mode == 0
                    and cfg.clrjnt0seqmd)
        self.act = _Activation(cfg.activfun, Ch, precision)
        # trunk: (Ly-1)-1 grouped 1x1 conv+act blocks, then 1x1 to Co
        self.n_trunk = 2 * (cfg.conv_layers - 2) + 1

    def init(self, rng, name: str):
        """Parameters of this network, module ``name`` under the root."""
        g0 = 1 if self.dense_groups else self.grp0
        gt = 1 if self.dense_groups else self.grps
        p = {}
        for conv_name, (kernel, _pad, _unit) in self.layer0.items():
            p[conv_name] = conv_init(rng, (name, conv_name), kernel, self.c,
                                     self.Ch, g0)
        if self.seq:
            p["seq_toCo"] = conv_init(rng, (name, "seq_toCo"), (1, 1), 1,
                                      self.Ch // 3)
            p["seq_toCg"] = conv_init(rng, (name, "seq_toCg"), (1, 1), 2,
                                      self.Ch // 3, bias_fan_in=1)
        act0 = self.act.init()
        if act0 is not None:
            p["act0"] = act0
        for i in range(self.n_trunk):
            path = (name, f"trunk_{i}")
            if i == self.n_trunk - 1:
                p[path[1]] = conv_init(rng, path, (1, 1), self.Ch, self.Co,
                                       gt)
            elif i % 2 == 0:
                p[path[1]] = conv_init(rng, path, (1, 1), self.Ch, self.Ch,
                                       gt)
            elif self.act.init() is not None:
                p[path[1]] = self.act.init()
        return p

    def _conv(self, p, x):
        return conv(p, x, self.precision)

    def _act(self, p, name, x):
        return self.act(p.get(name), x)

    # --- layer 0 -----------------------------------------------------------
    def _quant(self, x):
        r = self.cfg.rndfactor
        return jnp.round(x * r) / r

    def _band_specs(self, y_cond):
        """[(channel lo, hi), conv name] of the layer-0 convs this band
        sums (band -1 dispatches on the conditioning channel count)."""
        c = self.c
        band = self.band if self.band != -1 else y_cond.shape[-1] // c - 1
        if band not in (0, 1, 2):
            raise ValueError(f"bad band {band}")
        names = (("conv_00_11",), ("conv_00_01", "conv_11_01"),
                 ("conv_00_10", "conv_11_10", "conv_01_10"))[band]
        out = []
        for name in names:
            unit = self.layer0[name][2]
            out.append(((unit * c, (unit + 1) * c), name))
        return out

    def _layer0_submean(self, p, y_cond):
        """DC-removal variant: subtract the quantized box-filter local mean
        of each conditioning band before its layer-0 conv, and return the
        (quantized) averaged mean to re-bias the predicted variable.

        The reference's subtract_mean branch (LLICTI_nets.py:755-800) is
        vestigial/dead there (it calls a method that no longer exists);
        this is a working re-design of the same idea.
        """
        specs = self._band_specs(y_cond)
        out = None
        mean_sum = None
        for (lo, hi), name in specs:
            (kh, kw), pad, _unit = self.layer0[name]
            xb = y_cond[..., lo:hi]
            mn = _box_mean(_pad_edge(xb, pad), kh, kw)
            mnq = self._quant(mn)
            o = self._conv(p[name], _pad_edge(xb - mnq, pad))
            out = o if out is None else out + o
            mean_sum = mn if mean_sum is None else mean_sum + mn
        mean = self._quant(mean_sum / len(specs))
        return out, mean

    def _layer0_convs(self, p, y_cond):
        """Band-geometry conv sum (pre-activation, pre-seq)."""
        out = None
        for (lo, hi), name in self._band_specs(y_cond):
            pad = self.layer0[name][1]
            o = self._conv(p[name], _pad_edge(y_cond[..., lo:hi], pad))
            out = o if out is None else out + o
        return out

    def _layer0(self, p, y_cond, y_topred=None):
        out = self._layer0_convs(p, y_cond)
        if self.seq and y_topred is not None:
            out = self._apply_seq(p, out, y_topred, upto_clr=2)
        return self._act(p, "act0", out)

    def _apply_seq(self, p, base, y_seq, upto_clr: int):
        """Sequential-color layer-0 additions (reference :655-657,
        666-668, 680-682): the *current* pixel's earlier colors feed the
        later colors' channel groups.  Group-local, so color i's trunk
        output depends only on colors < i (causal for the codec)."""
        K = base.shape[-1] // 9
        if upto_clr >= 1:
            base = base.at[..., 3 * K:6 * K].add(
                self._conv(p["seq_toCo"], y_seq[..., 0:1]))
        if upto_clr >= 2:
            base = base.at[..., 6 * K:9 * K].add(
                self._conv(p["seq_toCg"], y_seq[..., 0:2]))
        return base

    def _trunk(self, p, h):
        for i in range(self.n_trunk):
            name = f"trunk_{i}"
            if i % 2 == 0:
                h = self._conv(p[name], h)
            else:
                h = self._act(p, name, h)
        return h

    # --- public API --------------------------------------------------------
    def get_params(self, p, y_cond, y_topred=None):
        """NN forward: conditioning bands -> GMM parameter map [B,H,W,Co].

        Codec path; assumes subtract_mean is off (as the reference's
        get_params does, LLICTI_nets.py:820-825)."""
        assert not self.cfg.subtract_mean
        return self._trunk(p, self._layer0(p, y_cond, y_topred))

    def band_base(self, p, y_cond):
        """Codec path for clrjnt0seqmd: pre-activation layer-0 sum."""
        return self._layer0_convs(p, y_cond)

    def params_from_base(self, p, base, y_seq, clr: int):
        """Codec path for clrjnt0seqmd: apply the seq additions causal up
        to color ``clr``, then activation + trunk.  Requires an
        elementwise activation (GDN1 couples channel groups and would
        break the per-color causality)."""
        assert self.cfg.activfun != "GDN1"
        return self._trunk(p, self._act(
            p, "act0", self._apply_seq(p, base, y_seq, clr)))

    def __call__(self, p, y_cond, y_topred):
        """Training forward: self-information map [B,H,W,c]."""
        if self.cfg.subtract_mean:
            out, mean = self._layer0_submean(p, y_cond)
            params = self._trunk(p, self._act(p, "act0", out))
            return self.self_informations(params, y_topred - mean)
        params = self.get_params(p, y_cond, y_topred if self.seq else None)
        return self.self_informations(params, y_topred)

    def self_informations(self, params, y):
        """GMM likelihood -> -log2 p per pixel/color.

        Channel layouts per clr_joint_mode (reference :827-935):
          mode 2: [3M sigma | 3M mu | 3M w | M a | M b | M d]; cross-color
                  mean updates mu_Co += a*Y, mu_Cg += b*Y + d*Co.
          mode 0: per color i: [M sigma | M mu | M w] at offset 3iM.
          mode 1: Y uses 2M mixtures, CoCg M each; Cg mean updated from Co.
        """
        cfg = self.cfg
        M = cfg.num_mixtures
        logistic = cfg.distribution == "logistic"
        if cfg.clrchs == 3 and cfg.clr_joint_mode == 2:
            stdev = params[..., 0:3 * M]
            mean = params[..., 3 * M:6 * M]
            w = params[..., 6 * M:9 * M]
            a = params[..., 9 * M:10 * M]
            b = params[..., 10 * M:11 * M]
            d = params[..., 11 * M:12 * M]
            mean = mean.at[..., M:2 * M].add(a * y[..., 0:1])
            mean = mean.at[..., 2 * M:3 * M].add(b * y[..., 0:1] + d * y[..., 1:2])
            return gmm_self_information(y[..., 0:3], stdev, mean, w, M,
                                        logistic=logistic)
        if cfg.clrchs == 3 and cfg.clr_joint_mode == 0:
            stdev = jnp.concatenate(
                [params[..., 0:M], params[..., 3 * M:4 * M], params[..., 6 * M:7 * M]], -1)
            mean = jnp.concatenate(
                [params[..., M:2 * M], params[..., 4 * M:5 * M], params[..., 7 * M:8 * M]], -1)
            w = jnp.concatenate(
                [params[..., 2 * M:3 * M], params[..., 5 * M:6 * M], params[..., 8 * M:9 * M]], -1)
            return gmm_self_information(y[..., 0:3], stdev, mean, w, M,
                                        logistic=logistic)
        if cfg.clrchs == 3 and cfg.clr_joint_mode == 1:
            # channel order of y is (0, Y, Co, Cg); reference :892-915
            stdev_Y = params[..., 2 * M:4 * M]
            mean_Y = params[..., 4 * M:6 * M]
            w_Y = params[..., 6 * M:8 * M]
            stdev_C = params[..., 8 * M:10 * M]
            mean_C = params[..., 10 * M:12 * M]
            w_C = params[..., 12 * M:14 * M]
            a = params[..., 14 * M:15 * M]
            mean_C = mean_C.at[..., M:2 * M].add(a * y[..., 2:3])
            si_Y = gmm_self_information(y[..., 1:2], stdev_Y, mean_Y, w_Y, 2 * M,
                                        logistic=logistic)
            si_C = gmm_self_information(y[..., 2:4], stdev_C, mean_C, w_C, M,
                                        logistic=logistic)
            return jnp.concatenate([si_Y, si_C], axis=-1)
        # single channel (clrchs < 3)
        stdev = params[..., 0:M]
        mean = params[..., M:2 * M]
        w = params[..., 2 * M:3 * M]
        return gmm_self_information(y[..., 0:1], stdev, mean, w, M,
                                    logistic=logistic)
