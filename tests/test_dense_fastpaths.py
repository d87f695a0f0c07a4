"""Equivalence guards for the codec's fast execution paths.

The codec runs grouped convs as dense block-diagonal convs (dense_groups
+ dense_group_params); they must stay equivalent to the training-path
math for every clr_joint_mode, and the codec must stay lossless over the
whole coded variant matrix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llicti_tpu.codec import Codec, dense_group_params
from llicti_tpu.models.llicti import LLICTIModel

from test_codec_roundtrip import small_cfg


@pytest.mark.parametrize("kw", [
    dict(clr_joint_mode=2),
    dict(clr_joint_mode=1),
    dict(clr_joint_mode=0),
    dict(clr_joint_mode=2, mwsa_joint=True),
    dict(clr_joint_mode=2, combine_layers1toL=True),
])
def test_dense_groups_match_grouped(kw):
    """dense block-diagonal kernels produce the grouped conv's outputs."""
    cfg = small_cfg(**kw)
    model_g = LLICTIModel(cfg=cfg)
    model_d = LLICTIModel(cfg=cfg, dense_groups=True)
    c = cfg.cond_channels
    y = jax.random.uniform(jax.random.PRNGKey(1), (1, 16, 16, 4 * c),
                           minval=-0.4, maxval=0.4)
    params = model_g.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params_d = dense_group_params(params, cfg)
    for b in range(3):
        pg = model_g.apply(params, y[..., : c * (b + 1)], 0, b,
                           method=LLICTIModel.band_params)
        pd = model_d.apply(params_d, y[..., : c * (b + 1)], 0, b,
                           method=LLICTIModel.band_params)
        np.testing.assert_allclose(np.asarray(pg), np.asarray(pd),
                                   rtol=2e-5, atol=2e-6)


def test_dynamic_y_range_header_roundtrip():
    """Y range restriction is lossless and shrinks the Y table for
    low-dynamic-range images."""
    cfg = small_cfg()
    from test_codec_roundtrip import make_codec

    codec = make_codec(cfg)
    rng = np.random.default_rng(0)
    dark = (rng.random((32, 32, 3)) * 40).astype(np.uint8)  # low range
    streams = codec.compress(dark)
    out = codec.decompress(streams)
    np.testing.assert_array_equal(out[0], dark)
    minmax = np.frombuffer(streams[0][1], np.int16)
    lo, hi = codec._clr_range(0, [int(v) for v in minmax])
    assert hi - lo < 255  # restricted vs the fixed [-127, 128]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(distribution="logistic"),
    dict(clr_joint_mode=1),
    dict(clr_joint_mode=1, distribution="logistic"),
    dict(clr_joint_mode=0),
    dict(clr_joint_mode=0, distribution="logistic"),
    dict(clr_joint_mode=0, clrjnt0seqmd=True),
    dict(clr_joint_mode=0, clrjnt0seqmd=True, distribution="logistic"),
])
def test_roundtrip_variant_matrix(kw):
    """Full codec round-trip over the coded variant matrix {clrjnt 0/1/2,
    seqmd} x {normal, logistic} on an odd size (crop path too): the
    encoder's (start, freq) lookups must feed the encode chain exactly,
    and a second encoder instance gives the same stream."""
    cfg = small_cfg(**kw)
    from test_codec_roundtrip import natural_image

    model = LLICTIModel(cfg=cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    codec = Codec(cfg, params, num_lanes=16)
    img = natural_image(33, 37, seed=4)
    streams = codec.compress(img)
    out = codec.decompress(streams)
    np.testing.assert_array_equal(out[0], img)
    s2 = Codec(cfg, params, num_lanes=16).compress(img)
    assert Codec.serialize(s2) == Codec.serialize(streams)
