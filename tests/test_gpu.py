"""Tests of what only the GPU can show: the codec on the card and its
pinned conv precision.  They skip elsewhere; ``chip_smoke.py`` runs them
on the card (``LLICTI_TEST_PLATFORM=gpu pytest -m gpu``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llicti_tpu.codec import CONV_PRECISION, Codec
from llicti_tpu.coder.rans_device import cdf_float_to_cum_int32
from llicti_tpu.models.llicti import LLICTIModel
from llicti_tpu.ops.gmm import cdf_sampling_points, gmm_cdf_table

from test_codec_roundtrip import natural_image, small_cfg

pytestmark = pytest.mark.gpu


def test_codec_gpu_roundtrip(gpu_device):
    """Lossless on the card on an odd-sized image (chip_smoke.py covers
    the other codec paths at full size)."""
    cfg = small_cfg()
    params = LLICTIModel(cfg=cfg).init(jax.random.PRNGKey(0))
    codec = Codec(cfg, params, num_lanes=64)
    img = natural_image(45, 61, seed=9)
    np.testing.assert_array_equal(codec.decompress(codec.compress(img))[0],
                                  img)


def test_conv_precision_is_float32_on_gpu(gpu_device):
    """At the codec's precision the GPU's interpolator output matches the
    CPU's to f32 rounding (TF32 would leave ~1e-3 relative errors)."""
    cfg = small_cfg()
    model = LLICTIModel(cfg=cfg, precision=CONV_PRECISION)
    params = model.init(jax.random.PRNGKey(1))
    y = np.random.default_rng(2).uniform(-0.4, 0.4, (1, 40, 56, 12)).astype(
        np.float32)

    def run(device):
        with jax.default_device(device):
            return np.asarray(jax.jit(lambda p, v: model.apply(
                p, v, 0, 2, method=LLICTIModel.band_params))(
                    params, jnp.asarray(y)))

    got, want = run(gpu_device), run(jax.devices("cpu")[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cdf_table_gpu_within_two_steps_of_cpu(gpu_device):
    """The XLA CDF path on the card against the CPU's (different erfc
    code): within 2 quantization steps, with the table contract."""
    rng = np.random.default_rng(3)
    M, lead = 5, (37, 53)
    s = rng.uniform(0.002, 0.2, lead + (M,)).astype(np.float32)
    m = rng.uniform(-0.4, 0.4, lead + (M,)).astype(np.float32)
    w = rng.uniform(0.05, 1.0, lead + (M,)).astype(np.float32)
    pts = np.asarray(cdf_sampling_points(-255, 256))

    def run(device):
        with jax.default_device(device):
            return np.asarray(jax.jit(lambda *a: cdf_float_to_cum_int32(
                gmm_cdf_table(*a)))(pts, s, m, w), np.int64)

    got, want = run(gpu_device), run(jax.devices("cpu")[0])
    assert np.abs(got - want).max() <= 2
    assert (got[..., -1] == 1 << 16).all()
    assert (np.diff(got, axis=-1) >= 1).all()
