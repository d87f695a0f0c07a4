"""The plain-JAX model, the .npz checkpoints and the compile-cache helper.

Reference numbers (tests/data/flax_reference.json) were recorded from the
Flax/Orbax implementation this code replaces: its parameter-tree layout
for several configs, and, with the committed bench weights, its
``band_params`` maps, its rate estimate and the codec's exact stream.
"""
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llicti_tpu.codec import Codec
from llicti_tpu.config import ModelConfig
from llicti_tpu.data.dataset import synthetic_natural_image
from llicti_tpu.models.llicti import LLICTIModel
from llicti_tpu.training.steps import init_state
from llicti_tpu.utils import compile_cache
from llicti_tpu.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = json.load(open(os.path.join(REPO, "tests", "data",
                                  "flax_reference.json")))
SMALL = dict(chs=[8, 1], evens=[4, 4], odds=[3, 3], dwtlevels=[0, 1],
             useprevlevNN=[False, True], num_mixtures=3)
VARIANTS = {
    "prelu": dict(activfun="PReLU"),
    "gdn": dict(activfun="GDN1"),
    "seqmd": dict(clr_joint_mode=0, clrjnt0seqmd=True),
    "combine": dict(combine_layers1toL=True),
    "clrjnt1": dict(clr_joint_mode=1),
    "leaky4": dict(activfun="LeakyReLU", conv_layers=4),
}


def _shapes(params):
    return {jax.tree_util.keystr(k): list(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _cfg(name):
    if name == "paper":
        return ModelConfig()
    return dataclasses.replace(ModelConfig(), **{**SMALL, **VARIANTS[name]})


@pytest.mark.parametrize("name", ["paper"] + sorted(VARIANTS))
def test_param_tree_matches_flax_layout(name):
    model = LLICTIModel(cfg=_cfg(name))
    assert _shapes(model.init(jax.random.PRNGKey(0))) == REF["shapes"][name]


def test_init_matches_flax_bit_for_bit():
    """Parameter keys derive from their paths as under Flax, so a seed
    gives the very weights it gave there."""
    params = LLICTIModel(cfg=ModelConfig()).init(jax.random.PRNGKey(3))
    h = hashlib.sha256()
    for k, v in sorted((jax.tree_util.keystr(k), v) for k, v in
                       jax.tree_util.tree_flatten_with_path(params)[0]):
        h.update(k.encode())
        h.update(np.asarray(v).tobytes())
    assert h.hexdigest() == REF["init_sha256_paper_seed3"]


def test_init_is_torch_default_uniform():
    """Kernels and biases ~ U(+-1/sqrt(fan_in)) (torch Conv2d default)."""
    params = LLICTIModel(cfg=ModelConfig()).init(jax.random.PRNGKey(3))
    conv = params["params"]["models_0_0"]["trunk_0"]["Conv_0"]
    k = np.asarray(conv["kernel"])  # [1, 1, 88, 352], fan_in 88
    bound = 1 / math.sqrt(88)
    assert np.abs(k).max() <= bound
    assert abs(k.std() - bound / math.sqrt(3)) < 0.02 * bound
    assert abs(k.mean()) < 0.02 * bound
    assert np.abs(np.asarray(conv["bias"])).max() <= bound


@pytest.fixture(scope="module")
def bench():
    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    params, meta = CheckpointManager(os.path.join(REPO, "bench_ckpt")).load(
        "bench", model.init(jax.random.PRNGKey(0)))
    img = synthetic_natural_image(64, 96, seed=11)
    return cfg, model, params, meta, img


def test_bench_ckpt_loads_into_paper_tree(bench):
    cfg, model, params, meta, _img = bench
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == 24
    assert sum(v.size for _k, v in leaves) == 196596
    assert meta["steps"] == 137500
    h = hashlib.sha256()
    for k, v in sorted((jax.tree_util.keystr(k), v) for k, v in leaves):
        h.update(k.encode())
        h.update(np.asarray(v).tobytes())
    assert h.hexdigest() == REF["bench_params_sha256"]


def test_band_params_match_flax(bench):
    cfg, model, params, _meta, img = bench
    x = jnp.asarray(img[None].astype(np.float32) / 255.0)
    y_list = model.apply(params, x, method=LLICTIModel.transform)
    c = cfg.cond_channels
    for key, ref in REF["band_params"].items():
        scl, b = (int(v) for v in key.split("_"))
        pm = np.asarray(model.apply(params, y_list[scl][..., :c * (b + 1)],
                                    scl, b, method=LLICTIModel.band_params))
        assert list(pm.shape) == ref["shape"]
        np.testing.assert_allclose(pm.reshape(-1)[:4], ref["first"],
                                   rtol=1e-6)
        np.testing.assert_allclose(pm.sum(), ref["sum"], rtol=1e-5)
        np.testing.assert_allclose(np.abs(pm).sum(), ref["abssum"],
                                   rtol=1e-5)


def test_rate_estimate_matches_flax(bench):
    _cfg_, model, params, _meta, img = bench
    x = jnp.asarray(img[None].astype(np.float32) / 255.0)
    si = model.apply(params, x)
    np.testing.assert_allclose([float(jnp.sum(s)) for s in si],
                               REF["rate_per_scale"], rtol=1e-5)


@pytest.mark.parametrize("lanes", [512, 1024])
def test_codec_stream_matches_flax(bench, lanes):
    """CPU codec with the converted bench weights gives the very stream
    (hence the bpsp) the Flax/Orbax code gave, and decodes losslessly."""
    cfg, _model, params, _meta, img = bench
    codec = Codec(cfg, params, num_lanes=lanes)
    streams = codec.compress(img)
    blob = Codec.serialize(streams)
    assert Codec.num_bytes(streams) == REF[f"codec_bytes_{lanes}"]
    assert hashlib.sha256(blob).hexdigest() == REF[
        f"codec_blob_sha256_{lanes}"]
    np.testing.assert_array_equal(codec.decompress(streams)[0], img)


def test_checkpoint_npz_roundtrip(tmp_path):
    """Params plus optax state (inject_hyperparams + Adam moments) and
    the step survive save/load bit-exactly; meta round-trips as JSON."""
    cfg = dataclasses.replace(ModelConfig(), **SMALL)
    model = LLICTIModel(cfg=cfg)
    state, tx = init_state(model, cfg, jax.random.PRNGKey(0),
                           jnp.zeros((2, 16, 16, 3)), 1e-3)
    grads = jax.tree.map(jnp.ones_like, state.params)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    state = state._replace(params=optax.apply_updates(state.params, updates),
                           opt_state=opt_state, step=state.step + 7)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("checkpoint", state, {"epoch": 3}, is_best=True)
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint.meta.json", "checkpoint.npz", "model_best.meta.json",
        "model_best.npz"]
    fresh, _tx = init_state(model, cfg, jax.random.PRNGKey(1),
                            jnp.zeros((2, 16, 16, 3)), 1e-3)
    for name in ("checkpoint", "model_best"):
        got, meta = mgr.load(name, fresh)
        assert meta == {"epoch": 3}
        assert int(got.step) == 7
        a, ta = jax.tree_util.tree_flatten(state)
        b, tb = jax.tree_util.tree_flatten(got)
        assert ta == tb
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_rejects_other_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("p", {"a": jnp.zeros((2,)), "b": jnp.ones((3,))}, {})
    with pytest.raises(KeyError):
        mgr.load("p", {"a": jnp.zeros((2,)), "c": jnp.zeros((3,))})
    with pytest.raises(ValueError):
        mgr.load("p", {"a": jnp.zeros((4,)), "b": jnp.ones((3,))})
    with pytest.raises(FileNotFoundError):
        mgr.load("missing", {})


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.compile_cache_dir() == os.path.join(REPO,
                                                             ".jax_cache")
    assert compile_cache.enable_compile_cache() == os.path.join(
        REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        REPO, ".jax_cache")


def test_compile_cache_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper reports it and sets
    no directory of its own."""
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_chip_smoke_refuses_cpu():
    """No GPU: non-zero exit, and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
