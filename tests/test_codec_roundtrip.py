"""End-to-end codec bit-exactness tests (the reference's oracle:
decode(encode(x)) == x, agents/llicti_agent.py:151-162).

Works with untrained (random-init) params: losslessness must hold for any
model weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llicti_tpu.codec import Codec, bucket_range
from llicti_tpu.config import ModelConfig
from llicti_tpu.models.llicti import LLICTIModel


def small_cfg(**kw):
    base = dict(
        chs=(8, 8), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
        useprevlevNN=(False, True),
    )
    base.update(kw)
    return ModelConfig(**base)


def make_codec(cfg, seed=0, backend="device"):
    model = LLICTIModel(cfg=cfg)
    lev = max(cfg.dwtlevels) + 1
    x = jnp.zeros((1, 2 ** lev * 4, 2 ** lev * 4, 3))
    params = model.init(jax.random.PRNGKey(seed), x)
    return Codec(cfg, params, backend=backend, num_lanes=32)


def natural_image(h, w, seed=0):
    """Smooth gradients + texture + noise: natural-ish statistics."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (
        127 + 80 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
        + 40 * np.sin((xx + yy) / 41.0)
    )
    img = np.stack([base, base * 0.8 + 20, base * 0.6 + 50], axis=-1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_bucket_range():
    assert bucket_range(-5, 10) == (-32, 31)
    assert bucket_range(0, 0) == (0, 31)
    assert bucket_range(-255, 255) == (-256, 255)
    assert bucket_range(-32, 31) == (-32, 31)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_roundtrip_even_size(backend):
    cfg = small_cfg()
    codec = make_codec(cfg, backend=backend)
    img = natural_image(32, 32)
    streams = codec.compress(img)
    out = codec.decompress(streams)
    np.testing.assert_array_equal(out[0], img)
    assert codec.last_slice_bits is not None
    assert len(codec.last_slice_bits) == 2
    assert all(len(row) == 9 for row in codec.last_slice_bits)


def test_roundtrip_random_noise():
    cfg = small_cfg()
    codec = make_codec(cfg)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    streams = codec.compress(img)
    out = codec.decompress(streams)
    np.testing.assert_array_equal(out[0], img)


@pytest.mark.parametrize("h,w", [(17, 19), (33, 32), (30, 31), (21, 24)])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_roundtrip_odd_sizes(h, w, backend):
    cfg = small_cfg()
    codec = make_codec(cfg, backend=backend)
    img = natural_image(h, w, seed=h * 100 + w)
    streams = codec.compress(img)
    out = codec.decompress(streams)
    assert out.shape == (1, h, w, 3)
    np.testing.assert_array_equal(out[0], img)


def test_backends_agree_on_rate():
    """Device-rANS and host-arithcoder rates should be within ~2%
    (same CDF quantization contract, different coders + lane flush)."""
    cfg = small_cfg()
    dev = make_codec(cfg, backend="device")
    hst = make_codec(cfg, backend="host")
    img = natural_image(48, 48, seed=3)
    b_dev = Codec.num_bytes(dev.compress(img))
    b_hst = Codec.num_bytes(hst.compress(img))
    assert abs(b_dev - b_hst) < 0.02 * b_hst + 32 * 4 + 64, (b_dev, b_hst)


def test_roundtrip_extreme_values():
    cfg = small_cfg()
    codec = make_codec(cfg)
    img = np.zeros((16, 16, 3), np.uint8)
    img[:8] = 255
    img[:, :4, 0] = 255
    streams = codec.compress(img)
    out = codec.decompress(streams)
    np.testing.assert_array_equal(out[0], img)


def test_serialize_roundtrip():
    cfg = small_cfg()
    codec = make_codec(cfg)
    img = natural_image(16, 24, seed=5)
    streams = codec.compress(img)
    blob = Codec.serialize(streams)
    back = Codec.deserialize(blob)
    assert back == streams
    out = codec.decompress(back)
    np.testing.assert_array_equal(out[0], img)


def test_bpp_reasonable():
    # even untrained, raw-band + coded bits must stay below 3x8 bpsp * 1.5
    cfg = small_cfg()
    codec = make_codec(cfg)
    img = natural_image(32, 32, seed=9)
    streams = codec.compress(img)
    bits = Codec.num_bytes(streams) * 8
    bpsp = bits / img.size
    assert bpsp < 12.0, bpsp


def test_three_scale_roundtrip():
    cfg = small_cfg(chs=(8, 8, 8), evens=(4, 4, 4), odds=(3, 3, 3),
                    dwtlevels=(0, 1, 2), useprevlevNN=(False, True, True))
    codec = make_codec(cfg)
    img = natural_image(40, 56, seed=11)
    streams = codec.compress(img)
    out = codec.decompress(streams)
    np.testing.assert_array_equal(out[0], img)


def test_pipelined_many_roundtrip():
    """compress_many/decompress_many pipeline == per-image results."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    imgs = [natural_image(32, 32, seed=s) for s in (1, 2, 3)]
    singles = [codec.compress(im) for im in imgs]
    manys = codec.compress_many(imgs)
    for s1, s2 in zip(singles, manys):
        assert [len(x) for g in s1 for x in g] == [
            len(x) for g in s2 for x in g]
        assert all(a == b for g1, g2 in zip(s1, s2)
                   for a, b in zip(g1, g2))
    outs = codec.decompress_many(manys)
    for im, out in zip(imgs, outs):
        assert np.array_equal(out[0], im)


def test_pipelined_many_per_image_accounting():
    """compress_many keeps one accounting table per image (two DIFFERENT
    images), matching the per-image compress tables; last_slice_bits /
    last_ideal_bits are the elementwise sums (compress_batch contract)."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    imgs = [natural_image(32, 32, seed=101),
            natural_image(32, 32, seed=202)]
    ref_act, ref_ideal = [], []
    for im in imgs:
        codec.compress(im)
        ref_act.append(codec.last_slice_bits)
        ref_ideal.append(codec.last_ideal_bits)
    # the two images must actually differ in coded size for this test
    # to distinguish per-image tables from last-image-only
    assert ref_act[0] != ref_act[1]
    codec.compress_many(imgs)
    assert codec.last_slice_bits_batch == ref_act
    for got, ref in zip(codec.last_ideal_bits_batch, ref_ideal):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-6)
    S = cfg.num_scales
    for s in range(S):
        for i in range(9):
            assert codec.last_slice_bits[s][i] == (
                ref_act[0][s][i] + ref_act[1][s][i])
            np.testing.assert_allclose(
                codec.last_ideal_bits[s][i],
                ref_ideal[0][s][i] + ref_ideal[1][s][i], rtol=1e-6)


def test_two_stage_roundtrip_and_split_point():
    """two_stage=True: the pipeline splits at the finest scale (head =
    coarse scales on the stream PREFIX, tail = scale 0 + chain), both
    directions on the same head/tail executables.  The container header
    records the exact head split point so a decoder can dispatch the
    head after uploading only the prefix (partial-stream decode)."""
    cfg = small_cfg()
    model = LLICTIModel(cfg=cfg)
    x = jnp.zeros((1, 16, 16, 3))
    params = model.init(jax.random.PRNGKey(0), x)
    codec = Codec(cfg, params, num_lanes=32, two_stage=True)
    img = natural_image(48, 56, seed=33)
    streams = codec.compress(img)
    hdr = streams[0][0]
    assert len(hdr) == 17
    head_words = int(np.frombuffer(hdr[13:17], np.uint32)[0])
    total_words = (len(streams[1][0]) - codec.N * 4) // 2
    assert 0 < head_words < total_words
    # header head_words == the coarse scales' slice accounting
    assert head_words == sum(
        sum(row) for row in codec.last_slice_bits[:-1]) // 16
    out = codec.decompress(streams, xorg=img)
    np.testing.assert_array_equal(out[0], img)
    assert codec.last_ycocg_err == 0
    # pipelined + resident + batch paths share the same program pair
    outs = codec.decompress_many([streams, streams])
    assert all(np.array_equal(o[0], img) for o in outs)
    fn = codec.prepare_decode(streams)
    np.testing.assert_array_equal(np.asarray(jax.device_get(fn()))[0], img)
    bst = codec.compress_batch([img, img])
    bouts = codec.decompress_batch(bst)
    assert all(np.array_equal(o, img) for o in bouts)


def test_two_stage_three_scales():
    """Head covers MULTIPLE coarse scales when S > 2."""
    cfg = small_cfg(chs=(8, 8, 8), evens=(4, 4, 4), odds=(3, 3, 3),
                    dwtlevels=(0, 1, 2), useprevlevNN=(False, True, True))
    model = LLICTIModel(cfg=cfg)
    x = jnp.zeros((1, 16, 16, 3))
    params = model.init(jax.random.PRNGKey(1), x)
    codec = Codec(cfg, params, num_lanes=32, two_stage=True)
    img = natural_image(40, 56, seed=35)
    streams = codec.compress(img)
    out = codec.decompress(streams)
    np.testing.assert_array_equal(out[0], img)


def test_two_stage_with_size_bucket():
    """two_stage composes with the pad-to-bucket compile strategy (the
    eval fallback path for crash-listed shape families)."""
    cfg = small_cfg()
    model = LLICTIModel(cfg=cfg)
    x = jnp.zeros((1, 16, 16, 3))
    params = model.init(jax.random.PRNGKey(2), x)
    codec = Codec(cfg, params, num_lanes=32, two_stage=True, size_bucket=16)
    img = natural_image(37, 45, seed=39)  # ragged -> pads to 48x48
    streams = codec.compress(img)
    out = codec.decompress(streams)
    assert out.shape == (1, 37, 45, 3)
    np.testing.assert_array_equal(out[0], img)


def test_two_stage_cross_family_decode():
    """A fused-codec stream decodes losslessly on a two_stage codec of
    the same params (and vice versa) on this backend — evidence the two
    program families compute identical CDFs.  (Production guidance stays:
    match the family across encoder and decoder, like num_lanes.)"""
    cfg = small_cfg()
    model = LLICTIModel(cfg=cfg)
    x = jnp.zeros((1, 16, 16, 3))
    params = model.init(jax.random.PRNGKey(0), x)
    fused = Codec(cfg, params, num_lanes=32)
    split = Codec(cfg, params, num_lanes=32, two_stage=True)
    img = natural_image(32, 48, seed=37)
    s_fused = fused.compress(img)
    s_split = split.compress(img)
    # same payload bytes from both encoders
    assert s_fused[1][0] == s_split[1][0]
    np.testing.assert_array_equal(split.decompress(s_fused)[0], img)
    np.testing.assert_array_equal(fused.decompress(s_split)[0], img)


def test_decompress_xorg_check():
    """Pre-color-transform decode check (reference decompres(..., xorg),
    LLICTI_nets.py:168-171): decoded YCoCg == transform(original)."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    img = natural_image(24, 28, seed=21)
    streams = codec.compress(img)
    out = codec.decompress(streams, xorg=img)
    assert np.array_equal(out[0], img)
    assert codec.last_ycocg_err == 0


def test_batch_container_roundtrip():
    """K same-shape images encoded by the K-batched executable and
    decoded by the same one: lossless per image, serialize round-trips."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    imgs = [natural_image(32, 40, seed=s) for s in range(4)]
    streams = codec.compress_batch(imgs)
    blob = Codec.serialize(streams)
    outs = codec.decompress_batch(Codec.deserialize(blob))
    assert len(outs) == 4
    for img, out in zip(imgs, outs):
        assert out.shape == img.shape
        np.testing.assert_array_equal(out, img)
    # rate sanity: random-init params code near-uniform (~8+ bits/sym);
    # the container must stay within ~2x of raw plus header overhead
    assert Codec.num_bytes(streams) < 2 * sum(i.size for i in imgs)


def test_batch_container_identical_images_identical_streams():
    """K copies of one image must produce byte-identical per-image blobs
    (per-image lanes are independent inside the batched program)."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    img = natural_image(48, 32, seed=9)
    streams = codec.compress_batch([img, img, img])
    assert streams[1][0] == streams[2][0] == streams[3][0]


def test_batch_container_odd_sizes_and_ragged_origs():
    """Odd H/W exercise pad flags inside the batched program."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    imgs = [natural_image(33, 37, seed=s) for s in range(2)]
    streams = codec.compress_batch(imgs)
    outs = codec.decompress_batch(streams)
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, img)


def test_resident_paths_match_wire_paths():
    """prepare_decode/prepare_encode (the serving steady-state closures
    bench.py times) must reproduce the wire paths exactly: the resident
    decode yields the decompress() image, the resident encode's buffer +
    cursors repack into the compress() blob byte-for-byte."""
    import jax

    from llicti_tpu.coder import rans_device as rd

    cfg = small_cfg()
    codec = make_codec(cfg)
    img = natural_image(33, 37, seed=8)  # odd size: pad/crop path too
    streams = codec.compress(img)
    ref = codec.decompress(streams)
    dec_fn = codec.prepare_decode(streams)
    rgb = np.asarray(jax.device_get(dec_fn()))
    np.testing.assert_array_equal(rgb[:, :33, :37], ref)
    np.testing.assert_array_equal(rgb[0, :33, :37], img)
    enc_fn = codec.prepare_encode(img)
    cursors, states, buf, _ideal = (np.asarray(jax.device_get(h))
                                    for h in enc_fn())
    blob = rd.pack_stream_packed(buf[0][: int(cursors[0, -1])], states[0])
    assert blob == streams[1][0]
    # batched resident decode matches decompress_batch
    imgs = [natural_image(32, 40, seed=s) for s in (1, 2)]
    bstreams = codec.compress_batch(imgs)
    ref_outs = codec.decompress_batch(bstreams)
    bfn = codec.prepare_decode_batch(bstreams)
    brgb = np.asarray(jax.device_get(bfn()))
    for k, (im, r) in enumerate(zip(imgs, ref_outs)):
        np.testing.assert_array_equal(brgb[k, :32, :40], r)
        np.testing.assert_array_equal(brgb[k, :32, :40], im)


def test_batch_container_slice_bits_accounting():
    """compress_batch keeps per-image AND summed slice-bit tables: the
    per-image word counts must equal each per-image blob's payload, and
    the summed table is what the est/act cross-check consumes."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    imgs = [natural_image(32, 40, seed=s) for s in (3, 5)]
    streams = codec.compress_batch(imgs)
    assert codec.last_slice_bits is not None
    assert len(codec.last_slice_bits_batch) == 2
    from llicti_tpu.coder import rans_device as rd
    for k, table in enumerate(codec.last_slice_bits_batch):
        bits = sum(sum(row) for row in table)
        states_np, words_np = rd.unpack_stream(streams[1 + k][0], codec.N)
        assert bits == words_np.size * 16
    total = sum(sum(row) for row in codec.last_slice_bits)
    assert total == sum(sum(sum(r) for r in t)
                        for t in codec.last_slice_bits_batch)


def test_batch_matches_single_rate_ballpark():
    """Union ranges cost a little rate vs per-image dynamic ranges, but
    the batch must stay within a few percent for similar images."""
    cfg = small_cfg()
    codec = make_codec(cfg)
    imgs = [natural_image(32, 32, seed=s) for s in range(3)]
    single_bytes = sum(Codec.num_bytes(codec.compress(i)) for i in imgs)
    batch_bytes = Codec.num_bytes(codec.compress_batch(imgs))
    assert batch_bytes < 1.1 * single_bytes
