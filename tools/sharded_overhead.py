#!/usr/bin/env python
"""Quantify the sharded codec's stream-size overhead vs single-chip.

VERDICT r3 weak #7: the per-shard cost (G lane-state flushes of N*4 B
each + replicate-pad seam rows) was only *bounded* by a +20% toy test,
never *measured* at realistic sizes.  This tool runs the flagship
5-scale model on a 512x768 crop through the single-chip Codec and the
ShardedCodec at G in {2, 4, 8} on the virtual CPU mesh (no multi-chip
hardware needed) and writes a table under experiments/.

Usage:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python tools/sharded_overhead.py
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import load_rgb, synthetic_image
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.parallel.codec_sp import ShardedCodec, make_sp_mesh
    from llicti_tpu.utils.checkpoint import CheckpointManager

    H, W = 512, 768
    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3)))
    try:
        params, meta = CheckpointManager(
            os.path.join(REPO, "bench_ckpt")).load("bench", params)
        print(f"trained params: {meta}", file=sys.stderr)
    except FileNotFoundError:
        meta = {}

    img = None
    test_dir = os.path.join(REPO, "data_corpus", "test")
    if os.path.isdir(test_dir):
        for f in sorted(os.listdir(test_dir)):
            full = load_rgb(os.path.join(test_dir, f))
            if full.shape[0] >= H and full.shape[1] >= W:
                img = np.ascontiguousarray(full[:H, :W])
                print(f"image: {f} crop {img.shape}", file=sys.stderr)
                break
    if img is None:
        img = synthetic_image(H, W, seed=42)

    # lane counts matching the per-shard work: the single-chip codec at
    # 1024 lanes (bench configuration) vs per-shard 1024//G so the TOTAL
    # lane count (and so the flush overhead budget) is comparable
    N_single = 1024
    single = Codec(cfg, params, num_lanes=N_single)
    nb_single = Codec.num_bytes(single.compress(img))
    out = single.decompress(single.compress(img))
    assert np.array_equal(out[0], img)
    print(f"single-chip: {nb_single} B "
          f"({nb_single * 8 / img.size:.4f} bpsp)", file=sys.stderr)

    rows = []
    for G in (2, 4, 8):
        N = max(64, N_single // G)
        codec = ShardedCodec(cfg, params, mesh=make_sp_mesh(shards=G),
                             num_lanes=N)
        streams = codec.compress(img)
        nb = ShardedCodec.num_bytes(streams)
        out = codec.decompress(streams, xorg=img)
        ok = bool(np.array_equal(out[0], img))
        oh_pct = (nb - nb_single) / nb_single * 100
        flush = G * N * 4
        rows.append(dict(G=G, lanes_per_shard=N, bytes=nb,
                         bpsp=round(nb * 8 / img.size, 4),
                         overhead_bytes=nb - nb_single,
                         overhead_pct=round(oh_pct, 3),
                         state_flush_bytes=flush, lossless=ok,
                         ycocg_err=codec.last_ycocg_err))
        print(f"G={G}: {nb} B  (+{oh_pct:.2f}% vs single, "
              f"flush {flush} B, lossless={ok})", file=sys.stderr)

    result = dict(image=f"{H}x{W}", checkpoint=meta,
                  single_chip_bytes=nb_single,
                  single_chip_bpsp=round(nb_single * 8 / img.size, 4),
                  single_chip_lanes=N_single, sharded=rows)
    out_path = os.path.join(REPO, "experiments", "sharded_overhead.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
