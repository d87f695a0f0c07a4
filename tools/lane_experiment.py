#!/usr/bin/env python
"""Device-sustained decode sweep over rANS lane counts and batch K.

The decode program's rANS scan step count is n_syms/num_lanes, so more
lanes trade stream size (+N*4 B lane flush, +renorm slack) for scan
time.  bench.py fixed 1024 after r4's 512-vs-1024 measurement; this
sweeps further and prints one JSON line per variant so the winner can
be promoted with evidence.  Needs a GPU to itself.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import jax

    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import synthetic_natural_image
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.utils.checkpoint import CheckpointManager

    H, W = 512, 768
    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    params, meta = CheckpointManager(
        os.path.join(REPO, "bench_ckpt")).load(
            "bench", model.init(jax.random.PRNGKey(0)))
    if jax.devices()[0].platform != "gpu":
        sys.exit("lane_experiment: needs a GPU")
    img = synthetic_natural_image(H, W, seed=2024)
    mp = H * W / 1e6

    def sustained(fn, M=20):
        jax.block_until_ready(fn())  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(M):
                h = fn()
            jax.block_until_ready(h)
            best = min(best, (time.perf_counter() - t0) / M)
        return best

    for lanes in (1024, 2048, 4096):
        codec = Codec(cfg, params, num_lanes=lanes)
        streams = codec.compress(img)
        out = codec.decompress(streams)
        ok = bool(np.array_equal(out[0], img))
        t = sustained(codec.prepare_decode(streams))
        print(json.dumps({
            "variant": f"lanes{lanes}",
            "ms_per_img": round(t * 1000, 2),
            "mps": round(mp / t, 2),
            "bpsp": round(Codec.num_bytes(streams) * 8 / img.size, 4),
            "lossless": ok,
        }), flush=True)

    # batch-K sweep at the bench's lane count
    codec = Codec(cfg, params, num_lanes=1024)
    for K in (4, 8):
        bstreams = codec.compress_batch([img] * K)
        bfn = codec.prepare_decode_batch(bstreams)
        t = sustained(bfn, M=8) / K
        outs = codec.decompress_batch(bstreams)
        ok = all(np.array_equal(o, img) for o in outs)
        print(json.dumps({
            "variant": f"batchK{K}_lanes1024",
            "ms_per_img": round(t * 1000, 2),
            "mps": round(mp / t, 2),
            "lossless": bool(ok),
        }), flush=True)


if __name__ == "__main__":
    main()
