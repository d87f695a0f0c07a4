#!/usr/bin/env python
"""Ragged-size eval on real hardware: pad-to-bucket compile economics.

Runs the codec round-trip over many distinct odd image sizes with
``Codec(size_bucket=64)`` and reports per-image timings plus the number
of compiled shape families — demonstrating the pad-to-bucket strategy
(SURVEY.md §7 hard part #4) on the device, not just in unit tests.

Output: a markdown table on stdout (paste into docs/PERF.md) and one
JSON line on stderr.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = [
    (353, 467), (301, 513), (511, 767), (384, 499),
    (257, 383), (449, 450), (333, 721), (405, 607),
]


def main() -> None:
    import jax

    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import list_images, load_rgb, synthetic_image
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.utils.checkpoint import CheckpointManager

    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    params, meta = CheckpointManager(
        os.path.join(REPO, "bench_ckpt")).load(
            "bench", model.init(jax.random.PRNGKey(0)))
    print(f"params: {meta}", file=sys.stderr)
    codec = Codec(cfg, params, size_bucket=64)

    sources = []
    test_dir = os.path.join(REPO, "data_corpus", "test")
    valid_dir = os.path.join(REPO, "data_corpus", "valid")
    for d in (test_dir, valid_dir):
        if os.path.isdir(d):
            sources += list_images([d])
    imgs = []
    for i, (h, w) in enumerate(SIZES):
        if sources:
            full = load_rgb(sources[i % len(sources)])
            if full.shape[0] >= h and full.shape[1] >= w:
                imgs.append(np.ascontiguousarray(full[:h, :w]))
                continue
        imgs.append(synthetic_image(h, w, seed=100 + i))

    rows = []
    t_all0 = time.time()
    for img in imgs:
        t0 = time.time()
        streams = codec.compress(img)
        enc_t = time.time() - t0
        t0 = time.time()
        out = codec.decompress(streams)
        dec_t = time.time() - t0
        ok = bool(np.array_equal(out[0], img))
        bpsp = Codec.num_bytes(streams) * 8 / img.size
        rows.append((img.shape[0], img.shape[1], bpsp, enc_t, dec_t, ok))
    total_t = time.time() - t_all0

    # second pass: everything warm (no compiles) — steady-state times
    rows2 = []
    for img in imgs:
        t0 = time.time()
        streams = codec.compress(img)
        enc_t = time.time() - t0
        t0 = time.time()
        out = codec.decompress(streams)
        dec_t = time.time() - t0
        rows2.append((enc_t, dec_t))

    n_shapes = len(codec.compiled_shapes)
    print(f"| size | bpsp | enc ms (cold/warm) | dec ms (cold/warm) "
          f"| lossless |")
    print("|---|---|---|---|---|")
    for (h, w, bpsp, e1, d1, ok), (e2, d2) in zip(rows, rows2):
        print(f"| {h}x{w} | {bpsp:.3f} | {e1*1000:.0f} / {e2*1000:.0f} "
              f"| {d1*1000:.0f} / {d2*1000:.0f} | {ok} |")
    print(f"\n{len(SIZES)} distinct odd sizes -> "
          f"{n_shapes} compiled shape families (bucket 64); "
          f"first pass {total_t:.1f}s total")
    print(json.dumps({
        "sizes": len(SIZES),
        "shape_families": n_shapes,
        "all_lossless": all(r[5] for r in rows),
        "warm_dec_ms": [round(d * 1000) for _, d in rows2],
    }), file=sys.stderr)


if __name__ == "__main__":
    main()
