#!/usr/bin/env python
"""Resident encode/decode times and per-stage device time of the fused
codec programs on one GPU.

Usage: python tools/profile_codec.py [--size 512x768] [--iters 20]
                                     [--out experiments/profile_codec]

With the bench weights and a seeded ``synthetic_natural_image``: checks
the round trip, times the resident decode and encode dispatches (inputs
staged on the device, ``block_until_ready``), then traces a few of each
with ``jax.profiler`` and reduces the trace to device time per codec
stage and the device's idle share (``llicti_tpu.utils.profile``).
Writes ``summary.json`` and the traces under ``--out``.  Fails without a
GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="512x768")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--out", default=os.path.join(REPO, "experiments",
                                                  "profile_codec"))
    args = ap.parse_args()

    import jax
    import numpy as np

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import synthetic_natural_image
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.utils.checkpoint import CheckpointManager
    from llicti_tpu.utils.compile_cache import enable_compile_cache
    from llicti_tpu.utils.profile import profile_dispatch

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"profile_codec: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {dev.device_kind}; nvidia-smi: {smi}", flush=True)
    h, w = (int(v) for v in args.size.split("x"))
    cfg = ModelConfig()
    params, _meta = CheckpointManager(os.path.join(REPO, "bench_ckpt")).load(
        "bench", LLICTIModel(cfg=cfg).init(jax.random.PRNGKey(0)))
    img = synthetic_natural_image(h, w, seed=args.seed)
    codec = Codec(cfg, params)
    streams = codec.compress(img)
    assert np.array_equal(codec.decompress(streams)[0], img)
    summary = {"device": dev.device_kind, "nvidia_smi": smi, "size": [h, w],
               "bpsp": Codec.num_bytes(streams) * 8 / img.size}
    dec = codec.prepare_decode(streams)
    # encode runs the same program; its optimized HLO names the stages
    hlo = dec.program.lower(*dec.args).compile().as_text()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "image_fn.hlo.txt"), "w") as f:
        f.write(hlo)
    for name, fn in (("decode", dec), ("encode", codec.prepare_encode(img))):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn()
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        prof = profile_dispatch(fn, os.path.join(args.out, name), hlo)
        summary[name] = dict(resident_ms=ms, profile=prof)
        print(f"{name}: resident {ms:.3f} ms/image; device per image "
              f"(ms): " + ", ".join(f"{s} {v:.3f}" for s, v in
                                    prof["stage_ms"].items())
              + f"; idle share {prof['idle_share']}", flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
