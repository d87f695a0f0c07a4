#!/usr/bin/env python
"""Benchmark: codec round-trip throughput on the flagship model, one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline", ...}; details on stderr.  Fails without a GPU.

Headline metric: sustained decode throughput in Mpixels/s on a 512x768
image (Kodak-size) with the bitstream resident on the device and the
decoded image left there (the serving steady state).  The JSON also
carries the end-to-end family (container bytes in host memory to RGB in
host memory, and the reverse) and the batched modes.  Every time is a
host-clock interval that ends in ``block_until_ready`` or a host fetch;
best of a few repeats.  The image is ``synthetic_natural_image`` from a
fixed seed; the weights are the committed ``bench_ckpt``.

Baseline: the reference decodes ~512x768 in ~0.65 s on a GPU + CPU
torchac => ~0.60 Mpixels/s (BASELINE.md, per-image log lines; timed at
reference agents/llicti_agent.py:135-149).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

IMG_SEED = 2024


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(2)
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import synthetic_natural_image
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.utils.checkpoint import CheckpointManager

    H, W = 512, 768
    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "bench_ckpt")
    params, meta = CheckpointManager(ckpt_dir).load(
        "bench", model.init(jax.random.PRNGKey(0)))
    print(f"bench params ({meta}); {dev.device_kind}, {smi}",
          file=sys.stderr)
    codec = Codec(cfg, params)
    img = synthetic_natural_image(H, W, seed=IMG_SEED)

    # warmup (compile)
    streams = codec.compress(img)
    out = codec.decompress(streams)
    ok = bool(np.array_equal(out[0], img))
    _ = codec.decompress_many([streams, streams])

    profile_dir = os.environ.get("LLICTI_PROFILE_DIR")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    def best_of(fn, reps=3, per=1):
        """Best wall time per item of ``fn`` (which ends in a host fetch
        or block_until_ready) over ``reps`` runs."""
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) / per)
        return best

    # ---- device-sustained (resident) throughput: the headline ---------
    # Inputs staged on the device once; M back-to-back dispatches, then
    # block_until_ready on the last output.
    M = 30
    dec_fn = codec.prepare_decode(streams)
    jax.block_until_ready(dec_fn())  # warm

    def resident(fn):
        def run():
            for _ in range(M):
                out = fn()
            jax.block_until_ready(out)
        return run

    dev_dec_t = best_of(resident(dec_fn), per=M)
    enc_fn = codec.prepare_encode(img)
    jax.block_until_ready(enc_fn())  # warm
    dev_enc_t = best_of(resident(enc_fn), per=M)

    # ---- end-to-end family ----------------------------------------------
    # single-image latency (host bytes -> host RGB), fused program and
    # the two-stage split (coarse scales, then the finest)
    codec_ts = Codec(cfg, params, two_stage=True)
    streams_ts = codec_ts.compress(img)  # warm (compile head/tail)
    ok = ok and bool(np.array_equal(codec_ts.decompress(streams_ts)[0], img))
    enc_t = best_of(lambda: codec.compress(img), reps=4)
    streams = codec.compress(img)
    dec_t = best_of(lambda: codec.decompress(streams), reps=4)
    out = codec.decompress(streams)
    dec_ts_t = best_of(lambda: codec_ts.decompress(streams_ts), reps=4)
    dec_best_t = min(dec_t, dec_ts_t)
    # pipelined: several full decodes/encodes enqueued, one sync
    n_pipe = 6
    pipe_t = best_of(lambda: codec.decompress_many([streams] * n_pipe),
                     reps=4, per=n_pipe)
    outs = codec.decompress_many([streams] * n_pipe)
    enc_pipe_t = best_of(lambda: codec.compress_many([img] * n_pipe),
                         per=n_pipe)
    streams_list = codec.compress_many([img] * n_pipe)
    # per-image accounting: compress_many populates one table per
    # pipelined image (codec.last_*_bits_batch); gate on image 0 (the
    # single-image est below is for one image) and verify the coder
    # closure holds for EVERY image of the pipelined call
    act_bits = sum(sum(row) for row in codec.last_slice_bits_batch[0])
    ideal_bits = sum(sum(row) for row in codec.last_ideal_bits_batch[0])
    per_img_gaps = [
        (sum(sum(r) for r in a) - sum(sum(r) for r in i))
        / max(sum(sum(r) for r in i), 1) * 100
        for a, i in zip(codec.last_slice_bits_batch,
                        codec.last_ideal_bits_batch)]
    # batch-container mode (K images, ONE K-batched executable both
    # ways); K=8 is the value carried over from the earlier build, not
    # yet re-swept on the GPU
    K = 8
    bstreams = codec.compress_batch([img] * K)  # warm
    bouts = codec.decompress_batch(bstreams)
    ok_batch = all(np.array_equal(o, img) for o in bouts)
    benc_t = best_of(lambda: codec.compress_batch([img] * K), per=K)
    bstreams = codec.compress_batch([img] * K)
    bdec_t = best_of(lambda: codec.decompress_batch(bstreams), per=K)
    bouts = codec.decompress_batch(bstreams)
    ok_batch = ok_batch and all(np.array_equal(o, img) for o in bouts)
    # resident batched decode: device throughput for a same-size shard
    bdec_fn = codec.prepare_decode_batch(bstreams)
    jax.block_until_ready(bdec_fn())  # warm
    MB = 10

    def resident_batch():
        for _ in range(MB):
            out = bdec_fn()
        jax.block_until_ready(out)

    dev_bdec_t = best_of(resident_batch, per=MB * K)
    if profile_dir:
        jax.profiler.stop_trace()
    ref_blob = Codec.serialize(streams)
    ok = (ok and all(np.array_equal(o[0], img) for o in outs)
          and all(Codec.serialize(s) == ref_blob for s in streams_list)
          and ok_batch)

    mp = H * W / 1e6
    bpsp = Codec.num_bytes(streams) * 8 / img.size
    baseline_dec_mps = 0.60  # reference: ~0.65 s for 512x768 (BASELINE.md)
    e2e_dec_mps = max(mp / pipe_t, mp / bdec_t)
    dev_dec_mps = mp / dev_dec_t

    # estimate-vs-actual rate cross-checks on the REAL weights (the
    # reference's third verification leg, rate_dist.py:97-135):
    # (a) full-range differentiable estimate vs coded bits, and
    # (b) two-sided coder closure: coded bits vs the exact code length
    #     of the quantized range-restricted tables (last_ideal_bits)
    est_fn = jax.jit(lambda p, x: sum(
        jnp.sum(si) for si in model.apply(p, x)))
    est_bits = float(est_fn(params, jnp.asarray(
        img[None].astype(np.float32) / 255.0)))
    gap_pct = (act_bits - est_bits) / max(est_bits, 1) * 100
    coder_gap_pct = (act_bits - ideal_bits) / max(ideal_bits, 1) * 100
    trained = "steps" in (meta if isinstance(meta, dict) else {})
    if trained and abs(gap_pct) > 2.0:
        print(f"FAIL: est-vs-actual rate gap {gap_pct:+.2f}% exceeds 2% "
              f"(est {est_bits/img.size:.4f} vs act "
              f"{act_bits/img.size:.4f} bpsp)", file=sys.stderr)
        sys.exit(1)
    # coder closure is model-independent (stream vs its own quantized
    # tables), so unlike the est/act gate above it runs unconditionally,
    # trained or not — and over every image of the pipelined call
    if any(abs(g) > 1.0 for g in [coder_gap_pct] + per_img_gaps):
        print(f"FAIL: coder closure gap exceeds 1% "
              f"(img0 {coder_gap_pct:+.2f}%, per-image "
              f"{[round(g, 2) for g in per_img_gaps]})", file=sys.stderr)
        sys.exit(1)

    print(
        f"DEVICE-SUSTAINED decode {dev_dec_mps:.2f} MP/s "
        f"({dev_dec_t*1000:.1f} ms/img) | "
        f"decode batched(K={K}) {mp/dev_bdec_t:.2f} MP/s "
        f"({dev_bdec_t*1000:.1f} ms/img) | encode {mp/dev_enc_t:.2f} MP/s "
        f"({dev_enc_t*1000:.1f} ms/img) || E2E "
        f"encode {mp/enc_t:.2f} MP/s ({enc_t*1000:.0f} ms) | "
        f"encode pipelined {mp/enc_pipe_t:.2f} MP/s "
        f"({enc_pipe_t*1000:.0f} ms/img) | "
        f"encode batched(K={K}) {mp/benc_t:.2f} MP/s "
        f"({benc_t*1000:.0f} ms/img) | "
        f"decode latency {mp/dec_best_t:.2f} MP/s ({dec_best_t*1000:.0f} ms; "
        f"fused {dec_t*1000:.0f}, two-stage {dec_ts_t*1000:.0f}) | "
        f"decode pipelined {mp/pipe_t:.2f} MP/s ({pipe_t*1000:.0f} ms/img) | "
        f"decode batched(K={K}) {mp/bdec_t:.2f} MP/s "
        f"({bdec_t*1000:.0f} ms/img) || "
        f"bpsp {bpsp:.3f} | est/act gap {gap_pct:+.2f}% | "
        f"coder gap {coder_gap_pct:+.2f}% | lossless={ok} | "
        f"device={dev.device_kind} ({smi})",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "decode_throughput_512x768_device_sustained",
        "value": round(dev_dec_mps, 3),
        "unit": "Mpixels/s",
        "vs_baseline": round(dev_dec_mps / baseline_dec_mps, 2),
        "device_ms": round(dev_dec_t * 1000, 1),
        "device_batched_mps": round(mp / dev_bdec_t, 3),
        "device_batched_ms_per_img": round(dev_bdec_t * 1000, 1),
        "encode_device_mps": round(mp / dev_enc_t, 3),
        "encode_device_ms": round(dev_enc_t * 1000, 1),
        "e2e_decode_pipelined_mps": round(mp / pipe_t, 3),
        "e2e_decode_vs_baseline": round(e2e_dec_mps / baseline_dec_mps, 2),
        "e2e_decode_latency_ms": round(dec_best_t * 1000, 1),
        "e2e_decode_latency_fused_ms": round(dec_t * 1000, 1),
        "e2e_decode_latency_two_stage_ms": round(dec_ts_t * 1000, 1),
        "e2e_encode_pipelined_mps": round(mp / enc_pipe_t, 3),
        "bpsp": round(bpsp, 4),
        "lossless": ok,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": smi,
    }))


if __name__ == "__main__":
    main()
