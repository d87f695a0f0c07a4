#!/usr/bin/env python
"""Train the flagship model on the photographic corpus (data_corpus/).

Device-resident design: the whole (tiled) corpus is staged on the
device ONCE as a uint8 array and random crops are sampled ON DEVICE with
jax.random inside the jitted train step, so the steady-state training
loop moves ~zero bytes from the host.

Semantics match the reference training recipe (agents/llicti_agent.py:
29-33,48-83): Adam @ 1e-4, grad-acc 2, value clip 5.0, random crop +
horizontal flip (no vertical), ReduceLROnPlateau on validation loss.

Resumable: checkpoints the full TrainState + scheduler under
--exp-dir; on restart continues from the latest checkpoint.  Exports
bench_ckpt-format params on every best validation so bench.py always
picks up the best real-corpus model.  SIGTERM/SIGINT checkpoint and
exit cleanly (so the chip can be borrowed for perf work mid-run).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_tiles(files, tile: int):
    """Decode + tile all images into a uint8 [N, tile, tile, 3] stack.

    Images are covered by a non-overlapping tile grid with the last
    row/column aligned to the border (so every tile is fully real
    pixels); images smaller than the tile are nearest-upscaled to fit
    (reference upscale-to-crop semantics, dataloaders/image_dl.py:85-97).
    """
    import numpy as np

    from llicti_tpu.data.dataset import _resize_to_fit, load_rgb

    tiles = []
    for f in files:
        img = _resize_to_fit(load_rgb(f), tile, tile)
        h, w = img.shape[:2]
        ys = list(range(0, h - tile + 1, tile))
        xs = list(range(0, w - tile + 1, tile))
        if ys[-1] != h - tile:
            ys.append(h - tile)
        if xs[-1] != w - tile:
            xs.append(w - tile)
        for y in ys:
            for x in xs:
                tiles.append(np.ascontiguousarray(img[y:y + tile, x:x + tile]))
    return np.stack(tiles)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--corpus", default=os.path.join(REPO, "data_corpus"))
    ap.add_argument("--exp-dir", default=os.path.join(
        REPO, "experiments", "corpus_run"))
    ap.add_argument("--bench-out", default=os.path.join(REPO, "bench_ckpt"),
                    help="export best params here for bench.py ('' disables)")
    ap.add_argument("--state-mirror",
                    default=os.path.join(REPO, "train_state"),
                    help="committed dir mirroring the FULL TrainState "
                         "(params+Adam moments+scheduler) on exit, so "
                         "optimizer progress survives container resets "
                         "(experiments/ is gitignored; '' disables)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--patch", type=int, default=160)
    ap.add_argument("--grad-acc", type=int, default=2)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--val-every", type=int, default=250)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import center_crop, list_images, load_rgb
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.training.schedule import ReduceLROnPlateau
    from llicti_tpu.training.steps import (get_learning_rate, init_state,
                                           make_eval_step, make_train_step,
                                           set_learning_rate)
    from llicti_tpu.utils.checkpoint import CheckpointManager

    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    P, B, acc, T = args.patch, args.batch, args.grad_acc, args.tile

    print("staging corpus ...", flush=True)
    train_tiles = build_tiles(
        list_images([os.path.join(args.corpus, "train")]), T)
    # validation: fixed center crops, device-resident (chunked eval)
    val_imgs = np.stack([
        center_crop(load_rgb(f), 512)
        for f in list_images([os.path.join(args.corpus, "valid")])])
    print(f"train tiles {train_tiles.shape} "
          f"({train_tiles.nbytes / 1e6:.0f} MB), valid {val_imgs.shape}",
          flush=True)

    corpus = jax.device_put(train_tiles)
    val_dev = jax.device_put(val_imgs.astype(np.float32) / 255.0)

    sample = jnp.zeros((B, P, P, 3), jnp.float32)
    state, tx = init_state(model, cfg, jax.random.PRNGKey(args.seed), sample,
                           args.lr)
    base_step = make_train_step(model, tx)
    base_key = jax.random.PRNGKey(args.seed + 1)

    def sampled_step(state, corpus):
        key = jax.random.fold_in(base_key, state.step)
        kidx, kyx, kf = jax.random.split(key, 3)
        n = corpus.shape[0]
        idx = jax.random.randint(kidx, (acc * B,), 0, n)
        yx = jax.random.randint(kyx, (acc * B, 2), 0, T - P + 1)
        fl = jax.random.bernoulli(kf, 0.5, (acc * B,))

        def crop(i, pos, f):
            p = jax.lax.dynamic_slice(
                corpus, (i, pos[0], pos[1], 0), (1, P, P, 3))[0]
            return jnp.where(f, p[:, ::-1], p)

        patches = jax.vmap(crop)(idx, yx, fl)
        batch = patches.astype(jnp.float32).reshape(acc, B, P, P, 3) / 255.0
        return base_step(state, batch)

    step = jax.jit(sampled_step, donate_argnums=0)
    eval_step = jax.jit(make_eval_step(model))

    os.makedirs(args.exp_dir, exist_ok=True)
    mgr = CheckpointManager(os.path.join(args.exp_dir, "checkpoints"))
    sched = ReduceLROnPlateau(lr=args.lr, min_lr=1e-5)
    best_val = float("inf")
    if mgr.exists("checkpoint"):
        state, meta = mgr.load("checkpoint", state)
        sched.load_state_dict(meta.get("scheduler", sched.state_dict()))
        best_val = meta.get("best_valid_loss", best_val)
        state = set_learning_rate(state, sched.lr)
        print(f"resumed at step {int(state.step)} "
              f"(best_val {best_val:.4f}, lr {sched.lr:.2e})", flush=True)
    elif (args.state_mirror
          and CheckpointManager(args.state_mirror).exists("checkpoint")):
        # Full-state resume from the committed mirror: unlike the bench
        # warm start below this keeps Adam moments, the plateau
        # scheduler's bad-epoch counts, and the decayed LR.
        state, meta = CheckpointManager(args.state_mirror).load(
            "checkpoint", state)
        sched.load_state_dict(meta.get("scheduler", sched.state_dict()))
        best_val = meta.get("best_valid_loss", best_val)
        # The mirror can lag the bench export (it used to be written only
        # on exit).  Never let a stale mirror best_val cause a first
        # validation to overwrite an already-better committed bench_ckpt.
        if args.bench_out and CheckpointManager(args.bench_out).exists(
                "bench"):
            _, bmeta = CheckpointManager(args.bench_out).load(
                "bench", state.params)
            bbest = bmeta.get("final_rate")
            if bbest is not None:
                best_val = min(best_val, float(bbest))
        state = set_learning_rate(state, sched.lr)
        print(f"resumed from mirror {args.state_mirror} at step "
              f"{int(state.step)} (best_val {best_val:.4f}, "
              f"lr {sched.lr:.2e})", flush=True)
    elif args.bench_out and CheckpointManager(args.bench_out).exists("bench"):
        # Warm start: no full TrainState survives (experiments/ is not
        # committed), but the best exported params do.  Adam moments
        # rebuild within a few hundred steps; the step counter resumes
        # from the export's step so budgets/logs stay cumulative.
        params, meta = CheckpointManager(args.bench_out).load(
            "bench", state.params)
        state = state._replace(
            params=params,
            step=jnp.asarray(int(meta.get("steps", 0)), jnp.int32))
        best_val = float(meta.get("final_rate", best_val))
        print(f"warm-started from {args.bench_out} at step "
              f"{int(state.step)} (best_val {best_val:.4f})", flush=True)

    def validate(params) -> float:
        tot = []
        for i in range(0, val_dev.shape[0], 4):
            loss, _ = eval_step(params, val_dev[i:i + 4])
            tot.append(float(loss))
        return float(np.mean(tot))

    stop = {"flag": False}

    def on_signal(sig, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    def save(state, tag="checkpoint"):
        mgr.save(tag, state, {
            "scheduler": sched.state_dict(),
            "best_valid_loss": best_val,
            "step": int(state.step),
        })

    log_path = os.path.join(args.exp_dir, "train_log.jsonl")
    t0 = time.time()
    last_t = t0
    metrics = None
    start_step = int(state.step)
    while int(state.step) < args.steps and not stop["flag"]:
        state, metrics = step(state, corpus)
        s = int(state.step)  # sync point (cheap scalar read)
        if s % args.log_every == 0:
            loss = float(metrics["loss"])
            now = time.time()
            rate = args.log_every / (now - last_t)
            last_t = now
            print(f"step {s}: rate {loss:.4f} bpp "
                  f"({rate:.1f} steps/s, lr {sched.lr:.2e})", flush=True)
        if s % args.val_every == 0:
            vl = validate(state.params)
            new_lr = sched.step(vl)
            if abs(new_lr - get_learning_rate(state)) > 1e-12:
                state = set_learning_rate(state, new_lr)
            is_best = vl < best_val
            if is_best:
                best_val = vl
            print(f"  valid @ {s}: {vl:.4f} bpp (bpsp {vl/3:.4f})"
                  f"{' *best*' if is_best else ''}", flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps({
                    "step": s, "valid_bpp": vl,
                    "train_bpp": float(metrics["loss"]),
                    "lr": sched.lr, "wall_s": time.time() - t0}) + "\n")
            save(state)
            if is_best:
                mgr.save("model_best", state, {
                    "scheduler": sched.state_dict(),
                    "best_valid_loss": best_val, "step": s})
                if args.bench_out:
                    CheckpointManager(args.bench_out).save(
                        "bench", state.params,
                        {"steps": s, "final_rate": vl,
                         "corpus": "data_corpus", "valid_bpsp": vl / 3})
                if args.state_mirror:
                    # keep the committed mirror in lockstep with the bench
                    # export: it must never lag behind what bench_ckpt
                    # holds (ADVICE r3: stale-mirror regression hazard)
                    CheckpointManager(args.state_mirror).save(
                        "checkpoint", state, {
                            "scheduler": sched.state_dict(),
                            "best_valid_loss": best_val,
                            "step": s,
                        })
    if metrics is not None:
        save(state)
        if args.state_mirror:
            CheckpointManager(args.state_mirror).save("checkpoint", state, {
                "scheduler": sched.state_dict(),
                "best_valid_loss": best_val,
                "step": int(state.step),
            })
            print(f"mirrored full TrainState to {args.state_mirror}",
                  flush=True)
    print(f"stopped at step {int(state.step)} "
          f"(best valid {best_val:.4f} bpp = {best_val/3:.4f} bpsp, "
          f"{time.time()-t0:.0f}s, "
          f"{(int(state.step)-start_step)} steps this run)", flush=True)


if __name__ == "__main__":
    main()
