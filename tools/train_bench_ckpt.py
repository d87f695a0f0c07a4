#!/usr/bin/env python
"""Train the flagship (paper-config) model on synthetic data and save the
params for bench.py.

Usage: python tools/train_bench_ckpt.py [steps] [--out DIR]

The container has no image dataset; synthetic gradients+texture+noise
images let the bench report a bpsp from a *trained* model rather than
random init.  Params land in ``bench_ckpt/`` at the repo root (bench.py
auto-loads them when present).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=1500)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_ckpt"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--patch", type=int, default=128)
    args = ap.parse_args()

    import jax

    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import ImageDataset, TrainLoader
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.training.steps import init_state, make_train_step
    from llicti_tpu.utils.checkpoint import CheckpointManager

    cfg = ModelConfig()
    model = LLICTIModel(cfg=cfg)
    ds = ImageDataset(synthetic_len=512, synthetic_size=args.patch * 2,
                      seed=11)
    loader = TrainLoader(ds, args.batch, args.patch, grad_acc=1, seed=7,
                         prefetch=8)
    sample = jnp.zeros((args.batch, args.patch, args.patch, 3), jnp.float32)
    state, tx = init_state(model, cfg, jax.random.PRNGKey(0), sample, 1e-3)
    step = jax.jit(make_train_step(model, tx))

    mgr = CheckpointManager(args.out)
    done = 0
    t0 = time.time()
    last = None
    while done < args.steps:
        for batch in loader:
            state, m = step(state, jnp.asarray(batch))
            last = m
            done += 1
            if done % 50 == 0:
                print(f"step {done}: rate {float(m['loss']):.3f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            if done >= args.steps:
                break
    print(f"final rate {float(last['loss']):.3f}")
    mgr.save("bench", state.params, {"steps": done,
                                     "final_rate": float(last["loss"])})
    print(f"saved params to {args.out}")


if __name__ == "__main__":
    main()
