"""Experiment runtime: the agent equivalent (train/validate/eval loops).

Mirrors the reference lifecycle (agents/base.py:13-150,
agents/llicti_agent.py:14-207):
* epoch loop with mid-epoch validation + best-checkpoint every
  loss_prnt_iters optimizer steps,
* ReduceLROnPlateau stepped on validation loss,
* checkpoint-on-exception and checkpoint-on-finalize,
* eval_model: real codec round-trip with bit-exactness check, bpsp from
  actual bytes, per-image enc/dec timing,
* model_size / flops estimation via jax cost analysis.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..codec import Codec
from ..config import LLICTIConfig
from ..data.dataset import EvalLoader, ImageDataset, TrainLoader
from ..models.llicti import LLICTIModel
from ..parallel.mesh import batch_sharding, make_mesh
from ..parallel.train import make_parallel_train_step, shard_state
from ..utils.checkpoint import CheckpointManager
from ..utils.logging_utils import RateLogger, setup_logging
from ..utils.notify import Notifier
from .schedule import ReduceLROnPlateau
from .steps import (TrainState, get_learning_rate, init_state, make_eval_step,
                    make_train_step, set_learning_rate)


def pad_to_multiple(x: np.ndarray, mult: int) -> np.ndarray:
    """Replicate-pad H, W (axis 1, 2) up to a multiple (reference
    agents/llicti_agent.py:105-113)."""
    h, w = x.shape[1], x.shape[2]
    nh = -(-h // mult) * mult
    nw = -(-w // mult) * mult
    if nh == h and nw == w:
        return x
    return np.pad(x, ((0, 0), (0, nh - h), (0, nw - w), (0, 0)), mode="edge")


class Trainer:
    def __init__(self, config: LLICTIConfig, mesh=None, use_mesh: bool = False):
        self.config = config
        cfg = config.model
        tc = config.train
        setup_logging(config.log_dir)
        self.logger = logging.getLogger("Agent")
        self.model = LLICTIModel(cfg=cfg)
        # num_data_shards > 1 requests DP over that many devices even when
        # the caller didn't pass use_mesh (no silently-ignored knobs)
        if mesh is None and not use_mesh and tc.num_data_shards > 1:
            use_mesh = True
        self.mesh = mesh if mesh is not None else (
            make_mesh(data=tc.num_data_shards if tc.num_data_shards > 1
                      else None) if use_mesh else None)

        # datasets
        dc = config.data
        if dc.synthetic or not dc.train_dirs:
            train_ds = ImageDataset(synthetic_len=dc.synthetic_len,
                                    synthetic_size=max(tc.patch_size, 64),
                                    seed=tc.seed)
            valid_ds = ImageDataset(synthetic_len=max(4, dc.synthetic_len // 32),
                                    synthetic_size=max(tc.patch_size, 64),
                                    seed=tc.seed + 1)
            test_ds = valid_ds
        else:
            train_ds = ImageDataset(dc.train_dirs)
            valid_ds = ImageDataset([dc.valid_dir])
            test_ds = ImageDataset([dc.test_dir])
        self.train_loader = TrainLoader(
            train_ds, tc.batch_size, tc.patch_size, tc.grad_acc_iters,
            tc.patches_per_img, seed=tc.seed,
            num_threads=max(1, dc.dl_numworkers))
        self.valid_loader = EvalLoader(valid_ds, tc.val_patch_size,
                                       batch_size=tc.val_batch_size)
        self.test_loader = EvalLoader(test_ds, 0)

        # state
        sample = jnp.zeros(
            (tc.grad_acc_iters, tc.batch_size, tc.patch_size, tc.patch_size, 3),
            jnp.float32)
        self.state, self.tx = init_state(
            self.model, cfg, jax.random.PRNGKey(tc.seed), sample[0],
            tc.learning_rate, tc.grad_clip_value)
        if self.mesh is not None:
            self.state = shard_state(self.state, self.mesh)
            self.train_step = make_parallel_train_step(
                self.model, self.tx, self.mesh)
            self.batch_sharding = batch_sharding(self.mesh, has_acc_axis=True)
        else:
            self.train_step = jax.jit(make_train_step(self.model, self.tx))
            self.batch_sharding = None
        self.eval_step = jax.jit(make_eval_step(self.model))

        self.scheduler = ReduceLROnPlateau(
            lr=tc.learning_rate, factor=tc.lr_factor, patience=tc.lr_patience,
            cooldown=tc.lr_cooldown, min_lr=tc.lr_min,
            threshold=tc.lr_threshold)
        self.train_logger = RateLogger()
        self.trnit_logger = RateLogger()
        self.valid_logger = RateLogger()
        self.test_logger = RateLogger()
        # failure/completion notifications land in the experiment's event
        # log (SMTP transport available via Notifier fields)
        self.notifier = Notifier(
            event_log=os.path.join(config.log_dir, "events.jsonl"))
        self.ckpt = CheckpointManager(config.checkpoint_dir)
        self.current_epoch = 0
        self.current_iteration = 0
        self.best_valid_loss = float("inf")

        if config.mode in ("test", "validate", "eval_model", "debug"):
            self.load_checkpoint("model_best", missing_ok=True)
        elif tc.resume_training:
            self.load_checkpoint(tc.checkpoint_file, missing_ok=True)
        self.model_size_estimation()

    # --- checkpointing -----------------------------------------------------
    def save_checkpoint(self, name: str = "checkpoint",
                        is_best: bool = False) -> None:
        meta = {
            "epoch": self.current_epoch,
            "iteration": self.current_iteration,
            "best_valid_loss": self.best_valid_loss,
            "scheduler": self.scheduler.state_dict(),
            "train_logger": self.train_logger.state_dict(),
            "trnit_logger": self.trnit_logger.state_dict(),
            "valid_logger": self.valid_logger.state_dict(),
        }
        self.ckpt.save(name, self.state, meta, is_best=is_best)

    def load_checkpoint(self, name: str, missing_ok: bool = False) -> bool:
        try:
            state, meta = self.ckpt.load(name, self.state)
        except FileNotFoundError:
            if missing_ok:
                self.logger.info(
                    "!!! No checkpoint '%s'; continuing with fresh params",
                    name)
                return False
            raise
        self.state = state
        self.current_epoch = meta.get("epoch", 0)
        self.current_iteration = meta.get("iteration", 0)
        self.best_valid_loss = meta.get("best_valid_loss", float("inf"))
        if "scheduler" in meta:
            self.scheduler.load_state_dict(meta["scheduler"])
            self.state = set_learning_rate(self.state, self.scheduler.lr)
        for key, lg in (("train_logger", self.train_logger),
                        ("trnit_logger", self.trnit_logger),
                        ("valid_logger", self.valid_logger)):
            if key in meta:
                lg.load_state_dict(meta[key])
        self.logger.info("Checkpoint '%s' loaded (epoch %d, iter %d)",
                         name, self.current_epoch, self.current_iteration)
        return True

    # --- loops -------------------------------------------------------------
    def run(self) -> None:
        mode = self.config.mode
        try:
            if mode == "debug":
                # anomaly detection analog of torch.autograd.detect_anomaly
                # (reference agents/base.py:112-114): fail fast on NaNs with
                # a traceback into the producing op
                jax.config.update("jax_debug_nans", True)
            if mode in ("train", "debug"):
                self.train()
            elif mode == "validate":
                self.validate()
            elif mode == "test":
                self.test()
            elif mode == "eval_model":
                self.eval_model()
            elif mode == "model_size":
                self.model_size_estimation(print_params=True)
            elif mode == "flops_est":
                self.flops_estimation()
            else:
                raise NameError(f"'{mode}' is not a valid mode")
        except KeyboardInterrupt:
            self.logger.info("CTRL+C received; finalizing")
        except Exception as exc:
            # crash-safety save (reference base.py:128-130) — but only if this
            # run actually made progress, so a mode typo can't clobber a good
            # checkpoint with fresh params
            if self.current_iteration > 0:
                self.save_checkpoint()
            # failure notification (the reference imports a Mailer for this
            # but never wires it, agents/base.py:7; we do wire it)
            self.notifier.send(
                f"[llicti] {self.config.exp_name} crashed in mode "
                f"'{mode}'",
                f"{type(exc).__name__}: {exc} "
                f"(epoch {self.current_epoch}, "
                f"iter {self.current_iteration})")
            raise

    def finalize(self) -> None:
        if self.config.mode in ("train", "debug") and self.current_iteration > 0:
            self.save_checkpoint()

    def train(self, max_steps: Optional[int] = None) -> None:
        tc = self.config.train
        for epoch in range(self.current_epoch, tc.max_epoch):
            self.current_epoch = epoch
            self.train_one_epoch(max_steps=max_steps)
            if (self.current_epoch + 1) % tc.validate_every == 0:
                valid_loss = self.validate()
                is_best = valid_loss < self.best_valid_loss
                if is_best:
                    self.best_valid_loss = valid_loss
                self.save_checkpoint(is_best=is_best)
            self.current_epoch += 1
            if max_steps is not None and self.current_iteration >= max_steps:
                break

    def train_one_epoch(self, max_steps: Optional[int] = None) -> None:
        tc = self.config.train
        for batch in self.train_loader:
            if self.batch_sharding is not None:
                batch = jax.device_put(batch, self.batch_sharding)
            self.state, metrics = self.train_step(self.state, jnp.asarray(batch))
            bd = np.asarray(metrics["breakdown"])
            self.train_logger(bd)
            self.trnit_logger(bd)
            self.current_iteration += 1
            if (self.current_iteration + 1) % tc.loss_prnt_iters == 0:
                self.trnit_logger.display(lr=get_learning_rate(self.state),
                                          typ="it",
                                          epoch=self.current_iteration)
                valid_loss = self.validate()
                is_best = valid_loss < self.best_valid_loss
                if is_best:
                    self.best_valid_loss = valid_loss
                self.save_checkpoint(is_best=is_best)
            if max_steps is not None and self.current_iteration >= max_steps:
                break
        if self.train_logger.rates:
            self.train_logger.display(lr=get_learning_rate(self.state),
                                      typ="tr", epoch=self.current_epoch)

    def validate(self) -> float:
        mult = 2 ** (max(self.config.model.dwtlevels) + 1)
        for batch in self.valid_loader:
            batch = pad_to_multiple(batch, mult)
            _, bd = self.eval_step(self.state.params, jnp.asarray(batch))
            self.valid_logger(np.asarray(bd))
        loss, _ = self.valid_logger.display(typ="va",
                                            epoch=self.current_epoch)
        new_lr = self.scheduler.step(loss)
        if abs(new_lr - get_learning_rate(self.state)) > 1e-12:
            self.state = set_learning_rate(self.state, new_lr)
        return loss

    def test(self) -> float:
        """Estimate-only eval over the test set: differentiable rate per
        image, no entropy coding (the reference's test() is an empty stub,
        agents/llicti_agent.py:116-120; eval_model covers the real-bytes
        path)."""
        mult = 2 ** (max(self.config.model.dwtlevels) + 1)
        losses = []
        for batch in self.test_loader:
            batch = pad_to_multiple(batch, mult)
            total, _ = self.eval_step(self.state.params, jnp.asarray(batch))
            losses.append(float(total))
        loss = float(np.mean(losses)) if losses else float("nan")
        self.logger.info("Test (estimate-only): mean rate %.4f bpp over "
                         "%d images", loss, len(losses))
        return loss

    def eval_model(self):
        """Real codec round-trip over the test set (reference
        llicti_agent.py:122-164).  With a multi-device mesh, uses the
        spatially-sharded codec (per-shard rANS streams, GSPMD halos)."""
        from ..parallel.codec_sp import ShardedCodec, make_sp_mesh

        if (self.mesh is not None and self.mesh.devices.size > 1
                and ShardedCodec.supports(self.config.model)):
            sp = make_sp_mesh(devices=self.mesh.devices.flatten())
            codec = ShardedCodec(self.config.model, self.state.params,
                                 mesh=sp)
        else:
            # configs outside the sharded codec's coded subset fall back
            # to the single-chip codec (device 0 of the mesh)
            codec = Codec(self.config.model, self.state.params)
        mult = 2 ** (max(self.config.model.dwtlevels) + 1)
        results = []
        for idx, img in enumerate(self.test_loader.iter_uint8()):
            t0 = time.time()
            streams = codec.compress(img)
            enc_t = time.time() - t0
            t0 = time.time()
            out = codec.decompress(streams)
            dec_t = time.time() - t0
            nbytes = Codec.num_bytes(streams)
            bpsp = nbytes * 8 / img.size
            # estimate-vs-actual cross-check (reference's third
            # verification leg, rate_dist.py:97-135): the differentiable
            # rate must track the real coded bits
            xpad = pad_to_multiple(
                img[None].astype(np.float32) / 255.0, mult)
            est_total, _ = self.eval_step(self.state.params,
                                          jnp.asarray(xpad))
            est_bits = float(est_total) * xpad.size / 3
            est_bpsp = est_bits / img.size
            act_bits = (sum(sum(row) for row in codec.last_slice_bits)
                        if codec.last_slice_bits else nbytes * 8)
            gap_pct = (act_bits - est_bits) / max(est_bits, 1) * 100
            # second leg (two-sided closure): actual stream vs the exact
            # code length of the quantized range-restricted tables — now
            # emitted by BOTH the single-chip and the sharded codec
            ideal_bits = (sum(sum(row) for row in codec.last_ideal_bits)
                          if getattr(codec, "last_ideal_bits", None)
                          else None)
            coder_gap_pct = ((act_bits - ideal_bits) / max(ideal_bits, 1)
                             * 100 if ideal_bits else None)
            ok = np.array_equal(out[0], img)
            numel = img.size
            hdr_row = [len(s) * 8 / numel * 3 for s in streams[0]]
            hdr_row = (hdr_row + [0.0] * 9)[:9]  # sharded header has 3 parts
            slice_rows = [[b / numel * 3 for b in row]
                          for row in (codec.last_slice_bits or [])]
            self.test_logger(np.asarray([hdr_row] + slice_rows))
            msg = (f"{idx:3d} {img.shape[0]:3d}x{img.shape[1]:3d} "
                   f"bpsp= {bpsp:.3f} (est {est_bpsp:.3f}, "
                   f"gap {gap_pct:+.1f}%")
            if coder_gap_pct is not None:
                msg += f", coder {coder_gap_pct:+.2f}%"
            msg += f") Enc/Dec-Times:{enc_t:.3f}/{dec_t:.3f} "
            if ok:
                msg += "(Check: Decoded img matches original)"
            else:
                err = np.abs(out[0].astype(int) - img.astype(int)).max()
                msg += (f"(Error: Decoded img does NOT match original! "
                        f"max abs err {err})")
            self.logger.info(msg)
            results.append(dict(bpsp=bpsp, est_bpsp=est_bpsp,
                                est_gap_pct=gap_pct,
                                coder_gap_pct=coder_gap_pct,
                                enc_t=enc_t, dec_t=dec_t, ok=ok))
        self.test_logger.display(typ="te")
        # results.json for tools/results_parser.py (reference
        # experiments/results_parser.py expects rate/dist per exp dir)
        if results:
            os.makedirs(self.config.out_dir, exist_ok=True)
            summary = {
                "rate": float(np.mean([r["bpsp"] for r in results])),
                "est_rate": float(np.mean([r["est_bpsp"] for r in results])),
                "dist": 0.0,
                "lossless": bool(all(r["ok"] for r in results)),
                "per_image": results,
            }
            with open(os.path.join(self.config.out_dir,
                                   "results.json"), "w") as f:
                json.dump(summary, f, indent=1)
        return results

    # --- introspection -----------------------------------------------------
    def model_size_estimation(self, print_params: bool = False) -> float:
        total = 0
        flat = jax.tree_util.tree_flatten_with_path(self.state.params)[0]
        for path, p in flat:
            if print_params:
                self.logger.info("%s %s", jax.tree_util.keystr(path), p.shape)
            total += int(np.prod(p.shape)) * p.dtype.itemsize
        mb = total / 1024 ** 2
        self.logger.info(
            "------------------TOT----------------------------------------")
        self.logger.info(
            " model param+buffer=total size: %.3f+0.000=%.3fMB", mb, mb)
        self.logger.info(
            "------------------END----------------------------------------")
        return mb

    def flops_estimation(self, h: int = 512, w: int = 512) -> Optional[float]:
        """MACs estimate via XLA cost analysis at 3 x h x w (reference uses
        ptflops at 3x512x512, llicti_agent.py:194-200)."""
        x = jnp.zeros((1, h, w, 3))
        lowered = jax.jit(
            lambda p, xx: self.model.apply(p, xx)).lower(self.state.params, x)
        cost = lowered.compile().cost_analysis()
        flops = (cost or {}).get("flops")
        if flops is not None:
            self.logger.info("Computational complexity: %.2f GMac",
                             flops / 2 / 1e9)
        n = sum(int(np.prod(p.shape))
                for p in jax.tree.leaves(self.state.params))
        self.logger.info("Number of parameters: %.2f k", n / 1e3)
        return flops
