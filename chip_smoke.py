#!/usr/bin/env python
"""Smoke test of the codec and the trainer on one GPU.

Drives the serving path (``Codec`` encode/decode, through the CLI and
the Python API) and the training path (``main.py``) once, at the paper
configuration's full width (configs/paper_a.json: 196,596 parameters, 5
scales, 88-channel groups) with the committed bench weights, and checks
every result by the repo's own means: losslessness across processes, the
rate gates, bpsp against a CPU run of the same image and weights.

  python chip_smoke.py              one GPU: phases 0 device, 1 CLI
                                    encode/decode in two processes and the
                                    GPU tests, 3 codec paths, 4 training
  python chip_smoke.py --chips 4    0 and only the 4-GPU paths (phase 5):
                                    ShardedCodec on an sp=4 mesh and the
                                    data=4 train step, each against its
                                    one-GPU counterpart
  python chip_smoke.py --phase N    phase 0 and phase N (1, 3 or 4)

Phase 2, a kernel against its plain reference, is empty: the codec runs
no hand-written kernel.

Every phase prints its findings on lines of its own; the last stdout line
is ``{"ok": true, "device": {"platform", "kind", "count"}}``.  A failed
phase exits non-zero without that line, and so does a run without a GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures as futures
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
PAPER_CONFIG = os.path.join(REPO, "configs", "paper_a.json")
H, W = 512, 768
IMG_SEED = 2024
K_BATCH = 8
# est/act and coder-closure gates (as bench.py applies them)
EST_GAP_PCT = 2.0
CODER_GAP_PCT = 1.0
CPU_BPSP_TOL = 0.005  # GPU vs CPU bpsp, same image and weights

# The parent initializes the GPU before the child processes of phase 1
# run; without preallocation it holds only its context while they do.
_PARENT_ENV = {"XLA_PYTHON_CLIENT_PREALLOCATE": "false"}
for _k, _v in _PARENT_ENV.items():
    os.environ.setdefault(_k, _v)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(msg):
    print(msg, flush=True)


def child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _PARENT_ENV}
    env.update(extra)
    return env


def run_child(args, env, timeout=900):
    t0 = time.time()
    r = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    dt = time.time() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
        raise PhaseFailed(f"{' '.join(args[1:4])} exited {r.returncode}")
    return r, dt


def bench_params(cfg):
    import jax

    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.utils.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(REPO, "bench_ckpt")).load(
        "bench", LLICTIModel(cfg=cfg).init(jax.random.PRNGKey(0)))


def smoke_image(seed=IMG_SEED):
    from llicti_tpu.data.dataset import synthetic_natural_image

    return synthetic_natural_image(H, W, seed=seed)


# ---------------------------------------------------------------- phase 0
def phase_device(jax, count_expected):
    from llicti_tpu.codec import CONV_PRECISION
    from llicti_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    log(f"device: {devs[0].device_kind} x{len(devs)} "
        f"({devs[0].platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, "nvidia-smi failed")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    log(f"jax {jax.__version__}")
    log(f"compile cache: {enable_compile_cache()}")
    log(f"precision: codec convs {CONV_PRECISION.name}; training "
        f"{jax.config.jax_default_matmul_precision or 'XLA default'}")
    check(len(devs) >= count_expected,
          f"{count_expected} GPUs needed, {len(devs)} found")


# ---------------------------------------------------------------- phase 1
def phase_cross_process():
    """CLI encode in one process, CLI decode in another with its own empty
    compile cache; the GPU-marked tests run beside them.  Each child
    process takes its own share of the card's memory."""
    import numpy as np

    img = smoke_image()
    src = os.path.join(WORK, "img.npy")
    np.save(src, img)
    blob = os.path.join(WORK, "img.llic")
    dec = os.path.join(WORK, "dec.npy")
    cli = [sys.executable, "-m", "llicti_tpu.cli"]
    ckpt = ["--ckpt", os.path.join(REPO, "bench_ckpt")]
    share = "XLA_PYTHON_CLIENT_MEM_FRACTION"
    out = os.path.join(WORK, "gpu_tests.out")
    with open(out, "w") as f:
        tests = subprocess.Popen(
            [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
             "-p", "no:cacheprovider"], cwd=REPO, stdout=f,
            stderr=subprocess.STDOUT,
            env=child_env(LLICTI_TEST_PLATFORM="gpu", **{share: "0.25"}))
    try:
        r, t_enc = run_child(cli + ["encode", src, blob] + ckpt,
                             child_env(**{share: "0.3"}))
        log(f"cli encode: {r.stderr.strip().splitlines()[-1]} "
            f"(process {t_enc:.1f} s)")
        cold = os.path.join(WORK, "decode_cache")
        os.makedirs(cold)
        r, t_dec = run_child(cli + ["decode", blob, dec] + ckpt, child_env(
            JAX_COMPILATION_CACHE_DIR=cold, **{share: "0.3"}))
        log(f"cli decode (cold cache {cold}): "
            f"{r.stderr.strip().splitlines()[-1]} (process {t_dec:.1f} s)")
        same = bool(np.array_equal(np.load(dec), img))
        log(f"cross-process decode bit-exact: {same}")
        check(same, "decode in a second process differs from the input")
        tests.wait(timeout=900)
    finally:
        if tests.poll() is None:
            tests.kill()
            tests.wait()
    with open(out) as f:
        report = f.read()
    if tests.returncode != 0:
        sys.stderr.write(report[-8000:])
    check(tests.returncode == 0, f"gpu tests exited {tests.returncode}")
    log(f"gpu tests: {report.strip().splitlines()[-1]}")


# ---------------------------------------------------------------- phase 3
def phase_codec(jax, cpu_child):
    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.utils.profile import profile_dispatch

    cfg = ModelConfig()
    params, meta = bench_params(cfg)
    img = smoke_image()
    model = LLICTIModel(cfg=cfg)

    def estimate():
        return float(jax.jit(lambda p, x: sum(
            jnp.sum(si) for si in model.apply(p, x)))(
            params, jnp.asarray(img[None].astype(np.float32) / 255.0)))

    def two_stage():
        t0 = time.perf_counter()
        two = Codec(cfg, params, two_stage=True)
        s2 = two.compress(img)
        ok_2 = bool(np.array_equal(two.decompress(s2)[0], img))
        return (ok_2, Codec.num_bytes(s2) * 8 / img.size,
                time.perf_counter() - t0)

    # the rate estimate and the two-stage programs compile in threads
    # beside the fused programs of the main thread
    with futures.ThreadPoolExecutor(2) as pool:
        f_est = pool.submit(estimate)
        f_two = pool.submit(two_stage)
        codec = Codec(cfg, params)
        t0 = time.perf_counter()
        streams = codec.compress(img)
        out = codec.decompress(streams)
        t_first = time.perf_counter() - t0
        ok = bool(np.array_equal(out[0], img))
        bpsp = Codec.num_bytes(streams) * 8 / img.size
        act = sum(sum(r) for r in codec.last_slice_bits)
        ideal = sum(sum(r) for r in codec.last_ideal_bits)
        coder_gap = (act - ideal) / max(ideal, 1) * 100
        log(f"compress/decompress (lanes {codec.N}): lossless {ok}, bpsp "
            f"{bpsp:.5f}, coder closure {coder_gap:+.3f}% "
            f"(|.|<={CODER_GAP_PCT}); first call {t_first:.1f} s")
        check(ok, "compress/decompress not lossless")
        check(abs(coder_gap) <= CODER_GAP_PCT, "coder closure gate")

        imgs = [img, smoke_image(IMG_SEED + 1)]
        many = codec.compress_many(imgs)
        outs = codec.decompress_many(many)
        ok_many = all(np.array_equal(o[0], i) for o, i in zip(outs, imgs))
        same = Codec.serialize(many[0]) == Codec.serialize(streams)
        closure = [(sum(map(sum, a)) - sum(map(sum, i))) / sum(map(sum, i))
                   * 100 for a, i in zip(codec.last_slice_bits_batch,
                                         codec.last_ideal_bits_batch)]
        log(f"compress_many/decompress_many (2 images): lossless "
            f"{ok_many}, stream equal to compress() {same}, coder closure "
            f"{[round(c, 3) for c in closure]}%")
        check(ok_many and same, "compress_many/decompress_many")
        check(all(abs(c) <= CODER_GAP_PCT for c in closure),
              "coder closure gate (many)")

        batch = [smoke_image(IMG_SEED + k) for k in range(K_BATCH)]
        t0 = time.perf_counter()
        bstreams = codec.compress_batch(batch)
        bouts = codec.decompress_batch(bstreams)
        ok_b = all(np.array_equal(o, i) for o, i in zip(bouts, batch))
        bbpsp = Codec.num_bytes(bstreams) * 8 / sum(i.size for i in batch)
        log(f"compress_batch/decompress_batch K={K_BATCH}: lossless "
            f"{ok_b}, bpsp {bbpsp:.5f}; first call "
            f"{time.perf_counter() - t0:.1f} s")
        check(ok_b, "batch container not lossless")

        est_bits = f_est.result()
        est_gap = (act - est_bits) / max(est_bits, 1) * 100
        log(f"est/act gap {est_gap:+.3f}% (|.|<={EST_GAP_PCT}; gated for "
            f"trained weights: {'steps' in meta})")
        check("steps" not in meta or abs(est_gap) <= EST_GAP_PCT,
              "est/act gate")
        ok_2, bpsp_2, t_2 = f_two.result()
        log(f"two_stage: lossless {ok_2}, bpsp {bpsp_2:.5f}; first call "
            f"{t_2:.1f} s")
        check(ok_2, "two-stage codec not lossless")

    dispatch = codec.prepare_decode(streams)
    compiled = dispatch.program.lower(*dispatch.args).compile()
    ma = compiled.memory_analysis()
    log("fused decode program memory_analysis: "
        + ", ".join(f"{k} {getattr(ma, k) / 2**20:.1f} MiB" for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")))
    # encode runs the same program; its optimized HLO names the stages
    hlo = compiled.as_text()
    with open(os.path.join(WORK, "image_fn.hlo.txt"), "w") as f:
        f.write(hlo)
    for name, fn in (("decode", dispatch), ("encode",
                                            codec.prepare_encode(img))):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(10):
            out = fn()
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / 10 * 1e3
        prof = profile_dispatch(fn, os.path.join(WORK, f"trace_{name}"),
                                hlo)
        log(f"resident fused {name}: {ms:.2f} ms/image; device ms per "
            "image by stage: " + ", ".join(
                f"{s} {v:.3f}" for s, v in prof["stage_ms"].items())
            + f"; busy {prof['busy_ms']:.3f} of {prof['window_ms']:.3f} "
            f"(idle share {prof['idle_share']})")
        log(f"  top device ops ({name}, ms per image): " + "; ".join(
            f"{k[:60]} [{st}] {v:.3f} <{op[-70:]}>"
            for st, k, v, op in prof["top_ops"][:10]))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 0) / 2**30:.2f}"
        f" GiB")

    # the same image and weights on the CPU (child started at launch)
    cpu_child.wait(timeout=900)
    with open(os.path.join(WORK, "cpu_bpsp.out")) as f:
        out = f.read()
    with open(os.path.join(WORK, "cpu_bpsp.err")) as f:
        err = f.read()
    check(cpu_child.returncode == 0, f"CPU bpsp run failed: {err[-2000:]}")
    cpu_bpsp = float(out.strip().splitlines()[-1])
    rel = abs(bpsp - cpu_bpsp) / cpu_bpsp
    log(f"bpsp GPU {bpsp:.5f} vs CPU {cpu_bpsp:.5f}: {rel * 100:.3f}% "
        f"(<= {CPU_BPSP_TOL * 100}%)")
    check(rel <= CPU_BPSP_TOL, "GPU bpsp strays from the CPU run")


def cpu_bpsp():
    """Child of phase 3: bpsp of the smoke image on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig

    cfg = ModelConfig()
    params, _meta = bench_params(cfg)
    img = smoke_image()
    streams = Codec(cfg, params).compress(img)
    print(Codec.num_bytes(streams) * 8 / img.size)


# ---------------------------------------------------------------- phase 4
def phase_training():
    """main.py at the reference recipe (batch 32, patch 160, grad-acc 2)
    on synthetic images: 3 steps, checkpoint, resume for 3 more,
    eval_model.  The images are the codec phases' seeded 512x768 ones,
    fed as .npy directories: patches of the K_BATCH batch images train,
    the smoke image validates and is coded, so eval_model reuses the
    compiled codec program of phases 1 and 3."""
    import numpy as np

    import main as entry

    with open(PAPER_CONFIG) as f:
        raw = json.load(f)
    raw["exp_name"] = "smoke"
    raw["experiments_root"] = os.path.join(WORK, "experiments")
    tr = raw["train"]
    steps = 3
    dirs = {k: os.path.join(WORK, "data", k) for k in ("train", "test")}
    for k, d in dirs.items():
        os.makedirs(d)
        for j in range(K_BATCH if k == "train" else 1):
            np.save(os.path.join(d, f"{j}.npy"), smoke_image(IMG_SEED + j))
    raw["data"] = {"train_dirs": [dirs["train"]], "valid_dir": dirs["test"],
                   "test_dir": dirs["test"]}
    tr["patches_per_img"] = steps * tr["batch_size"] * tr[
        "grad_acc_iters"] // K_BATCH
    tr["max_epoch"] = 1
    cfg_path = os.path.join(WORK, "paper_a_smoke.json")
    ckpt_dir = os.path.join(raw["experiments_root"], "smoke", "checkpoints")

    def run(mode=None, **train):
        tr.update(train)
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        argv = sys.argv
        sys.argv = ["main.py", cfg_path] + (["--mode", mode] if mode else [])
        t0 = time.perf_counter()
        try:
            entry.main()
        finally:
            sys.argv = argv
        return time.perf_counter() - t0

    def meta():
        with open(os.path.join(ckpt_dir, "checkpoint.meta.json")) as f:
            return json.load(f)

    dt = run()
    m = meta()
    rates = np.asarray(m["trnit_logger"]["rate"])
    log(f"train: {m['iteration']} steps in {dt:.1f} s (compile included); "
        f"per-step rate totals {rates.sum(axis=(1, 2)).round(4).tolist()} "
        f"bits/subpixel; valid {m['best_valid_loss']:.4f}")
    check(m["iteration"] == steps and rates.shape[0] == steps
          and np.isfinite(rates).all() and math.isfinite(
              m["best_valid_loss"]), "training steps")
    with np.load(os.path.join(ckpt_dir, "checkpoint.npz")) as z:
        check(all(np.isfinite(z[k]).all() for k in z.files),
              "non-finite checkpoint")
    dt = run(resume_training=True, max_epoch=2)
    m = meta()
    rates = np.asarray(m["trnit_logger"]["rate"])
    log(f"resume: at step {m['iteration']} after {dt:.1f} s, rates finite "
        f"{bool(np.isfinite(rates).all())}")
    check(m["iteration"] == 2 * steps and np.isfinite(rates).all(),
          "resume")
    dt = run(mode="eval_model")
    with open(os.path.join(raw["experiments_root"], "smoke", "out",
                           "results.json")) as f:
        res = json.load(f)
    gaps_ = [r["coder_gap_pct"] for r in res["per_image"]]
    log(f"eval_model: {len(res['per_image'])} images, lossless "
        f"{res['lossless']}, rate {res['rate']:.4f} bpsp, coder closure "
        f"max {max(abs(g) for g in gaps_):.3f}% ({dt:.1f} s)")
    check(res["lossless"], "eval_model not lossless")


# ------------------------------------------------------- phase 5 (4 GPUs)
def phase_four(jax):
    """ShardedCodec on sp=4 and the data=4 train step, each against its
    one-GPU counterpart."""
    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.parallel.codec_sp import ShardedCodec, make_sp_mesh
    from llicti_tpu.parallel.mesh import batch_sharding, make_mesh
    from llicti_tpu.parallel.train import make_parallel_train_step, shard_state
    from llicti_tpu.training.steps import init_state, make_train_step

    cfg = ModelConfig()
    params, _meta = bench_params(cfg)
    img = smoke_image()
    model = LLICTIModel(cfg=cfg)
    rng = np.random.default_rng(7)
    batch = jnp.asarray(rng.uniform(0, 1, (2, 32, 160, 160, 3)).astype(
        np.float32))
    state, tx = init_state(model, cfg, jax.random.PRNGKey(0), batch[0],
                           1e-4)
    state = state._replace(params=params, opt_state=tx.init(params))
    # the one-GPU counterparts compile in threads beside the mesh programs
    with futures.ThreadPoolExecutor(2) as pool:
        f_single = pool.submit(lambda: Codec(cfg, params).compress(img))
        f_step1 = pool.submit(lambda: jax.jit(make_train_step(
            model, tx)).lower(state, batch).compile())
        sp = ShardedCodec(cfg, params, mesh=make_sp_mesh(4))
        streams = sp.compress(img)
        ok = bool(np.array_equal(sp.decompress(streams)[0], img))
        act = sum(map(sum, sp.last_slice_bits))
        ideal = sum(map(sum, sp.last_ideal_bits))
        closure = (act - ideal) / ideal * 100
        bpsp = ShardedCodec.num_bytes(streams) * 8 / img.size
        mesh = make_mesh(data=4)
        state4 = shard_state(state, mesh)
        batch4 = jax.device_put(batch, batch_sharding(mesh, True))
        step4 = make_parallel_train_step(model, tx, mesh).lower(
            state4, batch4).compile()
        bpsp1 = Codec.num_bytes(f_single.result()) * 8 / img.size
        step1 = f_step1.result()
    disp = sp.prepare_decode(streams)
    jax.block_until_ready(disp())
    t0 = time.perf_counter()
    for _ in range(5):
        out = disp()
    jax.block_until_ready(out)
    t_sp = (time.perf_counter() - t0) / 5 * 1e3
    log(f"ShardedCodec sp=4 (lanes {sp.N}/shard): lossless {ok}, bpsp "
        f"{bpsp:.5f} vs one-GPU Codec {bpsp1:.5f}, coder closure "
        f"{closure:+.3f}%, resident decode {t_sp:.2f} ms/image")
    check(ok and abs(closure) <= CODER_GAP_PCT, "sharded codec")

    _s1, m1 = step1(state, batch)
    _s4, m4 = step4(state4, batch4)
    l1, l4 = float(m1["loss"]), float(m4["loss"])
    rel = abs(l4 - l1) / abs(l1)
    log(f"DP train step data=4: loss {l4:.6f} vs one GPU {l1:.6f} "
        f"(rel diff {rel:.2e}, tolerance 1e-3: TF32 convs, other "
        f"reduction order)")
    check(math.isfinite(l4) and rel <= 1e-3, "DP step loss")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phase", type=int, default=None, choices=(1, 3, 4))
    ap.add_argument("--cpu-bpsp", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.cpu_bpsp:
        cpu_bpsp()
        return 0

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    cpu_child = None
    if args.chips == 4:
        phases = {0: lambda: phase_device(jax, 4), 5: lambda: phase_four(jax)}
    else:
        # the CPU reference of phase 3 runs beside the GPU phases
        # (its output goes to files: a full pipe would stall it)
        cpu_child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-bpsp"],
            cwd=REPO, env=child_env(JAX_PLATFORMS="cpu"),
            stdout=open(os.path.join(WORK, "cpu_bpsp.out"), "w"),
            stderr=open(os.path.join(WORK, "cpu_bpsp.err"), "w"))
        # phase 2 (a hand-written kernel against its plain reference) is
        # empty: the codec runs none
        phases = {0: lambda: phase_device(jax, 1), 1: phase_cross_process,
                  3: lambda: phase_codec(jax, cpu_child), 4: phase_training}
        if args.phase is not None:
            phases = {0: phases[0], args.phase: phases[args.phase]}
    try:
        for i, phase in phases.items():
            t0 = time.perf_counter()
            try:
                phase()
            except PhaseFailed as e:
                log(f"FAILED: {e}")
                return 1
            log(f"-- phase {i} done ({time.perf_counter() - t0:.1f} s)")
    finally:
        if cpu_child is not None and cpu_child.poll() is None:
            cpu_child.kill()
            cpu_child.wait()
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
