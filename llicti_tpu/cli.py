"""File-level codec CLI: encode an image to a .llic bitstream and back.

Usage:
  python -m llicti_tpu.cli encode IMAGE OUT.llic [--ckpt DIR] [--config J]
  python -m llicti_tpu.cli decode IN.llic OUT.png [--ckpt DIR] [--config J]

IMAGE/OUT may be PNG/JPEG (needs Pillow) or a .npy uint8 [H, W, 3] array.

The bitstream is the serialized stream-group list (Codec.serialize).  The
model params come from a checkpoint dir (``--ckpt``, file name
"bench"/"model_best"/...; default: random init — still lossless, just a
poor rate).  Encoder and decoder must agree on ``--lanes`` and run on the
same kind of device.  A practical front-end the reference lacks (its
eval_model mode only round-trips in memory,
agents/llicti_agent.py:122-164).
"""
from __future__ import annotations

import argparse
import sys
import time


def _load_codec(args):
    import jax
    import jax.numpy as jnp

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from .codec import Codec
    from .config import ModelConfig, config_from_json
    from .models.llicti import LLICTIModel

    cfg = (config_from_json(args.config).model if args.config
           else ModelConfig())
    model = LLICTIModel(cfg=cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    if args.ckpt:
        from .utils.checkpoint import CheckpointManager

        params, _meta = CheckpointManager(args.ckpt).load(args.ckpt_name,
                                                          params)
    lanes = {} if args.lanes is None else {"num_lanes": args.lanes}
    return Codec(cfg, params, **lanes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llicti_tpu.cli")
    ap.add_argument("cmd", choices=["encode", "decode"])
    ap.add_argument("inp")
    ap.add_argument("out")
    ap.add_argument("--ckpt", default=None, help="checkpoint dir")
    ap.add_argument("--ckpt-name", default="bench")
    ap.add_argument("--config", default=None, help="JSON config path")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--lanes", type=int, default=None,
                    help="rANS lanes (default: the Codec's)")
    args = ap.parse_args(argv)

    from .codec import Codec

    codec = _load_codec(args)
    if args.cmd == "encode":
        from .data.dataset import load_rgb

        img = load_rgb(args.inp)
        t0 = time.time()
        streams = codec.compress(img)
        blob = Codec.serialize(streams)
        with open(args.out, "wb") as f:
            f.write(blob)
        bpsp = len(blob) * 8 / img.size
        print(f"{args.inp}: {img.shape[0]}x{img.shape[1]} -> "
              f"{len(blob)} bytes ({bpsp:.3f} bpsp) "
              f"in {time.time()-t0:.2f}s", file=sys.stderr)
    else:
        with open(args.inp, "rb") as f:
            blob = f.read()
        t0 = time.time()
        out = codec.decompress(Codec.deserialize(blob))
        from .data.dataset import save_rgb

        save_rgb(args.out, out[0])
        written = args.out
        print(f"{args.inp}: -> {out.shape[1]}x{out.shape[2]} "
              f"written to {written} in {time.time()-t0:.2f}s",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
