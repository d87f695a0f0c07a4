"""Worker for the two-process sharded-CODEC test.

Launched by tests/test_distributed_2proc.py: each OS process owns
xla_force_host_platform_device_count fake CPU devices; jax.distributed
glues them into one global 1-D ``sp`` mesh, and the ShardedCodec's
per-scale GSPMD programs run with halo exchanges AND per-shard rANS
streams crossing the process boundary — the closest single-box stand-in
for a >=2-host codec deployment (SURVEY.md §2.3.3-4).  Every process
must assemble byte-identical containers and a lossless round-trip.

argv: rank nprocs coordinator outdir
"""
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    rank = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    coord = sys.argv[3]
    outdir = sys.argv[4]

    import jax

    jax.config.update("jax_platforms", "cpu")
    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from llicti_tpu.parallel.distributed import initialize

    active = initialize(coordinator_address=coord, num_processes=nprocs,
                        process_id=rank)
    assert active == (nprocs > 1)

    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.config import ModelConfig
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.parallel.codec_sp import ShardedCodec, make_sp_mesh

    G = len(jax.devices())  # global mesh size (2 procs x 2 devices = 4)
    cfg = ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                      dwtlevels=(0, 1), useprevlevNN=(False, True))
    model = LLICTIModel(cfg=cfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 16, 16, 3), jnp.float32))
    codec = ShardedCodec(cfg, params, mesh=make_sp_mesh(), num_lanes=16)

    # same deterministic image on every process
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:16 * G, 0:40].astype(np.float32)
    base = 127 + 80 * np.sin(yy / 7.0) * np.cos(xx / 11.0)
    img = np.clip(np.stack([base, base * 0.8 + 20, base * 0.6 + 50],
                           axis=-1) + rng.normal(0, 6, base.shape + (3,)),
                  0, 255).astype(np.uint8)

    streams = codec.compress(img)
    out = codec.decompress(streams)
    lossless = bool(np.array_equal(out[0], img))
    act = float(np.sum(codec.last_slice_bits))
    ideal = float(np.sum(codec.last_ideal_bits))
    digest = hashlib.sha256(
        b"".join(bytes(b) for grp in streams for b in grp)).hexdigest()

    result = {
        "rank": rank,
        "process_count": jax.process_count(),
        "global_devices": G,
        "shard_blobs": len(streams[1]),
        "lossless": lossless,
        "container_sha256": digest,
        "act_bits": act,
        "ideal_bits": ideal,
        "closure_pct": (act - ideal) / max(ideal, 1.0) * 100.0,
    }
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"codec_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    print(f"rank {rank} ok: {result}", flush=True)


if __name__ == "__main__":
    main()
