"""Worker for the two-process jax.distributed DP test.

Launched by tests/test_distributed_2proc.py (and tools/scaling_bench.py):
each process owns xla_force_host_platform_device_count fake CPU devices;
jax.distributed glues them into one global mesh, and the DP train step
runs under GSPMD with the gradient psum crossing the process boundary —
the same program structure as a multi-host job.

argv: rank nprocs coordinator outdir [steps]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    rank = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    coord = sys.argv[3]
    outdir = sys.argv[4]
    steps = int(sys.argv[5]) if len(sys.argv) > 5 else 3

    import jax

    jax.config.update("jax_platforms", "cpu")
    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from llicti_tpu.parallel.distributed import initialize, local_batch_slice

    active = initialize(coordinator_address=coord, num_processes=nprocs,
                        process_id=rank)
    assert active == (nprocs > 1)
    assert jax.process_count() == nprocs

    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.config import ModelConfig
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from llicti_tpu.training.steps import init_state, make_train_step

    n_dev = len(jax.devices())  # global device count
    mesh = make_mesh(data=n_dev, spatial=1)
    cfg = ModelConfig(chs=(8, 1), evens=(4, 4), odds=(3, 3),
                      dwtlevels=(0, 1), useprevlevNN=(False, True))
    model = LLICTIModel(cfg=cfg)

    B, P, acc = 2 * n_dev, 32, 1
    sample = jnp.zeros((B, P, P, 3), jnp.float32)
    state, tx = init_state(model, cfg, jax.random.PRNGKey(0), sample, 1e-3)

    repl = replicated(mesh)
    bsh = batch_sharding(mesh, has_acc_axis=True)
    # processes hold identical full values (same seed); assemble global
    # replicated arrays from the process-local copies
    state = jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(repl, np.asarray(x)),
        state)
    step = jax.jit(make_train_step(model, tx), in_shardings=(repl, bsh),
                   out_shardings=(repl, repl))

    rng = np.random.default_rng(7)  # same stream everywhere; each process
    # CONTRIBUTES its local slice of the same global batch
    losses = []
    t0 = None
    for it in range(steps):
        batch = rng.uniform(0.2, 0.8, (acc, B, P, P, 3)).astype(np.float32)
        local = batch[:, local_batch_slice(B)]
        gbatch = jax.make_array_from_process_local_data(bsh, local)
        state, metrics = step(state, gbatch)
        losses.append(float(metrics["loss"]))
        if it == 0:
            jax.block_until_ready(metrics["loss"])
            t0 = time.time()  # exclude compile from the steps/s figure
    jax.block_until_ready(state.params)
    dt = time.time() - t0 if steps > 1 else 0.0
    out = {
        "rank": rank,
        "process_count": jax.process_count(),
        "global_devices": n_dev,
        "losses": losses,
        "steps_per_s": (steps - 1) / dt if dt > 0 else None,
    }
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"rank {rank} ok: {out}", flush=True)


if __name__ == "__main__":
    main()
