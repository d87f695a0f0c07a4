#!/usr/bin/env python
"""CLI driver: ``python main.py <config.json> [--mode MODE]``.

Accepts reference-style JSON configs (configs/llicti_A.json) or our nested
format.  Supports the reference's multi-experiment sweep
(``multi_agent``/``multi_param``, reference main.py:17-24) — each sweep
value gets its own experiment subdir and a full lifecycle.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main() -> None:
    ap = argparse.ArgumentParser(description="LLICTI")
    ap.add_argument("config", help="JSON config path")
    ap.add_argument("--mode", default=None,
                    help="override mode (train/eval_model/...)")
    ap.add_argument("--mesh", action="store_true",
                    help="use all local devices as a data mesh")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu, gpu)")
    args = ap.parse_args()

    import jax

    from llicti_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from llicti_tpu.config import config_from_dict
    from llicti_tpu.training.trainer import Trainer

    # agent registry: reference configs select the agent by class name
    # (reference main.py:30 via globals()); LLICTIAgent maps to our Trainer
    agents = {"LLICTIAgent": Trainer, "Trainer": Trainer}

    with open(args.config) as f:
        raw = json.load(f)

    sweeps = [raw]
    if raw.get("multi_agent") and raw.get("multi_param"):
        key = raw["multi_param"]
        vals = raw.get(key, [])
        if isinstance(vals, list):
            sweeps = []
            for v in vals:
                r = dict(raw)
                r[key] = v
                base = raw.get("multi_exp_name") or raw.get("exp_name", "exp")
                r["exp_name"] = os.path.join(base, f"exp_{v}")
                sweeps.append(r)

    for raw_i in sweeps:
        cfg = config_from_dict(raw_i)
        if args.mode:
            cfg = dataclasses.replace(cfg, mode=args.mode)
        agent_cls = agents[raw_i.get("agent", "Trainer")]
        trainer = agent_cls(cfg, use_mesh=args.mesh)
        trainer.run()
        trainer.finalize()


if __name__ == "__main__":
    main()
