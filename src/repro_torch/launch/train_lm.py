"""End-to-end training driver: the port's twin of the JAX package's
``examples/train_lm.py``.

A ~60M-param starcoder2-family LM (8 layers x 512 wide, 32k vocab) trained
with the full production path — deterministic pipeline, microbatching,
checkpointing, fault-tolerant supervision.  ``--smoke`` shrinks it to a
~2M-param 2 x 128 stack and 8 steps of 2 x 32 tokens.  Gate (the run fails
otherwise): the last loss is below the first.  The record is printed as
the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.train_lm --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, resolve_torch_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.elastic import reshard_params
from repro_torch.distributed.fault_tolerance import FailureInjector, Supervisor
from repro_torch.distributed.sharding import Recipe
from repro_torch.launch.train import build_trainer
from repro_torch.models.params import init_params
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod

__all__ = ["config", "run", "main"]

RECIPE = Recipe(remat="block", microbatch=2)


def config(smoke: bool):
    """(model config, steps, batch, seq) of the run."""
    base = get_config("starcoder2-3b")
    if smoke:
        return dataclasses.replace(
            base, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=4096, head_dim=32), 8, 2, 32
    return dataclasses.replace(
        base, num_layers=8, d_model=512, num_heads=8, num_kv_heads=2,
        d_ff=2048, vocab_size=32768, head_dim=64), 60, 8, 128


def run(smoke: bool = False, seed: int = 0, torch_device=DEFAULT_TORCH_DEVICE,
        fail_at: tuple = (), params=None, mesh=None) -> dict:
    """Train from a fresh checkpoint directory (removed afterwards) and
    return the record.  ``fail_at`` injects failures at those steps;
    ``params`` are the initial float32 weights on the device (drawn from
    ``seed`` when None; the token stream is ``seed``'s either way).  With
    a ``mesh`` the weights are placed on it and the step, its checkpoints
    and the Supervisor's restarts run there."""
    dev = resolve_torch_device(torch_device)
    cfg, steps, batch, seq = config(smoke)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, device=dev)
    n = sum(x.numel() for _, x in opt_mod.leaves(params))
    if mesh is not None:
        params = reshard_params(params, cfg, mesh, RECIPE, device=dev)
    opt_cfg = opt_mod.AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=steps)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed)
    state = {"params": params,
             "opt_state": ts_mod.init_opt_state(params, cfg, RECIPE, opt_cfg)}
    with tempfile.TemporaryDirectory(prefix="train_lm_") as ckpt_dir:
        sup = Supervisor(build_trainer(cfg, RECIPE, opt_cfg, mesh=mesh,
                                       device=dev),
                         state, pipe.batch_for_step, ckpt_dir, ckpt_every=25,
                         injector=FailureInjector(tuple(fail_at)))
        t0 = time.perf_counter()
        res = sup.run(steps)
        seconds = time.perf_counter() - t0
    losses = res["losses"]
    return {"smoke": smoke, "device": str(dev), "params": n, "steps": steps,
            "batch": batch, "seq": seq, "seconds": seconds,
            "tokens_per_s": batch * seq * len(losses) / seconds,
            "losses": losses, "restarts": res["restarts"],
            "final_step": res["final_step"],
            "loss_decreasing": losses[-1] < losses[0]}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (tiny model, a few steps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    record = run(smoke=args.smoke, seed=args.seed, torch_device=args.device)
    print(json.dumps(record))
    if not record["loss_decreasing"]:
        raise SystemExit("train_lm: the loss did not decrease")


if __name__ == "__main__":
    main()
