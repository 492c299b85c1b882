"""Training launcher: the Supervisor/checkpoint/pipeline path, on one
device or on a mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt/

Runs on the card unless ``--device cpu`` is given.  A ``--ckpt-dir``
holding checkpoints resumes from the latest one.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, resolve_torch_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.fault_tolerance import FailureInjector, Supervisor
from repro_torch.distributed.sharding import Recipe
from repro_torch.models.params import init_params
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod

__all__ = ["build_trainer", "main"]


def build_trainer(cfg, recipe, opt_cfg, mesh=None,
                  device=DEFAULT_TORCH_DEVICE):
    """``step(state, batch) -> (state, metrics)`` for the Supervisor:
    moves the numpy ``batch`` onto ``device`` and runs one train step on
    ``state = {"params", "opt_state"}`` (updated in place).  With a
    ``mesh`` the step runs on DTensors; a state restored from a checkpoint
    (whole arrays) is placed on the mesh first, so the Supervisor restarts
    on it."""
    dev = resolve_torch_device(device)
    step_fn = ts_mod.make_train_step(cfg, recipe, mesh, opt_cfg)
    moments = opt_cfg.moment_dtype

    def supervised_step(state, batch):
        if mesh is not None:
            state = ts_mod.shard_state(state, cfg, recipe, mesh, moments)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(state["params"],
                                             state["opt_state"], batch)
        return {"params": params, "opt_state": opt_state}, metrics

    return supervised_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject SimulatedFailure at these steps (FT demo)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_torch_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    recipe = Recipe(remat="block", microbatch=args.microbatch)
    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=5,
                                  total_steps=args.steps,
                                  moment_dtype=cfg.opt_moment_dtype
                                  if not args.reduced else "float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    n_params = sum(x.numel() for _, x in opt_mod.leaves(params))
    print(f"arch={cfg.name} family={cfg.family} params={n_params:,}")

    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, args.seed,
                         num_codebooks=cfg.num_codebooks,
                         vlm_tokens=cfg.num_vision_tokens if cfg.family == "vlm" else 0,
                         patch_dim=cfg.vision_patch_dim)
    opt_state = ts_mod.init_opt_state(params, cfg, recipe, opt_cfg)
    step_fn = build_trainer(cfg, recipe, opt_cfg, device=dev)
    sup = Supervisor(step_fn, {"params": params, "opt_state": opt_state},
                     pipe.batch_for_step, args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     injector=FailureInjector(tuple(args.fail_at)))
    t0 = time.perf_counter()
    result = sup.run(args.steps)
    dt = time.perf_counter() - t0
    losses = result["losses"]
    print(f"steps={result['final_step']} restarts={result['restarts']} "
          f"stragglers={result['stragglers']} time={dt:.1f}s")
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"(decreasing={losses[-1] < losses[0]})")
    return result


if __name__ == "__main__":
    main()
