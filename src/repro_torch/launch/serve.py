"""Serving launcher: batched greedy generation with the unified engine +
CAM-guided KV pool planning report.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b --reduced \
      --batch 4 --prompt-len 32 --new-tokens 16

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core.session import DEFAULT_TORCH_DEVICE
from repro_torch.models.params import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.planner import RequestMix, plan_kv_pool


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="yi-34b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    full_cfg = cfg
    if args.reduced:
        cfg = reduced(cfg)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    engine = ServeEngine(cfg, params,
                         max_seq=args.prompt_len + args.new_tokens + 8,
                         device=dev)

    rng = np.random.default_rng(args.seed)
    shape = (args.batch, args.prompt_len)
    if cfg.family == "audio":
        shape = shape + (cfg.num_codebooks,)
    prompts = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    res = engine.generate(prompts, max_new_tokens=args.new_tokens)
    print(f"arch={cfg.name}: generated {res.steps} tokens/seq for "
          f"{args.batch} seqs; prefill={res.prefill_seconds:.2f}s "
          f"decode={res.decode_seconds:.2f}s "
          f"({args.batch * res.steps / max(res.decode_seconds, 1e-9):.1f} tok/s)")
    print(kv_plan_line(full_cfg, dev))


def kv_plan_line(full_cfg, device) -> str:
    """The CAM-guided KV pool plan for the FULL config at production scale."""
    kv_bpt = 2 * full_cfg.num_layers * full_cfg.num_kv_heads * \
        full_cfg.head_dim * 2
    mix = RequestMix(n_requests=64, shared_prefix=2048, mean_context=8192,
                     decode_steps=256, kv_bytes_per_token=kv_bpt)
    weight_bytes = full_cfg.param_count() * 2 / 256     # bf16, sharded
    plan = plan_kv_pool(mix, hbm_budget_bytes=16 * 2**30,
                        weight_bytes=weight_bytes, device=device)
    return (f"CAM KV plan ({full_cfg.name}): block={plan.block_tokens} "
            f"tokens, pool={plan.pool_blocks} blocks, est "
            f"hit={plan.hit_rate:.3f}, est transfer/step="
            f"{plan.transfer_bytes_per_step/2**20:.2f} MiB")


if __name__ == "__main__":
    main()
