"""Serving launcher: batched prefill+decode with fault-tolerant retry.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rsc-llm \
      --batch 4 --prompt-len 32 --new-tokens 16

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import get_arch, list_archs, smoke_config
from repro_torch.runtime.fault_injection import FaultInjector
from repro_torch.runtime.serve_loop import ServeConfig, Server


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--inject-rate", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    server = Server(
        cfg,
        ServeConfig(batch=args.batch, prompt_len=args.prompt_len,
                    max_new_tokens=args.new_tokens, seed=args.seed),
        FaultInjector(rate_per_step=args.inject_rate, seed=args.seed),
        device=args.device)
    rep = server.run()
    print(json.dumps({
        "arch": cfg.name,
        "requests": rep.completed_requests,
        "tokens": rep.tokens_generated,
        "retries": rep.retries,
        "wall_s": round(rep.wall_s, 3),
        "tokens_per_s": round(rep.tokens_generated / max(rep.wall_s, 1e-9), 1),
    }, indent=1))


if __name__ == "__main__":
    main()
