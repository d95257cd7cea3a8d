"""Training launcher: fault-tolerant end-to-end driver (after
``repro.launch.train``).

Runs a training job with the complete reliability stack: checkpointing at
a step interval or the Daly-Young wall-time interval, auto-requeue on
injected faults, lemon exclusion, straggler monitoring, measured-ETTR
reporting.  Runs on the card unless ``--device cpu`` is given; on the card
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` must be set (the run is deterministic).

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 8
  CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch rsc-llm --preset 100m --steps 300 --inject-rate 0.01
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs.base import get_arch, list_archs, smoke_config
from repro_torch.runtime.fault_injection import FaultInjector
from repro_torch.runtime.train_loop import FaultTolerantTrainer, TrainerConfig

def preset_100m(cfg):
    """~100M-parameter variant of the arch family (for the end-to-end
    example on small hosts)."""
    return cfg.replace(
        name=cfg.name + "-100m",
        n_layers=min(cfg.n_layers, 8),
        block_groups=tuple(
            (p, min(r, max(1, 8 // max(1, len(p))))) for p, r in cfg.block_groups),
        d_model=512,
        n_heads=8,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
        d_head=64,
        d_ff=2048,
        vocab_size=32000,
        n_enc_layers=min(cfg.n_enc_layers, 4),
        loss_chunk=0,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rsc-llm", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--preset", default=None, choices=[None, "100m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="steps between checkpoints (0 = Daly-Young wall-time)")
    ap.add_argument("--sync-ckpt", action="store_true")
    ap.add_argument("--inject-rate", type=float, default=0.0,
                    help="crash-fault probability per step")
    ap.add_argument("--n-nodes", type=int, default=4)
    ap.add_argument("--grad-compression", default=None, choices=[None, "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    elif args.preset == "100m":
        cfg = preset_100m(cfg)

    tcfg = TrainerConfig(
        total_steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_async=not args.sync_ckpt,
        ckpt_every_steps=args.ckpt_every, n_nodes=args.n_nodes,
        seed=args.seed, grad_compression=args.grad_compression,
        n_microbatches=args.microbatches)
    injector = FaultInjector(rate_per_step=args.inject_rate,
                             n_nodes=args.n_nodes, seed=args.seed)
    trainer = FaultTolerantTrainer(cfg, tcfg, injector, device=args.device)
    report = trainer.run()

    print(json.dumps({
        "arch": cfg.name,
        "final_step": report.final_step,
        "attempts": len(report.attempts),
        "loss_first": report.losses[0] if report.losses else None,
        "loss_last": report.losses[-1] if report.losses else None,
        "measured_ettr": round(report.measured_ettr, 4),
        "checkpoint_block_s": round(report.checkpoint_block_s, 3),
        "restart_overhead_s": round(report.restart_overhead_s, 3),
        "excluded_nodes": sorted(report.excluded_nodes),
        "lemons": [v.node_id for v in report.lemon_verdicts],
    }, indent=1))


if __name__ == "__main__":
    main()
