"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

Runs the port's ``Trainer`` (checkpoint/restart, straggler watchdog) on
one device: ``--device cuda`` (the default) trains on the card and fails
without one; ``--device cpu`` trains on the CPU, with the kernels' plain
versions.  Use ``--smoke`` for the reduced config.  The trainer resumes
from the newest checkpoint in ``--ckpt-dir``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.models.common import NO_SHARD, tree_leaves
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to train on the CPU")
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    api = registry.get_model_api(cfg)
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", args.seq, args.batch, "train"),
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 10, 1),
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        grad_compression=args.grad_compression,
    )
    tr = Trainer(cfg, run, api, rules=NO_SHARD, device=args.device)
    devices = torch.cuda.device_count() if args.device == "cuda" else 1
    print(f"training {cfg.name} ({sum(x.numel() for x in tree_leaves(tr.state['params'])):,} params) "
          f"for {args.steps} steps on {devices} device(s)")
    log = tr.run_steps(args.steps)
    print(f"loss: {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}; "
          f"stragglers={len(tr.straggler_steps)} restarts={tr.restarts}")


if __name__ == "__main__":
    main()
