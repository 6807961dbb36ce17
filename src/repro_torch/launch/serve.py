"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Serves any arch of the registry, of every model family.  Builds the
model with random weights from a seeded ``torch.Generator`` on
the device, forms the batch by length with the pair-sort kernel, prefills
a batch of synthetic prompts (4–47 tokens, ``default_rng(0)``) and decodes
greedily.  ``--device cuda`` (the default) runs on the card and fails
without one; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.serve.engine import Request, ServeEngine


def synthetic_requests(n: int, vocab_size: int, new_tokens: int) -> list[Request]:
    """The reference launcher's request mix."""
    rng = np.random.default_rng(0)
    return [
        Request(i, rng.integers(0, vocab_size, int(rng.integers(4, 48))).astype(np.int32), max_new_tokens=new_tokens)
        for i in range(n)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch, smoke=args.smoke)
    api = registry.get_model_api(cfg)
    eng_device = torch.device(args.device)
    if eng_device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to serve on the CPU")
    params = api.init(cfg, torch.Generator(device=eng_device).manual_seed(0))
    eng = ServeEngine(cfg, params, api, max_len=256, device=eng_device)
    out = eng.generate(synthetic_requests(args.requests, cfg.vocab_size, args.new_tokens))
    for rid, toks in sorted(out.items()):
        print(f"request {rid}: {len(toks)} tokens -> {toks[:8]}...")


if __name__ == "__main__":
    main()
