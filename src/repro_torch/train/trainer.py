"""Training loop with the fleet-survival features: the port's copy of
``repro.train.trainer``.

* **checkpoint/restart**: periodic async atomic saves (params, optimizer,
  step, data-pipeline state); on construction the trainer auto-resumes
  from the newest complete checkpoint.
* **fault tolerance**: a step that raises ``RecoverableFailure``
  (injectable via ``fault_hook`` in tests) triggers restore-from-last-
  checkpoint and replay.
* **straggler mitigation**: per-step wall times feed an EWMA watchdog; a
  step slower than ``straggler_factor``× the EWMA is logged and counted.

The state lives on ``device`` (the card by default; ``"cpu"`` on request)
and the weights are drawn from ``torch.Generator(device)`` seeded with
``run.seed``.  A step's metrics are read with ``.item()``, which waits
for the card, so a step's wall time holds all of its device work.
"""

from __future__ import annotations

import time

import torch

from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.common import NO_SHARD, tree_map
from repro_torch.train.train_step import init_train_state, jit_train_step, make_train_step


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device needs a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    return device


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        run: RunConfig,
        model_api,
        *,
        rules=None,
        device="cuda",
        fault_hook=None,
        straggler_factor: float = 3.0,
        sync_checkpoints: bool = False,  # deterministic saves (tests)
    ):
        self.cfg, self.run, self.api = cfg, run, model_api
        self.rules = rules or NO_SHARD
        self.device = _resolve_device(device)
        self.fault_hook = fault_hook
        self.straggler_factor = straggler_factor
        self.sync_checkpoints = sync_checkpoints
        self.ckpt = Checkpointer(run.checkpoint_dir, keep=run.keep_checkpoints)
        self.data = SyntheticLMData(cfg, run.shape.global_batch, run.shape.seq_len, seed=run.seed, device=self.device)
        self.state = self._init_state()
        self.step_fn = jit_train_step(make_train_step(cfg, run, model_api, self.rules))
        self._ewma = None
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []
        self.restarts = 0
        self._restore_latest()  # auto-resume

    # ------------------------------------------------------------- lifecycle
    def _init_state(self) -> dict:
        gen = torch.Generator(self.device).manual_seed(self.run.seed)
        return init_train_state(gen, self.cfg, self.run, self.api)

    def _restore_latest(self) -> bool:
        """Load the newest checkpoint, if there is one, and the data
        pipeline's position with it.  The old state is dropped first, so
        the device never holds two."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        skeleton = tree_map(lambda _: None, self.state)
        self.state = None
        self.state, extra = self.ckpt.restore(latest, skeleton, device=self.device)
        if "data" in extra:
            self.data.restore(extra["data"])
        return True

    def _save(self, step: int):
        self.ckpt.save(step, self.state, extra={"data": self.data.state()}, async_save=not self.sync_checkpoints)

    # ------------------------------------------------------------------ run
    def run_steps(self, n: int) -> list[dict]:
        done = 0
        while done < n:
            step_no = int(self.state["step"])
            batch = self.data.next_batch()
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step_no)
                self.state, metrics = self.step_fn(self.state, batch)
                metrics = {k: v.item() for k, v in metrics.items()}
            except RecoverableFailure:  # injected / device failure
                self.restarts += 1
                self._recover()
                continue
            dt = time.perf_counter() - t0
            metrics["step"] = step_no
            metrics["wall_s"] = dt
            self._watch_straggler(step_no, dt)
            self.metrics_log.append(metrics)
            done += 1
            if self.run.checkpoint_every and (step_no + 1) % self.run.checkpoint_every == 0:
                self._save(step_no + 1)
        self.ckpt.wait()
        return self.metrics_log

    def _watch_straggler(self, step: int, dt: float):
        if self._ewma is None:
            self._ewma = dt
        elif dt > self.straggler_factor * self._ewma:
            self.straggler_steps.append(step)
        self._ewma = 0.9 * self._ewma + 0.1 * dt if self._ewma else dt

    def _recover(self):
        """Restore from the newest checkpoint and replay the data stream."""
        if not self._restore_latest():
            # no checkpoint yet: reinitialise (fresh start is the only replay)
            self.state = None
            self.state = self._init_state()
            self.data.step = 0


class RecoverableFailure(Exception):
    """Raised by fault hooks to simulate a recoverable fleet failure."""
