"""Drive the PyTorch/CUDA port on one GPU and hold every kernel to its plain version.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints
no result line):

1. preflight: the card, torch, CUDA and nvcc versions; build every kernel
   from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. every kernel against its plain torch version on the card, bit for bit,
   at the main path's shapes, with CUDA-event times beside the bound, the
   plain version's time and the library sort's; the tile sort K2 also at
   every boundary of its tiers (128 to 2^20 keys, 1, 3 and 36 rows, five
   key dtypes, heavy ties, float32 signed zeros) and timed at every shape
   the main path hands it; the merge K3 at every boundary of its tiers
   (2^8 to 2^21 keys a merged pair, 2 to 5 tiles a row, both half-passes,
   the same dtypes and cases) and timed at the path's (36, 2, 2^19); the
   count/rank K1 at every tile boundary for 1 to 4,096 buckets, one-bucket
   and out-of-range ids, and timed at every (ids, B) of the path; the pair
   sorts K5 and K7 at every boundary of theirs (128 to 2^19 pairs, 1 and
   3 rows, heavy ties, int64 keys with float64 payloads), each with the
   device time of each of its launches from ``torch.profiler``; the row
   sort K4 and the pair row sort K6 at every boundary of theirs (128 keys
   to 64 KiB a row, every key dtype, both K4 methods, 16-value ties,
   sentinel keys, garbage pads, lengths at a home run's edges and past
   both ends), K4 timed at (64, 8192) int32, float32 and int64 and at
   (64, 2^16) int8, K6 at (64, 8192) int32/int32 and int64/float64, each
   with its device time and kernel launches a call;
3. the main path, ``SortEngine.sort``, against ``np.sort``: six dtypes x
   five distributions at n = 100,000, skewed inputs at 60,000 (sampled
   splitters, large capacities, a forced overflow), int64 keys spanning
   the whole type, then paper scale (2^22 and 15,728,640 int32 keys, and
   2^22 keys on the 144-processor OHHC), and a profile of two requests;
4. ``SortEngine.sort_segments`` on 64 segments of 1,000-8,192 keys with
   each row backend, against ``np.sort`` per row, then 64 segments of
   9,000-65,536 keys, which take the bucket path;
5. the pairs path: ``SortEngine.sort_pairs`` with a flat payload at a
   serving batch (256 request lengths, ``ServeEngine.order_by_length``'s
   call) and at 2^19 pairs, ``argsort_keys`` at 2^19 int32 and int64
   keys, and a three-leaf pytree payload at 4,096 and 2^19 keys, each
   against numpy; a profile of one ``argsort_keys`` at 2^19;
6. the workloads: ``top_k`` at 15,728,640 int32 keys with k = n/2 (the
   sim path) and k = 1,000 (the host head), and ``merge_sorted`` of 2^20
   new keys into a sorted 2^22 buffer, against ``np.sort``;
7. serving: (a) ``Sortd`` over ``SortEngine()`` with the reference sortd
   benchmark's request mix, 600 requests from 8 closed-loop clients, int32
   and float32, at its ``SortdConfig(max_batch=64, max_wait_s=0.005,
   max_bucket=4096)`` and at the default ``SortdConfig()`` with a 15 %
   tail of 8,193-32,768-key requests (the bucket path, K1 and K2), then
   16 ``submit_merge`` ticks into a growing buffer; (b) the fault ladder:
   the five scenarios of the reference's fault benchmark at d_h = 1
   through ``Sortd.set_fault_scenario``, 100 requests each, then healed;
   the degraded flushes carry the slowdown a CPU engine quotes, and the
   two impossible scenarios launch no kernel; (c) ``SortdFleet`` of four
   workers, 800 requests of ``loadgen.request_mix``, healthy and with the
   busiest worker killed mid-load; every result against ``np.sort``;
8. conformance on the card (``repro_torch.verify``): (a) the smoke run as
   ``python -m repro_torch.verify --smoke`` runs it (252 sort, 66
   segment, 30 fault and 90 op cells, the cross-check, the property
   battery, the drift gate against ``tests/baselines/verify_smoke_torch.json``),
   then the fault cells of the two impossible classes again, which must
   launch nothing; (b) the port's ``--full`` grid (1,560 sort cells, the
   130 int64 sim cells among them) with the cross-check; (c) paper scale:
   int32 {random, dupes, sorted, local} at 4,194,304 and 15,728,640 keys
   through sim/paper, sim/sampled and host/paper at d_h = 1, random at
   4,194,304 through sim/paper at d_h = 2 and 3, cross-checked, and the
   metamorphic battery and fault replay on the 4,194,304-key random input;
   fails unless K1-K5 launched and K6, K7 did not;
9. the model layer: DeepSeek-V2-Lite-16B at full width (27 layers,
   d_model 2048, MLA rank 512, 64 experts top-6 + 2 shared, vocab
   102,400; 16.21 B float32 parameters made on the card from a seeded
   generator, bf16 compute) served by ``ServeEngine.generate`` for 4 and
   then 16 requests of the reference launcher's mix (prompts of 4-47
   tokens, 16 new tokens each, ``max_len`` 256), cold and warm: prefill
   and decode-step times synchronised with the card, tokens/s, the card's
   busy share, exactly 27·16 launches of K1 (one an MoE layer a forward)
   and one of K5 (``order_by_length``) a run, the same tokens twice; then
   (a) one layer's ``apply_moe`` with K1 and with its plain version and
   (b) its ``sorted`` and ``argsort`` dispatches, bit for bit, (c)
   float32 prefill + decode against ``forward`` within 2e-2 (capacity
   factor 64, no TF32), (d) ``order_by_length`` against the stable
   argsort; and K1 timed at the dispatch's shapes beside
   ``torch.bincount`` plus a stable ``torch.sort``;
10. the other model families at full width, each built on the card from a
   seeded generator, served, checked and freed before the next (the
   card's allocated memory back at its level after DeepSeek is freed):
   Zamba2-2.7B (hybrid: 54 Mamba2 blocks, d_model 2560, one shared
   attention + MLP block every 6; 9.07 GiB of float32 weights) served
   for 4 and then 16 requests as in phase 9, with K5 once and K1 never a
   ``generate``, the same tokens twice, its counted weights equal to
   ``cfg.param_count()`` plus the shared block's ``wq`` (2560^2, which
   the reference's count leaves out), (c) float32 prefill of 600 tokens
   (two 256-position chunks and a padded tail) + 2 decode steps against
   ``forward`` within 2e-2, and (e) one layer's ``ssd_chunked`` at S =
   600 against the decode update applied position by position within
   1e-3 relative; then mamba2-370m (ssm), whisper-tiny (encdec) and
   qwen2-vl-7b (vlm) served for 4 requests each, with (c) at 602 tokens
   (mamba2, and (e)), against random (B, 1500, 384) encoder frames
   (whisper) and with 1,024 random vision embeddings on a 32 x 32 patch
   grid of M-RoPE positions at S = 1,100 (qwen2-vl); every time beside
   the card's name and power limit;
11. training on the card (the card's memory back after phase 10): (a)
   DeepSeek-V2-Lite-16B at full width, 4 of its 27 layers (float32
   parameters, gradients and AdamW moments of all 27 take 241.6 GiB), a
   batch of 2 x 4,096 tokens (``train_4k``'s length), trained 6 steps
   through ``Trainer(device="cuda")`` with remat and the ``sorted`` MoE
   dispatch: finite losses, the last below the first, exactly 8 launches
   of K1 a step (4 MoE layers, forward and remat recompute); step ms,
   tokens/s, max allocated, and a seventh step under the profiler for the
   card's busy share and top kernels; (b) in a process of its own with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and deterministic algorithms, one
   layer's loss and every gradient leaf with the ``sorted`` (K1) and the
   ``argsort`` dispatch bit for bit; K1 timed at the training shape
   (49,152 ids, 64 buckets) beside its plain version and
   ``torch.bincount`` + a stable ``torch.sort``; (c) ``python -m
   repro_torch.launch.train --arch mamba2-370m --steps 3`` at full width
   in a subprocess; (d) mamba2-370m trained 3 steps with a checkpoint at
   step 2, then resumed by a second ``Trainer`` at step 2 with the data
   at step 2, its loss equal to the first run's bit for bit;
12. the perf gate (``repro_torch.perf``), run between phases 8 and 9:
   the card calibrated (a 1 GiB device copy, a float32 GEMM at k = 8,192
   without TF32) and printed beside the H100 data sheet; (a) all eight
   suites at full scope through ``run_suite(device="cuda")`` at the
   reference CLI's warmup 2 and 5 repeats, each case's median, IQR,
   ``norm_ratio`` and ``pct_of_roofline`` printed, failing on a case
   that raises, a non-finite or non-positive time, or a normalised case
   above 105 % of the calibrated roofline or 100 % of the data sheet's;
   (b) ``SortEngine(host_threshold=2^25).sort`` of 15,728,640 random
   int32 keys through ``run_case`` (warmup 1, 3 repeats), equal to
   ``np.sort`` outside the clock; (c) (a) recorded into a temporary
   directory and a second run of the engine and kernels suites judged
   against it by ``python -m repro_torch.perf --slack 2`` in process, and
   (a) judged against the committed ``src/repro_torch/perf/baselines/``,
   failing on a case new to or missing from either (timing verdicts are
   printed, not gated); (d) fails unless K1, K2, K4 and K5 launched in
   (a) and K3 in (b), and if K6 or K7 launched;
13. the dry-run against the card's own runs (``repro_torch.launch.dryrun``,
   host-only: shapes on the meta device, one device's step traced on fake
   tensors), after phase 11: (a) on ``make_smoke_mesh()`` (this card) and
   the H100 record, the very runs phases 11 (a) and 10 made, DeepSeek-V2-
   Lite 4 layers trained at 2 x 4,096 tokens and Zamba2-2.7B's prefill and
   decode at each of its batches (``max_len`` 256), each prediction
   printed beside that run's max allocated (the peak reset before each
   part in phase 10) and median time; fails when a predicted per-device
   total is more than 25 % off the measured max allocated, or its
   ``bound_time_s`` exceeds the measured time (a bound above a
   measurement is impossible); prints the implied roofline fraction; (b)
   ``python -m repro_torch.launch.dryrun --arch deepseek-v2-lite-16b
   --mesh both`` and ``--arch zamba2-2.7b --shape long_500k --mesh
   single`` in subprocesses (at once) into a temporary directory, then
   ``repro_torch.roofline.report`` and ``gen_experiments`` over it; fails
   on a ``.FAIL`` file, a nonzero exit or a kernel launch a child
   reports; (c) fails unless this process's launch counts are the same
   before and after (a) and (b);
14. the dist path over ranks (``SortEngine(mesh=...)`` on
   ``repro_torch.core.dist_sort``, ranks spawned by
   ``repro_torch.runtime.ranks.run_ranks``), after phase 13: (a) world
   size 1 over NCCL on a (1,) and a (1, 1) mesh, a dist plan forced for
   each of ``paper``, ``sample``, ``valiant`` and ``hier`` at 15,728,640
   random int32 keys, each equal to ``np.sort``, with K1 and K2 launched,
   and timed; (b) 4 ranks sharing the card over gloo (NCCL takes one rank
   a card): ``python -m repro_torch.verify --smoke --devices 4`` in a
   subprocess (510 cells, the 72 dist cells on the ranks, no cross-check
   mismatch), then the engine's own planned dist sort of 15,728,640 int32
   keys on (4,) for random, sorted and dupes keys and ``hier`` on (2, 2),
   each equal to ``np.sort`` on every rank, with the plan, retries, the
   share of the wall time in the ``all_to_all`` exchange and in the
   gathers, and each rank's K1/K2/K3 launches, which each rank returns;
   (c) ``int8_psum`` and ``hierarchical_psum`` (within 1e-6) and a
   4-stage ``pipeline_forward`` (within 1e-5) on card tensors over the 4
   ranks, held to the same calls on CPU tensors;
15. the model layer over a mesh (``jit_train_step(step, mesh,
   state_specs, batch_specs)``, FSDP x TP on DTensor), DeepSeek-V2-Lite
   at full width with its production ``shard_map`` MoE dispatch (K1 on
   each rank's own tokens at the local capacity, one all-reduce over the
   tensor axis), after phase 14: (a) world size 1 over NCCL on a (1, 1, 1)
   mesh, phase 11's cut (4 of 27 layers, 2 x 4,096 tokens, remat), 3
   steps: finite losses, exactly 8 launches of K1 a step, step 1's loss
   and grad_norm equal in bits to the unsharded ``sorted`` step on the
   same state and batch (both under deterministic algorithms), step ms
   and max allocated beside phase 11's; (b) 4 ranks sharing the card
   over gloo on (1, 2, 2), 2 of 27 layers, 4 x 1,024 tokens, one step
   without warmup, each rank drawing the parameters from one seed and
   keeping its shard: finite losses, the same metrics on every rank, 4
   launches of K1 a step on each; against the same model's unsharded
   step on the card, relative, step 1's loss within 1e-3 and its
   grad_norm within 1e-3 (limits set between the sound run's readings
   and planted faults', ``tools/mesh_fault_readings.py``); the step's
   share of the wall time in DTensor's redistributions (clocked,
   synchronised);
16. serving over a mesh (``ServeEngine(rules=...)``, ``prefill`` and
   ``decode_step`` on DTensors, caches laid out by ``cache_specs``),
   DeepSeek-V2-Lite at full width with its ``shard_map`` MoE dispatch,
   after phase 15: (a) world size 1 over NCCL on (1, 1, 1), all 27 layers,
   float32 weights from phase 9's seed, phase 9's first batch (4
   requests, 16 new tokens): the tokens equal phase 9's, K1 exactly 27 a
   forward and K5 once, the largest logit gap to phase 9, prefill and
   decode ms, max allocated, and the card's memory back after the rank;
   (b) 4 ranks sharing the card over gloo on (1, 2, 2), 2 of 27 layers,
   bf16 compute, 4 requests of the launcher's mix, 2 new tokens, against
   the same model unsharded on the card fed the sharded run's tokens:
   the prefill's and each decode step's logits within limits relative to
   the unsharded logits (set between the sound run's readings and planted
   faults', ``tools/mesh_fault_readings.py``), the same tokens on every
   rank, K1 2 a forward on each, the slowest rank's prefill and decode
   ms, the share of the generate in DTensor's redistributions, max
   allocated a rank, and the dry-run's per-device prediction of the
   decode cell beside it (report only); (c) the same ranks at global
   batch 1 (``kv_seq="data"``: the latent cache split along its sequence,
   each rank attending over its half, the halves joined by log-sum-exp),
   a 1,024-token prompt, ``max_len`` 2,048, 4 decode steps, with (b)'s
   gates;
17. the ssm and hybrid families over a mesh (the Mamba2 block split by
   SSM heads over the tensor axis, Zamba2's shared block, mamba2's
   sequence split), after phase 16: (a) world size 1 over NCCL on (1, 1,
   1): Zamba2-2.7B at full width, all 54 layers, float32 weights from
   phase 10's seed, served through ``ServeEngine(rules=...)`` for phase
   10's first batch: the tokens equal phase 10's, K5 once and K1 never,
   the largest logit gap to phase 10, prefill and decode ms, max
   allocated, the card's memory back after the rank; mamba2-370m at full
   width, all 48 layers, 3 steps of 2 x 4,096 tokens through
   ``jit_train_step(mesh=...)``: step 1's loss and grad_norm equal in
   bits to the unsharded step's (both under deterministic algorithms);
   (b) 4 ranks sharing the card over gloo on (1, 2, 2) under
   ``rules_for``: mamba2-370m (8 of 48 layers) 2 steps on one batch of 4
   x 1,024 tokens (the sequence split over ``model``), a prefill of that
   batch under the prefill rules and 4 requests of the launcher's mix, 8
   new tokens; Zamba2-2.7B (6 of 54 layers, one period) 2 steps of 4 x
   512 and the same requests; each held to the same model unsharded on
   the card (fed the sharded run's tokens) within ``MESH_SSM_GAP`` and
   ``MESH_SSM_SERVE_GAP`` (limits between the sound run's readings and
   planted faults', ``tools/mesh_fault_readings.py --path ssm``), the
   same tokens and metrics on every rank, K5 once a ``generate`` on each,
   the share in DTensor's redistributions, max allocated a rank and the
   bytes the head split moves a layer; (c) the same ranks at global batch
   1 for Zamba2 (``kv_seq="data"``), a 1,024-token prompt, ``max_len``
   2,048, 4 decode steps, with (b)'s gates;
18. the encdec and vlm families over a mesh (whisper's encoder and
   cross-attention split by heads, the cross cache under ``kv_seq``,
   qwen2-vl's vision embeddings and M-RoPE positions laid out by batch
   rows), after phase 17: (a) world size 1 over NCCL on (1, 1, 1):
   whisper-tiny and qwen2-vl-7b at full width, all layers, float32 weights
   from phase 10's seed, served through ``ServeEngine(rules=...)`` for
   phase 10's first batch: the tokens equal phase 10's with logit gap
   0.0, K5 once and K1 never; phase 10 (c)'s float32 prefill (encoder
   frames; vision embeddings on the M-RoPE grid) over the mesh equal in
   bits to the unsharded one; 3 training steps of whisper-tiny (all
   layers, 8 x 448) and qwen2-vl-7b (2 of 28 layers, 2 x 2,048 with 1,024
   vision tokens a row) through ``jit_train_step(mesh=...)``: step 1's
   loss and grad_norm equal in bits to the unsharded step's, max allocated
   under 75 GiB; (b) 4 ranks sharing the card over gloo on (1, 2, 2):
   whisper-tiny at full depth 2 steps on one batch of 4 x 448 and 4
   requests, 8 new tokens; qwen2-vl-7b (2 of 28 layers) one step on 4 x
   1,280 (1,024 vision tokens a row, each row on its own M-RoPE grid),
   then a prefill of that batch with its vision inputs and 2 decode steps;
   each held to the same model unsharded on the card within
   ``MESH_ENCDEC_GAP`` and ``MESH_ENCDEC_SERVE_GAP`` (limits between the
   sound run's readings and planted faults',
   ``tools/mesh_fault_readings.py --path encdec``), the same tokens and
   metrics on every rank, K5 once a ``generate`` on each; (c) whisper-tiny
   at global batch 1 (``kv_seq="data"``: the self and the cross caches
   split along their sequence, 750 of the 1,500 frames a rank), a
   448-token prompt, ``max_len`` 512, 4 decode steps, with (b)'s gates;
19. attention under sequence parallelism over a mesh (K and V gathered
   along the sequence inside each attention region, the queries of each
   rank's chunk attending from its start), after phase 18: (a) world
   size 1 over NCCL on (1, 1, 1) under the production (16, 16) mesh's
   SP rules by hand (``heads=None, seq="model"``; ``kv_seq="model"`` for
   serving): phase 15 (a)'s DeepSeek-V2-Lite cut one step equal in bits
   to phase 15 (a)'s unsharded first step, K1 launched as often; gemma3-4b
   at full width, all layers, phase 9's first batch served through
   ``ServeEngine(rules=...)``: the tokens equal the unsharded engine's;
   (b) 4 ranks sharing the card over gloo on (1, 1, 4): whisper-tiny at
   full width and depth under ``rules_for`` (6 heads on 4: SP, the
   encoder's frames split too) one step of 4 x 448, then a prefill of
   that batch and 3 decode steps; gemma3-4b at full width, 2 of 34
   layers, one step of 2 x 2,048 under the production rules; each held to
   the same model unsharded on the card within ``MESH_SP_GAP`` and
   ``MESH_SP_SERVE_GAP`` (limits between the sound run's readings and
   planted faults', ``tools/mesh_fault_readings.py --path sp``), the same
   metrics and tokens on every rank;
20. a ``kernels`` JSON line with each kernel's launches on its path
   (phase 3 for the sort kernels, the short segments for the row kernel,
   phase 5 for the tagged pair kernel, each plus its launches in phases
   7, 8, 9, 10, 11, 12 (a) and (b), 14 (a) and (b), 15 (a) and (b), 16
   (a)-(c), 17 (a)-(c), 18 (a)-(c) and 19 (a) and (b), summed over the ranks; the untagged pair kernel and the
   pair row kernel have no caller on any path and are checked in phase 2 only), each
   kernel's device time and launches a call (the script fails if the
   profiler gave none after three sessions), and K1's times at the
   training shape; the launches of single requests are printed on their
   own lines.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import devtrace  # noqa: E402
from repro_torch.core import OHHCTopology, SortEngine, SortPlan  # noqa: E402
from repro_torch.data import ALL_DISTRIBUTIONS, make_array  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    KERNELS,
    _build,
    batched,
    bitonic,
    launch_counts,
    ops,
    partition_kernel,
    ref,
    reset_launches,
)
from repro_torch.net.faults import FaultScenario  # noqa: E402
from repro_torch.serve import ChaosConfig, FleetConfig, Sortd, SortdConfig, SortdFleet  # noqa: E402
from repro_torch.serve.fleet.loadgen import drive_closed_loop, request_mix  # noqa: E402
from repro_torch.verify import cross_check, differential, grid, metamorphic_checks  # noqa: E402
from repro_torch.verify.properties import fault_replay_for_engine_run  # noqa: E402
from repro_torch.verify import __main__ as verify_cli  # noqa: E402
from repro_torch import perf  # noqa: E402
from repro_torch.perf import __main__ as perf_cli, suites as perf_suites  # noqa: E402
from repro_torch.roofline import H100  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.serve import synthetic_requests  # noqa: E402
from repro_torch.models import layers, lm, moe, ssm  # noqa: E402
from repro_torch.models.common import NO_SHARD, layer, tree_leaves, whole  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_train_state,
    jit_train_step,
    make_grad_fn,
    make_train_step,
)
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models.common import distribute, lay_out, mesh_zeros, set_mesh, spec_map  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshSpec, make_smoke_mesh  # noqa: E402
from repro_torch.runtime import hierarchical_psum, int8_psum  # noqa: E402
from repro_torch.runtime import ranks as rt_ranks  # noqa: E402
from repro_torch.runtime.pipeline import pipeline_forward  # noqa: E402

DEV = torch.device("cuda")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the float32 rate
# outside the tensor cores, used for every key type's compare-exchange
# operations (the table lists no separate integer rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
DTYPES = ("int8", "int16", "int32", "int64", "uint32", "float32")
TORCH_KEY = {
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "float32": torch.float32,
}
PAPER_MAX_KEYS = 15_728_640  # 60 MB of int32, the paper's largest size


def fail(msg: str):
    raise RuntimeError(msg)


def sh(*cmd: str) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        fail(f"{' '.join(cmd)} failed: {r.stderr.strip()}")
    return r.stdout.strip()


def smi() -> str:
    return sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` from CUDA events, warmup outside the clock."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least milliseconds for ``nbytes`` moved and ``ops`` operations done.

    Count what the function needs, not what a kernel's algorithm does: a
    sort of n keys needs about n·log2(n) comparisons (the comparison-sort
    lower bound, far below a bitonic network's compare-exchanges), a merge
    of two n-key tiles 2n."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sort_comparisons(lens) -> float:
    return float(sum(n * math.log2(n) for n in lens if n > 1))


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of a key tensor, so equality is bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    torch.cuda.synchronize()
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(bits(a), bits(b)):
        fail(f"{what}: kernel and plain version differ")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def random_keys(shape, dtype: torch.dtype, gen: np.random.Generator) -> torch.Tensor:
    if dtype.is_floating_point:
        x = gen.standard_normal(shape).astype(np.float32)
    else:
        info = torch.iinfo(dtype)
        x = gen.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True)
        x = x.astype(str(dtype).removeprefix("torch."))
    return torch.from_numpy(x).to(DEV)


# ----------------------------------------------------------------- phase 1
def preflight() -> None:
    print("card:", smi())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    print(sh(_build.nvcc_path(), "--version").splitlines()[-1])
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", _build.build_log(name))]
        spills = re.findall(r"(\d+) bytes spill stores", _build.build_log(name))
        print(
            f"  {name}.cu: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"spill stores {sorted(set(spills))}"
        )
        # ptxas reports each kernel's spills after its "Compiling entry function" line
        for fn, spill in re.findall(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores", _build.build_log(name), re.S
        ):
            if int(spill):
                print(f"    spills {spill} bytes: {fn}")


# ----------------------------------------------------------------- phase 2
def kernel_checks() -> dict:
    gen = np.random.default_rng(0)
    rows = {}

    rows["sort_tile"] = tile_kernel_checks(gen)

    rows["merge_tiles"] = merge_kernel_checks(gen)
    rows["bucket_count_rank"] = bcr_kernel_checks(gen)

    rows["batched_row_sort"] = row_kernel_checks(gen)
    rows.update(pair_kernel_checks(gen))
    for name, r in rows.items():
        print(
            f"kernel {name} {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}), plain {r['plain_ms']:.3f} ms, library {r['library_ms']}, "
            f"max_abs_err {r['max_abs_err']} {r.get('extra', '')}"
            + (f" device {r['device_ms']:.4f} ms" if r.get("device_ms") is not None else "")
        )
    return rows


# Row lengths at every boundary of the row sort's tiers (csrc/batched.cu on
# key_tiers.cuh): a partial warp, one warp's 512 keys, one chunk of int64
# (2^12), int32 (2^13) and int8/int16 (2^14), then device windows up to
# 64 KiB a row.
ROW_SIZES = (128, 512, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16)


def row_batch(nrows: int, n: int, dtype: torch.dtype, gen: np.random.Generator):
    """Keys from 16 values, some equal to the sentinel (float32: signed
    zeros too), lengths at a home run's edges, the row's, past both ends
    and random, and garbage in the pads."""
    raw = torch.from_numpy(gen.integers(0, 16, (nrows, n))).to(DEV)
    if dtype.is_floating_point:
        x = (raw - 8).to(dtype)
        x[raw == 15] = float("inf")
        x[(raw == 8) & torch.from_numpy(gen.random((nrows, n)) < 0.5).to(DEV)] = -0.0
    else:
        x = raw.to(dtype)
        x[raw == 15] = torch.iinfo(dtype).max
    lens = np.concatenate([[0, 1, 15, 16, 17, n - 1, n, -3, n + 5], gen.integers(0, n + 1, nrows - 9)])
    lens = torch.from_numpy(lens.astype(np.int32)).to(DEV)
    pad = torch.arange(n, device=DEV)[None, :] >= lens[:, None]
    return torch.where(pad, random_keys((nrows, n), dtype, gen), x), lens


def row_kernel_checks(gen: np.random.Generator) -> dict:
    """K4 bit for bit against its plain version at every tier boundary,
    every key dtype, both methods; at the kernels line's (64, 8192) int32
    against np.sort too; then timed at (64, 8192) int32 by events and on
    the card, with its launches a call, for both methods, and at int64
    (64, 8192) and int8 (64, 2^16)."""
    err, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        dt = TORCH_KEY[name]
        for n in ROW_SIZES:
            if n * torch.empty((), dtype=dt).element_size() > batched.MAX_ROW_BYTES:
                continue
            x, lens = row_batch(16, n, dt, gen)
            for method in batched.METHODS:
                err = max(err, same(batched.batched_row_sort(x, lens, method=method),
                                    batched.batched_row_sort_plain(x, lens, method=method),
                                    f"batched_row_sort {name} ({x.shape[0]}, {n}) {method}"))
                batches += 1
    print(f"batched_row_sort: {batches} batches at every tier boundary equal the plain version bit for bit")
    x = random_keys((64, 8192), torch.int32, gen)
    lens = torch.from_numpy(gen.integers(0, 8193, 64).astype(np.int32)).to(DEV)
    for method in batched.METHODS:
        out = batched.batched_row_sort(x, lens, method=method)
        err = max(err, same(out, batched.batched_row_sort_plain(x, lens, method=method), f"batched {method}"))
        host = out.cpu().numpy()
        for i, ln in enumerate(lens.cpu().tolist()):
            if not np.array_equal(host[i, :ln], np.sort(x[i, :ln].cpu().numpy())):
                fail(f"batched_row_sort {method} row {i} is not np.sort")
            if (host[i, ln:] != np.iinfo(np.int32).max).any():
                fail(f"batched_row_sort {method} row {i} pad is not the sentinel")
    timed = {}
    for shape, dt in (((64, 8192), torch.int32), ((64, 8192), torch.float32), ((64, 8192), torch.int64),
                      ((64, 1 << 16), torch.int8)):
        y = x if dt == torch.int32 else random_keys(shape, dt, gen)
        ylens = lens if dt == torch.int32 else torch.from_numpy(gen.integers(0, shape[1] + 1, 64).astype(np.int32)).to(DEV)
        for method in batched.METHODS if not dt.is_floating_point else ("bitonic",):
            err = max(err, same(batched.batched_row_sort(y, ylens, method=method),
                                batched.batched_row_sort_plain(y, ylens, method=method),
                                f"batched_row_sort {shape} {dt} {method}"))
            label = f"batched_row_sort {shape} {str(dt)[6:]} {method}"
            ms = cuda_ms(lambda m=method: batched.batched_row_sort(y, ylens, method=m), reps=11)
            tiers = launch_profile(label, lambda m=method: batched.batched_row_sort(y, ylens, method=m), "key_")
            profile_request(label, lambda m=method: batched.batched_row_sort(y, ylens, method=m))
            print(f"kernel {label}: {ms:.4f} ms by events, device {tiers.get('device_ms')} ms, "
                  f"{tiers.get('launches')} launches a call")
            timed[shape, dt, method] = ms, tiers
    plain = cuda_ms(lambda: batched.batched_row_sort_plain(x, lens, method="bitonic"), reps=3)
    lib = cuda_ms(lambda: torch.sort(x, dim=-1))
    # the kernel need not read the pad cells, but writes every cell
    valid = int(lens.sum())
    b, by = bound((valid + x.numel()) * 4 + 4 * 64, sort_comparisons(lens.cpu().tolist()))
    ms, tiers = timed[(64, 8192), torch.int32, "bitonic"]
    ms2, tiers2 = timed[(64, 8192), torch.int32, "bitonic2op"]
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/batched.cu",
        replaces="src/repro/kernels/batched.py:145", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(64, 8192) int32", device_ms=tiers.get("device_ms"), launches_per_call=tiers.get("launches"),
        extra=f"bitonic2op {ms2:.4f} ms, device {tiers2.get('device_ms')} ms",
    )


# Segment lengths at every boundary of the merge's tiers (csrc/bitonic.cu
# merge_pairs): 2^8 .. 2^21 keys a merged pair: within one chunk (read
# flipped by the chunk launch) for every key width, one to three distances
# past it (the flip window alone), and longer (device windows).
MERGE_LOG_SEGS = range(8, 22)


def merge_kernel_checks(gen: np.random.Generator) -> dict:
    """K3 bit for bit against its plain version at every tier boundary (2
    to 5 tiles a row, both half-passes), every key dtype, heavy ties and
    signed zeros, and against torch.sort of each merged pair; then timed
    at the main path's shape, (36, 2, 2^19), beside torch.sort over the
    same rows, with the device time of each launch."""
    err, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        for case in ("spread", "heavy_ties") + (("signed_zeros",) if name == "float32" else ()):
            for log_seg in MERGE_LOG_SEGS:
                m = 1 << (log_seg - 1)
                configs = [(t, f) for t in (2, 3, 4, 5) for f in (0, 1)] if log_seg <= 16 else [(2, 0), (3, 1)]
                for tiles, first in configs:
                    nrows = 2 if log_seg <= 16 else 1
                    buf = torch.sort(tile_keys((nrows, tiles, m), TORCH_KEY[name], case, gen), dim=-1).values
                    what = f"merge_tile_pairs {name} {case} 2^{log_seg} keys a pair, {tiles} tiles, first={first}"
                    got = bitonic.merge_tile_pairs(buf.clone(), first)
                    err = max(err, same(got, bitonic.merge_tile_pairs_plain(buf.clone(), first), what))
                    k = (tiles - first) // 2
                    span = slice(first, first + 2 * k)
                    if not torch.equal(got[:, span].reshape(nrows, k, 2 * m),
                                       torch.sort(buf[:, span].reshape(nrows, k, 2 * m), dim=-1).values):
                        fail(f"{what}: not torch.sort of each pair")
                    batches += 1
    print(f"merge_tile_pairs: {batches} batches at every tier boundary equal the plain version bit for bit")
    # the two-tile form at 2^19 (the earlier PRs' row)
    n = 1 << 19
    a = torch.sort(random_keys((n,), torch.int32, gen)).values
    c = torch.sort(random_keys((n,), torch.int32, gen)).values
    lo, hi = bitonic.merge_tiles(a, c)
    plo, phi = bitonic.merge_tiles_plain(a, c)
    err = max(err, same(lo, plo, "merge_tiles lo"), same(hi, phi, "merge_tiles hi"))
    rlo, rhi = ref.ref_merge(a, c)
    if not (torch.equal(lo, rlo) and torch.equal(hi, rhi)):
        fail("merge_tiles disagrees with torch.sort of the union")
    two = launch_profile("merge_tiles two 2^19 int32 tiles", lambda: bitonic.merge_tiles(a, c), "key_")
    print(f"kernel merge_tiles two 2^19 int32 tiles: {cuda_ms(lambda: bitonic.merge_tiles(a, c), reps=11):.4f} ms "
          f"by events, device {two.get('device_ms')} ms, {two.get('launches')} launches, "
          f"torch.sort of the union {cuda_ms(lambda: torch.sort(torch.cat([a, c])), reps=11):.4f} ms")
    # the main path's half-pass at 15,728,640 keys: 36 rows of two tiles
    tiles = torch.sort(random_keys((36, 2, n), torch.int32, gen), dim=-1).values
    got = bitonic.merge_tile_pairs(tiles.clone())
    err = max(err, same(got, bitonic.merge_tile_pairs_plain(tiles.clone()), "merge_tile_pairs (36, 2, 2^19)"))
    union = tiles.view(36, 2 * n)
    if not torch.equal(got.view(36, 2 * n), torch.sort(union, dim=-1).values):
        fail("merge_tile_pairs (36, 2, 2^19) disagrees with torch.sort of each row")
    # in place, over and over: the network's work does not depend on the keys
    work = tiles.clone()
    ms = cuda_ms(lambda: bitonic.merge_tile_pairs(work), reps=11)
    tiers = launch_profile("merge_tile_pairs (36, 2, 2^19) int32", lambda: bitonic.merge_tile_pairs(work), "key_")
    plain = cuda_ms(lambda: bitonic.merge_tile_pairs_plain(tiles.clone()), reps=3)
    lib = cuda_ms(lambda: torch.sort(union, dim=-1), reps=11)
    b, by = bound(2 * tiles.numel() * 4, tiles.numel())
    print(f"kernel merge_tile_pairs (36, 2, 2^19) int32: {ms:.4f} ms by events, device {tiers.get('device_ms')} ms, "
          f"{tiers.get('launches')} launches, torch.sort over (36, 2^20) {lib:.4f} ms, bound {b:.4f} ms")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:236", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(36, 2, 2^19) int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )


# The (ids, B) the main path hands K1: SortEngine.sort at 15,728,640 keys
# and at 2^22 (P = 36 and 144), top_k at k = n/2, merge_sorted of 2^20
# keys into 2^22, long-row sort_segments (64 rows x 37 buckets, each row's
# ids in its own buckets), and the kernels line's shape, kept from earlier PRs.
BCR_SHAPES = ((1 << 24, 37), (1 << 22, 37), (1 << 22, 145), (1 << 24, 33), (1 << 23, 37), (1 << 22, 2368),
              (1 << 24, 145))


def bcr_ids(n: int, nb: int, gen: np.random.Generator) -> torch.Tensor:
    if nb == 2368:  # 64 rows of 37 buckets, as scatter_rows_to_buckets offsets them
        row = np.arange(n) * 64 // n
        return torch.from_numpy((row * 37 + gen.integers(0, 37, n)).astype(np.int32)).to(DEV)
    return torch.from_numpy(gen.integers(0, nb, n).astype(np.int32)).to(DEV)


def bcr_profile(fn, reps: int = 5, attempts: int = 3) -> tuple["float | None", "int | None"]:
    """Device time of one call (its kernel and the memset of its status
    words; median of ``reps`` calls) and its kernel launches; a profiler
    session that lost the calls' markers is traced again, up to
    ``attempts`` sessions."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        calls = devtrace.call_events(fn, reps)
        if calls:
            return (float(np.median([sum(t for _, t in c) for c in calls])),
                    max(sum("bcr" in n for n, _ in c) for c in calls))
    return None, None


def bcr_kernel_checks(gen: np.random.Generator) -> dict:
    """K1 against its plain version and torch.bincount at every boundary
    of its tiles and at every bucket count the path uses, with every id
    in one bucket and with out-of-range ids; then timed at every shape
    the main path hands it."""
    lib = _build.load("partition")
    err, checks = 0.0, 0

    def check(ids, nb, what):
        kc, kr = partition_kernel.bucket_count_rank(ids, nb)
        pc, pr = partition_kernel.bucket_count_rank_plain(ids, nb)
        e = max(same(kc, pc, f"bucket_count_rank counts {what}"), same(kr, pr, f"bucket_count_rank ranks {what}"))
        valid = ids[(ids >= 0) & (ids < nb)]
        if not torch.equal(kc, torch.bincount(valid, minlength=nb).to(torch.int32)):
            fail(f"bucket_count_rank {what}: counts disagree with torch.bincount")
        return e

    for nb in (1, 2, 37, 145, 2368, 4096):
        tile = lib.rt_bcr_tile(nb)  # ids a tile at this B
        for n in (1, tile - 1, tile, tile + 1, 1 << 22, 1 << 24):
            ids = torch.from_numpy(gen.integers(0, nb, n).astype(np.int32)).to(DEV)
            err = max(err, check(ids, nb, f"n={n} B={nb}"))
            checks += 1
    for nb in (1, 37, 4096):
        for n in (lib.rt_bcr_tile(nb) + 1, 1 << 24):
            # every id in one bucket; then a third of them out of range
            err = max(err, check(torch.full((n,), nb - 1, dtype=torch.int32, device=DEV), nb, f"one bucket n={n} B={nb}"))
            ids = torch.from_numpy(gen.integers(0, nb, n).astype(np.int32)).to(DEV)
            ids[::6], ids[1::6], ids[2::6] = -3, nb, -(2**31)
            err = max(err, check(ids, nb, f"out of range n={n} B={nb}"))
            checks += 2
    print(f"bucket_count_rank: {checks} calls equal the plain version and torch.bincount")
    row = None
    for n, nb in BCR_SHAPES:
        ids = bcr_ids(n, nb, gen)
        ms = cuda_ms(lambda: partition_kernel.bucket_count_rank(ids, nb), reps=11)
        dev_ms, launches = bcr_profile(lambda: partition_kernel.bucket_count_rank(ids, nb))
        b, by = bound(4 * n + 4 * nb + 4 * n, 2 * n)
        print(f"kernel bucket_count_rank n=2^{n.bit_length() - 1} B={nb}: {ms:.4f} ms by events, device {dev_ms} ms "
              f"(kernel and memset), {launches} kernel launches, bound {b:.4f} ms")
        if launches is not None and launches != 1:
            fail(f"bucket_count_rank made {launches} kernel launches in one call, not 1")
        row = ids, nb, ms, dev_ms, launches, b, by
    ids, nb, ms, dev_ms, launches, b, by = row  # the last shape: (2^24, 145)
    plain = cuda_ms(lambda: partition_kernel.bucket_count_rank_plain(ids, nb), reps=3)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/partition.cu",
        replaces="src/repro/kernels/partition_kernel.py:84", max_abs_err=err,
        # no one PyTorch call gives both the counts and the stable ranks
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        shape="2^24 ids, B=145", device_ms=dev_ms, launches_per_call=launches,
    )


def payload(shape, dtype: torch.dtype, gen: np.random.Generator) -> torch.Tensor:
    """Random payload bits of ``dtype`` (any width 1, 2, 4 or 8 bytes)."""
    bits = bitonic._BITS[torch.empty((), dtype=dtype).element_size()]
    raw = torch.from_numpy(gen.integers(-(2**62), 2**62, shape)).to(bits)
    return raw.view(dtype).to(DEV)


def same_pairs(got, want, what: str) -> float:
    """Keys and payloads of a pair sort, bit for bit."""
    err = same(got[0], want[0], f"{what} keys")
    bits = bitonic._BITS[got[1].element_size()]
    same(got[1].view(bits), want[1].view(bits), f"{what} payloads")
    return err


# Row lengths at every boundary of the pair sort's tiers (csrc/bitonic.cu):
# under one warp's 256 pairs, one warp, one 2,048-pair chunk, two and
# four chunks (the first lengths with device-memory windows), then longer
# rows up to argsort_keys' full width.
PAIR_SIZES = (128, 256, 1 << 11, 1 << 12, 1 << 13, 1 << 15, 1 << 16, 1 << 19)
# Pair row lengths at every boundary of the pair row sort (csrc/batched.cu
# pair_chunk_rows): under one warp's 256 pairs, one warp, more runs a
# thread up to a row that fills one block's shared memory, and rows past
# it (the fill in torch, then the pair sort's launches).
ROW_PAIR_SIZES = (128, 256, 512, 2048, 8192, 1 << 14, 1 << 15, 1 << 16)


def pair_keys(shape, heavy_ties: bool, gen: np.random.Generator) -> torch.Tensor:
    """int32 keys over the whole type, or drawn from 16 values (heavy ties)."""
    if heavy_ties:
        return torch.from_numpy(gen.integers(0, 16, shape).astype(np.int32)).to(DEV)
    return random_keys(shape, torch.int32, gen)


def launch_profile(label: str, fn, kind: str, reps: int = 5, attempts: int = 3) -> dict:
    """Device time of each kernel launch of one call of ``fn`` (``reps``
    calls traced in one profiler session, median over the calls), summed
    by the launch kinds of a tiered sort, whose kernel names start with
    ``kind`` (``pair_`` for K5 and K7, ``key_`` for K2): the first chunk
    launch (every stage whose distances fit one chunk: registers, warp
    shuffles, shared memory), the later chunk launches (one stage's
    distances below the chunk each) and the device windows (several longer
    distances each, through device memory).  Every call must show the same
    launches in the same order; a session that does not (the profiler lost
    events) is traced again, up to ``attempts`` sessions, else nothing is
    reported."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        calls = devtrace.call_events(fn, reps) or []
        calls = [[(n, t) for n, t in c if kind in n] for c in calls]
        names = [n for n, _ in calls[0]] if calls else []
        if names and all([n for n, _ in c] == names for c in calls):
            break
        print(f"tiers {label}: launches {[len(c) for c in calls]} in {reps} calls, not the same each call "
              f"(profiler session {attempt} of {attempts})")
    else:
        return {}
    ms = np.median(np.array([[t for _, t in c] for c in calls]), axis=0)
    chunk = [t for n, t in zip(names, ms) if f"{kind}chunk" in n]
    window = [t for n, t in zip(names, ms) if f"{kind}device" in n]
    out = dict(device_ms=float(ms.sum()), launches=len(names), first_ms=float(chunk[0]) if chunk else 0.0,
               later_chunks=len(chunk) - 1, later_ms=float(sum(chunk[1:])), windows=len(window),
               window_ms=float(sum(window)))
    print(
        f"tiers {label}: {len(names)} launches, {out['device_ms']:.4f} ms on the card = first chunk launch "
        f"{out['first_ms']:.4f} ms + {out['later_chunks']} chunk launches {out['later_ms']:.4f} ms "
        f"+ {out['windows']} device windows {out['window_ms']:.4f} ms"
    )
    return out


# Row lengths at every boundary of the tile sort's tiers (csrc/bitonic.cu:
# 16 keys a thread, 32 KiB chunks): 128 keys (a partial warp), one warp's
# 512, one chunk of int64 (2^12), int32 (2^13) and int8/int16 (2^14), two
# and four chunks (the first device windows), 2^17 and 2^18 (where a stage
# first takes two device windows for int64 and int32), 2^19 (for
# int8/int16) and 2^20.
TILE_SIZES = (128, 512, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20)
# The rows the main path hands K2: SortEngine.sort at 2^20 keys a row
# (the shape of the kernels line, kept comparable with earlier runs), at
# 15,728,640 keys, at 2^22 keys and at 2^22 on the 144-processor OHHC;
# top_k's kept rows at k = n/2; long-row sort_segments.
TILE_SHAPES = ((36, 1 << 20), (72, 1 << 19), (36, 1 << 18), (144, 1 << 17), (32, 1 << 19), (2304, 4096))


def tile_keys(shape, dtype: torch.dtype, case: str, gen: np.random.Generator) -> torch.Tensor:
    """Keys over the whole type, drawn from 16 values (heavy ties), or
    float32 keys about half of them -0.0 or +0.0 (signed zeros)."""
    if case == "heavy_ties":
        return torch.from_numpy(gen.integers(0, 16, shape)).to(dtype).to(DEV)
    x = random_keys(shape, dtype, gen)
    if case == "signed_zeros":
        zero = torch.from_numpy(gen.random(shape) < 0.5).to(DEV)
        neg = torch.from_numpy(gen.random(shape) < 0.5).to(DEV)
        x = torch.where(zero, torch.where(neg, -torch.zeros_like(x), torch.zeros_like(x)), x)
    return x


def tile_kernel_checks(gen: np.random.Generator) -> dict:
    """K2 bit for bit against its plain version at every tier boundary
    (1, 3 and 36 rows; 36 up to 2^16 keys a row), every key dtype, heavy
    ties and signed zeros, then at the main path's shapes, each timed by
    events and by device time beside torch.sort over the same rows."""
    err, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        for case in ("spread", "heavy_ties") + (("signed_zeros",) if name == "float32" else ()):
            for n in TILE_SIZES:
                for nrows in (1, 3, 36) if n <= 1 << 16 else (1, 3):
                    x = tile_keys((nrows, n), TORCH_KEY[name], case, gen)
                    err = max(err, same(bitonic.sort_tile(x), bitonic.sort_tile_plain(x), f"sort_tile {name} {case} ({nrows}, {n})"))
                    batches += 1
    print(f"sort_tile: {batches} batches at every tier boundary equal the plain version bit for bit")
    timed = {}
    for shape in TILE_SHAPES:
        x = tile_keys(shape, torch.int32, "spread", gen)
        got = bitonic.sort_tile(x)
        err = max(err, same(got, bitonic.sort_tile_plain(x), f"sort_tile {shape}"))
        if not torch.equal(got, ref.ref_sort(x)):
            fail(f"sort_tile {shape} disagrees with torch.sort")
        ms = cuda_ms(lambda: bitonic.sort_tile(x), reps=11)
        lib = cuda_ms(lambda: torch.sort(x, dim=-1), reps=11)
        tiers = launch_profile(f"sort_tile {shape} int32", lambda: bitonic.sort_tile(x), "key_")
        b, by = bound(2 * x.numel() * 4, sort_comparisons([x.shape[1]] * x.shape[0]))
        print(f"kernel sort_tile {shape} int32: {ms:.4f} ms by events, device {tiers.get('device_ms')} ms, "
              f"{tiers.get('launches')} launches, torch.sort {lib:.4f} ms, bound {b:.4f} ms")
        timed[shape] = x, ms, lib, tiers, b, by
    # a float32 batch at 15,728,640 keys with signed zeros through the windows
    y = tile_keys((72, 1 << 19), torch.float32, "signed_zeros", gen)
    err = max(err, same(bitonic.sort_tile(y), bitonic.sort_tile_plain(y), "sort_tile (72, 2^19) float32 signed zeros"))
    x, ms, lib, tiers, b, by = timed[TILE_SHAPES[0]]
    plain = cuda_ms(lambda: bitonic.sort_tile_plain(x), reps=3)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:179", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(36, 2^20) int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )


def pair_kernel_checks(gen: np.random.Generator) -> dict:
    rows = {}
    n = 1 << 19
    # K5 and K7 at every tier boundary, 1 and 3 rows, random full-range
    # keys and heavy ties (16 values), 30 % pad tags, an arange payload
    err = 0.0
    for m in PAIR_SIZES:
        for nrows in (1, 3):
            for heavy in (False, True):
                k = pair_keys((nrows, m), heavy, gen)
                t = torch.from_numpy((gen.random((nrows, m)) < 0.3).astype(np.uint8)).to(DEV)
                v = torch.arange(nrows * m, dtype=torch.int32, device=DEV).view(nrows, m)
                what = f"(rows={nrows}, n={m}){' heavy ties' if heavy else ''}"
                err = max(err, same_pairs(
                    bitonic.sort_pairs_tile_tagged(k, t, v), bitonic.sort_pairs_tile_tagged_plain(k, t, v),
                    f"sort_pairs_tile_tagged {what}",
                ), same_pairs(bitonic.sort_pairs_tile(k, v), bitonic.sort_pairs_tile_plain(k, v), f"sort_pairs_tile {what}"))
    # 8-byte keys with 8-byte payloads: one whole chunk, two, and full width
    for shape in ((3, 2048), (3, 4096), (1, n)):
        k = random_keys(shape, torch.int64, gen)
        k[:, ::7] = torch.iinfo(torch.int64).max
        v = payload(shape, torch.float64, gen)
        t = torch.from_numpy((gen.random(shape) < 0.3).astype(np.uint8)).to(DEV)
        err = max(err, same_pairs(
            bitonic.sort_pairs_tile_tagged(k, t, v), bitonic.sort_pairs_tile_tagged_plain(k, t, v),
            f"sort_pairs_tile_tagged int64/float64 {shape}",
        ), same_pairs(bitonic.sort_pairs_tile(k, v), bitonic.sort_pairs_tile_plain(k, v), f"sort_pairs_tile int64/float64 {shape}"))
    # K5 at argsort_keys' full width: (1, 2^19) int32 keys with an arange
    # payload and every tag 0 (n_valid = n).
    k = random_keys((1, n), torch.int32, gen)
    idx = torch.arange(n, dtype=torch.int32, device=DEV)[None]
    tags = torch.zeros((1, n), dtype=torch.uint8, device=DEV)
    got = bitonic.sort_pairs_tile_tagged(k, tags, idx)
    err = max(err, same_pairs(got, bitonic.sort_pairs_tile_tagged_plain(k, tags, idx), "sort_pairs_tile_tagged 2^19"))
    if not torch.equal(got[0], torch.sort(k).values) or not torch.equal(k[0, got[1][0].long()], got[0][0]):
        fail("sort_pairs_tile_tagged: keys are not torch.sort's or payloads left their keys")
    # every key dtype at 4,096 with sentinel-equal keys and a pad tail,
    # every payload width
    for name in DTYPES:
        if name == "uint32":
            continue  # reaches the kernels as int32 (repro_torch.dtypes)
        dt = TORCH_KEY[name]
        for vdt in (torch.bool, torch.float16, torch.float32, torch.float64):
            y = random_keys((4, 4096), dt, gen)
            y[:, ::5] = float("inf") if dt.is_floating_point else torch.iinfo(dt).max
            t = (torch.arange(4096, device=DEV) >= 4000).to(torch.uint8).expand(4, 4096).contiguous()
            v = payload((4, 4096), vdt, gen)
            err = max(err, same_pairs(
                bitonic.sort_pairs_tile_tagged(y, t, v), bitonic.sort_pairs_tile_tagged_plain(y, t, v),
                f"sort_pairs_tile_tagged {name}/{vdt}",
            ))
    ms = cuda_ms(lambda: bitonic.sort_pairs_tile_tagged(k, tags, idx), reps=21)
    # the event time includes the wrapper's host work; this is the card's
    tiers = launch_profile("sort_pairs_tile_tagged (1, 2^19) int32/int32",
                           lambda: bitonic.sort_pairs_tile_tagged(k, tags, idx), "pair_")
    # a one-byte payload (bool) runs an instantiation of its own
    flags = torch.from_numpy(gen.random((1, n)) < 0.5).to(DEV)
    err = max(err, same_pairs(bitonic.sort_pairs_tile_tagged(k, tags, flags),
                              bitonic.sort_pairs_tile_tagged_plain(k, tags, flags), "sort_pairs_tile_tagged int32/bool"))
    print(f"kernel sort_pairs_tile_tagged (1, 2^19) int32/bool: "
          f"{cuda_ms(lambda: bitonic.sort_pairs_tile_tagged(k, tags, flags), reps=21):.4f} ms")
    plain = cuda_ms(lambda: bitonic.sort_pairs_tile_tagged_plain(k, tags, idx), reps=3)
    lib = cuda_ms(lambda: torch.sort(k, dim=-1), reps=21)
    b, by = bound(2 * n * (4 + 4) + n, sort_comparisons([n]))
    rows["sort_pairs_tile_tagged"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:212", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(1, 2^19) int32/int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )

    # K6 at every boundary of its tiers, every key dtype and payload width
    err6, batches = 0.0, 0
    for name in ("int8", "int16", "int32", "int64", "float32"):
        for m in ROW_PAIR_SIZES:
            for vdt in (torch.bool, torch.bfloat16, torch.int32, torch.float64):
                y, ylens = row_batch(12, m, TORCH_KEY[name], gen)
                yv = payload((12, m), vdt, gen)
                err6 = max(err6, same_pairs(batched.batched_row_sort_pairs(y, yv, ylens),
                                            batched.batched_row_sort_pairs_plain(y, yv, ylens),
                                            f"batched_row_sort_pairs {name}/{vdt} (12, {m})"))
                batches += 1
    print(f"batched_row_sort_pairs: {batches} batches at every tier boundary equal the plain version bit for bit")
    # K6 at (64, 8192) int32/int32, random lengths, garbage in the pads.
    x = random_keys((64, 8192), torch.int32, gen)
    xv = random_keys((64, 8192), torch.int32, gen)
    lens = torch.from_numpy(gen.integers(0, 8193, 64).astype(np.int32)).to(DEV)
    got = batched.batched_row_sort_pairs(x, xv, lens)
    err = max(err6, same_pairs(got, batched.batched_row_sort_pairs_plain(x, xv, lens), "batched_row_sort_pairs (64, 8192)"))
    hk, hv = got[0].cpu().numpy(), got[1].cpu().numpy()
    xk, xvh = x.cpu().numpy(), xv.cpu().numpy()
    for i, ln in enumerate(lens.cpu().tolist()):
        order = np.argsort(xk[i, :ln], kind="stable")
        if not np.array_equal(hk[i, :ln], xk[i, order]) or (hv[i, ln:] != 0).any():
            fail(f"batched_row_sort_pairs row {i} is not np.sort or its pad payloads are not 0")
        if not np.array_equal(np.sort(hv[i, :ln]), np.sort(xvh[i, :ln])):
            fail(f"batched_row_sort_pairs row {i} lost payloads")
    # one row past one block's shared memory: the fill, then K5's passes
    long_k = random_keys((2, 1 << 15), torch.int32, gen)
    long_v = payload((2, 1 << 15), torch.float64, gen)
    long_lens = torch.tensor([30_000, 1 << 15], dtype=torch.int32, device=DEV)
    before = launch_counts()["sort_pairs_tile_tagged"]
    err = max(err, same_pairs(
        batched.batched_row_sort_pairs(long_k, long_v, long_lens),
        batched.batched_row_sort_pairs_plain(long_k, long_v, long_lens),
        "batched_row_sort_pairs (2, 2^15) int32/float64",
    ))
    if launch_counts()["sort_pairs_tile_tagged"] != before + 1:
        fail("a row past one block did not go through the multi-pass pair kernel")
    ms = cuda_ms(lambda: batched.batched_row_sort_pairs(x, xv, lens))
    # the event time above includes the wrapper's host work; this is the kernel's own
    profile_request("batched_row_sort_pairs (64, 8192)", lambda: batched.batched_row_sort_pairs(x, xv, lens))
    k6 = launch_profile("batched_row_sort_pairs (64, 8192) int32/int32",
                        lambda: batched.batched_row_sort_pairs(x, xv, lens), "pair_")
    print(f"kernel batched_row_sort_pairs (64, 8192) int32/int32: {ms:.4f} ms by events, device "
          f"{k6.get('device_ms')} ms, {k6.get('launches')} launches a call")
    y64 = random_keys((64, 8192), torch.int64, gen)
    v64 = payload((64, 8192), torch.float64, gen)
    err = max(err, same_pairs(batched.batched_row_sort_pairs(y64, v64, lens),
                              batched.batched_row_sort_pairs_plain(y64, v64, lens), "batched_row_sort_pairs int64/float64"))
    k6w = launch_profile("batched_row_sort_pairs (64, 8192) int64/float64",
                         lambda: batched.batched_row_sort_pairs(y64, v64, lens), "pair_")
    print(f"kernel batched_row_sort_pairs (64, 8192) int64/float64: "
          f"{cuda_ms(lambda: batched.batched_row_sort_pairs(y64, v64, lens)):.4f} ms by events, device "
          f"{k6w.get('device_ms')} ms, {k6w.get('launches')} launches a call")
    plain = cuda_ms(lambda: batched.batched_row_sort_pairs_plain(x, xv, lens), reps=3)
    lib = cuda_ms(lambda: torch.sort(x, dim=-1))
    valid = int(lens.sum())
    b, by = bound((valid + x.numel()) * (4 + 4) + 4 * 64, sort_comparisons(lens.cpu().tolist()))
    rows["batched_row_sort_pairs"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/batched.cu",
        replaces="src/repro/kernels/batched.py:181", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(64, 8192) int32/int32", device_ms=k6.get("device_ms"), launches_per_call=k6.get("launches"),
    )

    # K7 at 2^19: the untagged pair sort (its tier boundaries ran above).
    got = bitonic.sort_pairs_tile(k, idx)
    err = same_pairs(got, bitonic.sort_pairs_tile_plain(k, idx), "sort_pairs_tile 2^19")
    if not torch.equal(got[0], torch.sort(k).values) or not torch.equal(k[0, got[1][0].long()], got[0][0]):
        fail("sort_pairs_tile: keys are not torch.sort's or payloads left their keys")
    for name in ("int8", "int64", "float32"):
        y = random_keys((4, 4096), TORCH_KEY[name], gen)
        v = payload((4, 4096), torch.int16, gen)
        err = max(err, same_pairs(bitonic.sort_pairs_tile(y, v), bitonic.sort_pairs_tile_plain(y, v), f"sort_pairs_tile {name}"))
    ms = cuda_ms(lambda: bitonic.sort_pairs_tile(k, idx), reps=21)
    tiers = launch_profile("sort_pairs_tile (1, 2^19) int32/int32", lambda: bitonic.sort_pairs_tile(k, idx), "pair_")
    plain = cuda_ms(lambda: bitonic.sort_pairs_tile_plain(k, idx), reps=3)
    lib = cuda_ms(lambda: torch.sort(k, dim=-1), reps=21)
    b, by = bound(2 * n * (4 + 4), sort_comparisons([n]))
    rows["sort_pairs_tile"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
        replaces="src/repro/kernels/bitonic.py:195", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        shape="(1, 2^19) int32/int32", device_ms=tiers.get("device_ms"),
        launches_per_call=tiers.get("launches"),
    )
    return rows


# ----------------------------------------------------------------- phase 3
def request_launches(label: str, fn) -> dict:
    """Kernel launches of one request (the counts' difference across it)."""
    before = launch_counts()
    fn()
    after = launch_counts()
    got = {k: after[k] - before[k] for k in after}
    print(f"launches of one request, {label}: {got}")
    return got


def timed_sort(eng: SortEngine, x: np.ndarray, what: str, reps: int = 1) -> None:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = eng.sort(x)
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(y, np.sort(x)) or y.dtype != x.dtype:
            fail(f"SortEngine.sort {what} differs from np.sort")
    r = eng.last_report
    p = r["plan"]
    wall = statistics.median(walls)
    print(
        f"sort {what}: path={p.path} method={p.method} capacity={r.get('capacity_used', p.capacity)} "
        f"retries={r['overflow_retries']} wall={wall * 1e3:.2f} ms ({x.size / wall:.4g} keys/s)"
    )


def main_path_sort() -> None:
    eng = SortEngine()
    for name in DTYPES:
        for dist in ALL_DISTRIBUTIONS:
            timed_sort(eng, make_array(dist, 100_000, seed=1, dtype=np.dtype(name)), f"{name}/{dist} n=100000")
    # below 65,536 keys skewed inputs stay on the sim path: sampled
    # splitters (local) and a large autotuned capacity (dupes)
    for name in DTYPES:
        for dist in ("local", "dupes"):
            timed_sort(eng, make_array(dist, 60_000, seed=1, dtype=np.dtype(name)), f"{name}/{dist} n=60000")
    # a forced small capacity overflows and escalates x2 until it fits
    dupes = make_array("dupes", 60_000, seed=7)
    forced = SortPlan("sim", "paper", 512, 65536, "forced small capacity")
    t0 = time.perf_counter()
    if not np.array_equal(eng.sort(dupes, plan=forced), np.sort(dupes)):
        fail("SortEngine.sort with a forced small capacity differs from np.sort")
    r = eng.last_report
    if r["overflow_retries"] == 0:
        fail("a forced capacity of 512 for 60,000 dupes did not overflow")
    print(
        f"sort int32/dupes n=60000 forced capacity 512: retries={r['overflow_retries']} "
        f"capacity_used={r['capacity_used']} wall={(time.perf_counter() - t0) * 1e3:.2f} ms"
    )
    # int64 keys spanning the whole type: the exact unsigned bucket rule
    gen = np.random.default_rng(3)
    wide = gen.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 100_000, dtype=np.int64, endpoint=True)
    timed_sort(eng, wide, "int64 full-span n=100000")
    paper = SortEngine(host_threshold=1 << 25)
    for n in (1 << 22, PAPER_MAX_KEYS):
        timed_sort(paper, make_array("random", n, seed=2), f"paper int32 random n={n}", reps=3)
    paper144 = SortEngine(OHHCTopology(2, "full"), host_threshold=1 << 25)
    timed_sort(paper144, make_array("random", 1 << 22, seed=4), "P=144 int32 random n=4194304", reps=3)
    for n in (1 << 22, PAPER_MAX_KEYS):
        x = make_array("random", n, seed=2)
        got = request_launches(f"SortEngine.sort int32 n={n}", lambda x=x: paper.sort(x))
        runs = 1 + paper.last_report["overflow_retries"]  # a retry runs the request again
        # K3: one call (the even half-pass over two tiles a row) at 15.7M keys
        for name, want in (("bucket_count_rank", runs), ("sort_tile", runs),
                           ("merge_tiles", runs if n == PAPER_MAX_KEYS else 0)):
            if got[name] != want:
                fail(f"one sort of {n} keys launched {name} {got[name]} times in {runs} runs, not {want}")
        profile_request(f"SortEngine.sort int32 n={n}", lambda x=x: paper.sort(x))


def profile_request(label: str, fn) -> "float | None":
    """Device time by kernel and copy for one warm request, beside its wall
    time (``repro_torch.devtrace``: only events on the card count)."""
    fn()  # warm
    torch.cuda.synchronize()
    walls = []

    def timed_request():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    calls = devtrace.call_events(timed_request, 1)
    wall = walls[0]
    if not calls or not calls[0]:
        print(f"profile {label}: wall {wall * 1e3:.3f} ms, device time not visible to torch.profiler")
        return None
    by_name: dict[str, list] = {}
    for name, ms in calls[0]:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += ms
        row[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    print(
        f"profile {label}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / (wall * 1e3):.1f}% of wall)"
    )
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms  x{count:<4d} {name[:90]}")
    return busy


# ----------------------------------------------------------------- phase 4
def main_path_segments() -> None:
    gen = np.random.default_rng(5)
    eng = SortEngine()
    for name in ("int32", "float32"):
        lens = gen.integers(1000, 8193, 64)
        keys = make_array("random", int(lens.sum()), seed=6, dtype=np.dtype(name))
        segs = np.split(keys, np.cumsum(lens)[:-1])
        for forced in ("pallas", "pallas2op", None):
            if forced is None:
                os.environ.pop("REPRO_ROW_BACKEND", None)
            else:
                os.environ["REPRO_ROW_BACKEND"] = forced
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eng.sort_segments(keys, lens)
                walls.append(time.perf_counter() - t0)
                for o, s in zip(out, segs):
                    if not np.array_equal(o, np.sort(s)):
                        fail(f"sort_segments {name} backend={forced} differs from np.sort")
            wall = statistics.median(walls)
            plan = eng.last_report["plan"]
            print(
                f"sort_segments {name} 64 x <=8192 backend={forced or 'unforced'}: method={plan.method} "
                f"wall={wall * 1e3:.2f} ms ({keys.size / wall:.4g} keys/s); {plan.reason}"
            )
            if forced is None:
                got = request_launches(
                    f"sort_segments {name} 64 x <=8192", lambda: eng.sort_segments(keys, lens)
                )
                if got["batched_row_sort"] != 1:
                    fail(f"one sort_segments request launched the row kernel {got['batched_row_sort']} times")
                profile_request(f"sort_segments {name} 64 x <=8192", lambda: eng.sort_segments(keys, lens))
    os.environ.pop("REPRO_ROW_BACKEND", None)


def long_segments() -> None:
    """Rows above the row kernel's 8,192 keys take the bucket path: one
    count/rank, one local sort and one gather for the whole batch."""
    gen = np.random.default_rng(8)
    eng = SortEngine()
    for name in ("int32", "float32"):
        lens = gen.integers(9000, 65537, 64)
        keys = make_array("random", int(lens.sum()), seed=9, dtype=np.dtype(name))
        segs = np.split(keys, np.cumsum(lens)[:-1])
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.sort_segments(keys, lens)
            walls.append(time.perf_counter() - t0)
            for o, s in zip(out, segs):
                if not np.array_equal(o, np.sort(s)):
                    fail(f"sort_segments {name} 64 x 9,000-65,536 differs from np.sort")
        wall = statistics.median(walls)
        r = eng.last_report
        print(
            f"sort_segments {name} 64 x 9,000-65,536: method={r['plan'].method} "
            f"capacity={r['plan'].capacity} retries={r['overflow_retries']} "
            f"wall={wall * 1e3:.2f} ms ({keys.size / wall:.4g} keys/s)"
        )
        t0 = time.perf_counter()
        eng.plan_segments(keys, lens)
        print(f"  of which plan_segments alone (packing and host stats): {(time.perf_counter() - t0) * 1e3:.2f} ms")
        got = request_launches(
            f"sort_segments {name} 64 x 9,000-65,536", lambda: eng.sort_segments(keys, lens)
        )
        runs = 1 + eng.last_report["overflow_retries"]
        if got["bucket_count_rank"] != runs or got["sort_tile"] != runs or got["batched_row_sort"]:
            fail("long segments did not share one count/rank and one tile sort launch per run")
        if name == "int32":
            profile_request(f"sort_segments {name} 64 x 9,000-65,536", lambda: eng.sort_segments(keys, lens))


# ----------------------------------------------------------------- phase 5
def timed(label: str, fn, check, reps: int = 3):
    """Warm median wall time of ``fn`` (the first call outside the clock),
    each result checked by ``check``."""
    check(fn())
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(out)
    wall = statistics.median(walls)
    print(f"{label}: wall={wall * 1e3:.3f} ms")
    return wall


def held_to_numpy(keys: np.ndarray, ks: np.ndarray, perm: np.ndarray, what: str, leaves=()) -> None:
    """Keys equal np.sort, keys[perm] equals them, perm is a permutation,
    and every payload leaf stays with its key."""
    if not np.array_equal(ks, np.sort(keys)) or not np.array_equal(keys[perm], ks):
        fail(f"{what}: keys differ from np.sort or keys[perm] differs from them")
    if not np.array_equal(np.sort(perm), np.arange(keys.size)):
        fail(f"{what}: the permutation is not one")
    for src, got in leaves:
        if np.asarray(got).tobytes() != src[perm].tobytes():
            fail(f"{what}: a payload leaf left its key")


def pairs_path() -> None:
    eng = SortEngine()
    gen = np.random.default_rng(11)

    def flat_check(keys, what):
        def check(out):
            ks, vs = out
            held_to_numpy(keys, ks.cpu().numpy(), vs.cpu().numpy().astype(np.int64), what)
        return check

    # ServeEngine.order_by_length: (prompt length, request index) of a batch
    lens = gen.integers(1, 4097, 256).astype(np.int32)
    idx = np.arange(256, dtype=np.int32)
    timed("sort_pairs flat, 256 request lengths", lambda: eng.sort_pairs(lens, idx), flat_check(lens, "sort_pairs 256"), reps=20)
    got = request_launches("sort_pairs flat 256", lambda: eng.sort_pairs(lens, idx))
    if got["sort_pairs_tile_tagged"] != 1 or sum(got.values()) != 1:
        fail("one flat sort_pairs request did not launch the tagged pair kernel exactly once")
    n = ops.MAX_TILE
    keys = make_array("random", n, seed=12)
    pidx = np.arange(n, dtype=np.int32)
    timed("sort_pairs flat, 2^19 int32 pairs", lambda: eng.sort_pairs(keys, pidx), flat_check(keys, "sort_pairs 2^19"))
    for dtype in ("int32", "int64"):
        if dtype == "int64":
            x = gen.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64, endpoint=True)
        else:
            x = keys

        def check(out, x=x, dtype=dtype):
            held_to_numpy(x, out[0], out[1], f"argsort_keys {dtype} 2^19")

        timed(f"argsort_keys 2^19 {dtype}", lambda x=x: eng.argsort_keys(x), check)
        if eng.last_report["plan"].path != "sim":
            fail(f"argsort_keys {dtype} at 2^19 left the pair kernel: {eng.last_report['plan']}")
        got = request_launches(f"argsort_keys 2^19 {dtype}", lambda x=x: eng.argsort_keys(x))
        if got["sort_pairs_tile_tagged"] != 1 or sum(got.values()) != 1:
            fail(f"one argsort_keys {dtype} request did not launch the tagged pair kernel exactly once")
    profile_request("argsort_keys 2^19 int32", lambda: eng.argsort_keys(keys))
    for m in (4096, n):
        k = keys[:m]
        flat = np.arange(m, dtype=np.int32)
        tree = {
            "idx": np.arange(m, dtype=np.int64),
            "nested": (k.astype(np.float64), (flat % 251).astype(np.int8)),
        }

        def check(out, k=k, tree=tree, m=m):
            ks, o = out
            held_to_numpy(k, ks, o["idx"], f"sort_pairs pytree {m}", [
                (tree["idx"], o["idx"]), (tree["nested"][0], o["nested"][0]),
                (tree["nested"][1], o["nested"][1]),
            ])

        timed(f"sort_pairs pytree of 3 leaves, {m} keys", lambda k=k, tree=tree: eng.sort_pairs(k, tree), check)
        got = request_launches(f"sort_pairs pytree {m}", lambda k=k, tree=tree: eng.sort_pairs(k, tree))
        if got["sort_pairs_tile_tagged"] != 1:
            fail("one pytree sort_pairs request did not launch the tagged pair kernel once")


# ----------------------------------------------------------------- phase 6
def workloads_path() -> None:
    eng = SortEngine(host_threshold=1 << 25)
    x = make_array("random", PAPER_MAX_KEYS, seed=13)
    want = np.sort(x)
    for k in (PAPER_MAX_KEYS // 2, 1000):
        def check(out, k=k):
            if not np.array_equal(out, want[:k]) or out.dtype != x.dtype:
                fail(f"top_k k={k} differs from np.sort(x)[:k]")

        timed(f"top_k n={PAPER_MAX_KEYS} k={k}", lambda k=k: eng.top_k(x, k), check)
        r = eng.last_report
        p = r["plan"]
        print(
            f"  plan path={p.path} capacity={r.get('capacity_used', p.capacity)} "
            f"retries={r['overflow_retries']} skipped={r['skipped_buckets']}; {p.reason}"
        )
        want_path = "sim" if k > PAPER_MAX_KEYS // 4 else "host"
        if p.path != want_path:
            fail(f"top_k k={k} planned {p.path}, not {want_path}")
        got = request_launches(f"top_k n={PAPER_MAX_KEYS} k={k}", lambda k=k: eng.top_k(x, k))
        runs = 1 + eng.last_report["overflow_retries"]
        if want_path == "sim" and (got["bucket_count_rank"] != runs or got["sort_tile"] != runs):
            fail("one top_k request on the sim path did not launch K1 and K2 once a run")
        if want_path == "host" and sum(got.values()):
            fail("the host head launched a kernel")
    profile_request(f"top_k n={PAPER_MAX_KEYS} k={PAPER_MAX_KEYS // 2}", lambda: eng.top_k(x, PAPER_MAX_KEYS // 2))
    buf = np.sort(make_array("random", 1 << 22, seed=14))
    new = make_array("random", 1 << 20, seed=15)
    merged = np.sort(np.concatenate([buf, new]))

    def check(out):
        if not np.array_equal(out, merged):
            fail("merge_sorted differs from np.sort of the union")

    timed("merge_sorted 2^20 new keys into a sorted 2^22 buffer", lambda: eng.merge_sorted(buf, new), check)
    print(f"  {eng.last_report['plan'].reason}")
    request_launches("merge_sorted 2^20 into 2^22", lambda: eng.merge_sorted(buf, new))


# ----------------------------------------------------------------- phase 7
SERVE_REQUESTS, SERVE_CLIENTS = 600, 8  # the reference sortd benchmark at --paper
FAULT_REQUESTS = 100
FLEET_REQUESTS, FLEET_WARM = 800, 60  # the reference fleet benchmark at --paper
PHASE7_KERNELS = ("batched_row_sort", "bucket_count_rank", "sort_tile")


def serving_mix(n_req: int, dtype: str, seed: int, *, max_bucket: int = 1 << 12, tail: float = 0.0) -> list:
    """The reference sortd benchmark's request stream: 2 % oversize
    (max_bucket + 1 to 2 max_bucket - 1 keys), 48 % of 64-511 keys, 35 % of
    512-2,047 and 15 % of 2,048-4,095.  With ``tail``, that share of the
    requests has 8,193-32,768 keys instead: rows past the row kernel's
    8,192 keys, which a flush sorts on the bucket path."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        if tail and rng.random() < tail:
            n = int(rng.integers(8193, 32769))
        else:
            r = rng.random()
            if r < 0.02:
                n = int(rng.integers(max_bucket + 1, max_bucket * 2))
            elif r < 0.50:
                n = int(rng.integers(64, 512))
            elif r < 0.85:
                n = int(rng.integers(512, 2048))
            else:
                n = int(rng.integers(2048, 4096))
        out.append(rng.integers(0, 1 << 30, n).astype(dtype))
    return out


def exact(reqs, outs, what: str) -> None:
    for x, o in zip(reqs, outs):
        if o.dtype != x.dtype or not np.array_equal(o, np.sort(x)):
            fail(f"{what}: a result differs from np.sort")


def record_flushes(eng: SortEngine) -> list:
    """Wrap ``eng.sort_segments`` (a ``Sortd`` flush) to keep each flush's
    plan, key count and dtype."""
    plans = []
    inner = eng.sort_segments

    def sort_segments(keys, seg_lens, **kw):
        out = inner(keys, seg_lens, **kw)
        plans.append((eng.last_report["plan"], int(np.sum(seg_lens)), np.asarray(keys).dtype))
        return out

    eng.sort_segments = sort_segments
    return plans


def serving_stats(m: dict, wall: float, n_req: int) -> str:
    rows = sum(b["requests"] for k, b in m["buckets"].items() if not k.endswith("/direct"))
    batches = sum(b["batches"] for k, b in m["buckets"].items() if not k.endswith("/direct"))
    methods = collections.Counter()
    for b in m["buckets"].values():
        methods.update(b["methods"])
    return (
        f"p50 {m['latency_ms']['p50']:.3f} ms, p99 {m['latency_ms']['p99']:.3f} ms, "
        f"{n_req / wall:.1f} requests/s, mean batch {rows / max(batches, 1):.2f}, "
        f"flushes {m['flushes']}, direct {m['oversize_direct']}, flush methods {dict(methods)}"
    )


def busy_share(label: str, fn) -> None:
    """The card's busy share over one run of ``fn``: the device time of
    every kernel and copy it ran (``devtrace``) over its wall time."""
    walls = []

    def timed_run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    calls = devtrace.call_events(timed_run, 1)
    if not calls or not calls[0]:
        print(f"busy {label}: device time not visible to torch.profiler")
        return
    busy = sum(ms for _, ms in calls[0])
    print(f"busy {label}: card busy {busy:.3f} ms of {walls[0] * 1e3:.3f} ms wall "
          f"({100 * busy / (walls[0] * 1e3):.2f}%), {len(calls[0])} device events")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, ms in calls[0]:
        by_name[name][0] += ms
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print("  top device time: " + "; ".join(f"{name[:70]} {ms:.3f} ms ({n})" for name, (ms, n) in top))


def sortd_run(cfg: SortdConfig, reqs: list, label: str) -> dict:
    """One closed-loop run of ``reqs`` through ``Sortd`` over a fresh
    ``SortEngine()``, warmed on a throwaway service first (as the
    reference benchmark warms), then the same run under the profiler for
    the card's busy share.  Returns the measured run's launches."""
    eng = SortEngine()
    with Sortd(eng, cfg) as warm:
        for x in reqs[:20]:
            warm.sort(x)
    reset_launches()
    with Sortd(eng, cfg) as sd:
        wall, outs = drive_closed_loop(sd.submit, reqs, clients=SERVE_CLIENTS)
        m = sd.metrics()
    counts = launch_counts()
    exact(reqs, outs, f"Sortd {label}")
    if m["completed"] != len(reqs) or m["failed"]:
        fail(f"Sortd {label}: {m['completed']} completed, {m['failed']} failed of {len(reqs)}")
    print(f"sortd {label}: {serving_stats(m, wall, len(reqs))}, wall {wall * 1e3:.1f} ms")
    print(f"  launches: {counts}")
    with Sortd(eng, cfg) as sd:
        busy_share(f"sortd {label}", lambda: exact(reqs, drive_closed_loop(sd.submit, reqs, clients=SERVE_CLIENTS)[1], label))
    return counts


def merge_ticks() -> dict:
    """16 ``submit_merge`` ticks of 2,048 keys into a buffer that starts
    at 16,384 keys and grows by each tick."""
    rng = np.random.default_rng(70)
    buf = np.sort(rng.integers(0, 1 << 30, 16384).astype(np.int32))
    reset_launches()
    walls = []
    with Sortd(SortEngine()) as sd:
        for _ in range(16):
            new = rng.integers(0, 1 << 30, 2048).astype(np.int32)
            t0 = time.perf_counter()
            out = sd.submit_merge(buf, new).result(timeout=120)
            walls.append(time.perf_counter() - t0)
            if not np.array_equal(out, np.sort(np.concatenate([buf, new]))):
                fail("Sortd.submit_merge differs from np.sort of the union")
            buf = out
        m = sd.metrics()
    counts = launch_counts()
    print(f"sortd merge: 16 ticks of 2048 into 16384..{buf.size - 2048} keys, median wall "
          f"{statistics.median(walls) * 1e3:.3f} ms, buckets {sorted(m['buckets'])}; launches {counts}")
    return counts


def fault_ladder() -> dict:
    """The five scenarios of the reference fault benchmark at d_h = 1,
    then healed, each serving ``FAULT_REQUESTS`` requests of the mix."""
    topo = OHHCTopology(1, "full")
    scenarios = [
        FaultScenario.optical_link_down(1),
        FaultScenario.random_links(topo, 2, seed=3),
        FaultScenario.random_links(topo, 4, seed=3),
        FaultScenario.group_uplinks_down(topo, 1),
        FaultScenario.worker_down(1),
        None,
    ]
    impossible = {"uplinks_g1_down", "worker1_down"}
    eng = SortEngine(topo)
    plans = record_flushes(eng)
    total = collections.Counter()
    cfg = SortdConfig(max_batch=64, max_wait_s=0.005, max_bucket=1 << 12)
    with Sortd(eng, cfg) as sd:
        for i, sc in enumerate(scenarios):
            name = sc.name if sc is not None else "healed"
            reqs = serving_mix(FAULT_REQUESTS, "int32", seed=40 + i)
            sd.set_fault_scenario(sc)
            m0 = sd.metrics()
            plans.clear()
            reset_launches()
            wall, outs = drive_closed_loop(sd.submit, reqs, clients=SERVE_CLIENTS)
            counts = launch_counts()
            m1 = sd.metrics()
            exact(reqs, outs, f"Sortd under {name}")
            flushes = sum(m1["flushes"].values()) - sum(m0["flushes"].values())
            degraded = m1["degraded_flushes"] - m0["degraded_flushes"]
            if len(plans) != flushes or not flushes:
                fail(f"{name}: {len(plans)} flush plans recorded for {flushes} flushes")
            slowdowns = sorted({p.fault_slowdown for p, _, _ in plans if p.fault_slowdown is not None})
            if sc is None:
                if degraded or any(p.fault is not None for p, _, _ in plans) or not counts["batched_row_sort"]:
                    fail("the healed service still served degraded flushes, or launched no row kernel")
            elif name in impossible:
                if any(p.path != "host" or p.fault != name for p, _, _ in plans) or degraded != flushes:
                    fail(f"{name}: a flush left the host fallback")
                if sum(counts.values()):
                    fail(f"{name}: the host fallback launched kernels {counts}")
            else:
                if degraded != flushes or any(p.fault != name or p.fault_slowdown is None for p, _, _ in plans):
                    fail(f"{name}: a flush plan lacks its fault or slowdown")
                if not counts["batched_row_sort"]:
                    fail(f"{name}: the degraded service launched no row kernel")
                cpu = SortEngine(topo, device="cpu", fault_scenario=sc)
                for p, n, dtype in plans:
                    if cpu.plan(np.zeros(n, dtype)).fault_slowdown != p.fault_slowdown:
                        fail(f"{name}: the card's flush slowdown {p.fault_slowdown} differs from the CPU's")
            print(f"fault {name}: {flushes} flushes ({degraded} degraded), paths "
                  f"{sorted({p.path for p, _, _ in plans})}, slowdowns {slowdowns}, "
                  f"{len(reqs) / wall:.1f} requests/s, wall {wall * 1e3:.1f} ms; launches {counts}")
            total.update(counts)
    return dict(total)


def fleet_path() -> dict:
    """``SortdFleet`` of four workers on the one card, each with its own
    ``SortEngine()``: 800 requests of ``loadgen.request_mix`` from 8
    clients after 60 warm ones, healthy and then with the busiest worker
    killed after 60 + 800 // 3 admissions."""
    warm = request_mix(FLEET_WARM, dtype="int32", seed=3)
    reqs = request_mix(FLEET_REQUESTS, dtype="int32", seed=11)
    # the kernels were built in phase 1; warm the row backends' probes on a
    # throwaway service before any worker's heartbeat starts
    with Sortd(SortEngine()) as w:
        for x in warm[:20]:
            w.sort(x)
    reset_launches()
    reports = {}
    for label, chaos in (
        ("healthy", None),
        ("chaos", ChaosConfig(name="kill-busiest-midload", kill_worker_after=FLEET_WARM + FLEET_REQUESTS // 3)),
    ):
        with SortdFleet(FleetConfig(workers=4), chaos=chaos) as fleet:
            drive_closed_loop(fleet.submit, warm, clients=SERVE_CLIENTS)
            wall, outs = drive_closed_loop(fleet.submit, reqs, clients=SERVE_CLIENTS)
            rep = fleet.report()
        exact(reqs, outs, f"SortdFleet {label}")
        f = rep["fleet"]
        methods = collections.Counter()
        for w in rep["workers"].values():
            for b in w["sortd"]["buckets"].values():
                methods.update(b["methods"])
        print(f"fleet {label}: flush methods {dict(methods)}")
        print(f"fleet {label}: {FLEET_REQUESTS / wall:.1f} requests/s, p50 {f['latency_ms']['p50']:.3f} ms, "
              f"p99 {f['latency_ms']['p99']:.3f} ms, steals {f['steals']}, failovers {f['failovers']}, "
              f"readmitted {f['readmitted']}, live {f['live_workers']}, wall {wall * 1e3:.1f} ms")
        reports[label] = rep
    if reports["healthy"]["fleet"]["failovers"]:
        fail("the healthy fleet failed a worker over")
    chaos = reports["chaos"]
    if chaos["fleet"]["failovers"] < 1 or chaos["chaos"]["killed_worker"] is None:
        fail("the chaos run killed no worker or failed none over")
    print(f"  chaos killed worker {chaos['chaos']['killed_worker']} ({chaos['chaos'].get('fault_scenario')})")
    counts = launch_counts()
    print(f"  launches over both fleet runs: {counts}")
    return counts


def serving_path() -> dict:
    total = collections.Counter()
    bench_cfg = SortdConfig(max_batch=64, max_wait_s=0.005, max_bucket=1 << 12)
    for dtype in ("int32", "float32"):
        total.update(sortd_run(bench_cfg, serving_mix(SERVE_REQUESTS, dtype, 11), f"{dtype} bench config"))
        total.update(sortd_run(SortdConfig(), serving_mix(SERVE_REQUESTS, dtype, 12, tail=0.15),
                               f"{dtype} default config, 15% of 8193-32768 keys"))
    total.update(merge_ticks())
    for name in PHASE7_KERNELS:
        if not total[name]:
            fail(f"{name} never launched on the Sortd path")
    total.update(fault_ladder())
    total.update(fleet_path())
    return dict(total)


# ----------------------------------------------------------------- phase 8
PHASE8_KERNELS = ("bucket_count_rank", "sort_tile", "merge_tiles", "batched_row_sort", "sort_pairs_tile_tagged")
# The paper's sizes (PERF.md section 4): 2^22 keys and 15,728,640 (60 MB
# of int32, its largest array).
PAPER_GRID_SIZES = (1 << 22, PAPER_MAX_KEYS)


def verify_cli_run(mode: str, *extra: str) -> tuple[dict, dict]:
    """``python -m repro_torch.verify --<mode>`` on the card, in process;
    its JSON report and its launches.  Fails unless it
    exits 0: no failing cell, cross-check mismatch, failing property or
    drift."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "report.json"
        reset_launches()
        t0 = time.perf_counter()
        rc = verify_cli.main([f"--{mode}", "--device", "cuda", "-q", "--report", str(path), *extra])
        secs = time.perf_counter() - t0
        counts = launch_counts()
        report = json.loads(path.read_text())
    if rc != 0:
        fail(f"python -m repro_torch.verify --{mode} on the card exited {rc}")
    print(f"verify --{mode}: {report['scenario_count']} cells, {len(report['property_checks'])} property checks, "
          f"{secs:.1f} s; launches {counts}")
    return report, counts


def paper_scale_grid() -> dict:
    """The paper's sizes through ``run_grid``: every row oracle-checked,
    the paths of one input cross-checked, with each row's seconds,
    capacity, retries and dense ``(P, capacity)`` buffer."""
    cells = [
        grid.Scenario(path, method, "int32", dist, n, 1)
        for n in PAPER_GRID_SIZES
        for dist in ("random", "dupes", "sorted", "local")
        for path, method in (("sim", "paper"), ("sim", "sampled"), ("host", "paper"))
    ]
    cells += [grid.Scenario("sim", "paper", "int32", "random", PAPER_GRID_SIZES[0], d_h) for d_h in (2, 3)]
    largest = (0, None)
    merges_at_largest = 0

    def progress(r):
        nonlocal last, largest, merges_at_largest
        now = launch_counts()
        got = {k: now[k] - last[k] for k in now if now[k] != last[k]}
        last = now
        if r.scenario.n == PAPER_GRID_SIZES[-1]:
            merges_at_largest += got.get("merge_tiles", 0)
        P = OHHCTopology(r.scenario.d_h, r.scenario.variant).total_procs
        dense = P * r.capacity * 4 if r.path == "sim" and r.capacity else 0
        largest = max(largest, (dense, r.scenario_id))
        print(f"paper {r.scenario_id}: {r.status}{' ' + r.detail if r.detail else ''}, {r.elapsed_s:.3f} s, path={r.path} "
              f"capacity={r.capacity} retries={r.retries} dense buffer {dense / 2**20:.1f} MiB; launches {got}")

    reset_launches()
    last = launch_counts()
    t0 = time.perf_counter()
    results = differential.run_grid(cells, progress=progress, engines=differential.EngineCache())
    fails = [f"{r.scenario_id}: {r.detail}" for r in results if r.status != "pass"]
    mismatches = cross_check(results)
    del results
    eng = SortEngine(host_threshold=1 << 25)  # 4,194,304 keys stay on the kernels
    x = make_array("random", PAPER_GRID_SIZES[0], seed=7)
    props = metamorphic_checks(eng, x, subject=f"int32/random/n{x.size}") + fault_replay_for_engine_run(eng, x)
    if eng.last_report["plan"].path != "sim":
        fail(f"the paper-scale property run left the kernels: {eng.last_report['plan']}")
    bad = [f"{p.check}[{p.subject}]: {p.detail}" for p in props if p.status != "pass"]
    counts = launch_counts()
    print(f"paper scale: {len(cells)} rows, {len(mismatches)} cross-check mismatches, "
          f"{len(props) - len(bad)}/{len(props)} property checks pass, {time.perf_counter() - t0:.1f} s; "
          f"largest dense buffer {largest[0] / 2**30:.3f} GiB ({largest[1]}); launches {counts}")
    if fails or mismatches or bad:
        fail(f"paper scale: failing rows {fails}, mismatches {mismatches}, properties {bad}")
    if not merges_at_largest:
        fail(f"no sim row of {PAPER_GRID_SIZES[-1]} keys reached the tile merge")
    return counts


def conformance() -> dict:
    t0 = time.perf_counter()
    total = collections.Counter()
    report, counts = verify_cli_run("smoke")
    if report["scenario_count"] != 438 or report["drift"] is None or not report["drift"]["clean"]:
        fail(f"the smoke run held {report['scenario_count']} cells or was not gated clean: {report['drift']}")
    total.update(counts)
    # the impossible fault classes take the host fallback and launch nothing
    cells = [c for c in grid.fault_grid() if c.fault in grid.FAULT_IMPOSSIBLE]
    reset_launches()
    results = differential.run_fault_grid(cells, engines=differential.EngineCache())
    if any(r.status != "pass" or r.path != "host" for r in results) or sum(launch_counts().values()):
        fail(f"an impossible fault cell failed, left the host or launched a kernel: {launch_counts()}")
    print(f"verify: {len(cells)} fault cells of {grid.FAULT_IMPOSSIBLE} on the host fallback, no launch")
    report, counts = verify_cli_run("full", "--skip-properties")
    if report["scenario_count"] != 1560 + 66 + 30 + 90:
        fail(f"the full run held {report['scenario_count']} cells")
    wide = [sid for sid, rec in report["baseline"]["scenarios"].items()
            if sid.startswith("sim/") and "/int64/" in sid and rec["path"] == "sim"]
    if len(wide) != 130:
        fail(f"{len(wide)} int64 sim cells ran on the sim path, not 130")
    total.update(counts)
    total.update(paper_scale_grid())
    for name in PHASE8_KERNELS:
        if not total[name]:
            fail(f"{name} never launched in phase 8")
    print(f"phase 8 (conformance): {time.perf_counter() - t0:.1f} s; launches {dict(total)}")
    return dict(total)


# ----------------------------------------------------------------- phase 12
# The reference CLI's --warmup 2 and 5 repeats for every suite; the
# paper-scale case at warmup 1 and 3 repeats (each call 15.7M keys).
PERF_WARMUP, PERF_REPEATS = 2, 5
PAPER_CASE_WARMUP, PAPER_CASE_REPEATS = 1, 3
PERF_SUITE_KERNELS = ("bucket_count_rank", "sort_tile", "batched_row_sort", "sort_pairs_tile_tagged")
UNCALLED_KERNELS = ("batched_row_sort_pairs", "sort_pairs_tile")  # K6, K7: no caller in either package
CALIBRATED_PCT_MAX, SHEET_PCT_MAX = 105.0, 100.0


def perf_line(rec) -> None:
    pct = "-" if rec.pct_of_roofline is None else f"{rec.pct_of_roofline:.6g} %"
    print(f"  {rec.case_id}: median {rec.median_s * 1e3:.4f} ms, iqr {rec.iqr_s * 1e3:.4f} ms, "
          f"norm_ratio {rec.norm_ratio:.6g}, pct_of_roofline {pct}", flush=True)


def roofline_checks(records) -> None:
    """No call beats the card's peaks: a normalised case above 105 % of the
    calibrated roofline, or above 100 % of the data sheet's, is a
    measurement fault (a sample that ended before the card did, or a
    calibration that read L2)."""
    for rec in records:
        if not (math.isfinite(rec.median_s) and rec.median_s > 0):
            fail(f"perf case {rec.case_id}: raw_s {rec.median_s}")
        if not rec.normalized:
            continue
        sheet = perf.normalize(rec.median_s, rec.workload, H100)["pct_of_roofline"]
        if not rec.pct_of_roofline <= CALIBRATED_PCT_MAX or not sheet <= SHEET_PCT_MAX:
            fail(f"perf case {rec.case_id}: {rec.pct_of_roofline} % of the calibrated roofline, "
                 f"{sheet} % of the data sheet's")


def paper_case(hw):
    """The paper's largest array through ``run_case``: ``SortEngine.sort``
    of 15,728,640 random int32 keys at phase 3's ``host_threshold`` (at
    the default 2^20 it would take the host path and launch nothing),
    checked against ``np.sort`` outside the clock."""
    state = {}

    def setup():
        eng = SortEngine(host_threshold=1 << 25, device=DEV.type)
        x = make_array("random", PAPER_MAX_KEYS, seed=PAPER_MAX_KEYS)
        state.update(eng=eng, x=x)
        eng.sort(x)
        return lambda: eng.sort(x)

    case = perf.PerfCase(
        suite="engine", key=f"sort/random/{PAPER_MAX_KEYS}/int32", setup=setup,
        workload=perf_suites._sort_workload(PAPER_MAX_KEYS, 4),
    )
    rec = perf.run_case(case, hw=hw, warmup=PAPER_CASE_WARMUP, repeats=PAPER_CASE_REPEATS, device=DEV.type)
    counts = launch_counts()
    eng, x = state["eng"], state["x"]
    if eng.last_report["plan"].path != "sim":
        fail(f"the paper-scale perf case left the kernels: {eng.last_report['plan']}")
    if not np.array_equal(eng.sort(x), np.sort(x)):
        fail("the paper-scale perf case differs from np.sort")
    perf_line(rec)
    roofline_checks([rec])
    return rec, counts


def verdict_lines(verdicts) -> None:
    for v in verdicts:
        rel = "-" if v.rel is None else f"{v.rel:.4f}x"
        print(f"    {v.status:7s} {v.case_id}: {rel} {v.detail}")


def perf_gate() -> dict:
    """Phase 12: the port's perf gate (``repro_torch.perf``) whole on the
    card; runs after phase 8, before the model phases.  Returns the
    launches of (a) and (b)."""
    t0 = time.perf_counter()
    dev = DEV.type
    hw = perf.host_hw(dev)
    label = perf_cli.hw_label(hw, dev)
    print(f"perf gate on {label}: calibrated {hw.name}: copy {hw.hbm_bw:.6g} B/s, float32 GEMM "
          f"{hw.peak_bf16_flops:.6g} FLOP/s; data sheet ({H100.name}): HBM {H100.hbm_bw:.6g} B/s, "
          f"float32 {PEAK_OPS_S:.6g}, bf16 {H100.peak_bf16_flops:.6g} FLOP/s")

    # (a) every suite at full scope
    reset_launches()
    records = {}
    for suite in perf_suites.SUITE_NAMES:
        ts = time.perf_counter()
        records[suite] = perf.run_suite(suite, smoke=False, hw=hw, warmup=PERF_WARMUP, repeats=PERF_REPEATS,
                                        progress=perf_line, device=dev)
        roofline_checks(records[suite])
        print(f"  suite {suite}: {len(records[suite])} cases, {time.perf_counter() - ts:.1f} s")
    suite_counts = launch_counts()
    print(f"perf gate (a): {sum(map(len, records.values()))} cases in {len(records)} suites; launches {suite_counts}")

    # (b) the paper's largest array
    reset_launches()
    _, paper_counts = paper_case(hw)
    print(f"perf gate (b): launches {paper_counts}")

    # (c) the gate end to end: (a) recorded, a second run of two suites
    # judged against it by the CLI; (a) against the committed baselines
    with tempfile.TemporaryDirectory() as tmp:
        for suite, recs in records.items():
            doc = perf.build_baseline(recs, suite=suite, hw_name=label)
            perf.save_baseline(doc, perf.baseline_path(suite, tmp))
        report = Path(tmp) / "report.json"
        reset_launches()
        rc = perf_cli.main(["--full", "--suite", "engine", "--suite", "kernels", "--device", dev,
                            "--baseline-dir", tmp, "--slack", "2", "--report", str(report), "-q"])
        gate_counts = launch_counts()
        rep = json.loads(report.read_text())
    print(f"perf gate (c): the CLI re-ran engine and kernels against (a) with --slack 2: exit {rc}, "
          f"{rep['totals']}; launches {gate_counts}")
    structural = []
    for suite, body in rep["suites"].items():
        verdicts = [perf.CaseVerdict(**v) for v in body["verdicts"]]
        verdict_lines(verdicts)
        structural += [v.case_id for v in verdicts if v.status in ("new", "missing")]
    for suite, recs in records.items():
        path = perf.baseline_path(suite, perf_cli.DEFAULT_BASELINE_DIR)
        if not path.exists():
            fail(f"no committed port baseline {path}")
        verdicts = perf.judge(recs, perf.load_baseline(path))
        print(f"  (a) against the committed {path.name}: {perf.summarize(verdicts)} (timing printed, not gated)")
        verdict_lines([v for v in verdicts if v.status != "pass"])
        structural += [v.case_id for v in verdicts if v.status in ("new", "missing")]
    if structural:
        fail(f"perf cases new to or missing from a baseline: {structural}")

    # (d) kernel launches
    for name in PERF_SUITE_KERNELS:
        if not suite_counts[name]:
            fail(f"{name} never launched in the perf suites")
    if not paper_counts["merge_tiles"]:
        fail("merge_tiles never launched in the paper-scale perf case")
    for name in UNCALLED_KERNELS:
        if suite_counts[name] or paper_counts[name] or gate_counts[name]:
            fail(f"{name} launched in phase 12")
    total = collections.Counter(suite_counts)
    total.update(paper_counts)
    print(f"phase 12 (perf gate): {time.perf_counter() - t0:.1f} s; launches over (a) and (b) {dict(total)}; "
          f"card {label}")
    return dict(total)


# ----------------------------------------------------------------- phase 9
SERVE_ARCH = "deepseek-v2-lite-16b"
SERVE_BATCHES = (4, 16)  # requests a generate
SERVE_NEW_TOKENS, SERVE_MAX_LEN = 16, 256  # the reference launcher's
PHASE9_FIRST: dict = {}  # the first batch's tokens and logits, which phase 16 (a) is held to


def sync_timed(fn, sink: list):
    """``fn`` with its milliseconds, synchronised with the card on both
    sides, appended to ``sink``."""
    def wrapper(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def peak_of(fn, sink: list):
    """``fn`` with the card's peak allocation reset before each call and
    its max allocated during the call appended to ``sink``."""
    def wrapper(*args):
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        sink.append(torch.cuda.max_memory_allocated())
        return out
    return wrapper


def logits_kept(fn, sink: list, on: list):
    """``fn`` (an engine's prefill or decode) with each call's logits
    appended to ``sink`` as float32 on the host while ``on[0]``."""
    def wrapper(*args):
        out = fn(*args)
        if on[0]:
            sink.append(out[0].float().cpu())
        return out
    return wrapper


def serve_batch(cfg, params, reqs: list, read_ms: float, card: str, parts: "list | None" = None,
                keep: "dict | None" = None) -> dict:
    """Two ``generate`` runs of ``reqs`` (cold, then warm), each held to
    ``max_new_tokens`` tokens a request, L·N launches of K1 (one an MoE
    layer a forward; none without MoE) and one of K5; the same tokens
    both times; then one more under the profiler for the card's busy
    share.  Returns the launches of the two runs.  With ``parts`` (a
    list), the peak is reset before every prefill and decode call, and the
    warm run's prefill and decode (batch, prompt length, ms, max
    allocated) are appended to it.  With ``keep`` (a dict), the cold run's
    tokens and every forward's logits go into it (phases 16 (a) and 17 (a))."""
    R, N = len(reqs), SERVE_NEW_TOKENS
    eng = ServeEngine(cfg, params, registry.get_model_api(cfg), max_len=SERVE_MAX_LEN)
    prefill_ms, decode_ms, prefill_peak, decode_peak = [], [], [], []
    if parts is not None:
        eng._prefill = peak_of(eng._prefill, prefill_peak)
        eng._decode = peak_of(eng._decode, decode_peak)
    kept, keeping = [], [keep is not None]
    eng._prefill, eng._decode = logits_kept(eng._prefill, kept, keeping), logits_kept(eng._decode, kept, keeping)
    eng._prefill = sync_timed(eng._prefill, prefill_ms)
    eng._decode = sync_timed(eng._decode, decode_ms)
    total, outs = collections.Counter(), []
    want = {"sort_pairs_tile_tagged": 1}
    if cfg.is_moe:
        want["bucket_count_rank"] = cfg.num_layers * N
    for run in ("cold", "warm"):
        for sink in (prefill_ms, decode_ms, prefill_peak, decode_peak):
            sink.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        wall = time.perf_counter() - t0
        got = launch_counts()
        if sorted(out) != [r.id for r in reqs] or any(len(out[r.id]) != N for r in reqs):
            fail(f"generate of {R} requests did not give {N} tokens to each")
        if {k: v for k, v in got.items() if v} != want:
            fail(f"generate of {R} requests launched {got}, not {want}")
        total.update(got)
        outs.append(out)
        if keeping[0]:
            keep.update(tokens=out, logits=list(kept))
            keeping[0] = False
        print(f"serve {cfg.name} R={R} N={N} {run} on {card}: prefill {prefill_ms[0]:.3f} ms, decode "
              f"{statistics.median(decode_ms):.3f} ms a step (median of {len(decode_ms)}; min {min(decode_ms):.3f}, "
              f"max {max(decode_ms):.3f}, first {decode_ms[0]:.3f}), wall {wall * 1e3:.1f} ms, "
              f"{R * N / wall:.1f} tokens/s; reading every parameter once at 3.35 TB/s takes {read_ms:.2f} ms; "
              f"launches {dict((k, v) for k, v in got.items() if v)}")
    if outs[0] != outs[1]:
        fail(f"two generate runs of the same {R} requests gave different tokens")
    if parts is not None:
        L = max(len(r.prompt) for r in reqs)
        parts.append({"kind": "prefill", "R": R, "L": L, "ms": prefill_ms[0], "peak": max(prefill_peak)})
        parts.append({"kind": "decode", "R": R, "L": L, "ms": statistics.median(decode_ms), "peak": max(decode_peak)})
        print(f"  warm run, each part's max allocated (the peak reset before it): prefill {max(prefill_peak) / 2**30:.2f} "
              f"GiB, decode {max(decode_peak) / 2**30:.2f} GiB")
    busy_share(f"{cfg.name} generate R={R} N={N} on {card}", lambda: eng.generate(reqs))
    lens = [len(r.prompt) for r in reqs]
    order = [r.id for r in eng.order_by_length(reqs)]
    if order != [int(i) for i in np.argsort(lens, kind="stable")]:
        fail(f"order_by_length of {lens} gave {order}, not the stable argsort")
    print(f"  (d) order_by_length of {R} requests equals np.argsort(lens, kind='stable'); "
          f"first tokens of request 0: {outs[0][0][:8]}")
    return total


def plain_count_rank(ids, num_buckets):
    return partition_kernel.bucket_count_rank_plain(ids, num_buckets)


def moe_dispatch_checks(cfg, params, reqs: list) -> None:
    """(a) layer 0's ``apply_moe`` with K1 and with its plain version, and
    (b) the ``sorted`` and ``argsort`` dispatches, on the prefill and
    decode hidden states of ``reqs`` at the served config: bit for bit."""
    blk = layer(params["blocks"], 0)
    eng = ServeEngine(cfg, params, registry.get_model_api(cfg), max_len=SERVE_MAX_LEN)
    toks, _ = eng._pad_batch(reqs)
    argsort = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="argsort"))
    with torch.inference_mode():
        for what, t in (("prefill", toks), ("decode", toks[:, -1:])):
            h = layers.apply_norm(blk["ln2"], layers.embed_tokens(params["embedding"], t, cfg, NO_SHARD), cfg)
            y_k1, _ = moe.apply_moe(blk["moe"], h, cfg, NO_SHARD)
            kernel = moe.ops.bucket_count_rank
            moe.ops.bucket_count_rank = plain_count_rank
            try:
                y_plain, _ = moe.apply_moe(blk["moe"], h, cfg, NO_SHARD)
            finally:
                moe.ops.bucket_count_rank = kernel
            y_argsort, _ = moe.apply_moe(blk["moe"], h, argsort, NO_SHARD)
            if not torch.equal(y_k1, y_plain):
                fail(f"(a) apply_moe at {what} ({tuple(h.shape)}): K1 and its plain version differ")
            if not torch.equal(y_k1, y_argsort):
                fail(f"(b) apply_moe at {what} ({tuple(h.shape)}): the sorted and argsort dispatches differ")
            A = h.shape[0] * h.shape[1] * cfg.moe.num_experts_per_tok
            print(f"  (a), (b) apply_moe layer 0 at {what} {tuple(h.shape)}: {A} assignments over "
                  f"{cfg.moe.num_experts} experts, capacity {moe.capacity(A, cfg)}: K1, its plain version and "
                  f"the argsort dispatch give equal outputs bit for bit")


def serve_consistency(cfg, params, S: int = 24, extras=None) -> None:
    """(c) the reference's serve-consistency test at full width: float32
    compute (no TF32) and, with MoE, capacity factor 64, so no token drops
    at any T; prefill on S - 2 tokens and two decode steps against
    ``forward``.  ``extras(B, S)`` gives the family's other inputs
    (encoder frames; vision embeddings and their (3, B, S) positions)."""
    f32 = cfg.replace(dtype=torch.float32, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    api = registry.get_model_api(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        B = 2
        gen = np.random.default_rng(1)
        toks = torch.from_numpy(gen.integers(0, cfg.vocab_size, (B, S))).to(DEV)
        batch = {"tokens": toks, **(extras(B, S) if extras else {})}
        head = dict(batch, tokens=toks[:, : S - 2])
        if "positions_thw" in batch:
            head["positions_thw"] = batch["positions_thw"][:, :, : S - 2]
        with torch.inference_mode():
            logits, _ = api.forward(params, batch, f32)
            cache = api.init_cache(f32, B, S + 4, device=DEV)
            last, cache = api.prefill(params, head, f32, NO_SHARD, cache)
            errs = [float((last - logits[:, S - 3]).abs().max())]
            for pos in (S - 2, S - 1):
                lg, cache = api.decode_step(params, toks[:, pos : pos + 1], f32, NO_SHARD, cache, pos)
                errs.append(float((lg - logits[:, pos]).abs().max()))
            del logits, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not all(math.isfinite(e) for e in errs) or max(errs) >= 2e-2:
        fail(f"(c) {cfg.name}: prefill + decode against forward at full width: errors {errs}, limit 2e-2")
    print(f"  (c) {cfg.name}: float32 prefill of {S - 2} tokens + 2 decode steps against forward, B={B} S={S}"
          f"{' with ' + ', '.join(k for k in batch if k != 'tokens') if len(batch) > 1 else ''}: max abs error "
          f"{max(errs):.3e} (prefill {errs[0]:.3e}, decode {errs[1]:.3e}, {errs[2]:.3e}), limit 2e-2")


def moe_count_rank_times(cfg, batches: list) -> None:
    """K1 at the MoE dispatch's shapes (A = 6·T ids over 64 experts, T the
    prefill or decode tokens of a batch) against its plain version and
    ``torch.bincount`` plus a stable ``torch.sort``."""
    gen = np.random.default_rng(9)
    E = cfg.moe.num_experts
    for T in sorted({t for R, L in batches for t in (R * L, R)}):
        A = T * cfg.moe.num_experts_per_tok
        ids = torch.from_numpy(gen.integers(0, E, A).astype(np.int32)).to(DEV)
        kernel = cuda_ms(lambda: partition_kernel.bucket_count_rank(ids, E), reps=21)
        plain = cuda_ms(lambda: partition_kernel.bucket_count_rank_plain(ids, E), reps=5)
        library = cuda_ms(lambda: (torch.bincount(ids, minlength=E), torch.sort(ids, stable=True)), reps=21)
        b, by = bound(4 * A + 4 * E + 4 * A, 2 * A)
        print(f"kernel bucket_count_rank at the MoE dispatch, T={T} tokens, A={A} ids, B={E}: {kernel:.4f} ms "
              f"by events, plain {plain:.4f} ms, torch.bincount + stable torch.sort {library:.4f} ms, "
              f"bound {b:.2e} ms ({by})")


def build_model(arch: str, phase: int):
    """``arch`` at full width, its float32 weights made on the card from a
    seeded generator; fails unless its counted weights are
    ``cfg.param_count()``, plus the hybrid shared block's ``wq``, which
    the reference's count leaves out.  Returns (cfg, params, ms to read
    every weight once at the peak rate)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config(arch)
    t = time.perf_counter()
    params = registry.get_model_api(cfg).init(cfg, torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    built = time.perf_counter() - t
    leaves = tree_leaves(params)
    n, nbytes = lm.counted_params(params), sum(x.numel() * x.element_size() for x in leaves)
    shared_wq = cfg.d_model * cfg.num_heads * cfg.resolved_head_dim if cfg.is_hybrid else 0
    if n != cfg.param_count() + shared_wq:
        fail(f"{arch}: {n} counted parameters, the tree's layout gives {cfg.param_count() + shared_wq}")
    gap = (f" + {shared_wq:,} (the shared block's wq, which the reference's param_count() leaves out)"
           if shared_wq else "")
    print(f"phase {phase} model {arch} ({cfg.family}): {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}; {n:,} counted parameters = cfg.param_count() {cfg.param_count():,}{gap}; "
          f"{sum(x.numel() for x in leaves):,} with every leaf, {nbytes / 2**30:.2f} GiB of float32 weights made on "
          f"the card in {built:.2f} s; max allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return cfg, params, nbytes / PEAK_BYTES_S * 1e3


def model_serving() -> dict:
    """Phase 9: DeepSeek-V2-Lite-16B at full width on the card, served by
    ``ServeEngine`` over the port's model layer."""
    t0 = time.perf_counter()
    cfg, params, read_ms = build_model(SERVE_ARCH, 9)
    print(f"  {cfg.num_heads} heads, MLA rank {cfg.mla.kv_lora_rank}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.num_experts_per_tok} + {cfg.moe.num_shared_experts} shared")
    total = collections.Counter()
    batches = []
    for R in SERVE_BATCHES:
        reqs = synthetic_requests(R, cfg.vocab_size, SERVE_NEW_TOKENS)
        keep = PHASE9_FIRST if R == SERVE_BATCHES[0] else None
        total.update(serve_batch(cfg, params, reqs, read_ms, smi(), keep=keep))
        batches.append((R, max(len(r.prompt) for r in reqs)))
    print(f"  max allocated while serving {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    moe_dispatch_checks(cfg, params, synthetic_requests(SERVE_BATCHES[-1], cfg.vocab_size, SERVE_NEW_TOKENS))
    serve_consistency(cfg, params)
    moe_count_rank_times(cfg, batches)
    del params
    torch.cuda.empty_cache()
    print(f"phase 9 (model serving): {time.perf_counter() - t0:.1f} s; launches {dict(total)}")
    return dict(total)


# ---------------------------------------------------------------- phase 10
# Zamba2 first (served at 4 and 16 requests), then one arch of each other
# family (4 requests); (c) runs past two 256-position SSD chunks.
FAMILY_ARCHS = ("zamba2-2.7b", "mamba2-370m", "whisper-tiny", "qwen2-vl-7b")
SSM_CHECK_LEN = 602  # 2 x 256 + 90: the inter-chunk recurrence and a padded tail
VLM_CHECK_LEN, VLM_GRID = 1100, 32  # 1,024 vision tokens on a 32 x 32 patch grid, then text
LEAK_BYTES = 64 << 20  # what a freed model may leave allocated on the card
PHASE10_FIRST: dict = {}  # Zamba2's first batch's tokens and logits, which phase 17 (a) is held to
PHASE10_KEPT: dict = {}  # the same of whisper-tiny and qwen2-vl-7b, by arch, which phase 18 (a) is held to


def allocated_back(base: int, label: str, phase: int = 10) -> None:
    """Fail unless the card's allocated memory is back within
    ``LEAK_BYTES`` of ``base``."""
    gc.collect()
    torch.cuda.empty_cache()
    now = torch.cuda.memory_allocated()
    print(f"  allocated after {label}: {now / 2**20:.1f} MiB (phase {phase} started at {base / 2**20:.1f} MiB)")
    if now - base > LEAK_BYTES:
        fail(f"{label}: {(now - base) / 2**20:.1f} MiB still allocated on the card")


def family_inputs(cfg):
    """``extras(B, S)`` for check (c): random encoder frames (encdec);
    random vision embeddings over the first ``vision_tokens`` positions
    with t = 0 and (h, w) on a ``VLM_GRID``-wide patch grid, then text
    positions equal on all three axes, which decode's broadcast position
    continues (vlm)."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    if cfg.family == "encdec":
        return lambda B, S: {"enc_frames": torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=gen, device=DEV)}
    if cfg.family == "vlm":
        def extras(B, S):
            V = cfg.vision_tokens
            thw = torch.arange(S, device=DEV).repeat(3, B, 1)
            idx = torch.arange(V, device=DEV)
            thw[0, :, :V], thw[1, :, :V], thw[2, :, :V] = 0, idx // VLM_GRID, idx % VLM_GRID
            ve = torch.randn((B, V, cfg.d_model), generator=gen, device=DEV) * cfg.d_model ** -0.5
            return {"vision_embeds": ve, "positions_thw": thw.to(torch.int32)}
        return extras
    return None


def ssd_check(cfg, params) -> None:
    """(e) layer 0's SSD at full width over 600 positions from a random
    state (random x, B and C, dt = softplus(normal + dt_bias), the layer's
    A), chunked against the decode update applied position by position,
    float32 with no TF32: within 1e-3 of the largest magnitude."""
    blk = layer(params["blocks"]["mamba"], 0)
    nh, hd, ng, ds = cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.n_groups, cfg.ssm.d_state
    B, S = 2, 600
    gen = torch.Generator(device=DEV).manual_seed(3)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=DEV)  # noqa: E731
    x, B_, C, st0 = rand(B, S, nh, hd), rand(B, S, ng, ds), rand(B, S, ng, ds), rand(B, nh, hd, ds)
    dt = torch.nn.functional.softplus(rand(B, S, nh) + blk["dt_bias"].float())
    A = -torch.exp(blk["A_log"].float())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            y, final = ssm.ssd_chunked(x, dt, A, B_, C, cfg, init_state=st0)
            st, ys = st0, []
            for t in range(S):
                yt, st = ssm.ssd_step(st, x[:, t], dt[:, t], A, B_[:, t].repeat_interleave(nh // ng, 1),
                                      C[:, t].repeat_interleave(nh // ng, 1))
                ys.append(yt)
            y_seq = torch.stack(ys, 1)
            chunked_ms = cuda_ms(lambda: ssm.ssd_chunked(x, dt, A, B_, C, cfg, init_state=st0), reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rel_y = float((y - y_seq).abs().max() / y_seq.abs().max())
    rel_s = float((final - st).abs().max() / st.abs().max())
    if not (rel_y <= 1e-3 and rel_s <= 1e-3):
        fail(f"(e) {cfg.name}: ssd_chunked against the sequential update: relative errors {rel_y}, {rel_s}, limit 1e-3")
    print(f"  (e) {cfg.name}: ssd_chunked (B={B}, S={S}, {nh} heads of {hd}, d_state {ds}, chunks of "
          f"{cfg.ssm.chunk_size}) against {S} decode updates: relative error outputs {rel_y:.3e}, final state "
          f"{rel_s:.3e}, limit 1e-3; ssd_chunked {chunked_ms:.3f} ms by events")


def serve_family(arch: str, card: str, parts: "list | None" = None) -> dict:
    """One arch at full width: built on the card, served, checked; its
    launches.  The caller frees it.  ``parts`` gets each batch's prefill
    and decode measurements (``serve_batch``)."""
    t0 = time.perf_counter()
    cfg, params, read_ms = build_model(arch, 10)
    total = collections.Counter()
    peaks = [torch.cuda.max_memory_allocated()]
    for R in SERVE_BATCHES if arch == FAMILY_ARCHS[0] else SERVE_BATCHES[:1]:
        reqs = synthetic_requests(R, cfg.vocab_size, SERVE_NEW_TOKENS)
        keep = None
        if R == SERVE_BATCHES[0]:
            keep = PHASE10_FIRST if arch == FAMILY_ARCHS[0] else PHASE10_KEPT.setdefault(arch, {})
        total.update(serve_batch(cfg, params, reqs, read_ms, card, parts, keep=keep))
        peaks.append(torch.cuda.max_memory_allocated())
    if parts:
        peaks += [p["peak"] for p in parts]
    print(f"  {arch}: max allocated while serving {max(peaks) / 2**30:.2f} GiB")
    S = {"encdec": 24, "vlm": VLM_CHECK_LEN}.get(cfg.family, SSM_CHECK_LEN)
    serve_consistency(cfg, params, S, family_inputs(cfg))
    if cfg.ssm.d_state:
        ssd_check(cfg, params)
    print(f"  {arch}: {time.perf_counter() - t0:.1f} s; max allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB on {card}")
    del params
    return total


def model_families(parts: list) -> dict:
    """Phase 10: the ssm, hybrid, encdec and vlm families at full width on
    the card, one model at a time.  ``parts`` gets Zamba2's prefill and
    decode measurements, each part's peak alone, for phase 13."""
    t0 = time.perf_counter()
    card = smi()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    if base > 1 << 30:
        fail(f"{base / 2**30:.2f} GiB still allocated after phase 9 freed DeepSeek-V2-Lite")
    print(f"phase 10 starts with {base / 2**20:.1f} MiB allocated on the card (DeepSeek-V2-Lite's 60 GiB freed)")
    total = collections.Counter()
    for arch in FAMILY_ARCHS:
        total.update(serve_family(arch, card, parts if arch == FAMILY_ARCHS[0] else None))
        allocated_back(base, arch)
    print(f"phase 10 (model families): {time.perf_counter() - t0:.1f} s; launches {dict(total)}; card {card}")
    return dict(total)


# ---------------------------------------------------------------- phase 11
TRAIN_ARCH = "deepseek-v2-lite-16b"
# Full width, depth cut from 27 to 4: float32 parameters, gradients and
# AdamW's m and v of all 27 layers take 241.6 GiB.  train_4k's 4,096
# tokens a sequence, its batch cut from 256 to 2.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 4096, 2, 6
TRAIN_MEMORY_LIMIT = 75 << 30  # max allocated past this: cut the batch to 1
BF16_OPS_S = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
RESUME_ARCH = "mamba2-370m"


def train_ops(cfg, tokens: int) -> tuple[float, float]:
    """Matmul operations of one remat train step (forward, backward, and
    the layers' forward again), as (bf16, float32): 2·N·D a forward pass
    over the weights each token uses (the routed experts at the dispatch
    buffer's E·C rows) and 4·N·D for its backward, in bf16; QKᵀ and P·V
    over every (query, key) pair the chunked attention computes (all S² of
    them), on float32 operands."""
    m, a = cfg.moe, cfg.mla
    d, H, L = cfg.d_model, cfg.num_heads, cfg.num_layers
    attn_w = d * H * (a.qk_nope_head_dim + a.qk_rope_head_dim) + d * (a.kv_lora_rank + a.qk_rope_head_dim) \
        + a.kv_lora_rank * H * (a.qk_nope_head_dim + a.v_head_dim) + H * a.v_head_dim * d
    shared = 3 * d * m.shared_d_ff * m.num_shared_experts + d * m.num_experts
    routed_rows = m.num_experts * moe.capacity(tokens * m.num_experts_per_tok, cfg)
    layer = 2 * (attn_w + shared) * tokens + 2 * 3 * d * m.expert_d_ff * routed_rows
    scores = 2 * TRAIN_BATCH * TRAIN_SEQ * TRAIN_SEQ * H * (a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim)
    unembed = 2 * d * cfg.vocab_size * tokens
    return 3 * (L * layer + unembed) + L * layer, 4 * L * scores


def train_main(card: str, measured: dict) -> dict:
    """(a) DeepSeek-V2-Lite at full width, 4 layers, trained 6 steps
    through ``Trainer(device="cuda")``: finite, falling losses, 8 launches
    of K1 a step (4 MoE layers, forward and remat recompute); then one
    more step under the profiler for the card's busy share.  ``measured``
    gets the warm step's median ms and the max allocated."""
    cfg = registry.get_config(TRAIN_ARCH).replace(num_layers=TRAIN_LAYERS)
    full = registry.get_config(TRAIN_ARCH)
    state_gib = 4 * 4 * full.param_count() / 2**30
    print(f"phase 11 (a) reduced: depth {full.num_layers} -> {TRAIN_LAYERS} layers (float32 parameters, gradients, "
          f"m and v of the full depth: {state_gib:.1f} GiB of counted weights alone); batch 256 -> {TRAIN_BATCH} "
          f"(train_4k's {TRAIN_SEQ} tokens a sequence); widths as published")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        run = RunConfig(model=cfg, shape=ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"), warmup_steps=1,
                        total_steps=TRAIN_STEPS, checkpoint_every=0, checkpoint_dir=ckpt)
        tr = Trainer(cfg, run, registry.get_model_api(cfg), device=DEV)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        leaves = tree_leaves(tr.state["params"])
        n = lm.counted_params(tr.state["params"])
        if n != cfg.param_count():
            fail(f"the 4-layer DeepSeek-V2-Lite counts {n} weights, cfg.param_count() {cfg.param_count()}")
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        print(f"  built {n:,} counted weights (cfg.param_count()), {sum(x.numel() for x in leaves):,} in all: "
              f"{nbytes / 2**30:.2f} GiB of float32 weights and {2 * nbytes / 2**30:.2f} GiB of AdamW moments on "
              f"the card in {built:.2f} s; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        reset_launches()
        per_step = []
        for _ in range(TRAIN_STEPS):
            before = launch_counts()["bucket_count_rank"]
            tr.run_steps(1)
            per_step.append(launch_counts()["bucket_count_rank"] - before)
        log = tr.metrics_log
        losses = [m["loss"] for m in log]
        walls = [m["wall_s"] * 1e3 for m in log]
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            fail(f"(a) a training loss is not finite: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"(a) the loss did not fall over {TRAIN_STEPS} steps: {losses}")
        if per_step != [2 * TRAIN_LAYERS] * TRAIN_STEPS:
            fail(f"(a) K1 launched {per_step} times a step, not {2 * TRAIN_LAYERS}")
        if peak > TRAIN_MEMORY_LIMIT:
            fail(f"(a) max allocated {peak / 2**30:.2f} GiB passes {TRAIN_MEMORY_LIMIT / 2**30:.0f} GiB: cut the batch")
        tokens = TRAIN_BATCH * TRAIN_SEQ
        warm = statistics.median(walls[1:])
        measured.update(ms=warm, peak=peak)
        ops16, ops32 = train_ops(cfg, tokens)
        floor_ms = (ops16 / BF16_OPS_S + ops32 / PEAK_OPS_S) * 1e3
        print(f"  (a) {TRAIN_STEPS} steps on {card}: losses {[round(x, 4) for x in losses]}; lr "
              f"{[m['lr'] for m in log]}; grad_norm {[round(m['grad_norm'], 3) for m in log]}; aux "
              f"{[round(m['aux'], 5) for m in log]}")
        print(f"  (a) step ms (host clock, synchronised by .item()): {[round(w, 1) for w in walls]}; warm median "
              f"{warm:.1f} ms, {tokens / warm * 1e3:.0f} tokens/s; max allocated {peak / 2**30:.2f} GiB; K1 launches "
              f"a step {per_step}; matmul operations a step {ops16 / 1e12:.2f} T bf16 + {ops32 / 1e12:.2f} T float32 "
              f"(attention), {floor_ms:.1f} ms at the peaks (989 T/s bf16, 67 T/s float32)")
        busy_share(f"one DeepSeek-V2-Lite train step (4 layers, {TRAIN_BATCH} x {TRAIN_SEQ}) on {card}",
                   lambda: tr.run_steps(1))
        total = launch_counts()
        if total["bucket_count_rank"] != 2 * TRAIN_LAYERS * (TRAIN_STEPS + 1):
            fail(f"(a) K1 launched {total['bucket_count_rank']} times in {TRAIN_STEPS + 1} steps")
        del tr, leaves
    return {k: v for k, v in total.items() if v}


def train_dispatch_twins() -> None:
    """(b), run in a process of its own with ``CUBLAS_WORKSPACE_CONFIG``
    set and deterministic algorithms on: one step's loss and gradients of
    DeepSeek-V2-Lite at full width, 1 layer, with the ``sorted`` dispatch
    (K1) and with ``argsort`` (``torch.sort``), bit for bit."""
    torch.use_deterministic_algorithms(True)
    cfg = registry.get_config(TRAIN_ARCH).replace(num_layers=1)
    run = RunConfig(model=cfg)
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    batch = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEV).next_batch()
    out = {}
    for dispatch in ("sorted", "argsort"):
        c = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
        reset_launches()
        loss, _, aux, grads = make_grad_fn(c, run, lm)(params, batch)
        torch.cuda.synchronize()
        out[dispatch] = loss, aux, grads, launch_counts()["bucket_count_rank"]
    (l1, a1, g1, n1), (l2, a2, g2, n2) = out["sorted"], out["argsort"]
    if (n1, n2) != (2, 0):
        fail(f"(b) K1 launched {n1} times with sorted (want 2: forward and recompute) and {n2} with argsort")
    if not (torch.equal(bits(l1), bits(l2)) and torch.equal(bits(a1), bits(a2))):
        fail(f"(b) the sorted and argsort losses differ: {float(l1)!r} {float(l2)!r}")
    diff = [k for k, (x, y) in enumerate(zip(g1, g2)) if not torch.equal(bits(x), bits(y))]
    if diff:
        fail(f"(b) {len(diff)} of {len(g1)} gradient leaves differ between the sorted and argsort dispatches")
    print(f"  (b) DeepSeek-V2-Lite 1 layer, {TRAIN_BATCH} x {TRAIN_SEQ}: loss {float(l1)!r} and aux {float(a1)!r} "
          f"with sorted (K1, {n1} launches) and argsort, bit for bit; all {len(g1)} gradient leaves bit for bit "
          f"under torch.use_deterministic_algorithms(True)")


def train_dispatch_times(card: str, row: dict) -> None:
    """K1 at the training dispatch's shape (6 · 2 · 4096 = 49,152 ids over
    64 experts) by events and on the device, beside its plain version and
    ``torch.bincount`` + a stable ``torch.sort``; added to K1's row."""
    cfg = registry.get_config(TRAIN_ARCH)
    E, A = cfg.moe.num_experts, cfg.moe.num_experts_per_tok * TRAIN_BATCH * TRAIN_SEQ
    gen = np.random.default_rng(11)
    ids = torch.from_numpy(gen.integers(0, E, A).astype(np.int32)).to(DEV)
    kc, kr = partition_kernel.bucket_count_rank(ids, E)
    pc, pr = partition_kernel.bucket_count_rank_plain(ids, E)
    err = max(same(kc, pc, "bucket_count_rank counts at the training shape"),
              same(kr, pr, "bucket_count_rank ranks at the training shape"))
    ms = cuda_ms(lambda: partition_kernel.bucket_count_rank(ids, E), reps=21)
    dev_ms, launches = bcr_profile(lambda: partition_kernel.bucket_count_rank(ids, E))
    plain = cuda_ms(lambda: partition_kernel.bucket_count_rank_plain(ids, E), reps=5)
    library = cuda_ms(lambda: (torch.bincount(ids, minlength=E), torch.sort(ids, stable=True)), reps=21)
    b, by = bound(4 * A + 4 * E + 4 * A, 2 * A)
    row.update(train_shape=f"{A} ids, B={E}", train_ms=ms, train_device_ms=dev_ms, train_plain_ms=plain,
               train_library_ms=library, train_bound_ms=b, train_max_abs_err=err)
    print(f"kernel bucket_count_rank at the training dispatch, A={A} ids, B={E}, on {card}: {ms:.4f} ms by events, "
          f"device {dev_ms} ms ({launches} kernel launches), plain {plain:.4f} ms, torch.bincount + stable "
          f"torch.sort {library:.4f} ms, bound {b:.2e} ms ({by}); equal to the plain version")


def train_launcher() -> None:
    """(c) ``python -m repro_torch.launch.train --arch mamba2-370m --steps 3``
    at full width and depth on the card, in a process of its own."""
    with tempfile.TemporaryDirectory() as ckpt:
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", RESUME_ARCH, "--steps", "3",
               "--ckpt-dir", ckpt]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"(c) {' '.join(cmd[1:7])} exited {r.returncode}: {r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    m = re.match(r"loss: (\S+) -> (\S+);", lines[-1]) if lines else None
    if not m or not all(math.isfinite(float(x)) for x in m.groups()):
        fail(f"(c) the launcher printed no finite loss: {r.stdout[-2000:]}")
    print(f"  (c) python -m repro_torch.launch.train --arch {RESUME_ARCH} --steps 3, "
          f"{time.perf_counter() - t0:.1f} s with the process's start: {' | '.join(lines[-2:])}")


def train_resume(card: str) -> None:
    """(d) mamba2-370m at full width trained 3 steps with a checkpoint
    every 2 (synchronous saves); a second ``Trainer`` on the directory
    resumes at step 2 with the data at step 2, and its step-2 loss equals
    the first trainer's bit for bit."""
    cfg = registry.get_config(RESUME_ARCH)
    api = registry.get_model_api(cfg)
    with tempfile.TemporaryDirectory() as ckpt:
        run = RunConfig(model=cfg, shape=ShapeConfig("cli", 128, 8, "train"), warmup_steps=1, total_steps=3,
                        checkpoint_every=2, checkpoint_dir=ckpt)
        tr = Trainer(cfg, run, api, device=DEV, sync_checkpoints=True)
        want = [m["loss"] for m in tr.run_steps(3)]
        saved = tr.ckpt.steps()
        del tr
        t0 = time.perf_counter()
        tr = Trainer(cfg, run, api, device=DEV)
        resumed = time.perf_counter() - t0
        step, data_step = int(tr.state["step"]), tr.data.step
        got = tr.run_steps(1)[0]["loss"]
        del tr
    if saved != [2] or (step, data_step) != (2, 2):
        fail(f"(d) checkpoints {saved}; resumed at step {step} with the data at {data_step}, not 2 and 2")
    if got != want[2]:
        fail(f"(d) the resumed step-2 loss {got!r} differs from the first trainer's {want[2]!r}")
    print(f"  (d) {RESUME_ARCH} 8 x 128 on {card}: losses {want}; resumed from step_2 in {resumed:.2f} s (init and "
          f"restore) at step 2, data step 2; its step-2 loss {got!r} equals the first run's bit for bit")


def model_training(rows: dict, measured: dict) -> dict:
    """Phase 11: training on the card: (a) DeepSeek-V2-Lite at full width
    through K1's dispatch, (b) the dispatch's K1 and argsort twins bit for
    bit (a process of its own) and K1 timed at the training shape, (c) the
    training launcher, (d) resume from a checkpoint.  ``measured`` gets
    (a)'s step ms and max allocated, for phase 13."""
    t0 = time.perf_counter()
    card = smi()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    if base > 1 << 30:
        fail(f"{base / 2**30:.2f} GiB still allocated after phase 10 freed its models")
    print(f"phase 11 starts with {base / 2**20:.1f} MiB allocated on the card")
    counts = train_main(card, measured)
    allocated_back(base, "(a) DeepSeek-V2-Lite training", 11)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.train_dispatch_twins()"], env=env,
                       cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    print(r.stdout.strip())
    if r.returncode != 0:
        fail(f"(b) the sorted/argsort training twins failed (exit {r.returncode}): {r.stderr[-3000:]}")
    train_dispatch_times(card, rows["bucket_count_rank"])
    train_launcher()
    train_resume(card)
    allocated_back(base, "(d) mamba2-370m resume", 11)
    print(f"phase 11 (model training): {time.perf_counter() - t0:.1f} s; launches {counts}; card {card}")
    return counts


# ---------------------------------------------------------------- phase 13
DRYRUN_MEMORY_TOLERANCE = 0.25  # predicted per-device total against max allocated
ZAMBA_ARCH = FAMILY_ARCHS[0]
DRYRUN_CLI = (
    ("--arch", TRAIN_ARCH, "--mesh", "both"),
    ("--arch", ZAMBA_ARCH, "--shape", "long_500k", "--mesh", "single"),
)


def predicted_against_measured(label: str, rec: dict, peak: int, ms: float, card: str) -> dict:
    """One prediction beside its run: fails when the predicted per-device
    total misses the measured max allocated by more than the tolerance, or
    when the predicted bound exceeds the measured time."""
    mem, roof = rec["memory_analysis"], rec["roofline"]
    total, bound_ms = mem["total_bytes"], roof["bound_time_s"] * 1e3
    off = total / peak - 1.0
    print(f"  (a) {label} on {card}: predicted {total / 2**30:.2f} GiB a device (arguments "
          f"{mem['argument_bytes'] / 2**30:.2f}, outputs {mem['output_bytes'] / 2**30:.2f}, temp "
          f"{mem['temp_bytes'] / 2**30:.2f}, aliased {mem['alias_bytes'] / 2**30:.2f}) against {peak / 2**30:.2f} GiB "
          f"max allocated ({100 * off:+.1f} %); bound {bound_ms:.3f} ms ({roof['dominant']}: compute "
          f"{roof['t_compute_s'] * 1e3:.3f}, memory {roof['t_memory_s'] * 1e3:.3f} ms) against {ms:.3f} ms measured, "
          f"roofline fraction {bound_ms / ms:.3f}; traced in {rec['compile_s']} s")
    if abs(off) > DRYRUN_MEMORY_TOLERANCE:
        fail(f"(a) {label}: predicted {total} bytes a device, measured max allocated {peak}: "
             f"{100 * off:+.1f} % past {100 * DRYRUN_MEMORY_TOLERANCE:.0f} %")
    if bound_ms > ms:
        fail(f"(a) {label}: the predicted bound {bound_ms:.3f} ms exceeds the measured {ms:.3f} ms")
    return {"label": label, "predicted_bytes": total, "measured_bytes": peak, "bound_ms": bound_ms, "ms": ms}


def dry_run_cli(out: str):
    """(b) the dry-run CLI for DeepSeek-V2-Lite on both meshes and Zamba2's
    long_500k on one, in two processes started at once; the caller goes on
    and ``dry_run_cli_done`` collects them."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    return [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", out], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for args in DRYRUN_CLI]


def dry_run_cli_done(procs: list, out: str, t0: float) -> None:
    """(b) the CLI's processes ended well, with no launch and no
    ``.FAIL``; then the report and the section generator over the cells."""
    n_ok = 0
    for args, proc in zip(DRYRUN_CLI, procs):
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"(b) dryrun {' '.join(args)} exited {proc.returncode}: {stdout[-2000:]} {stderr[-2000:]}")
        launched = re.search(r"kernel launches: (\{.*\})", stdout)
        if not launched or any(json.loads(launched.group(1)).values()):
            fail(f"(b) dryrun {' '.join(args)} reported launches: {launched and launched.group(1)}")
        summary = re.search(r"(\d+) ok, 0 failed in \S+ s", stdout)
        if not summary or summary.group(1) == "0":
            fail(f"(b) dryrun {' '.join(args)} ran no cell: {stdout[-2000:]}")
        n_ok += int(summary.group(1))
        print(f"  (b) python -m repro_torch.launch.dryrun {' '.join(args)}: {summary.group(0)}; {launched.group(0)}")
    fails = sorted(f for f in os.listdir(out) if f.endswith(".FAIL"))
    cells = sorted(f for f in os.listdir(out) if f.endswith(".json"))
    if fails or len(cells) != n_ok:
        fail(f"(b) the dry-run wrote {cells} and failed {fails}")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    for mod in ("repro_torch.roofline.report", "repro_torch.roofline.gen_experiments"):
        r = subprocess.run([sys.executable, "-m", mod, "--dir", out], env=env, capture_output=True, text=True,
                           timeout=120)
        if r.returncode != 0 or DRYRUN_CLI[0][1] not in r.stdout:
            fail(f"(b) {mod} exited {r.returncode}: {r.stderr[-2000:]}")
        if mod.endswith("report"):
            table = [ln for ln in r.stdout.splitlines() if ln.startswith("| ")]
    print(f"  (b) {len(cells)} cells, no .FAIL; report and gen_experiments rendered them; "
          f"{time.perf_counter() - t0:.1f} s from the start of the phase")
    print("\n".join("      " + ln for ln in table))


def dry_run_against_the_card(train_measured: dict, zamba_parts: list) -> None:
    """Phase 13: the dry-run's one-card predictions held to phases 11 (a)
    and 10's runs, the CLI over two archs, and no launch by either."""
    t0 = time.perf_counter()
    card = smi()
    before = launch_counts()
    with tempfile.TemporaryDirectory() as out:
        procs = dry_run_cli(out)
        try:
            mesh = make_smoke_mesh()
            print(f"phase 13 (dry-run): the smoke mesh {mesh.shape} {mesh.axis_names} on {card}; the H100 record "
                  f"({H100.name}: {H100.peak_bf16_flops:.3g} FLOP/s bf16, {H100.hbm_bw:.3g} B/s)")
            cfg = registry.get_config(TRAIN_ARCH).replace(num_layers=TRAIN_LAYERS)
            shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
            rec = dryrun.predict(TRAIN_ARCH, cfg, shape, mesh, grad_accum=1, full_trace=True, hw=H100)
            predicted_against_measured(f"{TRAIN_ARCH} {TRAIN_LAYERS} layers train {TRAIN_BATCH} x {TRAIN_SEQ} "
                                       "(phase 11 (a))", rec, train_measured["peak"], train_measured["ms"], card)
            zcfg = registry.get_config(ZAMBA_ARCH)
            for part in zamba_parts:
                shape = ShapeConfig("serve", part["L"], part["R"], part["kind"])
                rec = dryrun.predict(ZAMBA_ARCH, zcfg, shape, mesh, cache_len=SERVE_MAX_LEN, full_trace=True, hw=H100)
                predicted_against_measured(f"{ZAMBA_ARCH} {part['kind']} R={part['R']} L={part['L']} max_len="
                                           f"{SERVE_MAX_LEN} (phase 10)", rec, part["peak"], part["ms"], card)
            dry_run_cli_done(procs, out, t0)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    after = launch_counts()
    if after != before:
        fail(f"(c) kernels launched during the dry-run: {before} -> {after}")
    print(f"  (c) launch counts the same before and after (a) and (b): {after}")
    print(f"phase 13 (dry-run): {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- phase 14
DIST_METHODS = ("paper", "sample", "valiant", "hier")
DIST_KERNELS = ("bucket_count_rank", "sort_tile", "merge_tiles")
DIST_RANKS = 4  # ranks sharing the one card over gloo
DIST_CASES = (("random", (DIST_RANKS,)), ("sorted", (DIST_RANKS,)), ("dupes", (DIST_RANKS,)), ("random", (2, 2)))
# phase 14 (c): the reference's pipeline test shape, and one (256, 1024)
# float32 block a rank for the reductions
PIPE_L, PIPE_M, PIPE_MB, PIPE_D = 8, 6, 2, 16
PSUM_SHAPE = (256, 1024)


def dist_launches(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in DIST_KERNELS}


def dist_world_one(mesh, n: int) -> dict:
    """Phase 14 (a), the one rank of an NCCL group: each dist method forced
    at ``n`` random int32 keys on a (1,) mesh, ``hier`` on a (1, 1) one."""
    x = make_array("random", n, seed=21)
    want = np.sort(x)
    flat = SortEngine(mesh=mesh)
    hier = SortEngine(mesh=rt_ranks.make_mesh((1, 1), ("pod", "data"), "cuda"), axis_names=("pod", "data"))
    out = {}
    for method in DIST_METHODS:
        eng = hier if method == "hier" else flat
        plan = SortPlan("dist", method, None, None, "forced")
        eng.sort(x[: 1 << 20], plan=plan)  # warm: the first launches of each shape class
        before = launch_counts()
        t0 = time.perf_counter()
        y = eng.sort(x, plan=plan)
        secs = time.perf_counter() - t0
        out[method] = {"equal": bool(np.array_equal(y, want)), "s": secs, "launches": dist_launches(before),
                       "retries": eng.last_report["overflow_retries"], "cf": eng.last_report["capacity_factor"]}
    return out


def runtime_on_card(mesh, mesh22) -> dict:
    """Phase 14 (c) on one rank: ``int8_psum``, ``hierarchical_psum`` and
    ``pipeline_forward`` on card tensors against the same calls on CPU
    tensors in the same group; the largest differences."""
    rank = torch.distributed.get_rank()
    gen = np.random.default_rng(0)
    blocks = gen.standard_normal((DIST_RANKS, *PSUM_SHAPE)).astype(np.float32)
    w = (gen.standard_normal((PIPE_L, PIPE_D, PIPE_D)) * 0.3).astype(np.float32)
    x = gen.standard_normal((PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32)
    pipe = rt_ranks.make_mesh((DIST_RANKS,), ("pipe",), "cuda")
    mine = torch.from_numpy(blocks[rank])

    def block(p, h):
        return torch.tanh(h @ p["w"])

    calls = {
        "int8_psum": lambda d: int8_psum(mine.to(d), "data", mesh=mesh),
        "hierarchical_psum": lambda d: hierarchical_psum(mine.to(d), fast_axis="data", slow_axis="pod", mesh=mesh22),
        "pipeline_forward": lambda d: pipeline_forward({"w": torch.from_numpy(w).to(d)}, torch.from_numpy(x).to(d),
                                                       block, mesh=pipe),
    }
    out = {}
    for name, call in calls.items():
        card = call(DEV).cpu()
        out[name] = float((card.double() - call(torch.device("cpu")).double()).abs().max())
    return out


def dist_four_ranks(mesh, n: int) -> dict:
    """Phase 14 (b) and (c) on one of the ranks sharing the card over gloo:
    the engine's own planned dist sort of ``n`` keys on each case, with
    this rank's launches, and the synchronised seconds inside, and the
    bytes handed to, the exchange (``all_to_all``) and the gathers (the
    splitter sample, the counts, the global array); then the runtime."""
    mesh22 = rt_ranks.make_mesh((2, 2), ("pod", "data"), "cuda")
    engines = {(DIST_RANKS,): SortEngine(mesh=mesh), (2, 2): SortEngine(mesh=mesh22, axis_names=("pod", "data"))}
    for eng in engines.values():
        eng.sort(make_array("random", 1 << 20, seed=1))  # warm
    secs = {"all_to_all": 0.0, "all_gather": 0.0}
    nbytes = dict.fromkeys(secs, 0)
    originals = {name: getattr(rt_ranks, name) for name in secs}

    def clocked(name):
        def call(out, inp, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = originals[name](out, inp, group)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            nbytes[name] += inp.numel() * inp.element_size()
            return r
        return call

    out = {}
    for name in secs:
        setattr(rt_ranks, name, clocked(name))
    try:
        for dist_name, shape in DIST_CASES:
            eng = engines[shape]
            x = make_array(dist_name, n, seed=22)
            want = np.sort(x)
            secs.update(all_to_all=0.0, all_gather=0.0)
            nbytes.update(all_to_all=0, all_gather=0)
            before = launch_counts()
            t0 = time.perf_counter()
            y = eng.sort(x)
            wall = time.perf_counter() - t0
            rep = eng.last_report
            out[(dist_name, shape)] = {
                "equal": bool(np.array_equal(y, want)), "s": wall, "plan": f"{rep['plan'].path}/{rep['plan'].method}",
                "retries": rep["overflow_retries"], "cf": rep["capacity_factor"], "a2a_s": secs["all_to_all"],
                "gather_s": secs["all_gather"], "a2a_bytes": nbytes["all_to_all"], "gather_bytes": nbytes["all_gather"],
                "launches": dist_launches(before),
            }
    finally:
        for name, fn in originals.items():
            setattr(rt_ranks, name, fn)
    out["runtime"] = runtime_on_card(mesh, mesh22)
    return out


def dist_verify_cli() -> None:
    """``python -m repro_torch.verify --smoke --devices 4`` on the card, in
    a subprocess: every cell passes, the dist row on 4 ranks over gloo."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "report.json"
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.verify", "--smoke", "--devices", str(DIST_RANKS),
                            "-q", "--report", str(path)], env=env, capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        if r.returncode != 0 or not path.exists():
            fail(f"verify --smoke --devices {DIST_RANKS} exited {r.returncode}: {r.stdout[-2000:]} {r.stderr[-2000:]}")
        report = json.loads(path.read_text())
    dist_cells = [sid for sid in report["baseline"]["scenarios"] if sid.startswith("dist/")]
    if report["fails"] or report["cross_check_mismatches"] or len(dist_cells) != 72 or report["backend"] != "gloo":
        fail(f"verify --devices {DIST_RANKS}: fails {report['fails']}, mismatches "
             f"{report['cross_check_mismatches']}, {len(dist_cells)} dist cells, backend {report['backend']}")
    print(f"  (b) verify --smoke --devices {DIST_RANKS}: {report['scenario_count']} cells pass, "
          f"{len(dist_cells)} of them dist cells on {DIST_RANKS} ranks over {report['backend']}, "
          f"0 cross-check mismatches, {secs:.1f} s; {r.stdout.strip().splitlines()[-2]}")


def distributed_path() -> dict:
    """Phase 14: the dist path and the runtime over ranks; the launches of
    (a) and (b), summed over the ranks."""
    t0 = time.perf_counter()
    card = smi()
    print(f"phase 14 (dist path, {card}): gloo stages send/recv of CUDA tensors through host buffers")
    total = collections.Counter()
    (one,) = rt_ranks.run_ranks(dist_world_one, (1,), ("data",), backend="nccl", device="cuda",
                                args=(PAPER_MAX_KEYS,))
    for method, r in one.items():
        print(f"  (a) world size 1 over nccl, forced dist/{method}, {PAPER_MAX_KEYS} random int32 keys: "
              f"{r['s'] * 1e3:.1f} ms, capacity factor {r['cf']}, retries {r['retries']}, "
              f"equal to np.sort {r['equal']}; launches {r['launches']}")
        if not r["equal"]:
            fail(f"(a) dist/{method} differs from np.sort")
        if not (r["launches"]["bucket_count_rank"] and r["launches"]["sort_tile"]):
            fail(f"(a) dist/{method} did not launch K1 and K2: {r['launches']}")
        total.update(r["launches"])
    dist_verify_cli()
    per_rank = rt_ranks.run_ranks(dist_four_ranks, (DIST_RANKS,), ("data",), backend="gloo", device="cuda",
                                  args=(PAPER_MAX_KEYS,))
    for case in DIST_CASES:
        rows = [r[case] for r in per_rank]
        wall = max(r["s"] for r in rows)
        print(f"  (b) {DIST_RANKS} ranks over gloo, planned {rows[0]['plan']} on {case[1]}, {PAPER_MAX_KEYS} "
              f"{case[0]} int32 keys: {wall * 1e3:.1f} ms (slowest rank), retries {rows[0]['retries']}, "
              f"capacity factor {rows[0]['cf']}, all_to_all {max(r['a2a_s'] for r in rows) / wall:.3f} and gathers "
              f"{max(r['gather_s'] for r in rows) / wall:.3f} of the wall time, bytes a rank hands all_to_all "
              f"{rows[0]['a2a_bytes']} and the gathers {rows[0]['gather_bytes']}, equal to np.sort on every rank "
              f"{all(r['equal'] for r in rows)}; launches by rank {[r['launches'] for r in rows]}")
        if not all(r["equal"] for r in rows):
            fail(f"(b) {case} differs from np.sort on a rank")
        if not all(r["launches"]["bucket_count_rank"] and r["launches"]["sort_tile"] for r in rows):
            fail(f"(b) {case}: a rank did not launch K1 and K2")
        if any(r["plan"] != rows[0]["plan"] for r in rows):
            fail(f"(b) {case}: the ranks planned differently")
        for r in rows:
            total.update(r["launches"])
    limits = {"int8_psum": 1e-6, "hierarchical_psum": 1e-6, "pipeline_forward": 1e-5}
    for name, limit in limits.items():
        err = max(r["runtime"][name] for r in per_rank)
        print(f"  (c) {name} on card tensors over {DIST_RANKS} gloo ranks against the CPU: max abs diff {err}")
        if not err <= limit:
            fail(f"(c) {name} differs from its CPU run by {err} > {limit}")
    print(f"phase 14 (dist path): {time.perf_counter() - t0:.1f} s; launches {dict(total)}")
    return dict(total)


# ---------------------------------------------------------------- phase 15
MESH_ARCH = TRAIN_ARCH  # its production MoE dispatch is shard_map
MESH_ONE_STEPS = 3  # (a): phase 11's cut (4 of 27 layers, 2 x 4,096 tokens, remat)
# (b): 2 of 27 layers, a batch of 4 x 1,024, on (1, 2, 2) over 4 ranks sharing the card, one step (each
# planted fault below passes step 1's loss or grad_norm limit, so a second step's reading is not needed)
MESH_FOUR, MESH_FOUR_LAYERS, MESH_FOUR_BATCH, MESH_FOUR_SEQ, MESH_FOUR_STEPS = (1, 2, 2), 2, 4, 1024, 1
# (b)'s limits against the unsharded step, relative: step 1's loss and grad_norm.  Each lies between the
# sound run's gap and the planted faults' that it catches (tools/mesh_fault_readings.py, PERF.md): sound
# 4.46e-4, 3.07e-5; the tensor axis's all-reduce skipped -, 1.10e-2; a replicated leaf's norm counted per
# rank -, 1.32e-1; the global capacity in place of the local 1.98e-3, 7.53e-3
MESH_FOUR_GAP = {"loss": 1e-3, "grad_norm": 1e-3}
MESH_NAMES = ("pod", "data", "model")


def mesh_run(cfg, batch: int, seq: int):
    """No warmup: step 1 updates at the peak rate, so step 2's loss moves."""
    return RunConfig(model=cfg, shape=ShapeConfig("train", seq, batch, "train"), warmup_steps=0, total_steps=6)


def unsharded_steps(cfg, run, batches: list) -> list:
    """Unsharded train steps (no mesh: the shard_map dispatch runs
    ``sorted``) on the state made from seed 0, one a batch; each step's
    metrics as floats and its loss's and grad_norm's bits."""
    api = registry.get_model_api(cfg)
    state = init_train_state(torch.Generator(device=DEV).manual_seed(0), cfg, run, api)
    step = make_train_step(cfg, run, api)
    out = []
    for batch in batches:
        state, m = step(state, batch)
        out.append({k: float(v) for k, v in m.items()})
        out[-1]["bits"] = (int(bits(m["loss"])), int(bits(m["grad_norm"])))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_four_model():
    """(b)'s config, run and batch."""
    cfg = registry.get_config(MESH_ARCH).replace(num_layers=MESH_FOUR_LAYERS)
    run = mesh_run(cfg, MESH_FOUR_BATCH, MESH_FOUR_SEQ)
    return cfg, run, SyntheticLMData(cfg, MESH_FOUR_BATCH, MESH_FOUR_SEQ, seed=0, device=DEV).next_batch()


def mesh_four_gaps(metrics: list, ref: list) -> dict:
    """(b)'s readings against the unsharded steps, relative: step 1's loss
    and grad_norm, and the loss that step 1's update took off the batch
    (step 1's loss less step 2's, on the same batch; none after one step)."""
    gap = {k: abs(metrics[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ("loss", "grad_norm")}
    if len(metrics) > 1:  # one step takes nothing off
        drop, ref_drop = (m[0]["loss"] - m[1]["loss"] for m in (metrics, ref))
        gap["drop"] = abs(drop - ref_drop) / abs(ref_drop)
    return gap


def mesh_world_one(mesh) -> dict:
    """Phase 15 (a), the one rank of an NCCL group on a (1, 1, 1) mesh:
    phase 11's DeepSeek-V2-Lite (4 layers, 2 x 4,096 tokens) with the
    ``shard_map`` dispatch, 3 steps through ``jit_train_step(mesh=...)``;
    first the unsharded step on the same state and batch.  Both first
    steps run with deterministic algorithms (the index backward's atomic
    adds would otherwise reorder sums), the timed steps 2 and 3 without."""
    cfg = registry.get_config(MESH_ARCH).replace(num_layers=TRAIN_LAYERS)
    run = mesh_run(cfg, TRAIN_BATCH, TRAIN_SEQ)
    data = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEV)
    batches = [data.next_batch() for _ in range(MESH_ONE_STEPS)]
    torch.use_deterministic_algorithms(True)
    reset_launches()
    (plain,) = unsharded_steps(cfg, run, batches[:1])
    plain_k1 = launch_counts()["bucket_count_rank"]
    state = init_train_state(torch.Generator(device=DEV).manual_seed(0), cfg, run, lm)
    rules, sspecs, bspecs = sharding.train_specs(cfg, run.shape, run, mesh, state["params"])
    step = jit_train_step(make_train_step(cfg, run, lm, rules), mesh, sspecs, bspecs)
    torch.cuda.reset_peak_memory_stats()
    metrics, walls, per_step = [], [], []
    for i, batch in enumerate(batches):
        if i == 1:
            torch.use_deterministic_algorithms(False)
        before = launch_counts()["bucket_count_rank"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append((time.perf_counter() - t0) * 1e3)
        per_step.append(launch_counts()["bucket_count_rank"] - before)
        if i == 0:
            first_bits = (int(bits(m["loss"])), int(bits(m["grad_norm"])))
    peak = torch.cuda.max_memory_allocated()
    placements = str(state["params"]["blocks"]["moe"]["wi"].placements)
    del state, step
    return {"plain": plain, "plain_k1": plain_k1, "metrics": metrics, "first_bits": first_bits, "walls": walls,
            "per_step": per_step, "peak": peak, "wi": placements, "launches": dict(launch_counts())}


def clock_redistributions(secs: list):
    """Wrap DTensor's one redistribution function (every collective of a
    ``redistribute``, forward and backward) to add its synchronised
    seconds to ``secs[0]``; returns the undo, or ``None`` where this torch
    has no such function."""
    from torch.distributed.tensor import _redistribute

    original = getattr(_redistribute, "redistribute_local_tensor", None)
    if original is None:
        return None

    def clocked(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(*a, **k)
        if hasattr(out, "wait"):
            out = out.wait()
        torch.cuda.synchronize()
        secs[0] += time.perf_counter() - t0
        return out

    _redistribute.redistribute_local_tensor = clocked
    return lambda: setattr(_redistribute, "redistribute_local_tensor", original)


def mesh_four_ranks(mesh) -> dict:
    """Phase 15 (b) on one of 4 ranks sharing the card over gloo, mesh
    (1, 2, 2): DeepSeek-V2-Lite at full width, 2 layers, 4 x 1,024 tokens,
    ``MESH_FOUR_STEPS`` steps on one batch.  Each rank draws the whole
    parameter tree from seed 0 and keeps its shard (the moments are made
    on the shards), so the card never holds 4 whole states.  Step 1 runs
    with DTensor's redistributions clocked (their share), any later step
    without (its time)."""
    cfg, run, batch = mesh_four_model()
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    rules, sspecs, bspecs = sharding.train_specs(cfg, run.shape, run, mesh, params)
    params = spec_map(lambda s, x: distribute(x, s, mesh), sspecs["params"], params)
    gc.collect()
    torch.cuda.empty_cache()
    state = {"params": params, "opt": adamw_init(params), "step": mesh_zeros(mesh, torch.int32)}
    local_bytes = sum(x.to_local().numel() * x.to_local().element_size() for x in tree_leaves(state))
    step = jit_train_step(make_train_step(cfg, run, lm, rules), mesh, sspecs, bspecs)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, walls, per_step, coll = [], [], [], None
    for i in range(MESH_FOUR_STEPS):
        secs = [0.0]
        undo = clock_redistributions(secs) if i == 0 else None
        before = launch_counts()["bucket_count_rank"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            state, m = step(state, batch)
        finally:
            if undo:
                undo()
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append((time.perf_counter() - t0) * 1e3)
        per_step.append(launch_counts()["bucket_count_rank"] - before)
        if undo:
            coll = secs[0] * 1e3
    return {"metrics": metrics, "walls": walls, "per_step": per_step, "coll_ms": coll, "local_bytes": local_bytes,
            "peak": torch.cuda.max_memory_allocated(), "launches": dict(launch_counts())}


def mesh_training() -> dict:
    """Phase 15: the model layer over a mesh: (a) world size 1 over NCCL,
    (b) 4 ranks sharing the card over gloo.  Returns the launches of both,
    summed over the ranks."""
    t0 = time.perf_counter()
    card = smi()
    total = collections.Counter()
    full = registry.get_config(MESH_ARCH)
    print(f"phase 15 (model layer over a mesh, {card}): {MESH_ARCH} at full width with its production "
          f"MoE dispatch {full.moe.dispatch!r}; reduced: (a) depth {full.num_layers} -> {TRAIN_LAYERS} layers, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ} (phase 11's cut), {MESH_ONE_STEPS} steps; (b) depth "
          f"{full.num_layers} -> {MESH_FOUR_LAYERS} layers, batch {MESH_FOUR_BATCH} x {MESH_FOUR_SEQ}, "
          f"{MESH_FOUR_STEPS} steps; widths as published")
    env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # the rank's deterministic first steps
    try:
        (one,) = rt_ranks.run_ranks(mesh_world_one, (1, 1, 1), MESH_NAMES, backend="nccl", device="cuda")
    finally:
        if env_before is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
    ms, plain = one["metrics"], one["plain"]
    PHASE15_PLAIN.update(plain, k1=one["plain_k1"])
    losses = [m["loss"] for m in ms]
    want_k1 = 2 * TRAIN_LAYERS
    print(f"  (a) world size 1 over nccl, mesh (1, 1, 1), experts stored {one['wi']}: losses "
          f"{[round(x, 4) for x in losses]}, grad_norm {[round(m['grad_norm'], 4) for m in ms]}; K1 launches a "
          f"step {one['per_step']} (the unsharded step: {one['plain_k1']}); step ms (synchronised) "
          f"{[round(w, 1) for w in one['walls']]} (steps 2-3 without deterministic algorithms; beside phase 11's "
          f"step above), max allocated {one['peak'] / 2**30:.2f} GiB")
    print(f"  (a) step 1 against the unsharded 'sorted' step on the same state and batch: loss {ms[0]['loss']!r} vs "
          f"{plain['loss']!r}, grad_norm {ms[0]['grad_norm']!r} vs {plain['grad_norm']!r}; bits equal "
          f"{one['first_bits'] == tuple(plain['bits'])}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 15 (a): a loss is not finite: {losses}")
    if one["per_step"] != [want_k1] * MESH_ONE_STEPS:
        fail(f"phase 15 (a): K1 launched {one['per_step']} times a step, not {want_k1}")
    if one["first_bits"] != tuple(plain["bits"]):
        fail("phase 15 (a): step 1's loss or grad_norm differs in bits from the unsharded step's")
    total.update(one["launches"])
    cfg2, run2, batch2 = mesh_four_model()
    before = launch_counts()
    ref = unsharded_steps(cfg2, run2, [batch2] * MESH_FOUR_STEPS)
    total.update({k: v - before[k] for k, v in launch_counts().items()})
    ranks_out = rt_ranks.run_ranks(mesh_four_ranks, MESH_FOUR, MESH_NAMES, backend="gloo", device="cuda")
    first = ranks_out[0]["metrics"]
    n = cfg2.param_count()
    gap = mesh_four_gaps(first, ref)
    walls = [max(r["walls"][i] for r in ranks_out) for i in range(MESH_FOUR_STEPS)]
    coll = [r["coll_ms"] for r in ranks_out]
    share = ("not measured (this torch has no redistribute_local_tensor)" if coll[0] is None else
             round(max(coll) / walls[0], 3))
    print(f"  (b) 4 ranks over gloo on {MESH_FOUR}, {n:,} counted weights, {sum(r['local_bytes'] for r in ranks_out) / 1e9:.1f} GB "
          f"of state over the ranks, {MESH_FOUR_STEPS} step(s) on one batch: losses {[m['loss'] for m in first]!r}, "
          f"grad_norm {[m['grad_norm'] for m in first]!r}; the unsharded steps on the card: losses "
          f"{[m['loss'] for m in ref]!r}, grad_norm {[m['grad_norm'] for m in ref]!r}; relative gaps "
          f"{ {k: f'{v:.3e}' for k, v in gap.items()} } (limits {MESH_FOUR_GAP}); step ms (slowest rank): step 1 "
          f"with DTensor's redistributions clocked (synchronised) {walls[0]:.1f}, {share} of it in them"
          f"{'; later steps unclocked ' + str([round(w, 1) for w in walls[1:]]) if len(walls) > 1 else ''}; K1 "
          f"launches a step by rank {[r['per_step'] for r in ranks_out]}; max allocated by "
          f"rank {[round(r['peak'] / 2**30, 2) for r in ranks_out]} GiB")
    if not all(math.isfinite(m["loss"]) for r in ranks_out for m in r["metrics"]):
        fail("phase 15 (b): a loss is not finite")
    if any(r["metrics"] != first for r in ranks_out):
        fail("phase 15 (b): the ranks report different metrics")
    if any(r["per_step"] != [2 * MESH_FOUR_LAYERS] * MESH_FOUR_STEPS for r in ranks_out):
        fail(f"phase 15 (b): K1 launches a step by rank {[r['per_step'] for r in ranks_out]}, "
             f"not {2 * MESH_FOUR_LAYERS}")
    if not all(gap[k] <= MESH_FOUR_GAP[k] for k in gap):
        fail(f"phase 15 (b): the gaps {gap} to the unsharded steps pass the limits {MESH_FOUR_GAP}")
    for r in ranks_out:
        total.update(r["launches"])
    print(f"phase 15 (model layer over a mesh): {time.perf_counter() - t0:.1f} s; launches {dict(total)}")
    return dict(total)


# ---------------------------------------------------------------- phase 16
MESH_SERVE_FOUR_LAYERS, MESH_SERVE_FOUR_NEW = 2, 2  # (b): 2 of 27 layers, 2 new tokens (a prefill, one decode step)
MESH_SERVE_KV_PROMPT, MESH_SERVE_KV_MAX_LEN, MESH_SERVE_KV_STEPS = 1024, 2048, 4  # (c): batch 1, kv_seq
# (b)'s and (c)'s limits on the logits against the unsharded model on the card fed the same tokens (in
# the batch shards' row groups), each forward's largest gap relative to the unsharded logits' largest
# magnitude: the prefill's, every decode step's, and the decode steps' median.  Each lies between the
# sound run's readings and the planted faults' that it catches (tools/mesh_fault_readings.py --path
# serve, PERF.md; H100 80GB HBM3, 700 W): sound (b) 7.8e-2, 1.05e-1 (an MoE route flipped by a bf16 near
# tie lifts a step), 1.7e-2, (c) 1.0e-2, 1.2e-2, 9.4e-3; the attention's all-reduce skipped 1.02-1.31,
# 1.33-1.35, 1.12-1.18; a kv_seq write on every shard -, 2.3e-1, 1.4e-1; the log-sum-exp combine as a
# plain mean -, 1.6, 1.34
MESH_SERVE_GAP = {"prefill": 0.3, "decode": 0.3, "decode_median": 0.05}


def forward_log(eng, sink: list):
    """Wrap ``eng``'s prefill and decode: each call synchronised and timed,
    with its K1 launches, this rank's max allocated during it, its
    (host) input tokens and its logits (float32, on the host) appended to
    ``sink`` as a dict."""
    def wrap(fn, kind):
        def call(*args):
            tokens = args[1]["tokens"] if kind == "prefill" else args[1]
            before = launch_counts()["bucket_count_rank"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            sink.append({"kind": kind, "ms": (time.perf_counter() - t0) * 1e3,
                         "k1": launch_counts()["bucket_count_rank"] - before,
                         "peak": torch.cuda.max_memory_allocated(), "tokens": tokens.cpu(),
                         "logits": out[0].float().cpu()})
            return out
        return call
    eng._prefill, eng._decode = wrap(eng._prefill, "prefill"), wrap(eng._decode, "decode")


def mesh_serve_world_one(mesh) -> dict:
    """Phase 16 (a), the one rank of an NCCL group on a (1, 1, 1) mesh:
    DeepSeek-V2-Lite at full width, all 27 layers, its float32 weights
    from phase 9's seed, served through ``ServeEngine(rules=...)`` for
    phase 9's first batch."""
    cfg = registry.get_config(SERVE_ARCH)
    reqs = synthetic_requests(SERVE_BATCHES[0], cfg.vocab_size, SERVE_NEW_TOKENS)
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    rules = sharding.rules_for(cfg, ShapeConfig("serve", SERVE_MAX_LEN, len(reqs), "decode"), mesh)
    with set_mesh(mesh):
        eng = ServeEngine(cfg, params, lm, rules=rules, max_len=SERVE_MAX_LEN)
    del params
    log: list = []
    forward_log(eng, log)
    reset_launches()
    out = eng.generate(reqs)
    return {"tokens": out, "log": log, "launches": dict(launch_counts()), "rules": str(rules),
            "placements": str(eng.params["blocks"]["moe"]["wi"].placements)}


def mesh_serve_model():
    """(b)'s and (c)'s config: DeepSeek-V2-Lite at full width, 2 layers."""
    return registry.get_config(SERVE_ARCH).replace(num_layers=MESH_SERVE_FOUR_LAYERS)


def mesh_serve_kv_request(cfg, length: int = MESH_SERVE_KV_PROMPT, steps: int = MESH_SERVE_KV_STEPS) -> list:
    """(c)'s one request: a ``length``-token prompt from seed 5, ``steps``
    decode steps."""
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, length).astype(np.int32)
    return [Request(0, prompt, max_new_tokens=steps + 1)]


def mesh_serve_four_ranks(mesh) -> dict:
    """Phase 16 (b) and (c) on one of 4 ranks sharing the card over gloo,
    mesh (1, 2, 2): each rank draws the 2-layer model's whole tree from
    seed 0 and keeps its shard.  (b) 4 requests of the launcher's mix, 8
    new tokens, with DTensor's redistributions clocked for their share;
    (c) one 1,024-token request at ``max_len`` 2,048 under the decode
    rules of a batch of 1 (``kv_seq="data"``), 4 decode steps."""
    t0 = time.perf_counter()
    cfg = mesh_serve_model()
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    out = {}
    for case, reqs, max_len in (("b", synthetic_requests(4, cfg.vocab_size, MESH_SERVE_FOUR_NEW), SERVE_MAX_LEN),
                                ("c", mesh_serve_kv_request(cfg), MESH_SERVE_KV_MAX_LEN)):
        rules = sharding.rules_for(cfg, ShapeConfig("serve", max_len, len(reqs), "decode"), mesh)
        with set_mesh(mesh):
            eng = ServeEngine(cfg, params, lm, rules=rules, max_len=max_len)
        params = eng.params  # laid out once: (c)'s engine finds it so
        gc.collect()
        torch.cuda.empty_cache()
        out.setdefault("setup_s", time.perf_counter() - t0)
        log: list = []
        forward_log(eng, log)
        secs = [0.0]
        undo = clock_redistributions(secs) if case == "b" else None
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            toks = eng.generate(reqs)
        finally:
            if undo:
                undo()
        wall = (time.perf_counter() - t0) * 1e3
        if torch.distributed.get_rank():
            for f in log:
                f.pop("logits")
        out[case] = {"tokens": toks, "log": log, "wall": wall, "coll_ms": secs[0] * 1e3 if undo else None,
                     "launches": dict(launch_counts()), "rules": (rules.batch, rules.kv_seq)}
    return out


def teacher_forced(cfg, params, log: list, max_len: int, groups: int = 1, inputs: "dict | None" = None) -> list:
    """The unsharded model on the card fed what a sharded run's forwards
    were fed (``forward_log``: the padded prompt, then each step's
    tokens), one group of rows at a time: the batch shards' ``groups``
    (contiguous, as the batch axes split the rows), so that its MoE
    capacity is the ``shard_map`` dispatch's local one and it drops what
    the sharded run drops.  ``inputs`` holds the prefill's other leaves
    (default the engine's: zero encoder frames for the encdec family).
    Each forward's logits, float32 on the host."""
    api = registry.get_model_api(cfg)
    prompt = log[0]["tokens"].to(DEV)
    L, rows = prompt.shape[1], prompt.shape[0] // groups
    if inputs is None:
        inputs = {} if cfg.family != "encdec" else {
            "enc_frames": torch.zeros((prompt.shape[0], cfg.encoder_seq_len, cfg.d_model), dtype=cfg.dtype, device=DEV)}
    per_group = []
    with torch.inference_mode():
        for g in range(groups):
            part = slice(g * rows, (g + 1) * rows)
            rest = {k: v[:, part] if k == "positions_thw" else v[part] for k, v in inputs.items()}
            cache = api.init_cache(cfg, rows, max_len, device=DEV)
            logits, cache = api.prefill(params, {"tokens": prompt[part], **rest}, cfg, NO_SHARD, cache)
            out = [logits.float().cpu()]
            for s, f in enumerate(log[1:]):
                logits, cache = api.decode_step(params, f["tokens"][part].to(DEV), cfg, NO_SHARD, cache, L + s)
                out.append(logits.float().cpu())
            per_group.append(out)
            del cache
    return [torch.cat(fwd) for fwd in zip(*per_group)]


def batch_groups(rules_batch) -> int:
    """Into how many row groups (1, 2, 2)'s batch axes ``rules_batch`` cut a batch."""
    sizes = dict(zip(MESH_NAMES, MESH_FOUR))
    return math.prod(sizes[a] for a in (rules_batch or ()))


def logit_gaps(log: list, ref: list) -> dict:
    """The sharded forwards' logits against ``ref``'s, each forward's
    largest gap relative to the largest unsharded magnitude: the
    prefill's, the worst decode step's, the decode steps' median, and
    every forward's (``steps``)."""
    rel = [float((f["logits"] - r).abs().max() / r.abs().max()) for f, r in zip(log, ref)]
    return {"prefill": rel[0], "decode": max(rel[1:]), "decode_median": statistics.median(rel[1:]), "steps": rel}


def mesh_four_serving_checks(label: str, out: list, gap: dict, want_k1: int, limits: "dict | None" = None,
                             phase: int = 16) -> None:
    """(b)'s or (c)'s gates over the ranks' results: the same tokens on
    every rank, K1 ``want_k1`` a forward on each, K5 once a rank (none for
    one request), the relative logit gaps ``gap`` within ``limits``
    (default ``MESH_SERVE_GAP``)."""
    limits = MESH_SERVE_GAP if limits is None else limits
    first = out[0]
    if any(r["tokens"] != first["tokens"] for r in out):
        fail(f"phase {phase} ({label}): the ranks emitted different tokens")
    per_fwd = [[f["k1"] for f in r["log"]] for r in out]
    if any(k != [want_k1] * len(first["log"]) for k in per_fwd):
        fail(f"phase {phase} ({label}): K1 launches a forward by rank {per_fwd}, not {want_k1}")
    if any(r["launches"].get("sort_pairs_tile_tagged", 0) != (1 if len(first["tokens"]) > 1 else 0) for r in out):
        fail(f"phase {phase} ({label}): K5 launches by rank {[r['launches'] for r in out]}")
    if not all(math.isfinite(v) for v in gap["steps"]):
        fail(f"phase {phase} ({label}): a logit gap is not finite: {gap}")
    if not all(gap[k] <= limits[k] for k in limits):
        fail(f"phase {phase} ({label}): the logit gaps {gap} to the unsharded model pass the limits {limits}")


def mesh_serving() -> dict:
    """Phase 16: serving over a mesh, (a) world size 1 over NCCL, (b) and
    (c) 4 ranks sharing the card over gloo.  Returns the launches of all
    three, summed over the ranks."""
    t0 = time.perf_counter()
    card = smi()
    total = collections.Counter()
    full = registry.get_config(SERVE_ARCH)
    print(f"phase 16 (serving over a mesh, {card}): {SERVE_ARCH} at full width, MoE dispatch "
          f"{full.moe.dispatch!r}; (a) all {full.num_layers} layers, phase 9's first batch; reduced: (b) and (c) "
          f"depth {full.num_layers} -> {MESH_SERVE_FOUR_LAYERS} layers, (b) {MESH_SERVE_FOUR_NEW} new tokens, (c) "
          f"one {MESH_SERVE_KV_PROMPT}-token prompt, max_len {MESH_SERVE_KV_MAX_LEN}, {MESH_SERVE_KV_STEPS} decode "
          f"steps; widths as published")
    if not PHASE9_FIRST:
        fail("phase 16 (a): phase 9 kept no tokens for its first batch")
    base = torch.cuda.memory_allocated()
    (one,) = rt_ranks.run_ranks(mesh_serve_world_one, (1, 1, 1), MESH_NAMES, backend="nccl", device="cuda")
    allocated_back(base, "phase 16 (a)'s rank", phase=16)
    log = one["log"]
    gap = max(float((f["logits"] - w).abs().max()) for f, w in zip(log, PHASE9_FIRST["logits"]))
    k1 = [f["k1"] for f in log]
    decode_ms = [f["ms"] for f in log[1:]]
    print(f"  (a) world size 1 over nccl, mesh (1, 1, 1), {one['rules']}, experts stored {one['placements']}: "
          f"tokens equal phase 9's {one['tokens'] == PHASE9_FIRST['tokens']}; largest logit gap to phase 9 "
          f"{gap!r} over {len(log)} forwards; K1 a forward {sorted(set(k1))} ({len(k1)} forwards), K5 "
          f"{one['launches'].get('sort_pairs_tile_tagged', 0)}; prefill {log[0]['ms']:.3f} ms, decode "
          f"{statistics.median(decode_ms):.3f} ms a step (median of {len(decode_ms)}; min {min(decode_ms):.3f}, "
          f"max {max(decode_ms):.3f}) synchronised; max allocated {max(f['peak'] for f in log) / 2**30:.2f} GiB "
          f"(phase 9 served the same batch without a mesh above)")
    if one["tokens"] != PHASE9_FIRST["tokens"]:
        fail(f"phase 16 (a): the tokens differ from phase 9's: {one['tokens']} vs {PHASE9_FIRST['tokens']}")
    if k1 != [full.num_layers] * len(log) or one["launches"].get("sort_pairs_tile_tagged") != 1:
        fail(f"phase 16 (a): K1 a forward {k1} (not {full.num_layers}), launches {one['launches']}")
    total.update(one["launches"])

    cfg = mesh_serve_model()
    t_ranks = time.perf_counter()
    ranks_out = rt_ranks.run_ranks(mesh_serve_four_ranks, MESH_FOUR, MESH_NAMES, backend="gloo", device="cuda")
    print(f"  (b), (c): the 4 ranks took {time.perf_counter() - t_ranks:.1f} s, {ranks_out[0]['setup_s']:.1f} s of it "
          f"drawing and laying out the model on each")
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    gaps = {}
    for case, max_len in (("b", SERVE_MAX_LEN), ("c", MESH_SERVE_KV_MAX_LEN)):
        out = [r[case] for r in ranks_out]
        before = launch_counts()
        ref = teacher_forced(cfg, params, out[0]["log"], max_len, batch_groups(out[0]["rules"][0]))
        total.update({k: v - before[k] for k, v in launch_counts().items()})
        gaps[case] = logit_gaps(out[0]["log"], ref)
        slow = [max(r["log"][i]["ms"] for r in out) for i in range(len(out[0]["log"]))]
        coll = [r["coll_ms"] for r in out]
        share = ("" if coll[0] is None else
                 f", {max(coll) / max(r['wall'] for r in out):.3f} of the generate in DTensor's redistributions "
                 f"(clocked, synchronised)")
        print(f"  ({case}) 4 ranks over gloo on {MESH_FOUR}, rules (batch, kv_seq) {out[0]['rules']}: "
              f"{len(out[0]['tokens'])} requests, tokens the same on every rank; relative logit gaps to the unsharded "
              f"model fed the same tokens: prefill {gaps[case]['prefill']:.3e}, decode steps "
              f"{[f'{g:.3e}' for g in gaps[case]['steps'][1:]]}, their median {gaps[case]['decode_median']:.3e} "
              f"(limits {MESH_SERVE_GAP}); slowest rank: prefill "
              f"{slow[0]:.1f} ms, decode {statistics.median(slow[1:]):.1f} ms a step (median of {len(slow) - 1}), "
              f"generate {max(r['wall'] for r in out):.1f} ms{share}; K1 a forward {MESH_SERVE_FOUR_LAYERS} on each "
              f"rank; max allocated by rank {[round(max(f['peak'] for f in r['log']) / 2**30, 2) for r in out]} GiB")
        mesh_four_serving_checks(case, out, gaps[case], MESH_SERVE_FOUR_LAYERS)
        for r in out:
            total.update(r["launches"])
    # the dry-run's one-device prediction of (b)'s decode cell on (1, 2, 2), beside each rank's measured peak
    b = [r["b"] for r in ranks_out]
    L = b[0]["log"][0]["tokens"].shape[1]
    rec = dryrun.predict(SERVE_ARCH, cfg, ShapeConfig("serve", L, len(b[0]["tokens"]), "decode"),
                         MeshSpec(MESH_FOUR, MESH_NAMES), cache_len=SERVE_MAX_LEN, full_trace=True, hw=H100)
    mem = rec["memory_analysis"]
    peaks = [max(f["peak"] for f in r["log"][1:]) for r in b]
    off = [f"{100 * (mem['total_bytes'] / p - 1):+.1f} %" for p in peaks]
    print(f"  dry-run (report only): (b)'s decode cell on {MESH_FOUR}, R={len(b[0]['tokens'])} L={L} max_len "
          f"{SERVE_MAX_LEN}: predicted {mem['total_bytes'] / 2**30:.2f} GiB a device (arguments "
          f"{mem['argument_bytes'] / 2**30:.2f}, temp {mem['temp_bytes'] / 2**30:.2f}) against each rank's decode max "
          f"allocated {[round(p / 2**30, 2) for p in peaks]} GiB ({off})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16 (serving over a mesh): {time.perf_counter() - t0:.1f} s; launches {dict(total)}")
    return dict(total)


# ---------------------------------------------------------------- phase 17
SSM_MESH_ARCH, HYBRID_MESH_ARCH = "mamba2-370m", FAMILY_ARCHS[0]
MESH_SSM_ONE_STEPS = 3  # (a): mamba2-370m, all 48 layers, phase 11's batch (2 x 4,096 tokens)
# (b): (arch, layers, train batch, train sequence) on (1, 2, 2) over 4 ranks sharing the card; Zamba2's 6 of
# 54 layers are one period, so its shared block runs once
MESH_SSM_CUTS = ((SSM_MESH_ARCH, 8, 4, 1024), (HYBRID_MESH_ARCH, 6, 4, 512))
MESH_SSM_NEW = 8  # new tokens a request in (b)
# (b)'s limits against the same model unsharded on the card.  Training, relative: step 1's loss and
# grad_norm and the loss step 1's update took off its batch (as phase 15's); serving: each forward's
# largest logit gap relative to the unsharded logits' largest magnitude (as phase 16's), mamba2's prefill
# under the prefill rules (SP) among them.  Each lies between the sound runs' readings and the planted
# faults' that it catches (tools/mesh_fault_readings.py --path ssm, PERF.md; H100 80GB HBM3, 700 W).
# Training, sound mamba2 / Zamba2: 2.5e-5 / 5.6e-5, 2.3e-4 / 1.2e-3, 3.0e-4 / 2.5e-3; the gated norm over
# the rank's own channels grad_norm 2.6e-2 (mamba2), drop 1.5e-2 / 6.5e-2; B and C from the contiguous
# columns grad_norm 0.14 / 0.12, loss 2.8e-3 (Zamba2); a local slice for the reduce-scatter grad_norm
# 5.7e-2, drop 0.19 (mamba2; a conv state in another rank's channels is not read in training).  Serving,
# sound prefill / worst decode / decode median at most 3.8e-2, 6.9e-2, 4.4e-2 over (b) and (c); the norm
# fault at least 0.30, 0.38, 0.28 (Zamba2's (c)); B and C, the conv state and mamba2's SP prefill under
# the local slice 1.0-1.7
MESH_SSM_GAP = {"loss": 1e-3, "grad_norm": 5e-3, "drop": 1e-2}
MESH_SSM_SERVE_GAP = {"prefill": 0.2, "decode": 0.25, "decode_median": 0.15}


def head_split_bytes(cfg, B: int, S: int, tp: int, sp: bool) -> dict:
    """What one Mamba2 block's head split over a tensor axis of ``tp``
    moves into each rank in a forward of ``B`` x ``S`` positions (bf16 or
    float32 as ``cfg.dtype``), from shapes: ``in_proj`` and ``conv_w`` /
    ``conv_b`` gathered whole from their tensor shards, the gated norm's
    float32 sums of squares all-reduced, ``out_proj``'s partial sums
    all-reduced (or, under SP, the sequence gathered on entry and the
    partial sums reduce-scattered on exit).  An all-reduce of n bytes
    counts 2 (tp-1)/tp n, a gather or reduce-scatter (tp-1)/tp n."""
    s, e = cfg.ssm, torch.tensor([], dtype=cfg.dtype).element_size()
    d_inner, nh = cfg.d_inner, cfg.ssm_heads
    conv = d_inner + 2 * s.n_groups * s.d_state
    part = (tp - 1) / tp
    act = B * S * cfg.d_model * e
    out = {"weights": part * (cfg.d_model * (d_inner + conv + nh) + (s.d_conv + 1) * conv) * e,
           "norm": 2 * part * B * S * 4}
    out.update({"seq_gather": part * act, "seq_scatter": part * act} if sp else {"out_allreduce": 2 * part * act})
    out["total"] = sum(out.values())
    return out


def mesh_ssm_world_one(mesh) -> dict:
    """Phase 17 (a), the one rank of an NCCL group on (1, 1, 1): Zamba2-2.7B
    at full width, all 54 layers, its float32 weights from phase 10's
    seed, served through ``ServeEngine(rules=...)`` for phase 10's first
    batch; then mamba2-370m at full width, all 48 layers, 3 steps through
    ``jit_train_step(mesh=...)``, first the unsharded step on the same
    state and batch, both first steps under deterministic algorithms."""
    cfg = registry.get_config(HYBRID_MESH_ARCH)
    reqs = synthetic_requests(SERVE_BATCHES[0], cfg.vocab_size, SERVE_NEW_TOKENS)
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    rules = sharding.rules_for(cfg, ShapeConfig("serve", SERVE_MAX_LEN, len(reqs), "decode"), mesh)
    with set_mesh(mesh):
        eng = ServeEngine(cfg, params, lm, rules=rules, max_len=SERVE_MAX_LEN)
    del params
    log: list = []
    forward_log(eng, log)
    reset_launches()
    out = {"serve": {"tokens": eng.generate(reqs), "log": log, "launches": dict(launch_counts()),
                     "rules": str(rules), "placements": str(eng.params["blocks"]["mamba"]["in_proj"].placements)}}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg = registry.get_config(SSM_MESH_ARCH)
    run = mesh_run(cfg, TRAIN_BATCH, TRAIN_SEQ)
    data = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEV)
    batches = [data.next_batch() for _ in range(MESH_SSM_ONE_STEPS)]
    torch.use_deterministic_algorithms(True)
    (plain,) = unsharded_steps(cfg, run, batches[:1])
    state = init_train_state(torch.Generator(device=DEV).manual_seed(0), cfg, run, lm)
    rules, sspecs, bspecs = sharding.train_specs(cfg, run.shape, run, mesh, state["params"])
    step = jit_train_step(make_train_step(cfg, run, lm, rules), mesh, sspecs, bspecs)
    torch.cuda.reset_peak_memory_stats()
    metrics, walls = [], []
    for i, batch in enumerate(batches):
        if i == 1:
            torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first_bits = (int(bits(m["loss"])), int(bits(m["grad_norm"])))
    out["train"] = {"plain": plain, "metrics": metrics, "first_bits": first_bits, "walls": walls,
                    "peak": torch.cuda.max_memory_allocated(), "rules": str(rules)}
    del state, step
    out["launches"] = dict(launch_counts())
    return out


def mesh_ssm_model(arch: str):
    """(b)'s cut of ``arch``: (config, run, its one training batch)."""
    _, layers_, batch, seq = next(c for c in MESH_SSM_CUTS if c[0] == arch)
    cfg = registry.get_config(arch).replace(num_layers=layers_)
    return cfg, mesh_run(cfg, batch, seq), SyntheticLMData(cfg, batch, seq, seed=0, device=DEV).next_batch()


def mesh_steps(mesh, cfg, run, batch, steps: int = 2, rules=None) -> dict:
    """``steps`` steps on one batch over the ranks, under ``rules`` (default
    ``rules_for``'s), from the parameters of seed 0 (each rank keeps its
    shard); step 1 with DTensor's redistributions clocked."""
    api = registry.get_model_api(cfg)
    params = api.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    rules, sspecs, bspecs = sharding.train_specs(cfg, run.shape, run, mesh, params, rules)
    params = spec_map(lambda s, x: distribute(x, s, mesh), sspecs["params"], params)
    gc.collect()
    torch.cuda.empty_cache()
    state = {"params": params, "opt": adamw_init(params), "step": mesh_zeros(mesh, torch.int32)}
    step = jit_train_step(make_train_step(cfg, run, api, rules), mesh, sspecs, bspecs)
    torch.cuda.reset_peak_memory_stats()
    metrics, walls, coll = [], [], None
    for i in range(steps):
        secs = [0.0]
        undo = clock_redistributions(secs) if i == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            state, m = step(state, batch)
        finally:
            if undo:
                undo()
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append((time.perf_counter() - t0) * 1e3)
        if undo:
            coll = secs[0] * 1e3
    return {"metrics": metrics, "walls": walls, "coll_ms": coll, "peak": torch.cuda.max_memory_allocated(),
            "rules": (rules.seq, rules.heads)}


def mesh_generate(mesh, cfg, params, reqs: list, max_len: int, clocked: bool) -> dict:
    """One ``generate`` of ``reqs`` over the ranks through
    ``ServeEngine(rules=...)``, every forward logged (``forward_log``)."""
    rules = sharding.rules_for(cfg, ShapeConfig("serve", max_len, len(reqs), "decode"), mesh)
    with set_mesh(mesh):
        eng = ServeEngine(cfg, params, registry.get_model_api(cfg), rules=rules, max_len=max_len)
    log: list = []
    forward_log(eng, log)
    secs = [0.0]
    undo = clock_redistributions(secs) if clocked else None
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        toks = eng.generate(reqs)
    finally:
        if undo:
            undo()
    wall = (time.perf_counter() - t0) * 1e3
    if torch.distributed.get_rank():
        for f in log:
            f.pop("logits")
    return {"tokens": toks, "log": log, "wall": wall, "coll_ms": secs[0] * 1e3 if undo else None,
            "launches": dict(launch_counts()), "rules": (rules.batch, rules.kv_seq), "params": eng.params}


def mesh_ssm_four_ranks(mesh) -> dict:
    """Phase 17 (b) and (c) on one of 4 ranks sharing the card over gloo,
    mesh (1, 2, 2): mamba2-370m (8 of 48 layers) trained 2 steps on one
    batch of 4 x 1,024 tokens (the sequence split over ``model``),
    prefilled on that batch under the prefill rules, and serving 4
    requests of the launcher's mix; Zamba2-2.7B (6 of 54 layers) trained 2
    steps on 4 x 512 tokens, serving the same mix, then (c) one
    1,024-token request at ``max_len`` 2,048 (``kv_seq="data"``)."""
    out = {}
    for arch, *_ in MESH_SSM_CUTS:
        cfg, run, batch = mesh_ssm_model(arch)
        res = {"train": mesh_steps(mesh, cfg, run, batch)}
        gc.collect()
        torch.cuda.empty_cache()
        params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
        if arch == SSM_MESH_ARCH:
            B, S = batch["tokens"].shape
            rules = sharding.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
            with set_mesh(mesh):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = lm.prefill(params, {"tokens": batch["tokens"]}, cfg, rules,
                                       lm.init_cache(cfg, B, S, device=DEV))
                torch.cuda.synchronize()
            res["prefill"] = {"ms": (time.perf_counter() - t0) * 1e3, "rules": (rules.seq, rules.heads),
                              "logits": logits.float().cpu() if torch.distributed.get_rank() == 0 else None}
        reqs = synthetic_requests(4, cfg.vocab_size, MESH_SSM_NEW)
        res["b"] = mesh_generate(mesh, cfg, params, reqs, SERVE_MAX_LEN, clocked=True)
        params = res["b"].pop("params")  # laid out once: (c)'s engine finds it so
        if arch == HYBRID_MESH_ARCH:
            res["c"] = mesh_generate(mesh, cfg, params, mesh_serve_kv_request(cfg), MESH_SERVE_KV_MAX_LEN,
                                     clocked=False)
            res["c"].pop("params")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = res
    return out


def mesh_ssm_readings(ranks_out: list) -> dict:
    """The ranks' runs held to the same models unsharded on the card: per
    arch the training gaps (``mesh_four_gaps``), mamba2's prefill gap
    relative to the unsharded prefill's largest logit, and each serving
    run's logit gaps against the unsharded model fed its tokens."""
    readings = {}
    for arch, *_ in MESH_SSM_CUTS:
        cfg, run, batch = mesh_ssm_model(arch)
        out = [r[arch] for r in ranks_out]
        ref = unsharded_steps(cfg, run, [batch] * 2)
        got = {"train": mesh_four_gaps(out[0]["train"]["metrics"], ref), "ref_train": ref}
        params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
        if "prefill" in out[0]:
            B, S = batch["tokens"].shape
            with torch.inference_mode():
                want, _ = lm.prefill(params, {"tokens": batch["tokens"]}, cfg, NO_SHARD,
                                     lm.init_cache(cfg, B, S, device=DEV))
            want = want.float().cpu()
            got["prefill"] = float((out[0]["prefill"]["logits"] - want).abs().max() / want.abs().max())
        for case, max_len in (("b", SERVE_MAX_LEN), ("c", MESH_SERVE_KV_MAX_LEN)):
            if case in out[0]:
                runs = [r[case] for r in out]
                tf = teacher_forced(cfg, params, runs[0]["log"], max_len, batch_groups(runs[0]["rules"][0]))
                got[case] = logit_gaps(runs[0]["log"], tf)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        readings[arch] = got
    return readings


def mesh_ssm_families() -> dict:
    """Phase 17: the ssm and hybrid families over a mesh, (a) world size 1
    over NCCL, (b) and (c) 4 ranks sharing the card over gloo.  Returns
    the launches of all three, summed over the ranks."""
    t0 = time.perf_counter()
    card = smi()
    total = collections.Counter()
    full = {a: registry.get_config(a) for a in (SSM_MESH_ARCH, HYBRID_MESH_ARCH)}
    cuts = ", ".join(f"{a} depth {full[a].num_layers} -> {n} layers, training batch {b} x {s}"
                     for a, n, b, s in MESH_SSM_CUTS)
    print(f"phase 17 (the ssm and hybrid families over a mesh, {card}): at full width; (a) {HYBRID_MESH_ARCH} all "
          f"{full[HYBRID_MESH_ARCH].num_layers} layers serving phase 10's first batch, {SSM_MESH_ARCH} all "
          f"{full[SSM_MESH_ARCH].num_layers} layers, {MESH_SSM_ONE_STEPS} steps at {TRAIN_BATCH} x {TRAIN_SEQ}; "
          f"reduced: (b) {cuts}, 2 steps, 4 requests, {MESH_SSM_NEW} new tokens; (c) one {MESH_SERVE_KV_PROMPT}-token "
          f"prompt, max_len {MESH_SERVE_KV_MAX_LEN}, {MESH_SERVE_KV_STEPS} decode steps; widths as published")
    if not PHASE10_FIRST:
        fail("phase 17 (a): phase 10 kept no tokens for Zamba2's first batch")
    base = torch.cuda.memory_allocated()
    env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # the rank's deterministic first steps
    try:
        (one,) = rt_ranks.run_ranks(mesh_ssm_world_one, (1, 1, 1), MESH_NAMES, backend="nccl", device="cuda")
    finally:
        if env_before is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
    allocated_back(base, "phase 17 (a)'s rank", phase=17)
    serve, train = one["serve"], one["train"]
    log = serve["log"]
    gap = max(float((f["logits"] - w).abs().max()) for f, w in zip(log, PHASE10_FIRST["logits"]))
    decode_ms = [f["ms"] for f in log[1:]]
    print(f"  (a) world size 1 over nccl, mesh (1, 1, 1), {serve['rules']}, in_proj stored {serve['placements']}: "
          f"{HYBRID_MESH_ARCH} tokens equal phase 10's {serve['tokens'] == PHASE10_FIRST['tokens']}; largest logit "
          f"gap to phase 10 {gap!r} over {len(log)} forwards; K1 {sorted({f['k1'] for f in log})} a forward, K5 "
          f"{serve['launches'].get('sort_pairs_tile_tagged', 0)}; prefill {log[0]['ms']:.3f} ms, decode "
          f"{statistics.median(decode_ms):.3f} ms a step (median of {len(decode_ms)}; min {min(decode_ms):.3f}, "
          f"max {max(decode_ms):.3f}) synchronised; max allocated {max(f['peak'] for f in log) / 2**30:.2f} GiB")
    if serve["tokens"] != PHASE10_FIRST["tokens"]:
        fail(f"phase 17 (a): the tokens differ from phase 10's: {serve['tokens']} vs {PHASE10_FIRST['tokens']}")
    if any(f["k1"] for f in log) or serve["launches"].get("sort_pairs_tile_tagged") != 1:
        fail(f"phase 17 (a): K1 a forward {[f['k1'] for f in log]} (not 0), launches {serve['launches']}")
    ms, plain = train["metrics"], train["plain"]
    losses = [m["loss"] for m in ms]
    print(f"  (a) {SSM_MESH_ARCH} {train['rules']}: losses {[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(m['grad_norm'], 4) for m in ms]}; step ms (synchronised) {[round(w, 1) for w in train['walls']]} "
          f"(steps 2-3 without deterministic algorithms), max allocated {train['peak'] / 2**30:.2f} GiB; step 1 "
          f"against the unsharded step on the same state and batch: loss {ms[0]['loss']!r} vs {plain['loss']!r}, "
          f"grad_norm {ms[0]['grad_norm']!r} vs {plain['grad_norm']!r}; bits equal "
          f"{train['first_bits'] == tuple(plain['bits'])}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 17 (a): a loss is not finite: {losses}")
    if train["first_bits"] != tuple(plain["bits"]):
        fail("phase 17 (a): step 1's loss or grad_norm differs in bits from the unsharded step's")
    total.update(one["launches"])

    t_ranks = time.perf_counter()
    ranks_out = rt_ranks.run_ranks(mesh_ssm_four_ranks, MESH_FOUR, MESH_NAMES, backend="gloo", device="cuda")
    print(f"  (b), (c): the 4 ranks took {time.perf_counter() - t_ranks:.1f} s")
    before = launch_counts()
    readings = mesh_ssm_readings(ranks_out)
    total.update({k: v - before[k] for k, v in launch_counts().items()})
    for arch, n_layers, B, S in MESH_SSM_CUTS:
        out = [r[arch] for r in ranks_out]
        cfg = registry.get_config(arch).replace(num_layers=n_layers)
        tr, gap = out[0]["train"], readings[arch]["train"]
        coll = [r["train"]["coll_ms"] for r in out]
        share = "not measured" if coll[0] is None else round(max(coll) / max(r["train"]["walls"][0] for r in out), 3)
        hb = head_split_bytes(cfg, B // batch_groups(("data",)), S, MESH_FOUR[2], tr["rules"][0] is not None)
        print(f"  (b) {arch} on {MESH_FOUR}, rules (seq, heads) {tr['rules']}: 2 steps of {B} x {S}: losses "
              f"{[m['loss'] for m in tr['metrics']]!r}, grad_norm {[m['grad_norm'] for m in tr['metrics']]!r}; "
              f"unsharded on the card: losses {[m['loss'] for m in readings[arch]['ref_train']]!r}; relative gaps: "
              f"step 1's loss {gap['loss']:.3e}, grad_norm {gap['grad_norm']:.3e}, the loss step 1's update took "
              f"off {gap['drop']:.3e} (limits {MESH_SSM_GAP}); step ms (slowest rank): step 1 clocked "
              f"{max(r['train']['walls'][0] for r in out):.1f}, {share} of it in DTensor's redistributions; step 2 "
              f"{max(r['train']['walls'][1] for r in out):.1f}; max allocated by rank "
              f"{[round(r['train']['peak'] / 2**30, 2) for r in out]} GiB; the head split moves "
              f"{hb['total'] / 2**20:.1f} MiB into each rank a layer's forward ({ {k: round(v / 2**20, 2) for k, v in hb.items()} } MiB)")
        if not all(math.isfinite(m["loss"]) for r in out for m in r["train"]["metrics"]):
            fail(f"phase 17 (b) {arch}: a loss is not finite")
        if any(r["train"]["metrics"] != tr["metrics"] for r in out):
            fail(f"phase 17 (b) {arch}: the ranks report different metrics")
        if not all(gap[k] <= MESH_SSM_GAP[k] for k in MESH_SSM_GAP):
            fail(f"phase 17 (b) {arch}: the gaps {gap} to the unsharded steps pass the limits {MESH_SSM_GAP}")
        if "prefill" in out[0]:
            pg = readings[arch]["prefill"]
            print(f"  (b) {arch} prefill of the {B} x {S} batch under the prefill rules (seq, heads) "
                  f"{out[0]['prefill']['rules']}: {max(r['prefill']['ms'] for r in out):.1f} ms (slowest rank); "
                  f"last logits' gap to the unsharded prefill {pg:.3e} relative (limit "
                  f"{MESH_SSM_SERVE_GAP['prefill']})")
            if not pg <= MESH_SSM_SERVE_GAP["prefill"]:
                fail(f"phase 17 (b) {arch}: the prefill's logit gap {pg} passes {MESH_SSM_SERVE_GAP['prefill']}")
        for case in ("b", "c"):
            if case not in out[0]:
                continue
            runs = [r[case] for r in out]
            g = readings[arch][case]
            slow = [max(r["log"][i]["ms"] for r in runs) for i in range(len(runs[0]["log"]))]
            share = ("" if runs[0]["coll_ms"] is None else
                     f", {max(r['coll_ms'] for r in runs) / max(r['wall'] for r in runs):.3f} of the generate in "
                     f"DTensor's redistributions (clocked, synchronised)")
            print(f"  ({case}) {arch} serving, rules (batch, kv_seq) {runs[0]['rules']}: {len(runs[0]['tokens'])} "
                  f"requests; relative logit gaps to the unsharded model fed the same tokens: prefill "
                  f"{g['prefill']:.3e}, decode steps {[f'{v:.3e}' for v in g['steps'][1:]]}, median "
                  f"{g['decode_median']:.3e} (limits {MESH_SSM_SERVE_GAP}); slowest rank: prefill {slow[0]:.1f} ms, "
                  f"decode {statistics.median(slow[1:]):.1f} ms a step, generate {max(r['wall'] for r in runs):.1f} "
                  f"ms{share}; max allocated by rank "
                  f"{[round(max(f['peak'] for f in r['log']) / 2**30, 2) for r in runs]} GiB")
            mesh_four_serving_checks(f"{case}, {arch}", runs, g, 0, MESH_SSM_SERVE_GAP, phase=17)
            for r in runs:
                total.update(r["launches"])
    print(f"phase 17 (the ssm and hybrid families over a mesh): {time.perf_counter() - t0:.1f} s; launches "
          f"{dict(total)}")
    return dict(total)


# ---------------------------------------------------------------- phase 18
ENCDEC_MESH_ARCH, VLM_MESH_ARCH = FAMILY_ARCHS[2], FAMILY_ARCHS[3]
MESH_ENCDEC_ONE_STEPS = 3
# (a)'s training: (arch, layers (None: all), batch, sequence); qwen2-vl's 2 of 28 layers carry 1.56 B
# counted weights (two untied 545 M tables), 25 GiB of float32 state before activations
MESH_ENCDEC_ONE_TRAIN = ((ENCDEC_MESH_ARCH, None, 8, 448), (VLM_MESH_ARCH, 2, 2, 2048))
# (b): (arch, layers (None: all), batch, sequence, steps on one batch) on (1, 2, 2) over 4 ranks sharing
# the card; qwen2-vl's rows hold 1,024 vision tokens each
MESH_ENCDEC_CUTS = ((ENCDEC_MESH_ARCH, None, 4, 448, 2), (VLM_MESH_ARCH, 2, 4, 1280, 1))
MESH_ENCDEC_NEW = 8  # whisper-tiny's new tokens a request in (b)
MESH_VLM_DECODE = 2  # qwen2-vl's decode steps after its vision prefill in (b)
MESH_ENCDEC_KV_PROMPT, MESH_ENCDEC_KV_MAX_LEN, MESH_ENCDEC_KV_STEPS = 448, 512, 4  # (c): batch 1, kv_seq
# (b)'s and (c)'s limits against the same models unsharded on the card, as phase 17's: training, relative,
# step 1's loss and grad_norm and (whisper-tiny) the loss step 1's update took off its batch; serving, each
# forward's largest logit gap relative to the unsharded logits' largest magnitude.  Each lies between the
# sound runs' readings and the planted faults' that it catches (tools/mesh_fault_readings.py --path encdec,
# PERF.md; H100 80GB HBM3, 700 W).  Training, sound whisper-tiny / qwen2-vl-7b: loss 2.2e-5 / 4.0e-6,
# grad_norm 2.6e-3 / 2.0e-4, drop 6.8e-4 (whisper-tiny); cross K/V from another rank's heads 5.4e-2, 6.0e-2,
# 0.11; the vision splice of the first rows grad_norm 0.18 (the first rows' M-RoPE positions, 1.5e-5 and
# 5.4e-4, stay under: the prefill catches them).  Serving, sound prefill / worst decode / decode median at
# most 1.15e-2, 1.12e-2, 1.06e-2 over (b) and (c); the M-RoPE positions of the first rows 0.27, 0.27, 0.25;
# (c)'s cross slice without lse_combine -, 0.10, 0.10; cross K/V and the splice 0.85-1.08
MESH_ENCDEC_GAP = {"loss": 1e-3, "grad_norm": 1.5e-2, "drop": 1e-2}
MESH_ENCDEC_SERVE_GAP = {"prefill": 0.05, "decode": 0.03, "decode_median": 0.03}


def vision_rows(cfg, batch: dict) -> dict:
    """A vlm ``batch`` with its (3, B, S) M-RoPE positions made row by row:
    row r's image (the first ``vision_tokens`` positions) at temporal id r
    on a patch grid ``VLM_GRID`` wide for even rows and half as wide for
    odd ones, the text after it at its index on all three axes; so a rank
    that rotated by another rank's rows would show.  Another family's
    batch as it is."""
    if cfg.family != "vlm":
        return batch
    thw = batch["positions_thw"].clone()
    V = cfg.vision_tokens
    idx = torch.arange(V, device=thw.device, dtype=thw.dtype)
    for r in range(thw.shape[1]):
        w = VLM_GRID >> (r % 2)
        thw[0, r, :V], thw[1, r, :V], thw[2, r, :V] = r, idx // w, idx % w
    return dict(batch, positions_thw=thw)


def prefill_bits(cfg, api, params, mesh) -> dict:
    """Phase 10 (c)'s float32 prefill (2 rows of ``S`` - 2 tokens with the
    family's inputs, ``family_inputs``; no TF32) over ``mesh`` and
    unsharded: whether the last logits and every cache leaf agree in bits."""
    f32 = cfg.replace(dtype=torch.float32)
    B, S = 2, {"encdec": 24, "vlm": VLM_CHECK_LEN}[cfg.family]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))).to(DEV)
    batch = {"tokens": toks[:, : S - 2], **family_inputs(cfg)(B, S)}
    if "positions_thw" in batch:
        batch["positions_thw"] = batch["positions_thw"][:, :, : S - 2]
    rules = sharding.rules_for(f32, ShapeConfig("prefill", S - 2, B, "prefill"), mesh)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want, wcache = api.prefill(params, batch, f32, NO_SHARD, api.init_cache(f32, B, S + 4, device=DEV))
            with set_mesh(mesh):
                got, gcache = api.prefill(params, batch, f32, rules, api.init_cache(f32, B, S + 4, device=DEV))
            leaves = [(whole(g), w) for g, w in zip(tree_leaves(gcache), tree_leaves(wcache))]
            same_cache = all(torch.equal(bits(g), bits(w)) for g, w in leaves)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"S": S - 2, "logits": torch.equal(bits(got), bits(want)), "cache": same_cache,
            "gap": float((got - want).abs().max()), "extras": sorted(k for k in batch if k != "tokens")}


def mesh_encdec_world_one(mesh) -> dict:
    """Phase 18 (a), the one rank of an NCCL group on (1, 1, 1): whisper-tiny
    and qwen2-vl-7b at full width, all layers, float32 weights from phase
    10's seed, each served through ``ServeEngine(rules=...)`` for phase
    10's first batch, then phase 10 (c)'s float32 prefill over the mesh
    against the unsharded one; then 3 training steps of each through
    ``jit_train_step(mesh=...)`` (whisper-tiny all layers, 8 x 448;
    qwen2-vl-7b 2 of 28 layers, 2 x 2,048 with 1,024 vision tokens a row),
    first the unsharded step on the same state and batch, both first steps
    under deterministic algorithms."""
    out = {}
    reset_launches()
    for arch in (ENCDEC_MESH_ARCH, VLM_MESH_ARCH):
        cfg = registry.get_config(arch)
        api = registry.get_model_api(cfg)
        reqs = synthetic_requests(SERVE_BATCHES[0], cfg.vocab_size, SERVE_NEW_TOKENS)
        params = api.init(cfg, torch.Generator(device=DEV).manual_seed(0))
        rules = sharding.rules_for(cfg, ShapeConfig("serve", SERVE_MAX_LEN, len(reqs), "decode"), mesh)
        with set_mesh(mesh):
            eng = ServeEngine(cfg, params, api, rules=rules, max_len=SERVE_MAX_LEN)
        log: list = []
        forward_log(eng, log)
        before = launch_counts()
        toks = eng.generate(reqs)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        del eng
        out[arch] = {"serve": {"tokens": toks, "log": log, "launches": launches, "rules": str(rules),
                               "prefill_bits": prefill_bits(cfg, api, params, mesh)}}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for arch, n_layers, B, S in MESH_ENCDEC_ONE_TRAIN:
        cfg = registry.get_config(arch)
        cfg = cfg.replace(num_layers=n_layers) if n_layers else cfg
        api = registry.get_model_api(cfg)
        run = mesh_run(cfg, B, S)
        data = SyntheticLMData(cfg, B, S, seed=0, device=DEV)
        batches = [vision_rows(cfg, data.next_batch()) for _ in range(MESH_ENCDEC_ONE_STEPS)]
        torch.use_deterministic_algorithms(True)
        (plain,) = unsharded_steps(cfg, run, batches[:1])
        state = init_train_state(torch.Generator(device=DEV).manual_seed(0), cfg, run, api)
        rules, sspecs, bspecs = sharding.train_specs(cfg, run.shape, run, mesh, state["params"])
        step = jit_train_step(make_train_step(cfg, run, api, rules), mesh, sspecs, bspecs)
        torch.cuda.reset_peak_memory_stats()
        metrics, walls = [], []
        for i, batch in enumerate(batches):
            if i == 1:
                torch.use_deterministic_algorithms(False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first_bits = (int(bits(m["loss"])), int(bits(m["grad_norm"])))
        torch.use_deterministic_algorithms(False)
        out[arch]["train"] = {"plain": plain, "metrics": metrics, "first_bits": first_bits, "walls": walls,
                              "peak": torch.cuda.max_memory_allocated(), "layers": cfg.num_layers,
                              "counted": lm.counted_params(state["params"]), "shape": (B, S)}
        del state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(launch_counts())
    return out


def mesh_encdec_model(arch: str):
    """(b)'s cut of ``arch``: (config, run, its one batch, steps)."""
    _, n_layers, batch, seq, steps = next(c for c in MESH_ENCDEC_CUTS if c[0] == arch)
    cfg = registry.get_config(arch)
    cfg = cfg.replace(num_layers=n_layers) if n_layers else cfg
    data = SyntheticLMData(cfg, batch, seq, seed=0, device=DEV)
    return cfg, mesh_run(cfg, batch, seq), vision_rows(cfg, data.next_batch()), steps


def mesh_vision_serve(mesh, cfg, params, batch: dict, steps: int = MESH_VLM_DECODE,
                      max_len: "int | None" = None, prefill_rules=None) -> dict:
    """A prefill of ``batch``'s rows with their family's inputs (vision or
    encoder) under ``prefill_rules`` (default the prefill rules of
    ``rules_for``), then ``steps`` greedy decode steps under the decode
    rules, into a cache of ``max_len`` (default the prompt and the
    steps); each forward logged as ``forward_log`` logs it."""
    api = registry.get_model_api(cfg)
    B, S = batch["tokens"].shape
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    log: list = []

    def logged(kind, fn, tokens):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = fn()
        torch.cuda.synchronize()
        log.append({"kind": kind, "ms": (time.perf_counter() - t0) * 1e3, "k1": 0,
                    "peak": torch.cuda.max_memory_allocated(), "tokens": tokens.cpu(), "logits": logits.float().cpu()})
        return logits, cache

    reset_launches()
    with set_mesh(mesh):
        rules = prefill_rules or sharding.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
        cache = api.init_cache(cfg, B, max_len or S + steps, device=DEV)
        prefill_rules = rules
        logits, cache = logged("prefill", lambda: api.prefill(params, prompt, cfg, rules, cache), batch["tokens"])
        rules = sharding.rules_for(cfg, ShapeConfig("decode", S, B, "decode"), mesh)
        for j in range(steps):
            tok = torch.argmax(logits, -1)[:, None]
            logits, cache = logged("decode", lambda: api.decode_step(params, tok, cfg, rules, cache, S + j), tok)
    if torch.distributed.get_rank():
        for f in log:
            f.pop("logits")
    return {"tokens": [f["tokens"].tolist() for f in log[1:]], "log": log, "launches": dict(launch_counts()),
            "rules": (rules.batch, rules.kv_seq), "prefill_rules": (prefill_rules.heads, prefill_rules.seq,
                                                                    prefill_rules.kv_seq)}


def mesh_encdec_four_ranks(mesh) -> dict:
    """Phase 18 (b) and (c) on one of 4 ranks sharing the card over gloo,
    mesh (1, 2, 2): whisper-tiny at full depth trained 2 steps on one batch
    of 4 x 448 tokens, serving 4 requests of the launcher's mix, then (c)
    one 448-token request at ``max_len`` 512 (``kv_seq="data"``: the self
    and the cross caches split along their sequence, 750 frames a rank);
    qwen2-vl-7b (2 of 28 layers) one step on 4 x 1,280 tokens (1,024
    vision tokens a row), then a prefill of that batch with its vision
    inputs and ``MESH_VLM_DECODE`` decode steps."""
    out = {}
    for arch, *_ in MESH_ENCDEC_CUTS:
        cfg, run, batch, steps = mesh_encdec_model(arch)
        res = {"train": mesh_steps(mesh, cfg, run, batch, steps)}
        gc.collect()
        torch.cuda.empty_cache()
        params = registry.get_model_api(cfg).init(cfg, torch.Generator(device=DEV).manual_seed(0))
        if arch == ENCDEC_MESH_ARCH:
            reqs = synthetic_requests(4, cfg.vocab_size, MESH_ENCDEC_NEW)
            res["b"] = mesh_generate(mesh, cfg, params, reqs, SERVE_MAX_LEN, clocked=True)
            params = res["b"].pop("params")  # laid out once: (c)'s engine finds it so
            kv = mesh_serve_kv_request(cfg, MESH_ENCDEC_KV_PROMPT, MESH_ENCDEC_KV_STEPS)
            res["c"] = mesh_generate(mesh, cfg, params, kv, MESH_ENCDEC_KV_MAX_LEN, clocked=False)
            res["c"].pop("params")
        else:
            B, S = batch["tokens"].shape
            rules = sharding.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
            params = lay_out(params, sharding.param_layout(cfg, rules, mesh, params), mesh)  # each rank its shard
            gc.collect()
            torch.cuda.empty_cache()
            res["b"] = mesh_vision_serve(mesh, cfg, params, batch)
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = res
    return out


def mesh_encdec_readings(ranks_out: list) -> dict:
    """The ranks' runs held to the same models unsharded on the card: per
    arch the training gaps (``mesh_four_gaps``) and each serving run's
    logit gaps against the unsharded model fed its inputs and tokens."""
    readings = {}
    for arch, *_ in MESH_ENCDEC_CUTS:
        cfg, run, batch, steps = mesh_encdec_model(arch)
        out = [r[arch] for r in ranks_out]
        ref = unsharded_steps(cfg, run, [batch] * steps)
        got = {"train": mesh_four_gaps(out[0]["train"]["metrics"], ref), "ref_train": ref}
        params = registry.get_model_api(cfg).init(cfg, torch.Generator(device=DEV).manual_seed(0))
        if arch == ENCDEC_MESH_ARCH:
            for case, max_len in (("b", SERVE_MAX_LEN), ("c", MESH_ENCDEC_KV_MAX_LEN)):
                runs = [r[case] for r in out]
                tf = teacher_forced(cfg, params, runs[0]["log"], max_len, batch_groups(runs[0]["rules"][0]))
                got[case] = logit_gaps(runs[0]["log"], tf)
        else:
            inputs = {k: batch[k] for k in ("vision_embeds", "positions_thw")}
            B, S = batch["tokens"].shape
            tf = teacher_forced(cfg, params, out[0]["b"]["log"], S + MESH_VLM_DECODE, inputs=inputs)
            got["b"] = logit_gaps(out[0]["b"]["log"], tf)
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        readings[arch] = got
    return readings


def mesh_encdec_families() -> dict:
    """Phase 18: the encdec and vlm families over a mesh, (a) world size 1
    over NCCL, (b) and (c) 4 ranks sharing the card over gloo.  Returns
    the launches of all three, summed over the ranks."""
    t0 = time.perf_counter()
    card = smi()
    total = collections.Counter()
    full = {a: registry.get_config(a) for a in (ENCDEC_MESH_ARCH, VLM_MESH_ARCH)}
    cuts = ", ".join(f"{a} {'all ' + str(full[a].num_layers) if n is None else f'depth {full[a].num_layers} -> {n}'} "
                     f"layers, {k} step(s) of {b} x {s}" for a, n, b, s, k in MESH_ENCDEC_CUTS)
    trains = ", ".join(f"{a} ({'all' if n is None else f'depth {full[a].num_layers} -> {n}'} layers, {b} x {s})"
                       for a, n, b, s in MESH_ENCDEC_ONE_TRAIN)
    print(f"phase 18 (the encdec and vlm families over a mesh, {card}): at full width; (a) {ENCDEC_MESH_ARCH} and "
          f"{VLM_MESH_ARCH} all layers serving phase 10's first batch, phase 10 (c)'s prefill over the mesh, "
          f"{MESH_ENCDEC_ONE_STEPS} steps of {trains}; reduced: (b) {cuts}; {MESH_ENCDEC_NEW} new "
          f"tokens a request ({ENCDEC_MESH_ARCH}), a vision prefill and {MESH_VLM_DECODE} decode steps "
          f"({VLM_MESH_ARCH}); (c) one {MESH_ENCDEC_KV_PROMPT}-token prompt, max_len {MESH_ENCDEC_KV_MAX_LEN}, "
          f"{MESH_ENCDEC_KV_STEPS} decode steps; widths as published")
    missing = [a for a in (ENCDEC_MESH_ARCH, VLM_MESH_ARCH) if not PHASE10_KEPT.get(a)]
    if missing:
        fail(f"phase 18 (a): phase 10 kept no tokens for {missing}")
    base = torch.cuda.memory_allocated()
    env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # the rank's deterministic first steps
    try:
        (one,) = rt_ranks.run_ranks(mesh_encdec_world_one, (1, 1, 1), MESH_NAMES, backend="nccl", device="cuda")
    finally:
        if env_before is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
    allocated_back(base, "phase 18 (a)'s rank", phase=18)
    for arch in (ENCDEC_MESH_ARCH, VLM_MESH_ARCH):
        serve, kept = one[arch]["serve"], PHASE10_KEPT[arch]
        log, pb = serve["log"], serve["prefill_bits"]
        gap = max(float((f["logits"] - w).abs().max()) for f, w in zip(log, kept["logits"]))
        decode_ms = [f["ms"] for f in log[1:]]
        print(f"  (a) world size 1 over nccl, mesh (1, 1, 1), {serve['rules']}: {arch} tokens equal phase 10's "
              f"{serve['tokens'] == kept['tokens']}; largest logit gap to phase 10 {gap!r} over {len(log)} forwards; "
              f"K1 {sum(f['k1'] for f in log)}, K5 {serve['launches'].get('sort_pairs_tile_tagged', 0)}; prefill "
              f"{log[0]['ms']:.3f} ms, decode {statistics.median(decode_ms):.3f} ms a step (median of {len(decode_ms)}; "
              f"min {min(decode_ms):.3f}, max {max(decode_ms):.3f}) synchronised; max allocated "
              f"{max(f['peak'] for f in log) / 2**30:.2f} GiB; phase 10 (c)'s float32 prefill of 2 x {pb['S']} tokens "
              f"with {pb['extras']} over the mesh against the unsharded one: logits equal in bits {pb['logits']}, "
              f"every cache leaf {pb['cache']} (largest gap {pb['gap']!r})")
        if serve["tokens"] != kept["tokens"] or gap != 0.0:
            fail(f"phase 18 (a) {arch}: tokens or logits differ from phase 10's (largest gap {gap})")
        if any(f["k1"] for f in log) or serve["launches"].get("sort_pairs_tile_tagged") != 1:
            fail(f"phase 18 (a) {arch}: K1 a forward {[f['k1'] for f in log]} (not 0), launches {serve['launches']}")
        if not (pb["logits"] and pb["cache"]):
            fail(f"phase 18 (a) {arch}: the prefill over the mesh differs in bits from the unsharded one: {pb}")
    for arch, *_ in MESH_ENCDEC_ONE_TRAIN:
        train = one[arch]["train"]
        ms, plain = train["metrics"], train["plain"]
        losses = [m["loss"] for m in ms]
        print(f"  (a) {arch} training, {train['layers']} layers ({train['counted']:,} counted weights), "
              f"{train['shape'][0]} x {train['shape'][1]}: losses {[round(x, 4) for x in losses]}, grad_norm "
              f"{[round(m['grad_norm'], 4) for m in ms]}; step ms (synchronised) {[round(w, 1) for w in train['walls']]} "
              f"(steps 2-3 without deterministic algorithms), max allocated {train['peak'] / 2**30:.2f} GiB; step 1 "
              f"against the unsharded step on the same state and batch: loss {ms[0]['loss']!r} vs {plain['loss']!r}, "
              f"grad_norm {ms[0]['grad_norm']!r} vs {plain['grad_norm']!r}; bits equal "
              f"{train['first_bits'] == tuple(plain['bits'])}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"phase 18 (a) {arch}: a loss is not finite: {losses}")
        if train["first_bits"] != tuple(plain["bits"]):
            fail(f"phase 18 (a) {arch}: step 1's loss or grad_norm differs in bits from the unsharded step's")
        if train["peak"] > TRAIN_MEMORY_LIMIT:
            fail(f"phase 18 (a) {arch}: max allocated {train['peak'] / 2**30:.2f} GiB past 75 GiB")
    total.update(one["launches"])

    t_ranks = time.perf_counter()
    ranks_out = rt_ranks.run_ranks(mesh_encdec_four_ranks, MESH_FOUR, MESH_NAMES, backend="gloo", device="cuda")
    print(f"  (b), (c): the 4 ranks took {time.perf_counter() - t_ranks:.1f} s")
    before = launch_counts()
    readings = mesh_encdec_readings(ranks_out)
    total.update({k: v - before[k] for k, v in launch_counts().items()})
    for arch, n_layers, B, S, steps in MESH_ENCDEC_CUTS:
        out = [r[arch] for r in ranks_out]
        tr, gap = out[0]["train"], readings[arch]["train"]
        coll = [r["train"]["coll_ms"] for r in out]
        share = "not measured" if coll[0] is None else round(max(coll) / max(r["train"]["walls"][0] for r in out), 3)
        print(f"  (b) {arch} on {MESH_FOUR}, rules (seq, heads) {tr['rules']}: {steps} step(s) of {B} x {S}: losses "
              f"{[m['loss'] for m in tr['metrics']]!r}, grad_norm {[m['grad_norm'] for m in tr['metrics']]!r}; "
              f"unsharded on the card: losses {[m['loss'] for m in readings[arch]['ref_train']]!r}; relative gaps "
              f"{ {k: f'{v:.3e}' for k, v in gap.items()} } (limits {MESH_ENCDEC_GAP}); step ms (slowest rank): "
              f"step 1 clocked {max(r['train']['walls'][0] for r in out):.1f}, {share} of it in DTensor's "
              f"redistributions{'; step 2 ' + format(max(r['train']['walls'][1] for r in out), '.1f') if steps > 1 else ''}; "
              f"max allocated by rank {[round(r['train']['peak'] / 2**30, 2) for r in out]} GiB")
        if not all(math.isfinite(m["loss"]) for r in out for m in r["train"]["metrics"]):
            fail(f"phase 18 (b) {arch}: a loss is not finite")
        if any(r["train"]["metrics"] != tr["metrics"] for r in out):
            fail(f"phase 18 (b) {arch}: the ranks report different metrics")
        if not all(gap[k] <= MESH_ENCDEC_GAP[k] for k in gap):
            fail(f"phase 18 (b) {arch}: the gaps {gap} to the unsharded steps pass the limits {MESH_ENCDEC_GAP}")
        for case in ("b", "c"):
            if case not in out[0]:
                continue
            runs = [r[case] for r in out]
            g = readings[arch][case]
            slow = [max(r["log"][i]["ms"] for r in runs) for i in range(len(runs[0]["log"]))]
            share = ("" if runs[0].get("coll_ms") is None else
                     f", {max(r['coll_ms'] for r in runs) / max(r['wall'] for r in runs):.3f} of the generate in "
                     f"DTensor's redistributions (clocked, synchronised)")
            what = "a vision prefill of the batch" if arch == VLM_MESH_ARCH else f"{len(runs[0]['tokens'])} requests"
            print(f"  ({case}) {arch} serving, rules (batch, kv_seq) {runs[0]['rules']}: {what}; relative logit gaps to "
                  f"the unsharded model fed the same inputs: prefill {g['prefill']:.3e}, decode steps "
                  f"{[f'{v:.3e}' for v in g['steps'][1:]]}, median {g['decode_median']:.3e} (limits "
                  f"{MESH_ENCDEC_SERVE_GAP}); slowest rank: prefill {slow[0]:.1f} ms, decode "
                  f"{statistics.median(slow[1:]):.1f} ms a step{share}; max allocated by rank "
                  f"{[round(max(f['peak'] for f in r['log']) / 2**30, 2) for r in runs]} GiB")
            if arch == VLM_MESH_ARCH:  # no generate: no K5; the same gates otherwise
                if any(r["tokens"] != runs[0]["tokens"] for r in runs):
                    fail(f"phase 18 ({case}) {arch}: the ranks emitted different tokens")
                if any(r["launches"].get("bucket_count_rank", 0) for r in runs):
                    fail(f"phase 18 ({case}) {arch}: K1 launched: {[r['launches'] for r in runs]}")
                if not all(g[k] <= MESH_ENCDEC_SERVE_GAP[k] for k in MESH_ENCDEC_SERVE_GAP):
                    fail(f"phase 18 ({case}) {arch}: the logit gaps {g} pass the limits {MESH_ENCDEC_SERVE_GAP}")
            else:
                mesh_four_serving_checks(f"{case}, {arch}", runs, g, 0, MESH_ENCDEC_SERVE_GAP, phase=18)
            for r in runs:
                total.update(r["launches"])
    print(f"phase 18 (the encdec and vlm families over a mesh): {time.perf_counter() - t0:.1f} s; launches "
          f"{dict(total)}")
    return dict(total)


# ---------------------------------------------------------------- phase 19
SP_DENSE_ARCH = "gemma3-4b"  # 8 heads and 4 KV heads: SP on the production (16, 16) mesh
SP_ONE_RULES = {"heads": None, "seq": "model"}  # (a): the production mesh's SP rules, by hand on one rank
SP_ONE_SERVE_RULES = dict(SP_ONE_RULES, kv_seq="model")  # with the cache split as the prefill rules split it
# (b) on (1, 1, 4) over 4 ranks sharing the card: (arch, layers (None: all), batch, sequence); whisper-tiny's
# 6 heads give SP under rules_for itself, gemma3-4b takes the production rules by hand (its 8 heads divide 4)
MESH_SP_FOUR = (1, 1, 4)
MESH_SP_CUTS = ((ENCDEC_MESH_ARCH, None, 4, 448), (SP_DENSE_ARCH, 2, 2, 2048))
MESH_SP_DECODE = 3  # whisper-tiny's decode steps after its prefill in (b)
PHASE15_PLAIN: dict = {}  # phase 15 (a)'s unsharded first step (metrics and bits), which phase 19 (a) is held to
# (b)'s limits against the same models unsharded on the card, as phase 18's: training, relative, step 1's loss
# and grad_norm, by arch; serving, each forward's largest logit gap relative to the unsharded logits' largest
# magnitude.  Each lies between the sound runs' readings and the planted faults' that it catches
# (tools/mesh_fault_readings.py --path sp, PERF.md; H100 80GB HBM3, 700 W).  Sound whisper-tiny / gemma3-4b:
# loss 0.0 / 0.0, grad_norm 2.5e-3 / 5.2e-6; q_offset 0: 1.0e-2, 7.6e-3 / 2.6e-3, 7.4e-2; K/V not gathered:
# 5.3e-3, 0.10 / 1.8e-4, 5.4e-2; positions from 0: 7.0e-3, 5.3e-2 / 1.1e-4, 6.7e-3.  Serving, sound prefill /
# worst decode / decode median 0.0, 7.1e-3, 6.9e-3; the three faults 0.35-0.55, 0.18-0.33, 0.18-0.32
MESH_SP_GAP = {ENCDEC_MESH_ARCH: {"loss": 1e-3, "grad_norm": 1.5e-2}, SP_DENSE_ARCH: {"loss": 1e-3, "grad_norm": 1e-3}}
MESH_SP_SERVE_GAP = {"prefill": 0.05, "decode": 0.03, "decode_median": 0.03}


def sp_rules(cfg, shape, mesh, serve: bool = False):
    """``rules_for``'s batch, FSDP and tensor axes on ``mesh`` with the
    production mesh's sequence parallelism by hand (``SP_ONE_RULES``,
    and the cache's ``kv_seq`` for serving)."""
    return dataclasses.replace(sharding.rules_for(cfg, shape, mesh), **(SP_ONE_SERVE_RULES if serve else SP_ONE_RULES))


def mesh_sp_world_one(mesh) -> dict:
    """Phase 19 (a), the one rank of an NCCL group on (1, 1, 1), under the
    production mesh's SP rules by hand: phase 15 (a)'s DeepSeek-V2-Lite cut
    (4 layers, 2 x 4,096 tokens, ``shard_map`` dispatch) one step through
    ``jit_train_step(mesh=...)`` on phase 15 (a)'s first state and batch,
    under deterministic algorithms; then gemma3-4b at full width, all
    layers, float32 weights from seed 0, phase 9's first batch served
    unsharded and through ``ServeEngine(rules=...)`` (the cache split as
    ``kv_seq``)."""
    out = {}
    cfg = registry.get_config(MESH_ARCH).replace(num_layers=TRAIN_LAYERS)
    run = mesh_run(cfg, TRAIN_BATCH, TRAIN_SEQ)
    batch = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEV).next_batch()
    torch.use_deterministic_algorithms(True)
    try:
        state = init_train_state(torch.Generator(device=DEV).manual_seed(0), cfg, run, lm)
        rules, sspecs, bspecs = sharding.train_specs(cfg, run.shape, run, mesh, state["params"],
                                                     sp_rules(cfg, run.shape, mesh))
        step = jit_train_step(make_train_step(cfg, run, lm, rules), mesh, sspecs, bspecs)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["train"] = {"metrics": {k: float(v) for k, v in m.items()}, "ms": (time.perf_counter() - t0) * 1e3,
                        "bits": (int(bits(m["loss"])), int(bits(m["grad_norm"]))), "rules": str(rules),
                        "k1": launch_counts()["bucket_count_rank"], "peak": torch.cuda.max_memory_allocated()}
    finally:
        torch.use_deterministic_algorithms(False)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    cfg = registry.get_config(SP_DENSE_ARCH)
    reqs = synthetic_requests(SERVE_BATCHES[0], cfg.vocab_size, SERVE_NEW_TOKENS)
    params = lm.init(cfg, torch.Generator(device=DEV).manual_seed(0))
    served = {}
    for kind in ("unsharded", "mesh"):
        if kind == "mesh":
            rules = sp_rules(cfg, ShapeConfig("serve", SERVE_MAX_LEN, len(reqs), "prefill"), mesh, serve=True)
            with set_mesh(mesh):
                eng = ServeEngine(cfg, params, lm, rules=rules, max_len=SERVE_MAX_LEN)
        else:
            eng = ServeEngine(cfg, params, lm, max_len=SERVE_MAX_LEN)
        log: list = []
        forward_log(eng, log)
        before = launch_counts()
        toks = eng.generate(reqs)
        served[kind] = {"tokens": toks, "log": log, "launches": {k: v - before[k] for k, v in launch_counts().items()}}
        del eng
    out["serve"] = dict(served["mesh"], plain=served["unsharded"], rules=str(rules),
                        counted=lm.counted_params(params))
    out["launches"] = dict(launch_counts())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_sp_model(arch: str):
    """(b)'s cut of ``arch``: (config, run, its one batch)."""
    _, n_layers, batch, seq = next(c for c in MESH_SP_CUTS if c[0] == arch)
    cfg = registry.get_config(arch)
    cfg = cfg.replace(num_layers=n_layers) if n_layers else cfg
    return cfg, mesh_run(cfg, batch, seq), SyntheticLMData(cfg, batch, seq, seed=0, device=DEV).next_batch()


def mesh_sp_four_ranks(mesh) -> dict:
    """Phase 19 (b) on one of 4 ranks sharing the card over gloo, mesh
    (1, 1, 4): whisper-tiny at full width and depth under ``rules_for`` (6
    heads on 4: SP, its 1,500 encoder frames split too), one step on 4 x
    448 tokens, then a prefill of that batch with its encoder frames under
    the prefill rules (``kv_seq="model"``) and ``MESH_SP_DECODE`` decode
    steps; gemma3-4b at full width, 2 of 34 layers, one step on 2 x 2,048
    tokens under the production rules by hand (its 1,024-wide windows
    cross the 512-token chunks)."""
    out = {}
    cfg, run, batch = mesh_sp_model(ENCDEC_MESH_ARCH)
    res = {"train": mesh_steps(mesh, cfg, run, batch, 1)}
    gc.collect()
    torch.cuda.empty_cache()
    params = registry.get_model_api(cfg).init(cfg, torch.Generator(device=DEV).manual_seed(0))
    B, S = batch["tokens"].shape
    rules = sharding.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
    params = lay_out(params, sharding.param_layout(cfg, rules, mesh, params), mesh)  # each rank its shard
    gc.collect()
    torch.cuda.empty_cache()
    res["b"] = mesh_vision_serve(mesh, cfg, params, batch, MESH_SP_DECODE, S + MESH_SP_DECODE + 1)
    out[ENCDEC_MESH_ARCH] = res
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    cfg, run, batch = mesh_sp_model(SP_DENSE_ARCH)
    out[SP_DENSE_ARCH] = {"train": mesh_steps(mesh, cfg, run, batch, 1, sp_rules(cfg, run.shape, mesh))}
    return out


def mesh_sp_readings(ranks_out: list) -> dict:
    """The ranks' runs held to the same models unsharded on the card: per
    arch step 1's training gaps (``mesh_four_gaps``) and whisper-tiny's
    serving gaps against the unsharded model fed its inputs and tokens."""
    readings = {}
    for arch, *_ in MESH_SP_CUTS:
        cfg, run, batch = mesh_sp_model(arch)
        out = [r[arch] for r in ranks_out]
        ref = unsharded_steps(cfg, run, [batch])
        got = {"train": mesh_four_gaps(out[0]["train"]["metrics"], ref), "ref_train": ref}
        if "b" in out[0]:
            params = registry.get_model_api(cfg).init(cfg, torch.Generator(device=DEV).manual_seed(0))
            S = batch["tokens"].shape[1]
            tf = teacher_forced(cfg, params, out[0]["b"]["log"], S + MESH_SP_DECODE + 1,
                                inputs={"enc_frames": batch["enc_frames"]})
            got["b"] = logit_gaps(out[0]["b"]["log"], tf)
            del params
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        readings[arch] = got
    return readings


def mesh_sp() -> dict:
    """Phase 19: attention under sequence parallelism over a mesh, (a)
    world size 1 over NCCL under the production mesh's SP rules, (b) 4
    ranks sharing the card over gloo.  Returns the launches of both,
    summed over the ranks."""
    t0 = time.perf_counter()
    card = smi()
    total = collections.Counter()
    full = {a: registry.get_config(a) for a, *_ in MESH_SP_CUTS}
    cuts = ", ".join(f"{a} {'all ' + str(full[a].num_layers) if n is None else f'depth {full[a].num_layers} -> {n}'} "
                     f"layers, one step of {b} x {s}" for a, n, b, s in MESH_SP_CUTS)
    print(f"phase 19 (attention under sequence parallelism over a mesh, {card}): at full width; (a) the "
          f"production mesh's rules {SP_ONE_RULES} by hand, {MESH_ARCH} at phase 15 (a)'s cut (depth "
          f"{registry.get_config(MESH_ARCH).num_layers} -> {TRAIN_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ}) one step, "
          f"{SP_DENSE_ARCH} "
          f"all layers serving phase 9's first batch (kv_seq 'model'); reduced: (b) on {MESH_SP_FOUR}: {cuts}; "
          f"{ENCDEC_MESH_ARCH} a prefill and {MESH_SP_DECODE} decode steps; widths as published")
    if not PHASE15_PLAIN:
        fail("phase 19 (a): phase 15 kept no unsharded step")
    base = torch.cuda.memory_allocated()
    env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # the rank's deterministic step
    try:
        (one,) = rt_ranks.run_ranks(mesh_sp_world_one, (1, 1, 1), MESH_NAMES, backend="nccl", device="cuda")
    finally:
        if env_before is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
    allocated_back(base, "phase 19 (a)'s rank", phase=19)
    train, plain = one["train"], PHASE15_PLAIN
    print(f"  (a) world size 1 over nccl, mesh (1, 1, 1), {train['rules']}: {MESH_ARCH} step 1 loss "
          f"{train['metrics']['loss']!r} vs the unsharded {plain['loss']!r}, grad_norm "
          f"{train['metrics']['grad_norm']!r} vs {plain['grad_norm']!r}; bits equal "
          f"{train['bits'] == tuple(plain['bits'])}; K1 {train['k1']} launches (the unsharded step: "
          f"{plain['k1']}); {train['ms']:.1f} ms (synchronised, deterministic algorithms), max allocated "
          f"{train['peak'] / 2**30:.2f} GiB")
    if train["bits"] != tuple(plain["bits"]):
        fail("phase 19 (a): the step under SP differs in bits from the unsharded step")
    if not train["k1"] or train["k1"] != plain["k1"]:
        fail(f"phase 19 (a): K1 launched {train['k1']} times under SP, the unsharded step {plain['k1']}")
    serve = one["serve"]
    log, ref = serve["log"], serve["plain"]["log"]
    gap = max(float((f["logits"] - r["logits"]).abs().max()) for f, r in zip(log, ref))
    decode_ms = [f["ms"] for f in log[1:]]
    print(f"  (a) {SP_DENSE_ARCH} ({serve['counted']:,} counted weights) served over the mesh, {serve['rules']}: "
          f"tokens "
          f"equal the unsharded engine's {serve['tokens'] == serve['plain']['tokens']}; largest logit gap "
          f"{gap!r} over {len(log)} forwards; K5 {serve['launches'].get('sort_pairs_tile_tagged', 0)}; prefill "
          f"{log[0]['ms']:.3f} ms (unsharded {ref[0]['ms']:.3f}), decode {statistics.median(decode_ms):.3f} ms a "
          f"step (median of {len(decode_ms)}; unsharded {statistics.median(f['ms'] for f in ref[1:]):.3f}) "
          f"synchronised; max allocated {max(f['peak'] for f in log) / 2**30:.2f} GiB")
    if serve["tokens"] != serve["plain"]["tokens"]:
        fail(f"phase 19 (a): {SP_DENSE_ARCH}'s tokens over the mesh differ from the unsharded engine's")
    if serve["launches"].get("sort_pairs_tile_tagged") != 1:
        fail(f"phase 19 (a): {SP_DENSE_ARCH}'s launches {serve['launches']}")
    total.update(one["launches"])

    t_ranks = time.perf_counter()
    ranks_out = rt_ranks.run_ranks(mesh_sp_four_ranks, MESH_SP_FOUR, MESH_NAMES, backend="gloo", device="cuda")
    print(f"  (b): the 4 ranks took {time.perf_counter() - t_ranks:.1f} s")
    before = launch_counts()
    readings = mesh_sp_readings(ranks_out)
    total.update({k: v - before[k] for k, v in launch_counts().items()})
    for arch, n_layers, B, S in MESH_SP_CUTS:
        out = [r[arch] for r in ranks_out]
        tr, gap = out[0]["train"], readings[arch]["train"]
        coll = [r["train"]["coll_ms"] for r in out]
        share = "not measured" if coll[0] is None else round(max(coll) / max(r["train"]["walls"][0] for r in out), 3)
        print(f"  (b) {arch} on {MESH_SP_FOUR}, rules (seq, heads) {tr['rules']}: one step of {B} x {S}: loss "
              f"{tr['metrics'][0]['loss']!r}, grad_norm {tr['metrics'][0]['grad_norm']!r}; unsharded on the card: "
              f"loss {readings[arch]['ref_train'][0]['loss']!r}, grad_norm "
              f"{readings[arch]['ref_train'][0]['grad_norm']!r}; relative gaps "
              f"{ {k: f'{v:.3e}' for k, v in gap.items()} } (limits {MESH_SP_GAP[arch]}); step ms (slowest rank, "
              f"clocked) "
              f"{max(r['train']['walls'][0] for r in out):.1f}, {share} of it in DTensor's redistributions; max "
              f"allocated by rank {[round(r['train']['peak'] / 2**30, 2) for r in out]} GiB")
        if tr["rules"] != ("model", None):
            fail(f"phase 19 (b) {arch}: the rules (seq, heads) {tr['rules']} give no sequence parallelism")
        if not all(math.isfinite(m["loss"]) for r in out for m in r["train"]["metrics"]):
            fail(f"phase 19 (b) {arch}: a loss is not finite")
        if any(r["train"]["metrics"] != tr["metrics"] for r in out):
            fail(f"phase 19 (b) {arch}: the ranks report different metrics")
        if not all(gap[k] <= MESH_SP_GAP[arch][k] for k in gap):
            fail(f"phase 19 (b) {arch}: the gaps {gap} to the unsharded step pass the limits {MESH_SP_GAP[arch]}")
        if "b" in out[0]:
            runs = [r["b"] for r in out]
            g = readings[arch]["b"]
            slow = [max(r["log"][i]["ms"] for r in runs) for i in range(len(runs[0]["log"]))]
            print(f"  (b) {arch} serving, prefill rules (heads, seq, kv_seq) {runs[0]['prefill_rules']}, decode "
                  f"rules (batch, kv_seq) {runs[0]['rules']}: a prefill of the batch with its encoder frames and "
                  f"{MESH_SP_DECODE} decode steps; relative logit gaps to the unsharded model fed the same inputs: "
                  f"prefill {g['prefill']:.3e}, decode steps {[f'{v:.3e}' for v in g['steps'][1:]]}, median "
                  f"{g['decode_median']:.3e} (limits {MESH_SP_SERVE_GAP}); slowest rank: prefill {slow[0]:.1f} ms, "
                  f"decode {statistics.median(slow[1:]):.1f} ms a step; max allocated by rank "
                  f"{[round(max(f['peak'] for f in r['log']) / 2**30, 2) for r in runs]} GiB")
            if runs[0]["prefill_rules"][1] != "model":
                fail(f"phase 19 (b) {arch}: the prefill rules {runs[0]['prefill_rules']} split no sequence")
            if any(r["tokens"] != runs[0]["tokens"] for r in runs):
                fail(f"phase 19 (b) {arch}: the ranks emitted different tokens")
            if not all(math.isfinite(v) for v in g["steps"]):
                fail(f"phase 19 (b) {arch}: a logit gap is not finite: {g}")
            if not all(g[k] <= MESH_SP_SERVE_GAP[k] for k in MESH_SP_SERVE_GAP):
                fail(f"phase 19 (b) {arch}: the logit gaps {g} pass the limits {MESH_SP_SERVE_GAP}")
            for r in runs:
                total.update(r["launches"])
    print(f"phase 19 (attention under sequence parallelism over a mesh): {time.perf_counter() - t0:.1f} s; launches "
          f"{dict(total)}")
    return dict(total)


def main() -> None:
    t_script = time.perf_counter()
    preflight()
    rows = kernel_checks()

    reset_launches()
    main_path_sort()
    sort_counts = launch_counts()
    print("launches on SortEngine.sort:", sort_counts)
    for name in ("bucket_count_rank", "sort_tile", "merge_tiles"):
        if sort_counts[name] == 0:
            fail(f"{name} never launched on the SortEngine.sort path")

    reset_launches()
    main_path_segments()
    seg_counts = launch_counts()
    print("launches on SortEngine.sort_segments:", seg_counts)
    if seg_counts["batched_row_sort"] == 0:
        fail("batched_row_sort never launched on the sort_segments path")
    if seg_counts["sort_tile"] or seg_counts["merge_tiles"]:
        fail("sort_segments rows went through the tile kernels, not the row kernel")

    long_segments()

    reset_launches()
    pairs_path()
    pair_counts = launch_counts()
    print("launches on the pairs path (sort_pairs, argsort_keys):", pair_counts)
    if pair_counts["sort_pairs_tile_tagged"] == 0:
        fail("sort_pairs_tile_tagged never launched on the pairs path")

    reset_launches()
    workloads_path()
    work_counts = launch_counts()
    print("launches on top_k and merge_sorted:", work_counts)

    t0 = time.perf_counter()
    serve_counts = {name: 0 for name in KERNELS}
    serve_counts.update(serving_path())
    print(f"launches on the serving path (Sortd, fault ladder, fleet), {time.perf_counter() - t0:.1f} s:", serve_counts)

    verify_counts = conformance()
    perf_counts = {name: 0 for name in KERNELS}
    perf_counts.update(perf_gate())

    model_counts = {name: 0 for name in KERNELS}
    model_counts.update(model_serving())
    family_counts = {name: 0 for name in KERNELS}
    zamba_parts: list = []
    family_counts.update(model_families(zamba_parts))
    if family_counts["sort_pairs_tile_tagged"] == 0:
        fail("sort_pairs_tile_tagged never launched on the model families' path")
    train_counts = {name: 0 for name in KERNELS}
    train_measured: dict = {}
    train_counts.update(model_training(rows, train_measured))
    if train_counts["bucket_count_rank"] == 0:
        fail("bucket_count_rank never launched on the training path")
    dry_run_against_the_card(train_measured, zamba_parts)
    dist_counts = {name: 0 for name in KERNELS}
    dist_counts.update(distributed_path())
    mesh_counts = {name: 0 for name in KERNELS}
    mesh_counts.update(mesh_training())
    if mesh_counts["bucket_count_rank"] == 0:
        fail("bucket_count_rank never launched on the mesh training path")
    mesh_serve_counts = {name: 0 for name in KERNELS}
    mesh_serve_counts.update(mesh_serving())
    for name in ("bucket_count_rank", "sort_pairs_tile_tagged"):
        if mesh_serve_counts[name] == 0:
            fail(f"{name} never launched on the mesh serving path")
    mesh_ssm_counts = {name: 0 for name in KERNELS}
    mesh_ssm_counts.update(mesh_ssm_families())
    if mesh_ssm_counts["sort_pairs_tile_tagged"] == 0:
        fail("sort_pairs_tile_tagged never launched on the ssm and hybrid families' mesh path")
    mesh_encdec_counts = {name: 0 for name in KERNELS}
    mesh_encdec_counts.update(mesh_encdec_families())
    if mesh_encdec_counts["sort_pairs_tile_tagged"] == 0:
        fail("sort_pairs_tile_tagged never launched on the encdec and vlm families' mesh path")
    mesh_sp_counts = {name: 0 for name in KERNELS}
    mesh_sp_counts.update(mesh_sp())
    for name in ("bucket_count_rank", "sort_pairs_tile_tagged"):
        if mesh_sp_counts[name] == 0:
            fail(f"{name} never launched on the sequence-parallel mesh path")

    launches = {
        **sort_counts,
        "batched_row_sort": seg_counts["batched_row_sort"],
        "sort_pairs_tile_tagged": pair_counts["sort_pairs_tile_tagged"],
    }
    for name in launches:
        launches[name] += (serve_counts[name] + verify_counts[name] + perf_counts[name] + model_counts[name]
                           + family_counts[name] + train_counts[name] + dist_counts[name] + mesh_counts[name]
                           + mesh_serve_counts[name] + mesh_ssm_counts[name] + mesh_encdec_counts[name]
                           + mesh_sp_counts[name])
    # K6 and K7 have no caller in either package: phase 2 checks them, and
    # every path run above must have launched them no time
    for name in ("batched_row_sort_pairs", "sort_pairs_tile"):
        launches[name] = sum(
            c[name]
            for c in (sort_counts, seg_counts, pair_counts, work_counts, serve_counts, verify_counts, perf_counts,
                      model_counts, family_counts, train_counts, dist_counts, mesh_counts, mesh_serve_counts,
                      mesh_ssm_counts, mesh_encdec_counts, mesh_sp_counts)
        )
        if launches[name]:
            fail(f"{name} launched {launches[name]} times on a path: it has a caller now, so "
                 "the kernels line must count that path's launches")
    if set(rows) != set(KERNELS):
        fail(f"kernels not checked in phase 2: {sorted(set(KERNELS) - set(rows))}")
    unseen = [name for name, r in rows.items() if r.get("device_ms") is None or r.get("launches_per_call") is None]
    if unseen:
        fail(f"no device time or launch count from the profiler for {unseen}")
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r.get("device_ms"),
            "launches_per_call": r.get("launches_per_call"),
            "checked": "phase 2, bit for bit against the plain version",
            **{k: v for k, v in r.items() if k.startswith("train_")},
        })
    print(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s")
    print("card:", smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
