"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                  # everything
    python3 chip_smoke.py --kernels-only   # build and kernel phases only
    python3 chip_smoke.py --ssd-times SRC  # the SSD scan of the checkout
                                           # at SRC, timed (`ssd_times`)
    python3 chip_smoke.py --split-times SRC  # split_matmul of the checkout
                                             # at SRC (`split_times`)
    python3 chip_smoke.py --throttle-runs N  # the throttled scheduler
                                             # runs N times (`throttle_runs`)

It fails (non-zero exit, no result line) when CUDA is unavailable or when
the port cannot be imported, and otherwise runs, in order:

1. the card's `nvidia-smi` name and power limit; TF32 off for matmuls and
   cuDNN, so every fp32 comparison is a full-fp32 one;
2. the build of every kernel from `src/repro_torch/csrc` (one nvcc per
   source, all at once), with ptxas's register/shared-memory report;
3. one phase per kernel at the main paths' shapes plus off-path ones
   (each case through that kernel's `hold_*`):
   the kernel against its plain PyTorch version in float32 and bfloat16,
   with kernel, plain and library (`torch.matmul`, `torch.bmm`,
   `scaled_dot_product_attention`; none for the SSD scan) device times
   from CUDA events (`time_ms`: L2 flushed before every timed call, host
   launch time kept out), the bound the card's published rates give for
   the same work and the kernel's share of it (bound / kernel time), and
   each case's launch plan (for the SSD chunk kernels and `split_matmul`'s
   tiled product, whose fp32 products run in 3xTF32 on the tensor cores,
   the tensor-core bound beside the fp32 one; the tiled product's block,
   grid and K splits); `split_matmul`, `decode_attention` and
   `ssd_chunk_scan` are
   also called twice on the same inputs and must give bit-identical
   outputs (their split reductions and the SSD chunk walk are
   deterministic); the SSD scan's decode and chunk kernels are both timed
   at T = 1 and T = `DECODE_T_MAX`, beside the time `time_ms` gives an
   empty kernel (the floor of any launch);
4. the compile phase, on the host: each main path compiled by
   `repro_torch.compile` (no JAX) for its committed artifact's `Target`,
   into a fresh plan cache and predictor cache, its document held equal
   to the committed artifact's (checksum included), then compiled again
   from the warm plan cache; cold and warm seconds, the host's CPU model
   (`lscpu`) and numpy's version printed;
5. eight main paths (`PATHS`), each running the network the port compiled
   in phase 4 (strict: the port's static verifier checks its plan) on two
   CUDA-stream groups for a few seeded inputs ("requests"), each output
   held against `run_oracle` on the card, with every kernel's launch
   counter set to 0 just before the path and read just after:
   - VGG16 at 224x224x3 (`split_matmul`, `hadamard_matmul`);
   - a zamba2-7b decode step, 9 blocks, 4096-position KV cache
     (`split_matmul`, `decode_attention` on both sides of a kv-block split,
     `ssd_chunk_scan`);
   - resnet18 and resnet34 at 224x224x3 (`split_matmul`; direct convs on
     two streams, projection shortcuts through `_adapt`);
   - inception_v3 at 299x299x3 (`split_matmul`, `hadamard_matmul` on both
     sides of its one Winograd node; 68 fused segments);
   - rwkv6-1.6b's two plans at full width and depth (24 blocks): the
     decode step (every node on one group: `split_matmul` as a GEMV at
     M = 1, `ssd_chunk_scan`'s decode kernel at H = 64, hd = 64, N = 16)
     and the chunked prefill of 512 tokens (every node split:
     `split_matmul`'s tiled product at M = 512 on channel panels,
     `ssd_chunk_scan`'s chunk kernels on ssm-state halves);
   - deepseek-v2-lite-16b's decode step at full width and depth (27
     blocks, a 128-position cache): `split_matmul` as a GEMV (2048² and
     10944→2048 on one group, 2048→10944 on channel panels of 3408 and
     7536) and `decode_attention` at H = KV = 16, hd = 128 split by head
     (7 | 9);
   right after each of the last three paths' per-node walk, every
   distinct kernel call of one of its requests is held against its plain
   version in float32 and bfloat16 and timed (`HELD_PATHS`,
   `hold_walk_calls`);
6. two more requests of each path under torch.profiler: device time by
   kernel, and each kernel's launches in the trace beside its counter;
7. the fused segment walk of each path (`run(fused=True)`): every fused
   segment captured once as a CUDA graph (each printed with its kind, its
   nodes and the kernel launches its graph holds), then the same seeded
   requests, each output `torch.equal` to the per-node walk's and within
   `E2E_RTOL` of `run_oracle`, with the per-node walk's launch counts
   (credited at each replay), the reshard and elided counts over its
   channel splits (`fused_reshard_counts`) and one sync per segment; the
   two walks' median walls from one alternating run (per-node, fused,
   per-node, fused, ...); two fused requests under
   torch.profiler, with each kernel's launches in the trace beside its
   credited counter and the graph launches the trace shows;
8. a bfloat16 run of VGG16 and the zamba2-7b step (`BF16_PATHS`):
   `executor(dtype="bfloat16")`, per-node and fused, `BF16_REQUESTS`
   requests each, held against the float32 `run_oracle` at `BF16_RTOL`
   of its largest |value|, with the same launch counts;
9. the `calibrate` phase, on VGG16 and the zamba2-7b step
   (`CALIBRATE_PATHS`, the networks phase 4 compiled, which carry their
   predictors): `RECORD_RUNS` per-node runs and one fused run recorded
   into a fresh measurement store (each kernel launched that many times
   the plan's count), `recalibrate()` with its corrections, record count,
   the fidelity error before and after the fit over the card's records
   (after <= before) and the calibrator's version; `replan()` with its
   `PlanDiff`, the nodes that moved their axis or boundary and the host
   seconds; the replanned plan saved and loaded back strictly, then run
   per node and fused as a main path is (`REPLAN_REQUESTS` requests each,
   within `E2E_RTOL` of its own `run_oracle`, fused `torch.equal` to
   per-node, counts `expected_counts` of the replanned plan), every
   kernel call of one more request captured (`kernel_calls`) and each
   distinct call held against its plain version in float32 and bfloat16
   with its times and bound (`hold_walk_calls`); and the original and
   replanned plans' walls in turns, with no claim;
10. the `portfolio` phase: the committed zamba2-7b portfolio
   (`PORTFOLIO`) compiled on this host by `compile_portfolio` into fresh
   caches, its document equal to the committed one (checksum included),
   compiled again as all warm hits, cold and warm seconds printed; then
   the file loaded strictly and each of its three entries (batch 1 and 4,
   64- and 256-position caches), picked by `select`, run per node and
   fused as a main path is (`PORTFOLIO_REQUESTS` requests each), its
   kernel calls held as in phase 9; then the in-process portfolio's entry
   for the live step `PORTFOLIO_STEP` taken through phase 9's loop and
   swapped in with `replace`, the new document loaded back strictly;
11. the `serve` phase (`serve_phase`): codeqwen1.5-7b (`SERVE_ARCH`) at
   its published widths and full depth (32 layers, d_model 4096, 32 heads
   of 128, d_ff 13440, vocab 92416: 8.2 B parameters), its weights seeded
   draws made on the card.  A portfolio (`SERVE_BUCKETS`, b1s64 and
   b4s64) compiled on this host, cold then warm; each entry's plan run as
   a main path is (`main_path`: its `split_matmul` and `decode_attention`
   calls at H = KV = 32, hd = 128) and every kernel call of one of its
   requests held against its plain version in float32 and bfloat16
   (`hold_walk_calls`); the reduced model's prefill and decode logits on
   the card within `SERVE_LOGIT_RTOL` of the same weights on the CPU; in
   fp32, `ContinuousScheduler` on the virtual clock over `SERVE_TRAFFIC`
   greedy Poisson requests (0.33 / the b4s64 plan's cost, the reference's
   acceptance rate), its plans executed every `SERVE_FIDELITY_EVERY`
   steps, each completion equal token for token to the request served
   alone by the fixed-batch engine (on a mismatch the solo run's top-2
   logit gap there is printed); in bf16, the fixed-batch `ServingEngine`
   on `SERVE_FIXED_REQUESTS` requests (greedy and T = 0.7 in turns)
   shipping the b4s64 entry (`compiled=`, one `execute_plan`), then the
   scheduler on the wall clock: tokens/s, TTFT p50, latency p50/p99 and
   peak memory beside the card's name and power limit, and its offered
   load against the slots the card served (`offered_load`: that traffic
   is paced by the phone's plan cost, so on the card it overloads the
   scheduler and the wall figures are a backlog's); a decode step at
   batch 1 and 4 timed bare and under torch.profiler (device time by
   kernel, idle share, host launch calls); then the scheduler twice more
   on the virtual clock with a `ThrottleSim` (x8 from 100 steps' cost
   on; a drift window of 2 reports and a threshold of 1.5, so the
   monitor fires only on a wholly throttled window,
   `throttled_scheduler`), each on a fresh warm load of the portfolio:
   over the traffic above (most steps in b4s64, whose replan moves no
   node) and over sparse traffic (most steps in b1s64).  Every committed
   drift-triggered in-place replan must lower the fidelity error, and
   the sparse run must commit one that moved a node (every replan the
   monitor triggered printed with its pre and post fidelity errors).
   Every plan those runs executed (`executed_plans`: fidelity runs,
   replan candidates committed or not, the engine's `execute_plan`, on
   any of the four scheduler runs) that the entries did not hold runs as a
   main path with its kernel calls held.  Each serve walk's launch counts are set
   to 0 just before it and read just after, and `split_matmul` and
   `decode_attention` must launch in each;
12. the model phases (`model_phase`, one per `MODEL_ARCHS` entry), first
   zamba2-7b at its published widths and full depth (81 Mamba2 layers of
   112 SSM heads x 64 and state 64, the shared attention applied 9 times: 6.6 B
   parameters), its weights seeded draws made on the card; every Mamba2
   layer's SSD core is one `ssd_chunk_scan` launch per pass (the chunk
   kernel in a prefill, the decode kernel in a decode step).  In fp32
   (TF32 off): prefills of `MODEL_PROMPTS` tokens (512, a multiple of the
   reference's 256-token chunk, and 300) then `MODEL_DECODE_STEPS` decode
   steps, their last-position logits within `MODEL_LOGIT_RTOL` of
   `forward` over the same tokens (`model_check`), with exactly one SSD
   launch per layer per pass; every SSD call of one more prefill and one
   more decode step captured (`capture_calls`) and held against its plain
   version in float32 and bfloat16 (`hold_model_calls`); the fixed-batch
   `ServingEngine` on `MODEL_EQUAL_REQUESTS` equal-length greedy prompts,
   each completion equal to the request served alone, token for token.
   In bf16: the fixed-batch engine on `MODEL_SERVE_REQUESTS` requests of
   `MODEL_SERVE_PROMPT` tokens at batch `MODEL_SERVE_BATCH` with
   `MODEL_SERVE_NEW` new tokens each (tokens/s), a prefill at that batch
   timed bare and under torch.profiler (device time by kernel, idle
   share, the SSD chunk kernels' share), and a decode step at batch 1 and
   4 (`decode_breakdown`), each beside the card's name and power limit.
   Then rwkv6-1.6b the same way (24 RWKV6 layers, d_model 2048, 32 WKV
   heads x 64, channel mix d_ff 7168, vocab 65536: 1.4 B parameters): its
   WKV is plain PyTorch in both of the reference's branches, so each of
   its passes launches none of the port's kernels (its plans, phase 5,
   run them); the 512-token prompt takes the chunked WKV and `forward`
   over 516 tokens the step recurrence, so that check holds one against
   the other at full width; the profiled prefill sums the chunked WKV's
   eager ops apart (`wkv_range`);
13. the MLA and MoE model phases: deepseek-v2-lite-16b at its published
   widths and full depth (`deepseek_phase`: 27 layers of MLA attention,
   a dense first layer then 64 routed experts top-6 and 2 shared; 15.7 B
   parameters drawn on the card) and llama4-scout at its published
   widths and 6 of its 48 layers (`llama4_phase`, reduced: depth only).
   Neither model's passes launch a kernel of the port (the reference's
   MLA and MoE are no Pallas kernels); MoE capacity is per call, so each
   check compares calls on the same tokens: fp32 `prefill` against
   `forward`, one MLA layer in both branches against the dense pass, one
   MoE layer against a per-token loop (its dropped pairs printed); bf16,
   the engine against the model's own greedy loop, how many batched
   completions differ from solo runs (printed, not asserted), a profiled
   prefill, decode steps at batch 1 and 4, and the engine shipping the
   committed deepseek plan (`execute_plan` within `E2E_RTOL` of
   `run_oracle`, `split_matmul` and `decode_attention` launched);
   llama4-scout's bf16 `prefill` against `forward`, decode steps at
   batch 1 and 4, and the continuous scheduler completing its requests;
14. the Whisper phase (`whisper_phase`): whisper-large-v3 at its
   published widths and full depth (32 encoder and 32 decoder layers,
   d_model 1280, 20 heads, d_ff 5120, vocab 51866, 1500 encoder
   positions: 2.02 B parameters drawn on the card; frames seeded, the
   conv frontend a stub as in the reference).  In fp32: a prefill of
   `WHISPER_BATCH` x `WHISPER_PROMPT` tokens and `WHISPER_DECODE_STEPS`
   teacher-fed decode steps at device-tensor positions, every step's
   logits within `MODEL_LOGIT_RTOL` of the teacher-forced pass the loss
   takes; the reduced model on the card against the CPU.  In bf16: the
   fixed-batch engine on `WHISPER_REQUESTS` requests with seeded frames
   (tokens/s), the TTFT (one batched prefill, encode included, and a
   sync; median of 3), decode steps at batch 1 and 4 with the cross K/V
   products' device time summed apart (`cross_kv_range`).  No pass
   launches a kernel of the port;
15. the train phase (`train_phase`): whisper-large-v3 at full width and
   depth through `repro_torch.launch.train.train` in bf16 with fp32
   AdamW moments, on the mesh path (the (1, 1) host mesh, params placed
   by `sharding.shard_params` under `activation_mesh`), `TRAIN_STEPS`
   steps of `TRAIN_BATCH` x `TRAIN_SEQ`
   target tokens over 1500 frames (every loss finite, the last 5's mean
   below the first 5's; median s/step, peak memory, one profiled step's
   device time and idle share; the step's roofline terms from the dry
   run's walk over this card's peaks beside the measured s/step, as a
   multiple of max(t_compute, t_memory), `roofline_line`), a checkpoint of the params in the
   reference's layout saved and restored bit for bit; then one reduced
   fp32 train step of every `ARCH_IDS` family on the card against the CPU
   from the same weights and batch (`train_step_check`: the loss and
   every leaf's gradient within `TRAIN_RTOL`), zamba2-7b's launching
   `ssd_chunk_scan` once per layer with its gradient (`ScanWithGrad`),
   each of those calls held against its plain version and timed;
   then the mesh phases (`mesh_phases`): zamba2-7b at its published
   widths (112 SSD heads x 64, state 64) and 9 of its 81 layers (one
   shared-attention block) trained through the mesh path in bf16,
   `ZAMBA_TRAIN_STEPS` steps of 2 x 512 tokens (every loss finite,
   `ssd_chunk_scan` launched once per layer per step and no other
   kernel, s/step, peak memory, the roofline terms, and every SSD call of
   one forward held against its plain version,
   `zamba_train_phase`); the dry run on this host at published widths
   for the reference's CI combinations on the test meshes (`DRYRUN_CI`:
   each record's counts, bottleneck and walk seconds, `dryrun_phase`);
   `python -m repro_torch.launch.train --production-mesh` exiting 2 with
   the device-count message (`production_mesh_check`);
16. the `tune` phase (`tune_phase`): (a) a sweep of one op per kind at
   the paths' shapes (`tune_ops`: VGG16's n7 Winograd conv, a zamba2-7b
   GEMV at M = 1 and M = 4, an M = 64 linear for the tiled product, the
   zamba2-7b b8.attn fast side at S = 3072, the SSD chunk kernels at
   T = 4096): every candidate of the kind's Hopper launch spec
   (`repro_torch.kernels.tiles`, both search modes) held against the
   plain version in float32 and bfloat16, each output-tiling one
   `torch.equal` to the default launch in float32, each timed, with the
   default's time, the winner of each search mode and its bound; (b)
   `compile(tune=True)` of VGG16 and the zamba2-7b step into fresh caches
   with the measurements counted, cold then warm (no measurement, tune
   hits only), the tuned key against the untuned one and the documents
   equal but for `provenance.tune`; the tuned artifact saved with its
   sidecar, loaded strictly and run per node and fused as a main path
   is, every kernel call of one request carrying its op's tuned launch
   (`expected_launches`); the same plan tuned with its reduction axes
   too (`preserve_numerics=False`: split-K factors, runs, chunks), run
   alike and its kernel calls held against their plain versions
   (`hold_walk_calls`); tuned, relaxed and untuned walls in turns, no
   claim;
17. a JSON line of per-kernel numbers (launches summed over every walk
   above, `by_path` per walk with the float32 times of one request, one
   prefill or one decode step where the walk's calls were held), then the
   result line.  Each phase prints its seconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
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

ROOT = Path(__file__).resolve().parent
ARTIFACTS = ROOT / "src/repro_torch/artifacts"
ARTIFACT = ARTIFACTS / "vgg16_moto2022.coexec.json"
ZAMBA_ARTIFACT = ARTIFACTS / "zamba2-7b_b9_s4096_moto2022_t1.coexec.json"

#: kernel-vs-plain tolerance, relative to the largest |plain| value: fp32
#: sums of up to 25088 terms in another order differ by ~sqrt(K) * 2^-24;
#: bf16 outputs round to 8 bits, so one rounding step apart is 2^-8
KERNEL_RTOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}

#: seeded inputs run through each main path (repeated: a stream-order
#: fault gives wrong answers only now and then)
REQUESTS = 4

VGG, ZAMBA = "vgg16", "zamba2-7b"
R18, R34, INC = "resnet18", "resnet34", "inception_v3"
#: rwkv6-1.6b's two plans: the decode step and the chunked prefill of 512
#: tokens (the reference models chunked prefill for pure-SSM configs only)
RWKV, RWKV_PREFILL = "rwkv6-1.6b", "rwkv6-1.6b tokens=512"
#: deepseek-v2-lite-16b's decode-step plan (27 blocks, a 128-position cache)
DS = "deepseek-v2-lite-16b"

#: end-to-end tolerance against run_oracle, relative to the largest |oracle|
#: value.  VGG16: Winograd reassociates every eligible conv's fp32 sums and
#: the split/unsplit kernels sum in other orders, across 16 layers and 5
#: pools.  zamba2-7b: split/unsplit fp32 GEMV sums (K up to 14336), the
#: chunked SSD form against the step-by-step scan, and the kv-block
#: log-sum-exp merge, through 9 residual blocks.  The resnets and
#: inception_v3: the same fp32 reorderings (split and unsplit direct convs,
#: inception's one Winograd node), held to the VGG16 bound.  rwkv6-1.6b's
#: plans: split/unsplit fp32 sums (GEMVs, and the tiled product at M = 512,
#: K up to 4096), the SSD kernels against the step-by-step scan (the chunk
#: kernels' 3xTF32 products at T = 512), through 24 residual blocks.
#: deepseek-v2-lite-16b's plan: split/unsplit fp32 GEMV sums (K up to
#: 10944) and the head-split attention, through 27 residual blocks.
E2E_RTOL = {VGG: 2e-3, ZAMBA: 1e-4, R18: 2e-3, R34: 2e-3, INC: 2e-3,
            RWKV: 1e-4, RWKV_PREFILL: 1e-4, DS: 1e-4}


#: per-node/fused request pairs of the alternating wall measurement
WALL_PAIRS = 8

#: the bfloat16 phase: its paths, requests per walk, and its tolerance
#: against the float32 run_oracle relative to the largest |oracle| value
#: (the reference's own bf16 end-to-end tolerance)
BF16_PATHS = (VGG, ZAMBA)
BF16_REQUESTS = 2
BF16_RTOL = 5e-2

#: every kernel of the port, by its launch counter's name
KERNEL_NAMES = ("split_matmul", "hadamard_matmul", "decode_attention",
                "ssd_chunk_scan")

#: (label, M, K, N, c0, width, launches per request by main path).  A
#: co-executed linear launches once per group on its (K, c_pad) panel of
#: the packed weights; exclusive ones on the full weight
SPLIT_CASES = [
    ("n18 fast", 1, 25088, 3368, 0, 728, {VGG: 1}),
    ("n18 slow", 1, 25088, 3368, 0, 3368, {VGG: 1}),
    ("n19", 1, 4096, 4096, 0, 4096, {VGG: 1}),
    ("n20", 1, 4096, 1000, 0, 1000, {VGG: 1}),
    ("embed/q_proj/o_proj", 1, 3584, 3584, 0, 3584, {ZAMBA: 3}),
    ("in_proj fast", 1, 3584, 5696, 0, 1472, {ZAMBA: 8}),
    ("in_proj slow", 1, 3584, 5696, 0, 5696, {ZAMBA: 8}),
    ("out_proj fast", 1, 7168, 2528, 0, 1056, {ZAMBA: 8}),
    ("out_proj slow", 1, 7168, 2528, 0, 2528, {ZAMBA: 8}),
    ("mlp_up fast", 1, 3584, 9200, 0, 5136, {ZAMBA: 1}),
    ("mlp_up slow", 1, 3584, 9200, 0, 9200, {ZAMBA: 1}),
    ("mlp_down fast", 1, 14336, 2296, 0, 1288, {ZAMBA: 1}),
    ("mlp_down slow", 1, 14336, 2296, 0, 2296, {ZAMBA: 1}),
    ("resnet fc", 1, 512, 1000, 0, 1000, {R18: 1, R34: 1}),
    ("inception fc", 1, 2048, 1000, 0, 1000, {INC: 1}),
    ("n18 fast, full W", 1, 25088, 4096, 0, 728, {}),
    ("n18 slow, full W", 1, 25088, 4096, 728, 3368, {}),
    ("scalar c0=3 M=4", 4, 4096, 1000, 3, 997, {}),
    ("ragged M=17", 17, 100, 301, 96, 128, {}),
    ("ragged M=50", 50, 768, 3072, 2480, 592, {}),
    # rwkv6-1.6b's prefill plan at M = 512 (the tiled product), whole
    # weights; its walk's own split panels are held in `hold_walk_calls`
    ("rwkv6 embed M=512", 512, 2048, 2048, 0, 2048, {}),
    ("rwkv6 in_proj M=512", 512, 2048, 4096, 0, 4096, {}),
    ("rwkv6 out_proj M=512", 512, 4096, 2048, 0, 2048, {}),
    # deepseek-v2-lite-16b's plan, whole: mlp_up unsplit (its walk's two
    # channel panels are held in `hold_walk_calls`)
    ("deepseek mlp_up whole", 1, 2048, 10944, 0, 10944, {}),
    # the tiled product's narrow-copy variant (W[0, c0] 12 bytes into a
    # row in fp32, 6 in bf16) and short M: 9 rows, 64 rows at K = 3584
    ("odd c0=3 M=512", 512, 2048, 4096, 3, 1000, {}),
    ("M=9", 9, 768, 3072, 2480, 592, {}),
    ("M=64", 64, 3584, 3584, 0, 3584, {}),
]

#: (label, P, K, N, launches per request): P = ceil(H/2) * ceil(W/2) tiles
HADAMARD_CASES = [
    ("n3", 56 * 56, 64, 128, {VGG: 1}),
    ("n4", 56 * 56, 128, 128, {VGG: 1}),
    ("n6 fast", 28 * 28, 128, 192, {VGG: 1}),
    ("n6 slow", 28 * 28, 128, 64, {VGG: 1}),
    ("n7/n8", 28 * 28, 256, 256, {VGG: 2}),
    ("inception n5 fast", 37 * 37, 80, 160, {INC: 1}),
    ("inception n5 slow", 37 * 37, 80, 32, {INC: 1}),
    ("ragged", 37, 40, 136, {}),
    ("ragged P=1", 1, 32, 200, {}),
]

#: (label, H, KV, hd, S, pos, window, launches per request): b8.attn is a
#: kv-block split, positions [0, 3072) on the fast group, the rest on the
#: slow one; each side attends its whole block
ATTN_CASES = [
    ("b8.attn fast", 32, 32, 112, 3072, 3071, 0, {ZAMBA: 1}),
    ("b8.attn slow", 32, 32, 112, 1024, 1023, 0, {ZAMBA: 1}),
    ("b8.attn unsplit", 32, 32, 112, 4096, 4095, 0, {}),
    # deepseek-v2-lite-16b's b*.attn unsplit (its walk's 9- and 7-head
    # halves are held in `hold_walk_calls`)
    ("deepseek attn unsplit", 16, 16, 128, 128, 127, 0, {}),
    ("GQA g=4 hd=128", 32, 8, 128, 32768, 32767, 0, {}),
    ("window 1024", 32, 8, 128, 8192, 5000, 1024, {}),
    ("ragged S=1000", 16, 4, 64, 1000, 999, 0, {}),
]

#: (label, B, T, H, hd, N, launches per request); T = 16 is the port's
#: DECODE_T_MAX, the longest scan the decode kernel takes
SSD_CASES = [
    ("b*.ssm decode", 1, 1, 112, 64, 64, {ZAMBA: 8}),
    ("decode T=16", 1, 16, 112, 64, 64, {}),
    ("prefill B=2 T=512", 2, 512, 112, 64, 64, {}),
    ("prefill B=4 T=512", 4, 512, 112, 64, 64, {}),
    ("prefill T=4096", 1, 4096, 112, 64, 64, {}),
    ("ragged T=100", 2, 100, 6, 32, 16, {}),
    # rwkv6-1.6b's plans at N = 16, whole: the decode step and the chunked
    # prefill (its walks' ssm-state halves are held in `hold_walk_calls`)
    ("rwkv6 b*.ssm decode", 1, 1, 64, 64, 16, {}),
    ("rwkv6 b*.ssm T=512", 1, 512, 64, 64, 16, {}),
]

#: the SSD chunk kernels' comparison shapes at zamba2-7b's widths (H = 112,
#: hd = N = 64), (B, T): the model phase's fp32 and bf16 prefills and a
#: long one (`--ssd-times`)
SSD_COMPARE = ((2, 512), (4, 512), (1, 4096))

#: `--split-times`: the tiled product's shapes (K, N, width) at M = 512 in
#: rwkv6-1.6b's 512-token prefill plan: its three whole weights, then the
#: panels both sides of its channel splits run on (`plan_panels`)
SPLIT_WHOLE = ((2048, 2048, 2048), (2048, 4096, 4096), (4096, 2048, 2048))
#: and the most splits its launch sweep times a candidate at
SWEEP_MAX_SPLITS = 16

_TIMES = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_peaks() -> dict:
    """The card's published peaks (`repro_torch.roofline.analysis.PEAKS`,
    SXM or PCIe by the card's name)."""
    from repro_torch.roofline.analysis import peaks_for
    return peaks_for(torch.cuda.get_device_name(0))


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype, peaks: dict):
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = ops / peaks[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of one call (`repro_torch.runtime.autotune.
    time_ms`, which the autotuner measures with too): before each timed
    call a 128 MB write evicts the 50 MB L2 cache and a spin kernel holds
    the stream until the call and its end event are queued, so CUDA events
    bracket the call's device work and not the host's launch overhead."""
    from repro_torch.runtime.autotune import time_ms as device_time_ms
    return device_time_ms(fn, reps)


def check(label: str, got: torch.Tensor, want: torch.Tensor,
          rtol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not np.isfinite(err) or err > rtol * scale:
        raise AssertionError(f"{label}: max |kernel - plain| = {err:.3e} "
                             f"> {rtol:g} x {scale:.3g}")
    return err


class Tally:
    """One kernel's numbers: max errors, and times summed over the
    launches of one request of each walk that holds its cases (float32),
    keyed by that walk's times key."""

    def __init__(self, library: bool = True):
        self.library = library
        self.max_abs_err = self.max_abs_err_bf16 = 0.0
        self.by_path: dict = {}

    def note(self, dtype, err: float) -> None:
        """An error of a held call on a walk."""
        if dtype == torch.bfloat16:
            self.max_abs_err_bf16 = max(self.max_abs_err_bf16, err)
        else:
            self.max_abs_err = max(self.max_abs_err, err)

    def add(self, dtype, err: float, per_path: dict, times: dict) -> None:
        if dtype == torch.bfloat16:
            self.note(dtype, err)
            return
        if per_path:
            self.note(dtype, err)
        for path, n in per_path.items():
            agg = self.by_path.setdefault(path, dict.fromkeys(_TIMES, 0.0))
            for key in _TIMES:
                if times.get(key) is not None:
                    agg[key] += times[key] * n

    def total(self, key: str, paths):
        """`key` summed over one request of each of `paths`."""
        if key == "library_ms" and not self.library:
            return None
        return sum(p[key] for name, p in self.by_path.items()
                   if name in paths)


def _report(kernel: str, label: str, dtype, err: float, times: dict,
            shape: str) -> None:
    lib = times.get("library_ms")
    print(f"{kernel} {label:20s} {str(dtype)[6:]:8s} {shape}: max_abs_err "
          f"{err:.3e} kernel {times['ms']:.4f} ms plain "
          f"{times['plain_ms']:.4f} ms library "
          f"{'none' if lib is None else f'{lib:.4f} ms'} bound "
          f"{times['bound_ms']:.4f} ms ({times['bound_ms'] / times['ms']:.1%}"
          f" of it)", flush=True)


def _times(kernel_fn, plain_fn, library_fn, n_bytes, ops, dtype, peaks):
    bnd, tb, to = bound_ms(n_bytes, ops, dtype, peaks)
    return {"ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
            "library_ms": None if library_fn is None else time_ms(library_fn),
            "bound_ms": bnd, "t_bytes": tb, "t_ops": to}


# Each `hold_*` takes one call's arguments, in its wrapper's order (the
# launch last, where the call names one), on the card: it holds the kernel against its plain version, times kernel, plain
# and library call beside the bound, prints the case and returns
# (max_abs_err, times).  The kernel phases give them seeded tensors at the
# shapes of `*_CASES`; `hold_walk_calls` gives them the calls a walk made.

def hold_split_matmul(label: str, args: tuple, peaks: dict):
    from repro_torch.kernels.split_matmul.split_matmul import (
        plan_call, split_matmul, split_matmul_plain)
    x, w, c0, width, *rest = args
    launch = rest[0] if rest else None
    (m, k), n, dtype = x.shape, w.shape[1], x.dtype
    got = split_matmul(x, w, c0, width, launch=launch)
    err = check(f"split_matmul {label} {dtype}", got,
                split_matmul_plain(x, w, c0, width), KERNEL_RTOL[dtype])
    if not torch.equal(got, split_matmul(x, w, c0, width, launch=launch)):
        raise AssertionError(f"split_matmul {label} {dtype}: two calls on "
                             f"the same inputs differ")
    plan = plan_call(x, w, c0, width, launch)
    ops = 2 * m * k * width
    times = _times(lambda: split_matmul(x, w, c0, width, launch=launch),
                   lambda: split_matmul_plain(x, w, c0, width),
                   lambda: torch.matmul(x, w[:, c0:c0 + width]),
                   x.element_size() * (m * k + k * width + m * width),
                   ops, dtype, peaks)
    _report("split_matmul", label, dtype, err, times,
            f"M={m} K={k} N={n} c0={c0} width={width} "
            f"[{split_plan_text(plan, times, ops, dtype, peaks)}]")
    return err, times


def split_plan_text(plan, times: dict, ops: float, dtype, peaks: dict) -> str:
    """One `split_matmul` launch plan, as the kernel phases print it; for
    the tiled product in float32 the 3xTF32 tensor-core bound beside the
    fp32 one (three TF32 products per fp32 one; bound_ms divides by the
    CUDA cores' fp32 rate, and in bf16 by the tensor cores' bf16 rate)."""
    from repro_torch.kernels.split_matmul.split_matmul import (TILED,
                                                               TILED_NARROW)
    if plan.variant not in (TILED, TILED_NARROW):
        return (f"variant {plan.variant} {plan.col_tiles}x{plan.splits} "
                f"blocks, k_chunk {plan.k_chunk}")
    text = (f"tiled variant {plan.variant}, {plan.mt}x{plan.tile} blocks, "
            f"grid {plan.col_tiles}x{plan.row_tiles}x{plan.splits} "
            f"({plan.blocks} blocks), splits {plan.splits}, k_chunk "
            f"{plan.k_chunk}")
    if dtype == torch.float32:
        tc = tf32_bound_ms(times["t_bytes"], ops, peaks)
        text += (f"; 3xTF32 tensor-core bound {tc:.4f} ms "
                 f"({tc / times['ms']:.1%} of it)")
    return text


def tf32_bound_ms(t_bytes: float, ops: float, peaks: dict) -> float:
    """The least time of `ops` fp32 operations taken as three TF32
    tensor-core products each (3xTF32), or of the bytes, whichever is
    larger."""
    return max(t_bytes, 3 * ops / peaks["tf32"] * 1e3)


def hold_hadamard_matmul(label: str, args: tuple, peaks: dict):
    from repro_torch.kernels import build
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul, hadamard_matmul_plain, plan_hadamard)
    u, v, *rest = args
    launch = rest[0] if rest else None
    (g, p, k), n, dtype = u.shape, v.shape[2], u.dtype
    got = hadamard_matmul(u, v, launch=launch)
    err = check(f"hadamard_matmul {label} {dtype}", got,
                hadamard_matmul_plain(u, v), KERNEL_RTOL[dtype])
    plan = plan_hadamard(g, p, k, n, u.element_size(),
                         (u.data_ptr(), v.data_ptr(), got.data_ptr()),
                         build.sm_count(0), launch)
    times = _times(lambda: hadamard_matmul(u, v, launch=launch),
                   lambda: hadamard_matmul_plain(u, v),
                   lambda: torch.bmm(u, v),
                   u.element_size() * g * (p * k + k * n + p * n),
                   2 * g * p * k * n, dtype, peaks)
    _report("hadamard_matmul", label, dtype, err, times,
            f"P={p} K={k} N={n} [{plan.bm}x{plan.bn} tile, {plan.blocks} "
            f"blocks, vec {int(plan.vec)}]")
    return err, times


def hold_decode_attention(label: str, args: tuple, peaks: dict):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_attention_plain, plan_call, valid_range)
    q, k, v, pos, window, *rest = args
    launch = rest[0] if rest else None
    (h, hd), (s, kv, _), dtype = q.shape, k.shape, q.dtype
    out, lse = decode_attention(q, k, v, pos, window=window, launch=launch)
    want, want_lse = decode_attention_plain(q, k, v, pos, window=window)
    err = check(f"decode_attention {label} {dtype}", out, want,
                KERNEL_RTOL[dtype])
    check(f"decode_attention {label} {dtype} lse", lse, want_lse,
          KERNEL_RTOL[torch.float32])                # fp32 sums in both
    again = decode_attention(q, k, v, pos, window=window, launch=launch)
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"decode_attention {label} {dtype}: two calls "
                             f"on the same inputs differ")
    plan = plan_call(q, k, v, pos, window, launch)
    lo, hi = valid_range(s, pos, window)
    n = hi - lo + 1
    # the library call: the attended positions, (1, heads, S, hd)
    q4 = q[None, :, None, :]
    k4 = k[lo:hi + 1].permute(1, 0, 2)[None]
    v4 = v[lo:hi + 1].permute(1, 0, 2)[None]
    times = _times(
        lambda: decode_attention(q, k, v, pos, window=window, launch=launch),
        lambda: decode_attention_plain(q, k, v, pos, window=window),
        lambda: sdpa(q4, k4, v4, enable_gqa=h != kv),
        q.element_size() * (2 * h * hd + 2 * n * kv * hd) + 4 * h,
        4 * h * n * hd, dtype, peaks)
    _report("decode_attention", label, dtype, err, times,
            f"H={h} KV={kv} hd={hd} S={s} pos={pos} window={window} "
            f"[variant {plan.variant}, {plan.nsplit} runs of "
            f"{plan.run_len} over {lo}..{hi}, tile {plan.tile}, "
            f"{plan.stages} stages, {plan.blocks} blocks]")
    return err, times


def ssd_plan_text(plan) -> str:
    """One SSD launch plan, as the kernel phases print it."""
    from repro_torch.kernels.ssd_chunk.ssd_chunk import CHUNKED
    if plan.variant != CHUNKED:
        return (f"decode kernel, variant {plan.variant}, {plan.blocks} "
                f"blocks of {plan.rows} rows, {plan.lanes} lanes per row")
    nc, groups, b = plan.grid
    return (f"chunk kernels, chunk {plan.chunk}, {plan.heads} heads a "
            f"block, state and out grids {nc}x{groups}x{b}, pass "
            f"{plan.pass_blocks} blocks, smem state {plan.smem_state} B out "
            f"{plan.smem} B, workspace {plan.workspace / 1e6:.1f} MB, "
            f"{'16-byte cp.async' if plan.vec else 'synchronous'} staging")


def hold_ssd_chunk_scan(label: str, args: tuple, peaks: dict):
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        CHUNK, CHUNKED, plan_call, ssd_chunk_scan, ssd_chunk_scan_plain)
    args, launch = args[:6], (args[6] if len(args) > 6 else None)
    x = args[0]
    (b, t, h, hd), n, dtype = x.shape, args[1].shape[2], x.dtype
    chunk = None if launch is None else launch.get("chunk")
    sf, y = ssd_chunk_scan(*args, launch=launch)
    sf_p, y_p = ssd_chunk_scan_plain(*args, chunk=chunk or CHUNK)
    err = max(check(f"ssd_chunk_scan {label} {dtype} y", y, y_p,
                    KERNEL_RTOL[dtype]),
              check(f"ssd_chunk_scan {label} {dtype} state", sf, sf_p,
                    KERNEL_RTOL[dtype]))
    sf2, y2 = ssd_chunk_scan(*args, launch=launch)
    if not (torch.equal(sf, sf2) and torch.equal(y, y2)):
        raise AssertionError(f"ssd_chunk_scan {label} {dtype}: two calls on "
                             f"the same inputs differ")
    plan = plan_call(*args, sf, launch)
    ops = 6 * b * t * h * hd * n
    times = _times(lambda: ssd_chunk_scan(*args, launch=launch),
                   lambda: ssd_chunk_scan_plain(*args, chunk=chunk or CHUNK),
                   None, nbytes(*args, y, sf), ops, dtype, peaks)
    text = ssd_plan_text(plan)
    if plan.variant == CHUNKED:
        # the units the chunk kernels use: three TF32 tensor-core products
        # per fp32 one (bound_ms divides by the input type's CUDA-core rate)
        tc = tf32_bound_ms(times["t_bytes"], ops, peaks)
        text += (f"; 3xTF32 tensor-core bound {tc:.4f} ms "
                 f"({tc / times['ms']:.1%} of it)")
    _report("ssd_chunk_scan", label, dtype, err, times,
            f"B={b} T={t} H={h} hd={hd} N={n} [{text}]")
    return err, times


HOLDS = {"split_matmul": hold_split_matmul,
         "hadamard_matmul": hold_hadamard_matmul,
         "decode_attention": hold_decode_attention,
         "ssd_chunk_scan": hold_ssd_chunk_scan}

DTYPES = (torch.float32, torch.bfloat16)


def split_matmul_phase(peaks: dict) -> Tally:
    gen = torch.Generator(device="cuda").manual_seed(11)
    tally = Tally()
    for label, m, k, n, c0, width, per_path in SPLIT_CASES:
        for dtype in DTYPES:
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            err, times = hold_split_matmul(label, (x, w, c0, width), peaks)
            tally.add(dtype, err, per_path, times)
    return tally


def hadamard_phase(peaks: dict) -> Tally:
    gen = torch.Generator(device="cuda").manual_seed(12)
    tally = Tally()
    for label, p, k, n, per_path in HADAMARD_CASES:
        for dtype in DTYPES:
            u = torch.randn((16, p, k), generator=gen, device="cuda").to(dtype)
            v = (torch.randn((16, k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            err, times = hold_hadamard_matmul(label, (u, v), peaks)
            tally.add(dtype, err, per_path, times)
    return tally


def decode_attention_phase(peaks: dict) -> Tally:
    gen = torch.Generator(device="cuda").manual_seed(13)
    tally = Tally()
    for label, h, kv, hd, s, pos, window, per_path in ATTN_CASES:
        for dtype in DTYPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for shape in ((h, hd), (s, kv, hd),
                                                (s, kv, hd)))
            err, times = hold_decode_attention(label, (q, k, v, pos, window),
                                               peaks)
            tally.add(dtype, err, per_path, times)
    return tally


def ssd_inputs(gen, b: int, t: int, h: int, hd: int, n: int,
               dtype) -> list:
    """Seeded SSD scan operands on the card, as the ssm lowering makes
    them: stabilized dt and a, fan-in scaled B, C and state."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return [u.to(dtype) for u in (
        rand(b, t, h, hd), rand(b, t, n) / n ** 0.5,
        rand(b, t, n) / n ** 0.5, 0.05 + 0.2 * torch.sigmoid(rand(b, t, h)),
        -(0.1 + rand(h).abs()), rand(b, h, hd, n) / n ** 0.5)]


def ssd_phase(peaks: dict) -> Tally:
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        DECODE_T_MAX, launch_uncounted, plan_chunks, ssd_chunk_scan_plain)
    if DECODE_T_MAX not in {case[2] for case in SSD_CASES}:
        raise AssertionError(f"SSD_CASES has no case at DECODE_T_MAX = "
                             f"{DECODE_T_MAX}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    tally = Tally(library=False)          # no one PyTorch call computes it
    floor = time_ms(lambda: torch.cuda._sleep(0))
    print(f"ssd_chunk_scan floor: time_ms of an empty kernel "
          f"(torch.cuda._sleep(0)) {floor:.4f} ms", flush=True)
    for label, b, t, h, hd, n, per_path in SSD_CASES:
        for dtype in DTYPES:
            ins = ssd_inputs(gen, b, t, h, hd, n, dtype)
            err, times = hold_ssd_chunk_scan(label, tuple(ins), peaks)
            tally.add(dtype, err, per_path, times)
            if t <= DECODE_T_MAX and dtype == torch.float32:
                # the chunk kernels on the same inputs, launched directly
                # (not counted), against the decode kernel's time
                sf_p, y_p = ssd_chunk_scan_plain(*ins)
                chunked = plan_chunks(b, t, h, hd, n, 4, [
                    u.data_ptr() for u in ins[:3]])
                y_c, sf_c = torch.empty_like(y_p), torch.empty_like(sf_p)
                launch_uncounted(chunked, ins, y_c, sf_c)
                check(f"ssd_chunk_scan {label} chunk kernels y", y_c, y_p,
                      KERNEL_RTOL[dtype])
                check(f"ssd_chunk_scan {label} chunk kernels state", sf_c,
                      sf_p, KERNEL_RTOL[dtype])
                ms_c = time_ms(lambda: launch_uncounted(chunked, ins, y_c,
                                                        sf_c))
                print(f"ssd_chunk_scan {label} T={t}: decode kernel "
                      f"{times['ms']:.4f} ms, chunk kernels {ms_c:.4f} ms, "
                      f"empty kernel {floor:.4f} ms, bound "
                      f"{times['bound_ms']:.4f} ms", flush=True)
    return tally


def _copy_aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` on its device at an address of the same
    alignment modulo 256 bytes (the kernels pick their vector variants
    from it)."""
    pad = t.data_ptr() % 256 // t.element_size()
    out = torch.empty(pad + t.numel(), dtype=t.dtype,
                      device=t.device)[pad:].view(t.shape)
    return out.copy_(t)


def capture_calls(fn, every: bool = False) -> dict:
    """Every kernel call `fn()` makes, by kernel: {signature: [calls,
    arguments]}.  A profile hook sees each wrapper's call as it is made; a
    signature is the arguments' shapes, dtypes, scalars and each tensor's
    address modulo 16 bytes, and the first call of each keeps its
    arguments (`every`: a list of every call's), copied on the caller's
    stream (`_copy_aligned`), for the holds.  The run is not one a launch
    count is read from."""
    import inspect
    wrappers = kernel_counters()
    codes = {fn.__code__: (name, list(inspect.signature(fn).parameters))
             for name, fn in wrappers.items()}
    calls = {name: {} for name in wrappers}

    def hook(frame, event, _arg):
        if event != "call" or frame.f_code not in codes:
            return
        name, params = codes[frame.f_code]
        args = tuple(frame.f_locals[p] for p in params)
        sig = tuple((tuple(a.shape), a.dtype, a.data_ptr() % 16)
                    if torch.is_tensor(a) else a for a in args)
        entry = calls[name].setdefault(sig, [0, [] if every else None])
        entry[0] += 1
        if every or entry[1] is None:
            copy = tuple(_copy_aligned(a) if torch.is_tensor(a) else a
                         for a in args)
            if every:
                entry[1].append(copy)
            else:
                entry[1] = copy

    sys.setprofile(hook)
    try:
        fn()
    finally:
        sys.setprofile(None)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return calls


def kernel_calls(exe, x) -> dict:
    """Every kernel call one request of `exe`'s per-node walk makes on
    `x` (`capture_calls`), for `hold_walk_calls`."""
    return capture_calls(lambda: exe.run(x))


def hold_walk_calls(label: str, calls: dict, want: dict, peaks: dict,
                    tallies: dict) -> None:
    """Hold each distinct kernel call of one request of a walk
    (`kernel_calls`) against its plain version in float32 and bfloat16,
    as the kernel phases hold their cases, and add it to its kernel's
    tally under `label` with its calls per request; those calls must add
    up to the plan's counts `want`."""
    for name, sigs in calls.items():
        made = sum(n for n, _ in sigs.values())
        if made != want[name]:
            raise AssertionError(f"{label}: the walk called {name} {made} "
                                 f"times, the plan gives {want[name]}")
        for i, (n, args) in enumerate(sigs.values()):
            for dtype in DTYPES:
                cast = tuple(a.to(dtype) if torch.is_tensor(a)
                             and a.is_floating_point() else a for a in args)
                err, times = HOLDS[name](f"{label} #{i} x{n}", cast, peaks)
                tallies[name].add(dtype, err, {label: n}, times)


def kernel_counters() -> dict:
    from repro_torch.runtime.segments import launch_counters
    return launch_counters()


def zero_counts() -> None:
    """Every kernel's launch count set to 0, just before a walk."""
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    """Every kernel's launch count, just after a walk."""
    return {k: fn.launches for k, fn in kernel_counters().items()}


def expected_counts(plan) -> dict:
    """Kernel launches, reshard points and elided gathers of one request
    of a plan's chained walk on two groups, from its specs and graph: a
    co-executed node launches its kernel once per group, an exclusive one
    once (convs launch `hadamard_matmul` when Winograd-eligible); a channel
    or stackable typed split's output is gathered once unless its sole
    consumer chains it, and a non-stackable one (kv-block) merges its
    sides itself."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.winograd_conv.ops import winograd_eligible
    kernel = {"linear": "split_matmul", "attention": "decode_attention",
              "ssm": "ssd_chunk_scan"}
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    specs = plan.exec_specs()
    for s in specs:
        if s.unit == "conv" and winograd_eligible(s.op):
            counts["hadamard_matmul"] += 2 if s.coexec else 1
        elif s.unit in kernel:
            counts[kernel[s.unit]] += 2 if s.coexec else 1
    coexec = {s.node_id for s in specs if s.coexec}
    merged = {s.node_id for s in specs if s.coexec and s.axis != "channel"
              and not registry.axis_spec(s.unit, s.axis).stackable}
    elided = plan.graph_ir().elided(coexec) - merged
    counts["reshard"] = len(coexec - merged - elided)
    counts["elided"] = len(elided)
    return counts


def fused_reshard_counts(plan) -> tuple:
    """(reshard points, elided gathers) of one request of the fused walk.
    Its segments are cut over the channel splits alone, and a typed-axis
    split runs as a singleton that gathers or merges its own sides, so the
    counts are the graph's materialization points and elided edges over
    the channel splits: the per-node walk's unless a head or ssm-state
    split chains with its neighbours there."""
    coexec = plan.coexec_node_ids()
    graph = plan.graph_ir()
    return (len(graph.materialization_points(coexec)),
            len(graph.elided(coexec)))


def _node_kind(spec) -> str:
    from repro_torch.kernels.winograd_conv.ops import winograd_eligible
    if spec.unit == "conv":
        return "winograd conv" if winograd_eligible(spec.op) else \
            "direct conv"
    if spec.op is None:
        return spec.unit
    return f"{spec.unit} ({spec.axis + ' split' if spec.coexec else 'one group'})"


def host_cpu_model() -> str:
    """The host CPU as `lscpu` names it (model name, vendor, CPU count),
    with /proc/cpuinfo's model name where `lscpu` knows none."""
    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError:
        out = ""
    for line in out.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip().lower(), value.strip())
    model = fields.get("model name", "unknown")
    if model in ("", "-", "unknown"):
        info = Path("/proc/cpuinfo")
        for line in (info.read_text().splitlines() if info.exists() else []):
            key, _, value = line.partition(":")
            if key.strip() == "model name":
                model = f"{value.strip()} (/proc/cpuinfo; lscpu: {model})"
                break
    return (f"{model}, vendor {fields.get('vendor id', 'unknown')}, "
            f"{fields.get('cpu(s)', '?')} CPUs")


def predictor_files(root: Path) -> dict:
    """Each predictor pickle under `root` with its modification time: a
    compile that trains writes its files, one that loads leaves them."""
    return {p.name: p.stat().st_mtime_ns for p in root.glob("*.pkl")}


def compile_phase(paths) -> dict:
    """Compile every main path with `repro_torch.compile` on this host,
    for its committed artifact's `Target` and mode, into a fresh plan
    cache and a fresh predictor cache; each document must equal the
    committed artifact's, checksum included, and a second compile must be
    a warm hit of the plan cache.  Returns the compiled networks by path
    name."""
    import repro_torch
    from repro_torch.graph.frontends import from_model

    print(f"compile: host {host_cpu_model()}; numpy {np.__version__}",
          flush=True)
    compiled = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_compile_") as tmp:
        plans, predictors = Path(tmp, "plans"), Path(tmp, "predictors")
        for name, artifact, _, _ in paths:
            doc = json.loads(artifact.read_text())
            target = repro_torch.Target.from_json(doc["target"])
            network = (from_model(GRAPHS[name][0], **GRAPHS[name][1])
                       if name in GRAPHS else name)
            before = predictor_files(predictors)
            t = time.perf_counter()
            net = repro_torch.compile(network, target, mode=doc["mode"],
                                      cache=plans,
                                      predictor_cache=predictors)
            cold = time.perf_counter() - t
            after = predictor_files(predictors)
            written = sorted(p for p in after if before.get(p) != after[p])
            if net.from_cache:
                raise AssertionError(f"compile {name}: the first compile "
                                     f"hit a fresh plan cache")
            got = net.to_json()
            if got != doc:
                raise AssertionError(
                    f"compile {name}: the port's plan differs from "
                    f"{artifact.name} (checksum {got['checksum']}, "
                    f"committed {doc['checksum']}; key {net.key}, "
                    f"committed {doc['plan']['provenance']})")
            t = time.perf_counter()
            again = repro_torch.compile(network, target, mode=doc["mode"],
                                        cache=plans,
                                        predictor_cache=predictors)
            warm = time.perf_counter() - t
            if not again.from_cache or again.to_json() != doc:
                raise AssertionError(f"compile {name}: the second compile "
                                     f"was not a warm hit of the plan")
            how = (f"predictors trained ({len(written)} files written)"
                   if written else
                   "predictors loaded (no file written)")
            print(f"compile {name}: threads {target.threads}, {how}; cold "
                  f"{cold:.3f} s, warm {warm:.3f} s; equal to "
                  f"{artifact.name} (checksum {got['checksum']}, key "
                  f"{net.key})", flush=True)
            compiled[name] = net
    return compiled


def main_path(name: str, compiled, make_input, out_shape, requests: int,
              rtol: float):
    """One main path: the network the port compiled, on two CUDA-stream
    groups, `requests` seeded inputs, each held against run_oracle within
    `rtol` of its largest |value|, launch counts checked per request
    against its plan; returns the launch counts (counters set to 0 just
    before the path, read just after), its float32 executor, the expected
    counts and each request's (input, output, oracle)."""
    from repro_torch.analysis import errors, verify_plan

    t0 = time.perf_counter()
    bad = errors(verify_plan(compiled.plan, stats=False))
    if bad:
        raise AssertionError(f"{name}: the compiled plan fails the static "
                             f"verifier: {bad[0]}")
    exe = compiled.executor(device="cuda")
    want = expected_counts(compiled.plan)
    print(f"{name}: the plan (key {compiled.key}), weights "
          f"on {exe.device} in {time.perf_counter() - t0:.1f} s; groups "
          f"{len(exe.groups)}; per request the plan gives {want}",
          flush=True)
    if not exe.split_capable:
        raise AssertionError("the main path needs two co-execution groups")
    exe.run(warmup=True)                       # builds, cuDNN choice

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    per_run, outputs = [], []
    for r in range(requests):
        x = make_input(r)
        before = {k: fn.launches for k, fn in counters.items()}
        t = time.perf_counter()
        y, rep = exe.run(x)
        wall = (time.perf_counter() - t) * 1e3
        per_run.append({k: fn.launches - before[k]
                        for k, fn in counters.items()})
        outputs.append((x, y, rep, wall))
    counts = {k: fn.launches for k, fn in counters.items()}

    refs = []
    for r, ((x, y, rep, wall), launched) in enumerate(zip(outputs, per_run)):
        oracle = exe.run_oracle(x)
        refs.append((x, y, oracle))
        torch.cuda.synchronize()
        if tuple(y.shape) != out_shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name} request {r}: output "
                                 f"{tuple(y.shape)} is not a finite "
                                 f"{out_shape} tensor")
        err = float((y - oracle).abs().max())
        scale = max(1.0, float(oracle.abs().max()))
        if err > rtol * scale:
            raise AssertionError(f"{name} request {r}: max |run - "
                                 f"run_oracle| = {err:.3e} > "
                                 f"{rtol} x {scale:.3g}")
        for k in KERNEL_NAMES:
            if launched[k] != want[k]:
                raise AssertionError(f"{name} request {r}: {launched[k]} "
                                     f"{k} launches, want {want[k]}")
        if (rep.reshard_points, rep.elided) != (want["reshard"],
                                                want["elided"]):
            raise AssertionError(
                f"{name} request {r}: {rep.reshard_points} reshard points, "
                f"{rep.elided} elided; want {want['reshard']} and "
                f"{want['elided']}")
        share = {}
        for t, spec in zip(rep.timings, exe.specs):
            kind = _node_kind(spec)
            share[kind] = share.get(kind, 0.0) + t.wall_us
        parts = ", ".join(f"{k} {v / rep.wall_us:.1%}"
                          for k, v in sorted(share.items()))
        shown = " ".join(f"{k} {launched[k]}" for k in KERNEL_NAMES
                         if want[k])
        print(f"{name} request {r}: wall {wall:.3f} ms (nodes "
              f"{rep.wall_us / 1e3:.3f} ms: {parts}); max_abs_err "
              f"{err:.3e} (scale {scale:.3g}); launches {shown}; reshard "
              f"{rep.reshard_points} elided {rep.elided} syncs "
              f"{rep.sync_points}", flush=True)
    walls = sorted(o[3] for o in outputs)
    print(f"{name}: median request wall {statistics.median(walls):.3f} ms "
          f"over {requests} requests (min {walls[0]:.3f}, max "
          f"{walls[-1]:.3f})", flush=True)
    return counts, exe, want, refs


def fused_path(name: str, exe, want: dict, refs: list,
               rtol: float) -> dict:
    """The fused segment walk of a main path: capture every fused segment
    as a CUDA graph, then run the per-node walk's requests again, each
    output bit-identical to that walk's and within `rtol` of run_oracle,
    with the same launch counts, the reshard and elided counts of
    `fused_reshard_counts` and one sync per segment; returns the launch
    counts (counters set to 0 just before the requests, read just
    after)."""
    from repro_torch.graph.ir import SEGMENT_FUSED

    reshard, elided = fused_reshard_counts(exe.plan)
    partition = exe.plan.segment_partition()
    specs = {s.node_id: s for s in exe.specs}
    t = time.perf_counter()
    programs = exe.segment_programs()          # the requests' input shape
    torch.cuda.synchronize()
    captured = sum(p.graph is not None for p in programs)
    n_fused = sum(s.kind == SEGMENT_FUSED for s in partition)
    print(f"{name} fused: {len(programs)} segments, {n_fused} fused; "
          f"captured {captured} CUDA graphs in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if captured != n_fused:
        raise AssertionError(f"{name}: {captured} graphs for {n_fused} "
                             f"fused segments")
    for p in programs:
        held = (", ".join(f"{k} {n}" for k, n in p.launches.items())
                or "no launch of the port's kernels")
        what = (f"graph holds {held}" if p.graph is not None
                else f"eager ({p.modes[p.node_ids[0]]})")
        print(f"  segment {p.index:2d} {p.kind:9s} "
              f"{' + '.join(p.node_ids)}: {what}", flush=True)
    exe.run(refs[0][0], fused=True, warmup=True)     # warm the replays

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = []
    for x, _, _ in refs:
        before = {k: fn.launches for k, fn in counters.items()}
        t = time.perf_counter()
        y, rep = exe.run(x, fused=True)
        wall = (time.perf_counter() - t) * 1e3
        runs.append((y, rep, wall, {k: fn.launches - before[k]
                                    for k, fn in counters.items()}))
    counts = {k: fn.launches for k, fn in counters.items()}

    for r, ((x, y_node, oracle), (y, rep, wall, launched)) in enumerate(
            zip(refs, runs)):
        if not torch.equal(y, y_node):
            diff = float((y - y_node).abs().max())
            raise AssertionError(f"{name} fused request {r}: output differs "
                                 f"from the per-node walk's (max |diff| "
                                 f"{diff:.3e})")
        err = float((y - oracle).abs().max())
        scale = max(1.0, float(oracle.abs().max()))
        if not err <= rtol * scale:
            raise AssertionError(f"{name} fused request {r}: max |run - "
                                 f"run_oracle| = {err:.3e} > "
                                 f"{rtol} x {scale:.3g}")
        for k in KERNEL_NAMES:
            if launched[k] != want[k]:
                raise AssertionError(f"{name} fused request {r}: "
                                     f"{launched[k]} {k} launches, want "
                                     f"{want[k]}")
        if (rep.reshard_points, rep.elided) != (reshard, elided):
            raise AssertionError(
                f"{name} fused request {r}: {rep.reshard_points} reshard "
                f"points, {rep.elided} elided; want {reshard} and {elided}")
        if not rep.fused or rep.sync_points != len(partition):
            raise AssertionError(f"{name} fused request {r}: "
                                 f"{rep.sync_points} syncs, want one per "
                                 f"segment ({len(partition)})")
        share = {}
        for seg_wall, p in zip(rep.segment_wall_us, programs):
            kind = ("graph replays" if p.graph is not None else
                    _node_kind(specs[p.node_ids[0]]))
            share[kind] = share.get(kind, 0.0) + seg_wall
        parts = ", ".join(f"{k} {v / rep.wall_us:.1%}"
                          for k, v in sorted(share.items()))
        shown = " ".join(f"{k} {launched[k]}" for k in KERNEL_NAMES
                         if want[k])
        print(f"{name} fused request {r}: wall {wall:.3f} ms (segments "
              f"{rep.wall_us / 1e3:.3f} ms: {parts}); bit-identical to the "
              f"per-node walk; max_abs_err {err:.3e} (scale {scale:.3g}); "
              f"launches {shown}; reshard {rep.reshard_points} elided "
              f"{rep.elided} syncs {rep.sync_points}", flush=True)
    return counts


def alternating_walls(exes: dict, x, pairs: int) -> None:
    """Request walls of the per-node and fused walks of one or more plans'
    executors (`exes`, by label) on one input, run in turns (per-node,
    fused, then the next plan's, ...), so all see the same card and host
    state."""
    walls = {}
    for _ in range(pairs):
        for label, exe in exes.items():
            for fused in (False, True):
                t = time.perf_counter()
                exe.run(x, fused=fused)
                walls.setdefault((label, fused), []).append(
                    (time.perf_counter() - t) * 1e3)
    parts = []
    for (label, fused), ms in walls.items():
        ms = sorted(ms)
        walk = "fused" if fused else "per-node"
        parts.append(f"{label} {walk} median "
                     f"{statistics.median(ms):.3f} ms (min {ms[0]:.3f}, max "
                     f"{ms[-1]:.3f})")
    print(f"walls, {pairs} alternating rounds: " + "; ".join(parts),
          flush=True)


def bf16_path(name: str, compiled, want: dict, refs: list) -> dict:
    """The path in bfloat16 (`executor(dtype="bfloat16")`): the first
    `BF16_REQUESTS` requests of the float32 path, per-node then fused, each
    output a finite bf16 tensor within `BF16_RTOL` of the float32
    run_oracle, the fused outputs `torch.equal` to the per-node ones, with
    the float32 path's launch counts; returns the launch counts per walk
    (counters set to 0 just before each walk's requests, read just
    after)."""
    t = time.perf_counter()
    exe = compiled.executor(device="cuda", dtype="bfloat16")
    x0 = refs[0][0]
    exe.run(x0, warmup=True)                   # bf16 builds, cuDNN choice
    exe.run(x0, fused=True, warmup=True)       # bf16 captures
    print(f"{name} bf16: weights and graphs in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    counters = kernel_counters()
    counts, per_node = {}, []
    for fused in (False, True):
        walk = f"{name} bf16{' fused' if fused else ''}"
        for fn in counters.values():
            fn.launches = 0
        for r, (x, _, oracle) in enumerate(refs[:BF16_REQUESTS]):
            before = {k: fn.launches for k, fn in counters.items()}
            y, rep = exe.run(x, fused=fused)
            torch.cuda.synchronize()
            launched = {k: fn.launches - before[k]
                        for k, fn in counters.items()}
            if (y.dtype != torch.bfloat16 or y.shape != oracle.shape
                    or not bool(torch.isfinite(y).all())):
                raise AssertionError(f"{walk} request {r}: output "
                                     f"{tuple(y.shape)} {y.dtype} is not a "
                                     f"finite bf16 {tuple(oracle.shape)}")
            err = float((y.float() - oracle).abs().max())
            scale = max(1.0, float(oracle.abs().max()))
            if not err <= BF16_RTOL * scale:
                raise AssertionError(f"{walk} request {r}: max |run - fp32 "
                                     f"run_oracle| = {err:.3e} > "
                                     f"{BF16_RTOL} x {scale:.3g}")
            if fused and not torch.equal(y, per_node[r]):
                raise AssertionError(f"{walk} request {r}: output differs "
                                     f"from the bf16 per-node walk's")
            if not fused:
                per_node.append(y.clone())
            for k in KERNEL_NAMES:
                if launched[k] != want[k]:
                    raise AssertionError(f"{walk} request {r}: "
                                         f"{launched[k]} {k} launches, "
                                         f"want {want[k]}")
            shown = " ".join(f"{k} {launched[k]}" for k in KERNEL_NAMES
                             if want[k])
            print(f"{walk} request {r}: max_abs_err vs the fp32 oracle "
                  f"{err:.3e} (scale {scale:.3g}, {err / scale:.2e} of it)"
                  f"{'; bit-identical to the per-node walk' if fused else ''}"
                  f"; launches {shown}; syncs {rep.sync_points}", flush=True)
        counts[walk] = {k: fn.launches for k, fn in counters.items()}
    return counts


def changed_nodes(old, new) -> list:
    """Each node whose decision moved its axis or its boundary between two
    plans, as "node axis cpu/gpu -> axis cpu/gpu"."""
    moved = []
    after = new.plan.decisions_by_node
    for nid, o in old.plan.decisions_by_node.items():
        n = after[nid]
        if (o.axis, o.c_cpu, o.c_gpu) != (n.axis, n.c_cpu, n.c_gpu):
            moved.append(f"{nid} {o.axis} {o.c_cpu}/{o.c_gpu} -> {n.axis} "
                         f"{n.c_cpu}/{n.c_gpu}")
    return moved


def calibrate_path(name: str, net: str, compiled, make_input, out_shape,
                   peaks: dict, tallies: dict):
    """The measurement loop on the card for a compiled network of `net`
    that carries the predictors it planned with: `RECORD_RUNS` per-node
    runs and one fused run recorded into a fresh store (each kernel
    launched 3x the plan's count), `recalibrate()` (the fidelity error
    over the card's records may not grow), `replan()` and its diff, the
    replanned plan saved and loaded back strictly, then run per node and
    fused against its own `run_oracle` and `expected_counts`, each kernel
    call of one of its requests held against the plain version
    (`hold_walk_calls`), and the two plans' walls in turns.  Returns the
    walks as {walk: (times key, launch counts)} and the replanned
    network."""
    from repro_torch.api import CompiledNetwork
    from repro_torch.measure import MeasurementStore, fidelity_error

    walks = {}
    exe = compiled.executor(device="cuda")
    want = expected_counts(compiled.plan)
    x = make_input(REQUESTS)
    # kernel builds and the fused segments' captures (whose warm-up runs
    # launch kernels) stay out of the records and the counted runs
    exe.run(x, warmup=True)
    exe.run(x, fused=True, warmup=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_calibrate_") as tmp:
        store = MeasurementStore(Path(tmp, "measurements"))
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        for fused in (False,) * RECORD_RUNS + (True,):
            rep = compiled.record(x, store=store, device="cuda",
                                  warmup=False, fused=fused)
            print(f"{name} record{' fused' if fused else ''}: "
                  f"{rep.fidelity_summary()}", flush=True)
        recorded = time.perf_counter() - t
        counts = {k: fn.launches for k, fn in counters.items()}
        walks[f"{name} calibrate"] = (None, counts)
        for k in KERNEL_NAMES:
            runs = RECORD_RUNS + 1
            if counts[k] != runs * want[k]:
                raise AssertionError(
                    f"{name} calibrate: {counts[k]} {k} launches over "
                    f"{runs} recorded runs, want {runs * want[k]}")
        records = store.load(compiled.key)
        cal = compiled.recalibrate(store)
        pre, post = fidelity_error(records), cal.fidelity_error(records)
        if not post <= pre:
            raise AssertionError(f"{name} calibrate: the fit raised the "
                                 f"fidelity error {pre} -> {post}")
        print(f"{name} calibrate: {len(records)} records ({cal.n_records} "
              f"usable) from {RECORD_RUNS} per-node runs and 1 fused run in "
              f"{recorded:.2f} s; fidelity error (sum |log wall/pred|) "
              f"{pre:.3f} -> {post:.3f} over the card's records; calibrator "
              f"{cal.version}", flush=True)
        for line in cal.summary().splitlines():
            print(f"  {line.strip()}", flush=True)
        t = time.perf_counter()
        new, diff = compiled.replan(cal, store=store,
                                    cache=Path(tmp, "plans"))
        replan_s = time.perf_counter() - t
        for line in diff.summary().splitlines():
            print(f"{name} {line.strip()}", flush=True)
        moved = changed_nodes(compiled, new)
        print(f"{name} replan: {replan_s:.3f} s on the host; nodes that "
              f"moved their axis or boundary: "
              f"{'; '.join(moved) if moved else 'none (an empty diff)'}",
              flush=True)
        loaded = CompiledNetwork.load(new.save(Path(tmp, "replanned.json")))
        if loaded.to_json() != new.to_json():
            raise AssertionError(f"{name} replan: the saved plan does not "
                                 f"load back as it was")
        print(f"{name} replanned: saved and loaded strictly (key "
              f"{loaded.key}, calibration {loaded.provenance.calibration})",
              flush=True)
    label = f"{name} replanned"
    counts, exe_new, want_new, refs = main_path(
        label, loaded, make_input, out_shape, REPLAN_REQUESTS, E2E_RTOL[net])
    walks[label] = (label, counts)
    walks[f"{label} fused"] = (label, fused_path(label, exe_new, want_new,
                                                 refs, E2E_RTOL[net]))
    hold_walk_calls(label, kernel_calls(exe_new, make_input(0)), want_new,
                    peaks, tallies)
    alternating_walls({f"{name} original": exe, label: exe_new}, x,
                      WALL_PAIRS)
    return walks, new


def portfolio_phase(peaks: dict, tallies: dict) -> dict:
    """The committed zamba2-7b portfolio: compiled on this host by
    `compile_portfolio` into fresh caches (its document equal to the
    committed one, checksum included; a second compile all warm hits);
    the file loaded strictly and each entry, picked by `select`, run on
    the card per node and fused against its `run_oracle` with its
    `expected_counts`, each kernel call of one of its requests held
    against the plain version; then the replan path of a server: the
    in-process portfolio's entry for the live step `PORTFOLIO_STEP`
    recorded, recalibrated and replanned (`calibrate_path`) and swapped in
    with `replace`, the bucket tag kept, the new document loaded back
    strictly.  Returns the walks as {walk: (times key, launch counts)}."""
    import repro_torch

    doc = json.loads(PORTFOLIO.read_text())
    target = repro_torch.Target.from_json(doc["target"])
    buckets = [(e["batch"], e["seq"]) for e in doc["entries"]]
    with tempfile.TemporaryDirectory(prefix="repro_torch_portfolio_") as tmp:
        kw = dict(buckets=buckets, blocks=ZAMBA_GRAPH["blocks"],
                  cache=Path(tmp, "plans"),
                  predictor_cache=Path(tmp, "predictors"))
        t = time.perf_counter()
        pf = repro_torch.compile_portfolio(doc["model"], target, **kw)
        cold = time.perf_counter() - t
        got = pf.to_json()
        if any(c.from_cache for c in pf.entries.values()) or got != doc:
            raise AssertionError(
                f"portfolio: the port's portfolio differs from "
                f"{PORTFOLIO.name} (checksum {got['checksum']}, committed "
                f"{doc['checksum']})")
        t = time.perf_counter()
        again = repro_torch.compile_portfolio(doc["model"], target, **kw)
        warm = time.perf_counter() - t
        if (not all(c.from_cache for c in again.entries.values())
                or again.to_json() != doc):
            raise AssertionError("portfolio: the second compile was not all "
                                 "warm hits of the committed document")
    print(f"portfolio {doc['model']}: buckets "
          f"{', '.join(b.tag for b in pf.buckets)}; cold {cold:.3f} s, warm "
          f"{warm:.3f} s; equal to {PORTFOLIO.name} (checksum "
          f"{got['checksum']}); keys "
          f"{', '.join(c.key for c in pf.entries.values())}", flush=True)
    walks = {}
    loaded = repro_torch.PlanPortfolio.load(PORTFOLIO)
    for b in loaded.buckets:
        picked, compiled = loaded.select(b.batch, b.seq)
        if picked != b:
            raise AssertionError(f"portfolio: select({b.batch}, {b.seq}) "
                                 f"picked {picked.tag}, not {b.tag}")
        label = f"{ZAMBA} {b.tag}"
        make = decode_input(b.batch)
        counts, exe, want, refs = main_path(
            label, compiled, make, (b.batch, ZAMBA_D), PORTFOLIO_REQUESTS,
            E2E_RTOL[ZAMBA])
        walks[label] = (label, counts)
        walks[f"{label} fused"] = (label, fused_path(label, exe, want, refs,
                                                     E2E_RTOL[ZAMBA]))
        hold_walk_calls(label, kernel_calls(exe, make(0)), want, peaks,
                        tallies)
        del compiled, exe, refs
        torch.cuda.empty_cache()

    if not pf.can_replan() or loaded.can_replan():
        raise AssertionError("portfolio: an in-process portfolio must be "
                             "able to replan and a loaded one must not")
    b, entry = pf.select(*PORTFOLIO_STEP)
    print(f"portfolio: the live step (batch, seq) = {PORTFOLIO_STEP} is "
          f"served by {b.tag}", flush=True)
    cal_walks, new = calibrate_path(
        f"{ZAMBA} {b.tag}", ZAMBA, entry, decode_input(b.batch),
        (b.batch, ZAMBA_D), peaks, tallies)
    walks.update(cal_walks)
    pf.replace(b, new)
    doc_new = pf.to_json()
    back = repro_torch.PlanPortfolio.from_json(doc_new)
    others_kept = all(e == o for e, o in zip(doc_new["entries"],
                                              doc["entries"])
                      if (o["batch"], o["seq"]) != (b.batch, b.seq))
    if (pf.select(*PORTFOLIO_STEP)[1] is not new
            or new.provenance.bucket != b.tag or not others_kept
            or back.entries[b].to_json() != new.to_json()):
        raise AssertionError(f"portfolio: {b.tag} was not replaced by its "
                             f"replanned plan")
    print(f"portfolio: {b.tag} replaced by its replanned plan (key "
          f"{new.key}, bucket tag {new.provenance.bucket}); checksum "
          f"{doc['checksum']} -> {doc_new['checksum']}, the new document "
          f"loads strictly", flush=True)
    return walks


# ------------------------------------------------------------------- model

def hold_model_calls(label: str, calls: dict, want: int, peaks: dict,
                     tallies: dict) -> None:
    """Hold every `ssd_chunk_scan` call of one model pass (`capture_calls`
    with `every`) against its plain version in float32 and bfloat16; the
    first call of each signature through `hold_ssd_chunk_scan`, timed and
    added to the tally under `label` with its calls per pass, the others
    checked untimed.  The pass must have made `want` calls, and no other
    kernel's."""
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        ssd_chunk_scan, ssd_chunk_scan_plain)
    made = {k: sum(n for n, _ in sigs.values()) for k, sigs in calls.items()}
    if made != {k: (want if k == "ssd_chunk_scan" else 0) for k in made}:
        raise AssertionError(f"{label}: kernel calls {made}, want "
                             f"{want} ssd_chunk_scan calls and no other")
    tally = tallies["ssd_chunk_scan"]
    worst = dict.fromkeys(DTYPES, 0.0)
    for i, (n, every) in enumerate(calls["ssd_chunk_scan"].values()):
        for dtype in DTYPES:
            for j, args in enumerate(every):
                cast = tuple(a.to(dtype) if torch.is_tensor(a)
                             and a.is_floating_point() else a for a in args)
                if j == 0:
                    err, times = hold_ssd_chunk_scan(f"{label} #{i} x{n}",
                                                     cast, peaks)
                    tally.add(dtype, err, {label: n}, times)
                else:
                    sf, y = ssd_chunk_scan(*cast[:6], launch=cast[6])
                    sf_p, y_p = ssd_chunk_scan_plain(*cast[:6])
                    err = max(check(f"{label} call {j} {dtype} y", y, y_p,
                                    KERNEL_RTOL[dtype]),
                              check(f"{label} call {j} {dtype} state", sf,
                                    sf_p, KERNEL_RTOL[dtype]))
                    tally.note(dtype, err)
                worst[dtype] = max(worst[dtype], err)
    print(f"{label}: all {want} ssd_chunk_scan calls held against the plain "
          f"version: max_abs_err f32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e}", flush=True)


def ssd_per_pass(cfg) -> int:
    """`ssd_chunk_scan` launches of one model pass: one per Mamba2 layer;
    none for RWKV6, whose WKV is plain PyTorch in both branches, as the
    reference's is no Pallas kernel."""
    return cfg.n_layers if cfg.ssm_kind == "mamba2" else 0


def model_check(name: str, model, params, batch: int, t: int, rng,
                smi: str) -> dict:
    """fp32: a prefill of `batch` seeded prompts of `t` tokens, then
    `MODEL_DECODE_STEPS` decode steps, their last-position logits held
    against `forward` over the same t + steps tokens within
    `MODEL_LOGIT_RTOL` of its largest |logit|.  The counts are set to 0
    just before the prefill and before the steps and read just after
    each; each pass launches `ssd_chunk_scan` `ssd_per_pass` times and no
    other kernel.  Returns the two walks."""
    steps, layers = MODEL_DECODE_STEPS, ssd_per_pass(model.cfg)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (batch, t + steps))).cuda()
    cache = model.init_cache(batch, t + steps, device="cuda")
    walks = {}
    label = f"{name} model prefill" + ("" if t == MODEL_PROMPTS[0]
                                       else f" T={t}")
    zero_counts()
    wall = time.perf_counter()
    logits, cache = model.prefill(params, toks[:, :t], cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    walks[label] = (label, read_counts())
    got = [logits]
    decode = label.replace("prefill", "decode")
    zero_counts()
    for i in range(steps):
        logits, cache = model.decode_step(params, toks[:, t + i:t + i + 1],
                                          cache, t + i)
        got.append(logits)
    torch.cuda.synchronize()
    walks[decode] = (decode, read_counts())
    for walk, want in ((label, layers), (decode, steps * layers)):
        counts = walks[walk][1]
        if counts != {k: (want if k == "ssd_chunk_scan" else 0)
                      for k in counts}:
            raise AssertionError(f"{walk}: launches {counts}, want {want} "
                                 f"ssd_chunk_scan launches and no other")
    full, _ = model.forward(params, toks)
    want = full[:, t - 1:]
    got = torch.stack(got, dim=1)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (got.shape == want.shape and np.isfinite(err)
            and err <= MODEL_LOGIT_RTOL * scale):
        raise AssertionError(f"{label}: prefill + {steps} decode steps "
                             f"differ from forward by {err:.3e} > "
                             f"{MODEL_LOGIT_RTOL} x {scale:.3g}")
    print(f"{label}: fp32 prefill of {batch} x {t} tokens in {wall:.3f} s "
          f"({layers} ssd_chunk_scan launches) + {steps} decode steps "
          f"({steps * layers} launches); "
          f"their last-position logits within {err:.3e} of forward over "
          f"{t + steps} tokens (largest |logit| {scale:.3g}, "
          f"{err / scale:.2e} of it, limit {MODEL_LOGIT_RTOL:g}); {smi}",
          flush=True)
    return walks


def prefill_breakdown(name: str, model, params, b: int, t_len: int,
                      max_len: int, rng, smi: str, part=None,
                      spans=()) -> None:
    """A bf16 prefill of `b` x `t_len` seeded tokens into a `max_len`
    cache: walls bare (median of 3), then device time by kernel under
    torch.profiler (`_profile`, with its `spans`), launches and the idle
    share, and `part(rows, busy, ranges)`'s text where given."""
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (b, t_len))).cuda()
    cache = model.init_cache(b, max_len, device="cuda")

    def prefill():
        model.prefill(params, toks, cache)

    prefill()
    torch.cuda.synchronize()
    bare = []
    for _ in range(3):
        t = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t) * 1e3)
    rows, busy, wall, host_calls, ranges = _profile(f"{name} prefill",
                                                    prefill, 2, spans=spans)
    extra = "" if part is None else f"{part(rows, busy, ranges)}; "
    print(f"profile {name} bf16 prefill of {b} x {t_len} tokens: wall "
          f"{statistics.median(bare):.3f} ms bare (median of 3: "
          + ", ".join(f"{w:.3f}" for w in bare) + f"), {wall:.3f} ms under "
          f"the profiler; kernels {busy:.3f} ms of device time in "
          f"{sum(r[1] for r in rows) / 2:g} launches (idle >= "
          f"{1 - busy / wall:.1%} of the profiled wall); {extra}host launch "
          f"calls {sum(host_calls.values()):g}; {smi}", flush=True)
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.3f} ms {count / 2:6g}x {key[:100]}", flush=True)


def model_phase(arch: str, peaks: dict, tallies: dict, smi: str) -> dict:
    """A model of `MODEL_ARCHS` at its published widths and full depth,
    its weights seeded draws made on the card: zamba2-7b (81 Mamba2
    layers, the shared attention applied 9 times), every Mamba2 layer's
    SSD core one `ssd_chunk_scan` launch per pass; rwkv6-1.6b (24 RWKV6
    layers), which launches none of the port's kernels (its WKV is plain
    PyTorch, as the reference's is no Pallas kernel; its plans run the
    kernels, `PATHS`):

    - fp32, TF32 off: prefills of `MODEL_PROMPTS` tokens (a multiple of
      the reference's chunk, its chunked branch, and one that is not, its
      step branch) and decode steps held against `forward` (`model_check`;
      for rwkv6-1.6b `forward` over 516 tokens takes the step recurrence,
      so the 512-token check holds the chunked WKV against it); every SSD
      call of one prefill and one decode step captured and held against
      its plain version in float32 and bfloat16 (`hold_model_calls`); the
      fixed-batch `ServingEngine` on `MODEL_EQUAL_REQUESTS` equal-length
      greedy prompts, each completion equal to the request served alone,
      token for token (neither model is pad-aware, in the reference too,
      so only equal lengths batch exactly);
    - bf16: the fixed-batch engine on `MODEL_SERVE_REQUESTS` requests of
      `MODEL_SERVE_PROMPT` tokens at batch `MODEL_SERVE_BATCH`, its
      tokens/s; a prefill at that batch timed bare and under
      torch.profiler (device time by kernel; the SSD kernels' share, or
      the chunked WKV's eager ops summed apart, `WKV_RANGE`); decode steps
      at batch 1 and 4 (`decode_breakdown`).

    Returns the walks as {walk: (times key, launch counts)}: counters set
    to 0 just before each walk, read just after."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import Request, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    name, n, layers = cfg.name, cfg.param_count(), ssd_per_pass(cfg)
    if cfg.ssm_kind == "mamba2":
        what = (f"{cfg.n_layers} Mamba2 layers (d_model {cfg.d_model}, "
                f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} SSM "
                f"heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}), the "
                f"shared attention ({cfg.n_heads} heads x {cfg.head_dim}, "
                f"d_ff {cfg.d_ff}) every {cfg.attn_every}")
    else:
        what = (f"{cfg.n_layers} RWKV6 layers (d_model {cfg.d_model}, "
                f"{cfg.d_model // cfg.ssm_head_dim} WKV heads x "
                f"{cfg.ssm_head_dim}, channel mix d_ff {cfg.d_ff})")
    print(f"model {name}: {what}, vocab {cfg.vocab_size}: "
          f"{n / 1e9:.3f} B parameters ({2 * n / 1e9:.1f} GB bf16, "
          f"{4 * n / 1e9:.1f} GB fp32); "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated on the "
          f"card before the phase", flush=True)
    walks = {}
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    t = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model fp32 weights: drawn on the card in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    rng = np.random.default_rng(21)
    for t_len in MODEL_PROMPTS:
        walks.update(model_check(name, model, params, MODEL_FP32_BATCH,
                                 t_len, rng, smi))

    if layers:
        # every SSD call of one prefill and one decode step, held
        label = f"{name} model prefill"
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
            MODEL_FP32_BATCH, MODEL_PROMPTS[0] + 1))).cuda()
        cache = model.init_cache(MODEL_FP32_BATCH, MODEL_PROMPTS[0] + 1,
                                 device="cuda")
        calls = capture_calls(lambda: model.prefill(
            params, toks[:, :-1], cache), every=True)
        hold_model_calls(label, calls, layers, peaks, tallies)
        calls = capture_calls(lambda: model.decode_step(
            params, toks[:, -1:], cache, MODEL_PROMPTS[0]), every=True)
        hold_model_calls(f"{name} model decode", calls, layers, peaks,
                         tallies)
        del calls, cache

    # the fixed-batch engine: batched greedy tokens against solo runs
    max_len = MODEL_EQUAL_PROMPT + MODEL_EQUAL_NEW
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, MODEL_EQUAL_PROMPT).astype(np.int32),
                max_new_tokens=MODEL_EQUAL_NEW)
            for i in range(MODEL_EQUAL_REQUESTS)]
    label = f"{name} model serve fp32"
    zero_counts()
    done = ServingEngine(cfg, model, params, max_batch=MODEL_EQUAL_REQUESTS,
                         max_len=max_len, device="cuda").run(reqs)
    walks[label] = (None, read_counts())
    for r, c in zip(reqs, done):
        want = ServingEngine(cfg, model, params, max_batch=1,
                             max_len=max_len, device="cuda").run([r])[0]
        if c.tokens != want.tokens:
            raise AssertionError(
                f"{label}: the batched tokens differ from the solo run's: "
                + _first_divergence(model, params, r, c.tokens, want.tokens,
                                    max_len))
    print(f"{label}: {len(reqs)} greedy requests of {MODEL_EQUAL_PROMPT} "
          f"tokens batched together, each completion equal to the request "
          f"served alone, token for token ({sum(len(c.tokens) for c in done)}"
          f" tokens)", flush=True)
    del model, params
    torch.cuda.empty_cache()

    # bf16, the configuration's serving dtype, at full depth
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, t_len, new = MODEL_SERVE_BATCH, MODEL_SERVE_PROMPT, MODEL_SERVE_NEW
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, t_len).astype(np.int32),
                max_new_tokens=new) for i in range(MODEL_SERVE_REQUESTS)]
    engine = ServingEngine(cfg, model, params, max_batch=b,
                           max_len=t_len + new, device="cuda")
    engine.run([dataclasses.replace(reqs[0], max_new_tokens=2)])   # warm
    label = f"{name} model serve bf16"
    zero_counts()
    t = time.perf_counter()
    done = engine.run(reqs)
    host = time.perf_counter() - t
    walks[label] = (None, read_counts())
    tokens = sum(len(c.tokens) for c in done)
    launches = walks[label][1]["ssd_chunk_scan"]
    batches = -(-len(reqs) // b)
    if (tokens != len(reqs) * new or launches != batches * new * layers
            or not all(0 <= v < cfg.vocab_size for c in done
                       for v in c.tokens)):
        raise AssertionError(f"{label}: {tokens} tokens and {launches} SSD "
                             f"launches, want {len(reqs) * new} in [0, "
                             f"{cfg.vocab_size}) and "
                             f"{batches * new * layers}")
    print(f"{label}: {len(reqs)} greedy requests of {t_len} tokens in "
          f"batches of {b}, {new} new tokens each: {tokens} tokens in "
          f"{host:.3f} s ({tokens / host:.1f} tok/s; {launches} "
          f"ssd_chunk_scan launches); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; {smi}",
          flush=True)

    # the prefill: bare walls, then device time by kernel
    def part(rows, busy, spans) -> str:
        if layers:
            ssd, phases = ssd_device_ms(rows)
            return (f"the SSD chunk kernels {ssd:.3f} ms ({ssd / busy:.1%} "
                    f"of the device time: {phases})")
        wkv = spans[WKV_RANGE]
        return (f"the chunked WKV's eager ops {wkv:.3f} ms "
                f"({wkv / busy:.1%} of the device time)")

    with wkv_range():
        prefill_breakdown(name, model, params, b, t_len, t_len + new, rng,
                          smi, part, spans=(WKV_RANGE,))
    for batch in (1, b):
        decode_breakdown(f"{name} model bf16", model, params, batch)
    print(f"model {name}: {smi}", flush=True)
    del model, params, engine
    torch.cuda.empty_cache()
    return walks


# ------------------------------------------------------- MLA and MoE models

def mla_dense(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Causal MLA over all of `x` through the dense latent scores:
    `mla_full`'s branch below its flash threshold, at any length
    (`mla_full` takes the flash walk from 2048 tokens on, which needs
    whole 1024-token chunks)."""
    from repro_torch.models import mla
    b, t, _ = x.shape
    ar = torch.arange(t, device=x.device)
    pos = ar.expand(b, t)
    q_nope, q_rope = mla._queries(p, x, cfg, pos)
    c_kv, k_rope = mla._latents(p, x, cfg, pos)
    return mla._attend_latent(p, q_nope, q_rope, c_kv, k_rope,
                              ar[None, :] <= ar[:, None], cfg)


def mla_layer_check(p: dict, cfg, gen, smi: str) -> None:
    """fp32, TF32 off: one MLA layer's `mla_prefill` over T seeded inputs,
    then one `mla_decode` step into an S-position latent cache, against
    the dense causal pass over the T + 1 inputs, within
    `MODEL_LOGIT_RTOL` of its largest |value|, for each (T, S) of
    `DS_MLA_CASES`: both dense, then both flash (`flash_latent_full`,
    `flash_latent_decode`)."""
    from repro_torch.models import mla
    for t, s in DS_MLA_CASES:
        x = torch.randn((1, t + 1, cfg.d_model), generator=gen,
                        device="cuda")
        want = mla_dense(p, x, cfg)
        wall = time.perf_counter()
        out, (c_kv, k_rope) = mla.mla_prefill(p, x[:, :t], cfg)
        cache_c = torch.zeros((1, s, cfg.kv_lora_rank), device="cuda")
        cache_k = torch.zeros((1, s, cfg.qk_rope_head_dim), device="cuda")
        cache_c[:, :t], cache_k[:, :t] = c_kv, k_rope
        step, _, _ = mla.mla_decode(p, x[:, t:], cfg, cache_c, cache_k, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        got = torch.cat([out, step], dim=1)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        branch = (("flash" if t >= mla._FLASH_THRESHOLD else "dense")
                  + " prefill, "
                  + ("flash" if s >= mla._DECODE_FLASH_THRESHOLD
                     else "dense") + " decode")
        if not (np.isfinite(err) and err <= MODEL_LOGIT_RTOL * scale):
            raise AssertionError(f"mla layer T={t} S={s} ({branch}): "
                                 f"prefill + decode differ from the dense "
                                 f"pass by {err:.3e} > {MODEL_LOGIT_RTOL} x "
                                 f"{scale:.3g}")
        print(f"mla layer T={t} S={s} ({branch}): mla_prefill over {t} "
              f"inputs + one mla_decode step within {err:.3e} of the dense "
              f"causal pass over {t + 1} ({err / scale:.2e} of its largest "
              f"|value| {scale:.3g}, limit {MODEL_LOGIT_RTOL:g}); "
              f"{wall:.3f} s; {smi}", flush=True)


def moe_loop(p: dict, x: torch.Tensor, cfg, capacity: int) -> tuple:
    """The MoE layer's capacity semantics one (token, slot) at a time: each
    token's fp32 router probabilities ranked on the host (a tie to the
    lower expert), its top-k gates renormalised, then its slots in flat
    (token, slot) order, each kept while its expert has taken fewer than
    `capacity` pairs and run through that expert's FFN alone; plus the
    shared experts.  Returns (y, dropped pairs)."""
    import torch.nn.functional as F

    from repro_torch.models.layers import mlp
    e, k = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1).cpu().numpy()
    taken = [0] * e
    dropped = 0
    y = torch.zeros_like(xt)
    for i, row in enumerate(probs):
        top = sorted(range(e), key=lambda j: (-row[j], j))[:k]
        gates = row[top] / max(float(row[top].sum()), 1e-9)
        for g, j in zip(gates, top):
            if taken[j] >= capacity:
                dropped += 1
                continue
            taken[j] += 1
            h = F.silu(xt[i] @ p["w_gate"][j]) * (xt[i] @ p["w_up"][j])
            y[i] += float(g) * (h @ p["w_down"][j])
    if "shared" in p:
        y = y + mlp(p["shared"], xt)
    return y.reshape(x.shape), dropped


def moe_layer_check(p: dict, cfg, gen, smi: str) -> None:
    """fp32, TF32 off: one MoE layer on `DS_MOE_TOKENS` seeded inputs
    against `moe_loop` at the same capacity, within `MODEL_LOGIT_RTOL` of
    its largest |value|; both must drop the same number of (token, slot)
    pairs.  The count is printed; none dropped is a finding of these
    draws, not a pass of the drop path (the CPU tests hold a binding
    case against the reference)."""
    from repro_torch.models import moe
    b, t = DS_MOE_TOKENS
    k = cfg.experts_per_token
    x = torch.randn((b, t, cfg.d_model), generator=gen, device="cuda")
    cap = moe.expert_capacity(b * t, cfg)
    wall = time.perf_counter()
    y, aux = moe.moe_layer(p, x, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    *_, keep = moe.route(p, x.reshape(b * t, -1), cfg, cap)
    drops = int((~keep).sum())
    want, loop_drops = moe_loop(p, x, cfg, cap)
    err = float((y - want).abs().max())
    scale = float(want.abs().max())
    if drops != loop_drops or not (np.isfinite(err)
                                   and err <= MODEL_LOGIT_RTOL * scale):
        raise AssertionError(f"moe layer: {drops} drops against the loop's "
                             f"{loop_drops}; max |err| {err:.3e} > "
                             f"{MODEL_LOGIT_RTOL} x {scale:.3g}?")
    note = ("" if drops else " (none dropped: a finding of these draws, "
            "not a pass of the drop path)")
    print(f"moe layer ({cfg.n_experts} experts, top-{k}, "
          f"{cfg.n_shared_experts} shared, ff {cfg.moe_d_ff}) on {b} x {t} "
          f"tokens: capacity {cap} per expert; {drops} of {b * t * k} "
          f"(token, slot) pairs dropped{note}; within {err:.3e} of the "
          f"per-token loop ({err / scale:.2e} of its largest |value| "
          f"{scale:.3g}, limit {MODEL_LOGIT_RTOL:g}); aux {float(aux):.4f}; "
          f"layer {wall:.3f} s; {smi}", flush=True)


def greedy_loop(model, params, batch: list, max_len: int, new: int) -> list:
    """Greedy tokens of `batch` (equal-length prompts) from the model's own
    prefill and `decode_step` loop, as the engine's greedy sampling takes
    them (argmax)."""
    toks = torch.from_numpy(np.stack([r.prompt for r in batch]).astype(
        np.int64)).cuda()
    t = toks.shape[1]
    cache = model.init_cache(len(batch), max_len, device="cuda")
    logits, cache = model.prefill(params, toks, cache)
    tok = logits.argmax(-1)
    out = [tok]
    for step in range(1, new):
        logits, cache = model.decode_step(params, tok[:, None], cache,
                                          t + step - 1)
        tok = logits.argmax(-1)
        out.append(tok)
    return torch.stack(out, dim=1).tolist()


def deepseek_phase(smi: str, compiled) -> dict:
    """deepseek-v2-lite-16b (`DS_ARCH`) at its published widths and full
    depth (27 layers: MLA attention with kv_lora_rank 512, a dense first
    layer, then 64 routed experts top-6 and 2 shared of ff 1408), its
    weights seeded draws made on the card.  Its model path is plain
    PyTorch (the reference's MLA and MoE are no Pallas kernels), so no
    model pass launches a kernel of the port; its decode-step plan
    (`PATHS`, and the engine below) runs `split_matmul` and
    `decode_attention`.  MoE capacity is per call (a token's output
    depends on the other tokens of its call), so each check compares
    calls with the same tokens:

    - fp32, TF32 off: `prefill` on `DS_FP32_BATCH` x `DS_FP32_PROMPT`
      tokens against `forward` on the same tokens (the same N, so the
      same capacity and drops) within `MODEL_LOGIT_RTOL` of its largest
      |logit|; one MLA layer in both branches (`mla_layer_check`); one MoE
      layer against its per-token loop (`moe_layer_check`);
    - bf16: the fixed-batch engine on `MODEL_SERVE_REQUESTS` equal-length
      prompts of `MODEL_SERVE_PROMPT` tokens at batch `MODEL_SERVE_BATCH`
      (tokens/s), equal token for token to the model's own prefill and
      greedy decode loop at that batch (`greedy_loop`); how many batched
      completions differ from the request served alone, printed, not
      asserted (capacity drops make a difference legitimate); a prefill at
      that batch bare and under torch.profiler; decode steps at batch 1
      and 4 (`decode_breakdown`); the engine shipping the deepseek plan
      (`compiled=`, as `serve --compiled` ships it: `compiled` is the
      network the compile phase held equal to the committed artifact,
      whose executor its main path built, so the plan's 1.4 B seeded
      weights are not drawn again), its `execute_plan()` within
      `E2E_RTOL` of `run_oracle` with the plan's launch counts.

    Returns the walks as {walk: (times key, launch counts)}: counters set
    to 0 just before each walk, read just after."""
    from repro_torch.models import build_model, get_config
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serving import Request, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(DS_ARCH)
    name, n = cfg.name, cfg.param_count()
    print(f"model {name}: {cfg.n_layers} layers (d_model {cfg.d_model}, "
          f"MLA {cfg.n_heads} heads, kv_lora_rank {cfg.kv_lora_rank}, rope "
          f"{cfg.qk_rope_head_dim}, nope {cfg.qk_nope_head_dim}, v "
          f"{cfg.v_head_dim}; {cfg.first_dense_layers} dense layer of d_ff "
          f"{cfg.d_ff}, then {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token} + {cfg.n_shared_experts} shared of ff "
          f"{cfg.moe_d_ff}), vocab {cfg.vocab_size}: {n / 1e9:.3f} B "
          f"parameters, {cfg.active_param_count() / 1e9:.3f} B active "
          f"({2 * n / 1e9:.1f} GB bf16, {4 * n / 1e9:.1f} GB fp32): full "
          f"width and depth, not reduced; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated on the "
          f"card before the phase", flush=True)
    walks = {}
    none = dict.fromkeys(KERNEL_NAMES, 0)

    def no_kernels(label: str, counts: dict) -> None:
        if counts != none:
            raise AssertionError(f"{label}: launches {counts}; the model "
                                 f"path launches none of the port's "
                                 f"kernels")

    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    t = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model fp32 weights: drawn on the card in "
          f"{time.perf_counter() - t:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated",
          flush=True)
    rng = np.random.default_rng(25)
    b, t_len = DS_FP32_BATCH, DS_FP32_PROMPT
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (b, t_len))).cuda()
    cache = model.init_cache(b, t_len, device="cuda")
    label = f"{name} model prefill"
    zero_counts()
    wall = time.perf_counter()
    logits, _ = model.prefill(params, toks, cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    walks[label] = (None, read_counts())
    no_kernels(label, walks[label][1])
    full, aux = model.forward(params, toks)
    want = full[:, -1]
    err = float((logits - want).abs().max())
    scale = float(want.abs().max())
    if not (logits.shape == want.shape and np.isfinite(err)
            and err <= MODEL_LOGIT_RTOL * scale):
        raise AssertionError(f"{label}: prefill logits differ from forward "
                             f"by {err:.3e} > {MODEL_LOGIT_RTOL} x "
                             f"{scale:.3g}")
    print(f"{label}: fp32 prefill of {b} x {t_len} tokens in {wall:.3f} s, "
          f"its last-position logits within {err:.3e} of forward on the "
          f"same tokens (largest |logit| {scale:.3g}, {err / scale:.2e} of "
          f"it, limit {MODEL_LOGIT_RTOL:g}); aux loss {float(aux):.4f}; no "
          f"kernel of the port launched; {smi}", flush=True)
    del cache, full, logits
    gen = torch.Generator(device="cuda").manual_seed(26)
    layer = params["pattern"][0][0]
    mla_layer_check(layer["attn"], cfg, gen, smi)
    moe_layer_check(layer["ffn"], cfg, gen, smi)
    del model, params, layer
    gc.collect()
    torch.cuda.empty_cache()

    # bf16, the configuration's serving dtype, at full depth
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, t_len, new = MODEL_SERVE_BATCH, MODEL_SERVE_PROMPT, MODEL_SERVE_NEW
    max_len = t_len + new
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, t_len).astype(np.int32),
                max_new_tokens=new) for i in range(MODEL_SERVE_REQUESTS)]
    engine = ServingEngine(cfg, model, params, max_batch=b, max_len=max_len,
                           device="cuda")
    engine.run([dataclasses.replace(reqs[0], max_new_tokens=2)])   # warm
    label = f"{name} model serve bf16"
    zero_counts()
    t = time.perf_counter()
    done = engine.run(reqs)
    host = time.perf_counter() - t
    walks[label] = (None, read_counts())
    no_kernels(label, walks[label][1])
    tokens = sum(len(c.tokens) for c in done)
    if tokens != len(reqs) * new or not all(
            0 <= v < cfg.vocab_size for c in done for v in c.tokens):
        raise AssertionError(f"{label}: {tokens} tokens, want "
                             f"{len(reqs) * new} in [0, {cfg.vocab_size})")
    for i in range(0, len(reqs), b):
        loop = greedy_loop(model, params, reqs[i:i + b], max_len, new)
        got = [c.tokens for c in done[i:i + b]]
        if got != loop:
            raise AssertionError(f"{label}: the engine's tokens of requests "
                                 f"{i}..{i + b - 1} differ from the model's "
                                 f"own prefill + greedy decode loop at "
                                 f"batch {b}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    solo = ServingEngine(cfg, model, params, max_batch=1, max_len=max_len,
                         device="cuda")
    differ = sum(solo.run([r])[0].tokens != c.tokens
                 for r, c in zip(reqs[:b], done))
    print(f"{label}: {len(reqs)} greedy requests of {t_len} tokens in "
          f"batches of {b}, {new} new tokens each: {tokens} tokens in "
          f"{host:.3f} s ({tokens / host:.1f} tok/s); equal token for token "
          f"to the model's own prefill + greedy decode loop at batch {b}; "
          f"{differ} of the first batch's {b} completions differ from the "
          f"request served alone (not asserted: a decode step's {b} tokens "
          f"share "
          f"each expert's capacity of {expert_capacity(b, cfg)}, the "
          f"prefill's {b * t_len} a capacity of "
          f"{expert_capacity(b * t_len, cfg)}); peak memory {peak:.1f} GB; "
          f"{smi}", flush=True)
    prefill_breakdown(name, model, params, b, t_len, max_len, rng, smi)
    for batch in (1, b):
        decode_breakdown(f"{name} model bf16", model, params, batch)

    # the engine shipping the decode-step plan, as `serve --compiled`
    # ships the committed artifact; the executor is warm from the main path
    engine = ServingEngine(cfg, model, params, max_batch=b,
                           max_len=max_len, compiled=compiled,
                           device="cuda")
    engine.plan_executor.run(warmup=True)
    label = f"{name} serve --compiled"
    zero_counts()
    engine.run([dataclasses.replace(r, max_new_tokens=4)
                for r in reqs[:b]])
    y, report = engine.execute_plan()
    walks[label] = (None, read_counts())
    oracle = engine.plan_executor.run_oracle()
    torch.cuda.synchronize()
    err = float((y - oracle).abs().max())
    scale = max(1.0, float(oracle.abs().max()))
    want = expected_counts(compiled.plan)
    got = walks[label][1]
    if not (np.isfinite(err) and err <= E2E_RTOL[DS] * scale) or any(
            got[k] != want[k] for k in KERNEL_NAMES):
        raise AssertionError(f"{label}: execute_plan within {err:.3e} of "
                             f"run_oracle (limit {E2E_RTOL[DS]} x "
                             f"{scale:.3g}); launches {got}, want {want}")
    print(f"{label}: the bf16 engine served {b} requests shipping the "
          f"plan (key {compiled.key}, equal to {DS_ARTIFACT.name}); "
          f"execute_plan within {err:.3e} of run_oracle (scale "
          f"{scale:.3g}, limit {E2E_RTOL[DS]:g}); launches split_matmul "
          f"{got['split_matmul']}, decode_attention "
          f"{got['decode_attention']}; {report.fidelity_summary()}",
          flush=True)
    print(f"model {name}: {smi}", flush=True)
    del model, params, engine, solo
    gc.collect()
    torch.cuda.empty_cache()
    return walks


def llama4_phase(smi: str) -> dict:
    """llama4-scout-17b-a16e (`L4_ARCH`) at its published widths, cut to
    `L4_LAYERS` of its 48 layers (reduced: depth only; the whole model,
    215.5 GB in bf16, does not fit one card), bf16, its weights seeded
    draws made on the card: GQA attention (40 heads, 8 KV) and 16 routed
    experts top-1 plus one shared on every layer.  `prefill` on
    `L4_BATCH` x `L4_PROMPT` tokens against `forward` on the same tokens
    within `BF16_RTOL` of its largest |logit|; decode steps at batch 1
    and 4 at per-slot positions (`decode_breakdown`); the continuous
    scheduler (per-slot positions: GQA) on `L4_REQUESTS` greedy Poisson
    requests on the wall clock, every one completed.  No pass launches a
    kernel of the port.  Returns the walks."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import (ContinuousScheduler, SchedulerConfig,
                                     poisson_requests)

    gc.collect()
    torch.cuda.empty_cache()
    whole = get_config(L4_ARCH)
    cfg = dataclasses.replace(whole, n_layers=L4_LAYERS)
    name, n = cfg.name, cfg.param_count()
    print(f"model {name}: {cfg.n_layers} of {whole.n_layers} layers (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, kv "
          f"{cfg.n_kv_heads}; {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token} + {cfg.n_shared_experts} shared of ff "
          f"{cfg.moe_d_ff}), vocab {cfg.vocab_size}: {n / 1e9:.3f} B "
          f"parameters ({2 * n / 1e9:.1f} GB bf16; the whole model "
          f"{whole.param_count() / 1e9:.2f} B, "
          f"{2 * whole.param_count() / 1e9:.1f} GB): reduced, depth only; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated on the "
          f"card before the phase", flush=True)
    walks = {}
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model bf16 weights: drawn on the card in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    rng = np.random.default_rng(27)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (L4_BATCH, L4_PROMPT))).cuda()
    cache = model.init_cache(L4_BATCH, L4_PROMPT, device="cuda")
    label = f"{name} model prefill"
    zero_counts()
    wall = time.perf_counter()
    logits, _ = model.prefill(params, toks, cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    walks[label] = (None, read_counts())
    full, aux = model.forward(params, toks)
    want = full[:, -1]
    err = float((logits.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not (logits.shape == want.shape and np.isfinite(err)
            and err <= BF16_RTOL * scale) or any(walks[label][1].values()):
        raise AssertionError(f"{label}: bf16 prefill logits differ from "
                             f"forward by {err:.3e} (limit {BF16_RTOL} x "
                             f"{scale:.3g}), or launches "
                             f"{walks[label][1]}")
    print(f"{label}: bf16 prefill of {L4_BATCH} x {L4_PROMPT} tokens in "
          f"{wall:.3f} s, its last-position logits within {err:.3e} of "
          f"forward on the same tokens (largest |logit| {scale:.3g}, "
          f"{err / scale:.2e} of it, limit {BF16_RTOL:g}); aux loss "
          f"{float(aux):.4f}; {smi}", flush=True)
    del cache, full, logits
    for batch in (1, MODEL_SERVE_BATCH):
        decode_breakdown(f"{name} model bf16", model, params, batch)
    reqs = poisson_requests(L4_REQUESTS, rate=50.0,
                            vocab_size=cfg.vocab_size,
                            prompt_lens=(4, 8, 16), max_new=(4, 8, 12),
                            temperatures=(0.0,), seed=29)
    label = f"{name} scheduler"
    zero_counts()
    rep = ContinuousScheduler(
        cfg, model, params, device="cuda",
        config=SchedulerConfig(max_batch=MODEL_SERVE_BATCH, max_len=64,
                               clock="wall")).run(reqs)
    walks[label] = (None, read_counts())
    if (sorted(c.rid for c in rep.completions) != [r.rid for r in reqs]
            or rep.total_tokens != sum(r.max_new_tokens for r in reqs)):
        raise AssertionError(f"{label}: {len(rep.completions)} completions, "
                             f"{rep.total_tokens} tokens, want every one of "
                             f"{len(reqs)} requests")
    print(f"{label}: " + rep.summary().replace("\n", "; ")
          + f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
          f"GB; {smi}", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return walks


# ------------------------------------------------- Whisper and the training

#: the profiler range around each decoder layer's cross K/V products
#: (`cross_kv_range`)
XKV_RANGE = "whisper cross k/v"


@contextlib.contextmanager
def cross_kv_range():
    """Each `encdec.cross_kv` call inside the block runs in a
    `record_function` range named `XKV_RANGE`, so a profile sums the
    cross K/V products' device time apart (`_profile`'s `spans`).  The
    model code is not changed: `_decoder_stack` looks the function up in
    its module at each call."""
    from torch.profiler import record_function

    from repro_torch.models import encdec
    real = encdec.cross_kv

    def ranged(*args):
        with record_function(XKV_RANGE):
            return real(*args)

    encdec.cross_kv = ranged
    try:
        yield
    finally:
        encdec.cross_kv = real


def whisper_frames(gen, b: int, cfg) -> torch.Tensor:
    """`b` seeded frame-embedding rows (the stubbed conv frontend's
    output, scaled as the reference's `make_batch` scales them), drawn on
    the card."""
    return torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device="cuda").mul_(0.02)


def whisper_teacher_check(model, params, smi: str) -> None:
    """fp32 (TF32 off): `prefill` of `WHISPER_BATCH` x `WHISPER_PROMPT`
    seeded tokens over seeded frames, then `WHISPER_DECODE_STEPS`
    teacher-fed `decode_step`s at device-tensor positions; every step's
    logits within `MODEL_LOGIT_RTOL` of the largest |logit| of the
    teacher-forced pass the loss takes (`encode` -> `_decoder_stack(mode=
    "train")` -> `ln_dec` -> `unembed`) at the same positions."""
    from repro_torch.models.layers import rms_norm

    cfg = model.cfg
    b, t, steps = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE_STEPS
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = whisper_frames(gen, b, cfg)
    toks = torch.randint(0, cfg.vocab_size, (b, t + steps), generator=gen,
                         device="cuda")
    cache = model.init_cache(b, t + steps, device="cuda")
    wall = time.perf_counter()
    logits, cache = model.prefill(params, toks[:, :t], cache, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    got = [logits]
    for i in range(steps):
        pos = torch.tensor(t + i, device="cuda")
        logits, cache = model.decode_step(params, toks[:, t + i:t + i + 1],
                                          cache, pos)
        got.append(logits)
    got = torch.stack(got, dim=1)
    enc = model.encode(params, frames)
    x, _ = model._decoder_stack(params, model._dec_embed(params, toks), enc,
                                "train")
    full = rms_norm(x, params["ln_dec"], cfg.norm_eps) @ params["unembed"]
    want = full[:, t - 1:]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (got.shape == want.shape and np.isfinite(err)
            and err <= MODEL_LOGIT_RTOL * scale):
        raise AssertionError(f"whisper fp32: prefill + {steps} decode steps "
                             f"differ from the teacher-forced pass by "
                             f"{err:.3e} > {MODEL_LOGIT_RTOL} x {scale:.3g}")
    print(f"whisper fp32: prefill of {b} x {t} tokens over {b} x "
          f"{cfg.encoder_seq} frames in {wall:.3f} s + {steps} teacher-fed "
          f"decode steps; their logits within {err:.3e} of the teacher-"
          f"forced pass (largest |logit| {scale:.3g}, {err / scale:.2e} of "
          f"it, limit {MODEL_LOGIT_RTOL:g}); {smi}", flush=True)


def whisper_reduced_check(cfg) -> None:
    """Reduced whisper-large-v3 in fp32 (its 1500 encoder positions kept):
    the same seeded weights and frames on the CPU and on the card, a
    prefill then 4 decode steps; every logit within `SERVE_LOGIT_RTOL` of
    the largest |CPU logit| (the CPU tests tie the CPU path to the
    reference's)."""
    from repro_torch.models import build_model
    small = dataclasses.replace(cfg.reduced(), dtype="float32")
    model = build_model(small)
    params = {"cpu": model.init(torch.Generator().manual_seed(0))}
    params["cuda"] = _to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(501)
    b, t = 2, 12
    frames = torch.from_numpy((rng.standard_normal(
        (b, small.encoder_seq, small.d_model)) * 0.02).astype(np.float32))
    toks = torch.from_numpy(rng.integers(1, small.vocab_size, (b, t)))
    steps = torch.from_numpy(rng.integers(1, small.vocab_size, (4, b, 1)))
    logits = {}
    for dev in ("cpu", "cuda"):
        cache = model.init_cache(b, 32, device=dev)
        out, cache = model.prefill(params[dev], toks.to(dev), cache,
                                   frames.to(dev))
        logits[dev] = [out]
        for i, tok in enumerate(steps):
            out, cache = model.decode_step(params[dev], tok.to(dev), cache,
                                           t + i)
            logits[dev].append(out)
    worst = 0.0
    for i, (want, got) in enumerate(zip(logits["cpu"], logits["cuda"])):
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if not err <= SERVE_LOGIT_RTOL * scale:
            raise AssertionError(f"whisper reduced: step {i} logits on the "
                                 f"card differ from the CPU's by {err:.3e} "
                                 f"> {SERVE_LOGIT_RTOL} x {scale:.3g}")
    print(f"whisper reduced {small.name} (d_model {small.d_model}, "
          f"{small.encoder_layers} + {small.n_layers} layers, "
          f"{small.encoder_seq} frames, fp32): prefill + 4 decode steps on "
          f"the card within {worst:.2e} of the CPU's largest |logit| "
          f"(limit {SERVE_LOGIT_RTOL:g})", flush=True)


def whisper_phase(smi: str) -> dict:
    """whisper-large-v3 (`WHISPER_ARCH`) at its published widths and full
    depth (32 encoder and 32 decoder layers, d_model 1280, 20 heads, d_ff
    5120, vocab 51866, 1500 encoder positions: 2.02 B parameters), its
    weights seeded draws made on the card and its frames seeded (the
    conv frontend is a stub, as in the reference):

    - fp32, TF32 off: prefill and teacher-fed decode steps against the
      teacher-forced pass (`whisper_teacher_check`);
    - the reduced model on the card against the CPU
      (`whisper_reduced_check`);
    - bf16: the fixed-batch `ServingEngine` on `WHISPER_REQUESTS` requests
      with seeded frames and 4-16-token prompts at batch
      `MODEL_SERVE_BATCH`, `WHISPER_NEW` new tokens each (tokens/s); the
      TTFT, one batched `prefill` (its `encode` included) and a sync,
      median of 3; decode steps at batch 1 and 4 (`decode_breakdown`),
      the cross K/V products summed apart (`cross_kv_range`).

    No pass launches a kernel of the port (the reference's Whisper runs
    no Pallas kernel).  Returns the walks."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import Request, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    name, n = cfg.name, cfg.param_count()
    print(f"model {name}: {cfg.encoder_layers} encoder + {cfg.n_layers} "
          f"decoder layers (d_model {cfg.d_model}, {cfg.n_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}), vocab {cfg.vocab_size}, "
          f"{cfg.encoder_seq} encoder positions: {n / 1e9:.3f} B parameters "
          f"({2 * n / 1e9:.1f} GB bf16, {4 * n / 1e9:.1f} GB fp32); "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated on the "
          f"card before the phase", flush=True)
    walks = {}
    with torch.no_grad():
        model = build_model(dataclasses.replace(cfg, dtype="float32"))
        t = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        print(f"whisper fp32 weights: drawn on the card in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        label = f"{name} model fp32"
        zero_counts()
        whisper_teacher_check(model, params, smi)
        walks[label] = (None, read_counts())
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        whisper_reduced_check(cfg)

        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(2)
        rng = np.random.default_rng(31)
        reqs = []
        for i in range(WHISPER_REQUESTS):
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=rng.integers(4, 17)).astype(np.int32)
            frames = whisper_frames(gen, 1, cfg)[0].cpu().numpy()
            reqs.append(Request(rid=i, prompt=prompt, frames=frames,
                                max_new_tokens=WHISPER_NEW))
        b = MODEL_SERVE_BATCH
        engine = ServingEngine(cfg, model, params, max_batch=b,
                               max_len=16 + WHISPER_NEW, device="cuda")
        engine.run([dataclasses.replace(reqs[0], max_new_tokens=2)])  # warm
        label = f"{name} serve bf16"
        zero_counts()
        t = time.perf_counter()
        done = engine.run(reqs)
        host = time.perf_counter() - t
        walks[label] = (None, read_counts())
        tokens = sum(len(c.tokens) for c in done)
        if tokens != len(reqs) * WHISPER_NEW or not all(
                0 <= v < cfg.vocab_size for c in done for v in c.tokens):
            raise AssertionError(f"{label}: {tokens} tokens, want "
                                 f"{len(reqs) * WHISPER_NEW} in [0, "
                                 f"{cfg.vocab_size})")

        # TTFT: one batched prefill (the encoder included) and a sync
        frames = whisper_frames(gen, b, cfg)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (b, 16))).cuda()
        ttft = []
        for _ in range(4):
            cache = model.init_cache(b, 16 + WHISPER_NEW, device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.prefill(params, toks, cache, frames)
            torch.cuda.synchronize()
            ttft.append((time.perf_counter() - t) * 1e3)
        ttft = ttft[1:]                    # the first call warms the shapes
        print(f"{label}: {len(reqs)} greedy requests (4-16-token prompts, "
              f"{cfg.encoder_seq} seeded frames each) in batches of {b}, "
              f"{WHISPER_NEW} new tokens each: {tokens} tokens in "
              f"{host:.3f} s ({tokens / host:.1f} tok/s); TTFT (a batched "
              f"prefill of {b} x 16 tokens, encode included, and a sync) "
              f"{statistics.median(ttft):.3f} ms (median of 3: "
              + ", ".join(f"{v:.3f}" for v in ttft) + f"); peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; {smi}",
              flush=True)
        del cache, frames
        with cross_kv_range():
            for batch in (1, b):
                decode_breakdown(f"{name} model bf16", model, params, batch,
                                 spans=(XKV_RANGE,))
    if any(c for _, counts in walks.values() for c in counts.values()):
        raise AssertionError(f"whisper: a kernel of the port was launched: "
                             f"{walks}")
    print(f"model {name}: {smi}", flush=True)
    del model, params, engine
    gc.collect()
    torch.cuda.empty_cache()
    return walks


def _grad_errors(got, want) -> tuple:
    """The worst leaf's max |got - want| relative to that leaf's largest
    |want|, and that leaf's index."""
    from repro_torch.core.tree import tree_leaves
    worst, at = 0.0, None
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        a, b = a.float().cpu(), b.float()
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not np.isfinite(err) or err > worst:
            worst, at = err, i
    return worst, at


def train_step_check(arch: str, peaks: dict, tallies: dict) -> dict:
    """One train step of reduced `arch` in fp32 (TF32 off) on the card and
    on the CPU from the same seeded weights and batch: the loss within
    `TRAIN_RTOL` of the CPU's, and every leaf's gradient within
    `TRAIN_RTOL` of that leaf's largest |CPU gradient|.  The counts are set
    to 0 just before the card's step and read just after; a Mamba2 model
    must launch `ssd_chunk_scan` once per layer (through `ScanWithGrad`,
    whose backward carries the gradient upstream of the scan), and every
    SSD call of its forward is held against its plain version in float32
    and bfloat16 and timed (`hold_model_calls`).  Returns the walk."""
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = {"cpu": model.init(torch.Generator().manual_seed(0))}
    params["cuda"] = _to_device(params["cpu"], "cuda")
    raw = make_batch(cfg, 2, TRAIN_CHECK_SEQ, seed=7)
    out = {}
    for dev in ("cpu", "cuda"):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        if dev == "cuda":
            zero_counts()
        out[dev] = loss_and_grads(model, params[dev], batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
    (want_loss, want), (loss, got) = out["cpu"], out["cuda"]
    loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    worst, at = _grad_errors(got, want)
    label = f"{cfg.name} train step"
    mamba = cfg.ssm_kind == "mamba2"
    if not (loss_err <= TRAIN_RTOL and worst <= TRAIN_RTOL):
        raise AssertionError(f"{label}: the card's loss is {loss_err:.2e} "
                             f"and its gradient (leaf #{at}) {worst:.2e} "
                             f"from the CPU's, limit {TRAIN_RTOL:g}")
    want_launches = cfg.n_layers if mamba else 0
    if counts != {k: (want_launches if k == "ssd_chunk_scan" else 0)
                  for k in counts}:
        raise AssertionError(f"{label}: launches {counts}, want "
                             f"{want_launches} ssd_chunk_scan launches "
                             f"and no other")
    print(f"{label} (reduced: d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers; fp32, batch 2 x {TRAIN_CHECK_SEQ}): loss {float(loss):.6f}"
          f" on the card, {loss_err:.2e} from the CPU's; every leaf's "
          f"gradient within {worst:.2e} of its largest |CPU gradient| "
          f"(limit {TRAIN_RTOL:g}); {counts['ssd_chunk_scan']} "
          f"ssd_chunk_scan launches", flush=True)
    if not mamba:
        return {label: (None, counts)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    with torch.no_grad():
        calls = capture_calls(lambda: model.loss(params["cuda"], batch),
                              every=True)
    hold_model_calls(label, calls, want_launches, peaks, tallies)
    return {label: (label, counts)}


def train_phase(smi: str, peaks: dict, tallies: dict) -> dict:
    """The training path (`repro_torch.launch.train.train`, the code
    `python -m repro_torch.launch.train` runs):

    - whisper-large-v3 at its published widths and full depth in its
      bf16 with fp32 AdamW moments, through the mesh path (the host mesh,
      params placed by `shard_params` under `activation_mesh`),
      `TRAIN_STEPS` steps of `TRAIN_BATCH` x `TRAIN_SEQ` target tokens
      over 1500 frames; every loss finite and the mean of the last 5 below
      the first 5; the median seconds a step, the peak memory, and one
      more step under torch.profiler (device time by kernel, the idle
      share); the step's roofline terms on the 1x1 mesh beside its
      measured seconds (`roofline_line`); `save_checkpoint` of the params in the
      reference's layout then `restore_checkpoint`, the restored params
      bit-equal to the trained ones;
    - every `ARCH_IDS` family reduced in fp32: one step on the card
      against the CPU (`train_step_check`; zamba2-7b's SSD calls held and
      timed into `tallies`).

    Returns the walks."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import (ARCH_IDS, build_model, get_config,
                                    params_from_numpy, params_to_reference)
    from repro_torch.optim import AdamWConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.sharding import param_shardings, shard_params
    from repro_torch.sharding.ctx import activation_mesh

    gc.collect()
    torch.cuda.empty_cache()
    walks = {}
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, t = TRAIN_BATCH, TRAIN_SEQ
    print(f"train {cfg.name}: {TRAIN_STEPS} AdamW steps of {b} x {t} target "
          f"tokens over {b} x {cfg.encoder_seq} frames, {cfg.dtype} params "
          f"({2 * cfg.param_count() / 1e9:.1f} GB) with fp32 moments "
          f"({8 * cfg.param_count() / 1e9:.1f} GB)", flush=True)
    label = f"{cfg.name} train"
    mesh = make_host_mesh("cuda")
    zero_counts()
    with activation_mesh(mesh):
        params = shard_params(params, param_shardings(params, mesh))
        params, opt_state, losses, seconds = train(
            cfg, model, params, steps=TRAIN_STEPS, batch=b, seq=t,
            lr=TRAIN_LR, device=mesh.devices[0], log_every=5)
    walks[label] = (None, read_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"{label}: losses {losses}: not all finite, or "
                             f"the last 5's mean {last:.4f} is not below "
                             f"the first 5's {first:.4f}")
    step = make_train_step(model, AdamWConfig(
        lr=TRAIN_LR, total_steps=TRAIN_STEPS,
        warmup_steps=max(1, TRAIN_STEPS // 10)))
    raw = make_batch(cfg, b, t, seed=TRAIN_STEPS)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    rows, busy, wall, calls, _ = _profile(label, lambda: step(
        params, opt_state, batch), 1)
    print(f"{label}: losses " + ", ".join(f"{v:.4f}" for v in losses)
          + f"; mean of the last 5 {last:.4f} < the first 5's {first:.4f}; "
          f"{statistics.median(seconds):.3f} s a step (median of "
          f"{TRAIN_STEPS}; first {seconds[0]:.3f} s); peak memory {peak:.1f} "
          f"GB; {smi}", flush=True)
    print(f"profile {label} step: wall {wall:.3f} ms under the profiler; "
          f"kernels {busy:.3f} ms of device time in "
          f"{sum(r[1] for r in rows):g} launches (idle >= "
          f"{1 - busy / wall:.1%} of the profiled wall); host launch calls "
          f"{sum(calls.values()):g}; {smi}", flush=True)
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.3f} ms {count:6g}x {key[:100]}", flush=True)
    roofline_line(label, cfg, model, mesh, t, b, seconds, peak, smi)
    del batch, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()

    # the checkpoint, in the reference's layout, back bit for bit
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="ckpt_", dir=ROOT / "build") \
            as tmp:
        t0 = time.perf_counter()
        tree = {"params": params_to_reference(params)}
        out = save_checkpoint(tmp, TRAIN_STEPS, tree)
        saved = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in out.iterdir())
        t0 = time.perf_counter()
        back = restore_checkpoint(tmp, TRAIN_STEPS, tree)
        del tree
        again = params_from_numpy(back["params"], "cuda")
        restored = time.perf_counter() - t0
        del back
        pairs = list(zip(tree_leaves(again), tree_leaves(params)))
        if not all(a.dtype == p.dtype and torch.equal(a, p)
                   for a, p in pairs):
            raise AssertionError(f"{label}: the restored params are not "
                                 f"bit-equal to the trained ones")
        print(f"{label}: checkpoint of {len(pairs)} leaves ({size / 1e9:.2f}"
              f" GB on disk) saved in {saved:.1f} s, restored in "
              f"{restored:.1f} s, every leaf bit-equal", flush=True)
        del again, pairs
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    for arch in ARCH_IDS:
        walks.update(train_step_check(arch, peaks, tallies))
    return walks


def roofline_line(label: str, cfg, model, mesh, t: int, b: int,
                  seconds: list, peak_gb: float, smi: str) -> None:
    """Print the train step's roofline terms on `mesh` (`launch.dryrun.
    walk_step` on fake tensors at the step's shape, over this card's peaks
    by its name) beside the measured median seconds a step, as a multiple
    of max(t_compute, t_memory), and the dry run's per-device memory
    estimate beside the measured peak.  A kernel the walk counts as its
    plain version (`counted_as_plain`) is named on the line."""
    from repro_torch.launch.dryrun import counted_as_plain, walk_step
    from repro_torch.launch.shapes import InputShape
    from repro_torch.roofline.analysis import build_report

    shape = InputShape(f"train b{b}s{t}", t, b, "train")
    cost, arg_bytes, out_bytes, walk_s = walk_step(cfg, model, shape, mesh)
    rep = build_report(cfg.name, shape, mesh.name, mesh.size, cost,
                       arg_bytes + out_bytes + cost.peak_live_bytes, cfg,
                       peaks=card_peaks())
    bound = max(rep.t_compute, rep.t_memory)
    med = statistics.median(seconds)
    print(f"roofline {label} step ({cfg.dtype}, {b} x {t}) on the "
          f"{mesh.name} mesh: {rep.hlo_flops:.4e} FLOPs counted, "
          f"{rep.model_flops:.4e} model FLOPs (useful "
          f"{rep.useful_flops_ratio:.3f}), {rep.hlo_bytes:.4e} bytes (eager, "
          f"unfused) -> t_compute {rep.t_compute * 1e3:.3f} ms at the bf16 "
          f"peak, t_memory {rep.t_memory * 1e3:.3f} ms, "
          f"{rep.bottleneck}-bound; measured {med * 1e3:.1f} ms a step "
          f"(median) = {med / bound:.2f} x max(t_compute, t_memory); peak "
          f"memory estimate {rep.peak_memory_bytes / 1e9:.1f} GB against "
          f"{peak_gb:.1f} GB measured; walk {walk_s:.1f} s on the host; "
          + "".join(f"{k} counted as its plain version; "
                    for k in counted_as_plain(cfg))
          + smi, flush=True)


def zamba_train_phase(smi: str, peaks: dict, tallies: dict) -> dict:
    """zamba2-7b at its published widths (d_model 3584, 112 SSD heads x 64,
    state 64) and `ZAMBA_TRAIN_LAYERS` layers (the fewest that hold one
    shared-attention block), bf16 with fp32 moments, `ZAMBA_TRAIN_STEPS`
    AdamW steps of `ZAMBA_TRAIN_BATCH` x `ZAMBA_TRAIN_SEQ` tokens through
    the mesh path (`launch.train.train` on the host mesh, params placed
    by `shard_params` under `activation_mesh`).  Every loss finite; the
    counts set to 0 just before the steps and read just after:
    `ssd_chunk_scan` launched once per layer per step (its forward; the
    gradient through `ScanWithGrad`) and no other kernel; seconds a step,
    peak memory and the roofline terms (`roofline_line`); then every SSD
    call of one more forward held against its plain version in float32
    and bfloat16 and timed (`hold_model_calls`).  Returns the walk."""
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import build_model, get_config
    from repro_torch.sharding import param_shardings, shard_params
    from repro_torch.sharding.ctx import activation_mesh

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("zamba2_7b")
    cfg = dataclasses.replace(full, n_layers=ZAMBA_TRAIN_LAYERS)
    model = build_model(cfg)
    b, t, steps = ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, ZAMBA_TRAIN_STEPS
    label = f"{cfg.name} train (published widths, {cfg.n_layers} layers)"
    mesh = make_host_mesh("cuda")
    torch.cuda.reset_peak_memory_stats()
    with activation_mesh(mesh):
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        params = shard_params(params, param_shardings(params, mesh))
        zero_counts()
        params, _, losses, seconds = train(
            cfg, model, params, steps=steps, batch=b, seq=t, lr=TRAIN_LR,
            device=mesh.devices[0], log_every=1)
        torch.cuda.synchronize()
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = steps * cfg.n_layers
    if counts != {k: (want if k == "ssd_chunk_scan" else 0) for k in counts}:
        raise AssertionError(f"{label}: launches {counts}, want {want} "
                             f"ssd_chunk_scan launches ({steps} steps x "
                             f"{cfg.n_layers} layers) and no other")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses} are not all finite")
    print(f"{label}: {steps} AdamW steps of {b} x {t} tokens on the "
          f"{mesh.name} mesh ({cfg.param_count() / 1e9:.2f} B parameters, "
          f"{cfg.dtype}, fp32 moments): losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; {statistics.median(seconds):.3f} s a step (median; first "
          f"{seconds[0]:.3f} s); peak memory {peak:.1f} GB; "
          f"{counts['ssd_chunk_scan']} ssd_chunk_scan launches; {smi}",
          flush=True)
    roofline_line(label, cfg, model, mesh, t, b, seconds, peak, smi)
    raw = make_batch(cfg, b, t, seed=steps)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    with torch.no_grad():
        calls = capture_calls(lambda: model.loss(params, batch), every=True)
    hold_model_calls(label, calls, cfg.n_layers, peaks, tallies)
    del model, params, batch, calls
    gc.collect()
    torch.cuda.empty_cache()
    return {label: (label, counts)}


def dryrun_phase() -> None:
    """The dry run on this host (no card): `launch.dryrun.lower_one` at
    published widths for the reference's CI combinations on the test
    meshes (`DRYRUN_CI`), each record's status as the reference's CI test
    expects, its counts, bottleneck and walk seconds printed."""
    from repro_torch.launch.dryrun import lower_one

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="dryrun_", dir=ROOT / "build") \
            as tmp:
        for arch, shape, multi_pod, want in DRYRUN_CI:
            rec = lower_one(arch, shape, multi_pod=multi_pod, verbose=False,
                            test_mesh=True, report_dir=Path(tmp))
            if rec["status"] != want or (want == "ok"
                                         and not rec["hlo_flops"] > 0):
                raise AssertionError(f"dryrun {arch} x {shape}: {rec}")
            where = f"dryrun {arch} x {shape} @ {rec['mesh']}"
            if want == "skipped":
                print(f"{where}: skipped ({rec['reason']})", flush=True)
                continue
            print(f"{where}: {rec['hlo_flops']:.4e} FLOPs, "
                  f"{rec['hlo_bytes']:.4e} bytes, {rec['model_flops']:.4e} "
                  f"model FLOPs (useful {rec['useful_flops_ratio']:.3f}), "
                  f"peak/device {rec['peak_memory_bytes'] / 1e9:.2f} GB, "
                  f"t_compute {rec['t_compute_s'] * 1e3:.3f} ms, t_memory "
                  f"{rec['t_memory_s'] * 1e3:.3f} ms (H100 SXM peaks), "
                  f"collectives not counted; {rec['bottleneck']}-bound; "
                  f"walk {rec['walk_s']} s", flush=True)


def production_mesh_check() -> None:
    """`python -m repro_torch.launch.train --production-mesh` exits 2 with
    the device-count message."""
    want = "the data x model mesh needs 16 x 16 = 256 devices; this " \
        "process runs on 1"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2_7b", "--production-mesh"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if out.returncode != 2 or want not in out.stderr:
        raise AssertionError(f"--production-mesh: exit {out.returncode}, "
                             f"stderr {out.stderr[-500:]!r}")
    print(f"launch.train --production-mesh: exit 2, "
          f"{out.stderr.strip()!r}", flush=True)


def serve_traffic(cfg, cost: float):
    """The serve phase's traffic: `SERVE_TRAFFIC` greedy Poisson requests
    at 0.33 / `cost` (the largest bucket's plan cost)."""
    from repro_torch.serving import poisson_requests
    return poisson_requests(
        SERVE_TRAFFIC, rate=0.33 / cost, vocab_size=cfg.vocab_size,
        prompt_lens=(4, 8, 16), max_new=(4, 8, 12), temperatures=(0.0,),
        seed=19)


def sparse_traffic(cfg, cost: float):
    """`THROTTLE_REQUESTS` greedy Poisson requests at `THROTTLE_RATE` /
    `cost`: most steps run one request, in the b1s64 bucket."""
    from repro_torch.serving import poisson_requests
    return poisson_requests(
        THROTTLE_REQUESTS, rate=THROTTLE_RATE / cost,
        vocab_size=cfg.vocab_size, prompt_lens=(4, 8, 16),
        max_new=(4, 8, 12), temperatures=(0.0,), seed=19)


def throttled_scheduler(cfg, model, params, portfolio, store: Path,
                        plan_cache: Path, cost: float, traffic):
    """`ContinuousScheduler` on the virtual clock over `traffic` with a
    `ThrottleSim` (x`THROTTLE_SCALE` from 100 x `cost` on, `cost` the
    largest bucket's plan cost), its plans executed every
    `THROTTLE_CONFIG["fidelity_every"]` steps, each of `portfolio`'s plans
    executed once before the run (warm executors).  The drift monitor's
    window is 2 reports with a threshold between log(scale) / 2 and
    log(scale), so it fires only once both reports in its window are
    throttled: the replan's `pre` fidelity error and its calibrator's fit
    then see only drifted walls.

    Returns its report and every replan the monitor triggered, as
    (bucket, step, pre, post, committed): `pre` the window's mean
    fidelity error, `post` the candidate plan's (None where the static
    verifier refused it).  The scheduler is not changed: this one
    instance's `_replan` and `_profile_scaled` are wrapped to read them."""
    from repro_torch.serving import (ContinuousScheduler, SchedulerConfig,
                                     ThrottleSim)
    for compiled in portfolio.entries.values():
        compiled.profile(device="cuda", warmup=True)
    sched = ContinuousScheduler(
        cfg, model, params, portfolio=portfolio, device="cuda",
        measurement_store=store, plan_cache=plan_cache,
        throttle=ThrottleSim(at_s=100 * cost, scale=THROTTLE_SCALE),
        config=SchedulerConfig(max_batch=SERVE_MAX_BATCH,
                               max_len=SERVE_MAX_LEN, clock="virtual",
                               **THROTTLE_CONFIG))
    errors, attempts = [], []
    profile, replan = sched._profile_scaled, sched._replan

    def profiled(compiled, now):
        report = profile(compiled, now)
        errors.append(report.fidelity_error())
        return report

    def replanned(bucket, compiled, now, step):
        window = sched._fid_log[bucket][-THROTTLE_CONFIG["fidelity_window"]:]
        seen, made = len(errors), len(sched.replan_events)
        replan(bucket, compiled, now, step)
        attempts.append((bucket.tag, step, float(np.mean(window)),
                         errors[-1] if len(errors) > seen else None,
                         len(sched.replan_events) > made))

    sched._profile_scaled, sched._replan = profiled, replanned
    return sched.run(traffic), attempts


def replan_attempts(attempts, rep) -> str:
    """`throttled_scheduler`'s replans as text, each committed one with
    the nodes it moved."""
    moved = iter(ev.changes for ev in rep.replan_events)
    return "; ".join(
        f"[{tag}] step {step}: pre {pre:.3f}, post "
        f"{'refused' if post is None else f'{post:.3f}'}, "
        + (f"committed, {next(moved)} nodes moved" if done
           else "old plan kept")
        for tag, step, pre, post, done in attempts) or \
        "the monitor never fired"


def throttle_faults(rep, require_move: bool) -> list:
    """What the throttled run `rep` failed: a committed replan that did
    not lower the fidelity error; with `require_move`, no committed
    replan that moved a node and lowered it."""
    faults = [f"[{ev.bucket}] at step {ev.step} committed without lowering "
              f"the fidelity error ({ev.pre_fidelity:.3f} -> "
              f"{ev.post_fidelity:.3f})" for ev in rep.replan_events
              if not ev.post_fidelity < ev.pre_fidelity]
    if require_move and not any(ev.changes > 0
                                and ev.post_fidelity < ev.pre_fidelity
                                for ev in rep.replan_events):
        faults.append("no committed replan that moved a node and lowered "
                      "the fidelity error")
    return faults


def throttle_runs(runs: int, smi: str) -> int:
    """`--throttle-runs N`: the serve phase's two throttled scheduler runs
    (its own traffic, then the sparse one) N times on codeqwen1.5-7b at
    full width and depth (bf16), each from a fresh warm load of the same
    portfolio and a fresh measurement store; prints each run's replans,
    how many sparse runs committed a replan that moved a node and lowered
    the fidelity error, and how many of the serve traffic's b4s64 replans
    were committed.  Returns 0 when every run passed the serve phase's
    checks."""
    import repro_torch
    from repro_torch.models import build_model, get_config

    cfg = get_config(SERVE_ARCH)
    passed, b4_tried, b4_done = 0, 0, 0
    with tempfile.TemporaryDirectory(prefix="repro_torch_throttle_") as tmp:
        target = repro_torch.Target(device="moto2022")
        kw = dict(buckets=SERVE_BUCKETS, cache=Path(tmp, "plans"),
                  predictor_cache=Path(tmp, "predictors"))
        pf = repro_torch.compile_portfolio(cfg, target, **kw)
        cost = pf.entries[pf.buckets[-1]].plan.end_to_end_us * 1e-6
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        for i in range(runs):
            faults = []
            for kind, traffic in (("serve", serve_traffic(cfg, cost)),
                                  ("sparse", sparse_traffic(cfg, cost))):
                t = time.perf_counter()
                rep, attempts = throttled_scheduler(
                    cfg, model, params,
                    repro_torch.compile_portfolio(cfg, target, **kw),
                    Path(tmp, f"meas_{kind}_{i}"), Path(tmp, "plans"), cost,
                    traffic)
                host = time.perf_counter() - t
                faults += throttle_faults(rep, kind == "sparse")
                b4 = [done for tag, _, _, _, done in attempts
                      if tag == pf.buckets[-1].tag]
                if kind == "serve":
                    b4_tried, b4_done = b4_tried + len(b4), b4_done + sum(b4)
                print(_report_line(f"throttle run {i} {kind}", rep, host),
                      flush=True)
                print(f"  replans: {replan_attempts(attempts, rep)}",
                      flush=True)
            passed += not faults
            for fault in faults:
                print(f"  FAULT: {fault}", flush=True)
    print(f"throttle: {passed} of {runs} runs passed (sparse traffic: a "
          f"committed replan that moved a node and lowered the fidelity "
          f"error; every committed replan lowered it); on the serve "
          f"traffic {b4_done} of {b4_tried} {pf.buckets[-1].tag} replans "
          f"committed (window {THROTTLE_CONFIG['fidelity_window']}, "
          f"threshold {THROTTLE_CONFIG['drift_threshold']}, scale "
          f"{THROTTLE_SCALE}); {smi}", flush=True)
    return 0 if passed == runs else 1


# ------------------------------------------------------------------- serve

def _to_device(tree, device):
    """A model's params (nested dicts and lists of tensors) on `device`."""
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def serve_reduced_check(cfg) -> None:
    """Reduced `cfg` in fp32: the same seeded weights on the CPU and on the
    card, a left-padded prefill then decode steps at a shared position
    and at per-row positions; every logit within `SERVE_LOGIT_RTOL` of the
    largest |CPU logit| (the CPU tests tie the CPU path to the
    reference's)."""
    from repro_torch.models import build_model
    small = dataclasses.replace(cfg.reduced(), dtype="float32")
    model = build_model(small)
    params = {"cpu": model.init(torch.Generator().manual_seed(0))}
    params["cuda"] = _to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(500)
    b, t = 3, 12
    toks = torch.from_numpy(rng.integers(1, small.vocab_size, (b, t)))
    steps = torch.from_numpy(rng.integers(1, small.vocab_size, (4, b, 1)))
    start = torch.tensor([0, 4, 7])
    logits = {}
    for dev in ("cpu", "cuda"):
        cache = model.init_cache(b, 32, device=dev)
        out, cache = model.prefill(params[dev], toks.to(dev), cache,
                                   start=start.to(dev))
        logits[dev] = [out]
        for i, tok in enumerate(steps):
            pos = (t + i if i < 2 else
                   torch.tensor([t + i, t + i + 2, t + i + 1], device=dev))
            out, cache = model.decode_step(params[dev], tok.to(dev), cache,
                                           pos, start=start.to(dev))
            logits[dev].append(out)
    worst = 0.0
    for i, (want, got) in enumerate(zip(logits["cpu"], logits["cuda"])):
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if not err <= SERVE_LOGIT_RTOL * scale:
            raise AssertionError(f"serve reduced: step {i} logits on the "
                                 f"card differ from the CPU's by {err:.3e} "
                                 f"> {SERVE_LOGIT_RTOL} x {scale:.3g}")
    print(f"serve reduced {small.name} (d_model {small.d_model}, "
          f"{small.n_layers} layers, fp32): prefill + 4 decode steps on the "
          f"card within {worst:.2e} of the CPU's largest |logit| (limit "
          f"{SERVE_LOGIT_RTOL:g})", flush=True)


def _first_divergence(model, params, req, got, want,
                      max_len: int = None) -> str:
    """Where the batched tokens for `req` leave the solo run's: the step,
    both tokens, and the top-2 logit gap of the solo run there (a cache of
    `max_len` positions, `SERVE_MAX_LEN` unless given)."""
    step = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))
    cache = model.init_cache(1, max_len or SERVE_MAX_LEN, device="cuda")
    prompt = torch.from_numpy(req.prompt.astype(np.int64))[None].cuda()
    logits, cache = model.prefill(params, prompt, cache)
    for i in range(step):
        logits, cache = model.decode_step(
            params, torch.tensor([[want[i]]], device="cuda"), cache,
            len(req.prompt) + i)
    top = logits[0].float().topk(2).values
    return (f"request {req.rid} step {step}: batched "
            f"{got[step] if step < len(got) else None}, solo "
            f"{want[step] if step < len(want) else None}; the solo run's "
            f"top-2 logit gap there {float(top[0] - top[1]):.3e}")


def _profile(label: str, fn, n: int, spans=()):
    """`n` calls of `fn` under torch.profiler: the CUDA kernels' rows
    (device ms per call, launches over the `n` calls, name) by falling
    device time, their device ms per call, the wall per call in ms (host
    clock around the calls and a sync), per call the host calls that put
    work on the card (kernel launches, copies and graph launches: the
    CUDA runtime's API events in the trace), by name, and the device ms
    per call of the kernels launched inside each `record_function` range
    named in `spans`.  A range also shows on the device timeline as one
    annotation as long as its first kernel's start to its last kernel's
    end: that is not a kernel, so it is left out of the rows and of the
    ranges' sums.  Raises if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count, e.key)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0 and e.key not in spans),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0.0:
        raise AssertionError(f"profile {label}: the trace holds no device "
                             f"time")
    calls = {}
    for e in events:
        if e.key.startswith(HOST_LAUNCH_CALLS):
            calls[e.key] = calls.get(e.key, 0) + e.count / n
    def kernel_us(e) -> float:
        """Device time of the kernels an event and its callees launched."""
        return (sum(k.duration for k in e.kernels if k.name not in spans)
                + sum(kernel_us(c) for c in e.cpu_children))

    ranges = {k: sum(kernel_us(e) for e in prof.events()
                     if e.name == k and e.device_type == DeviceType.CPU)
              / 1e3 / n for k in spans}
    return rows, busy, wall, calls, ranges


#: the profiler range around each chunked WKV call (`wkv_range`)
WKV_RANGE = "rwkv6 chunked wkv"


@contextlib.contextmanager
def wkv_range():
    """Each `_wkv_chunked` call inside the block runs in a `record_function`
    range named `WKV_RANGE`, so a profile sums its eager ops' device time
    apart (`_profile`'s `spans`).  The block's model code is not changed:
    `rwkv6_mix` looks the function up in its module at each call."""
    from torch.profiler import record_function

    from repro_torch.models import ssm
    real = ssm._wkv_chunked

    def ranged(*args):
        with record_function(WKV_RANGE):
            return real(*args)

    ssm._wkv_chunked = ranged
    try:
        yield
    finally:
        ssm._wkv_chunked = real


def ssd_device_ms(rows) -> tuple:
    """The SSD chunk kernels' device ms per call in `_profile`'s rows,
    summed over every kernel whose name holds "ssd_chunk" (the state, pass
    and out phases; one kernel before they were split), and each one's
    share as text."""
    mine = [(ms, re.search(r"ssd_chunk\w*", key).group(0))
            for ms, _, key in rows if "ssd_chunk" in key]
    by = {}
    for ms, name in mine:
        by[name] = by.get(name, 0.0) + ms
    return (sum(by.values()),
            ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by.items())))


def decode_breakdown(label: str, model, params, batch: int,
                     steps: int = 4, top: int = 8, spans=()) -> None:
    """Where a decode step's time goes: `steps` steps of `batch` slots at
    per-slot positions (the scheduler's call; a shared position for a
    model without them), timed bare (host clock around the steps and a
    sync), then under torch.profiler: device time by kernel against the
    step wall, the host calls that put work on the card, and the device
    time of the kernels inside each `record_function` range of `spans`
    with its share.  Raises if the trace holds no device time."""
    cache = model.init_cache(batch, SERVE_MAX_LEN, device="cuda")
    tok = torch.ones((batch, 1), dtype=torch.long, device="cuda")
    pos = (torch.arange(batch, device="cuda")
           if getattr(model, "per_slot_pos", False) else SERVE_MAX_LEN // 2)

    def step():
        model.decode_step(params, tok, cache, pos)

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t) * 1e3 / steps
    rows, busy, wall, calls, ranges = _profile(label, step, steps,
                                               spans=spans)
    within = "".join(f"; {k} {v:.3f} ms ({v / busy:.1%} of the device "
                     f"time)" for k, v in ranges.items())
    print(f"profile {label}: decode step of {batch} slots, wall {bare:.3f} "
          f"ms bare, {wall:.3f} ms under the profiler; kernels {busy:.3f} "
          f"ms of device time in {sum(r[1] for r in rows) / steps:g} "
          f"launches (idle >= {1 - busy / wall:.1%} of the profiled wall); "
          f"host launch calls per step {sum(calls.values()):g}{within}",
          flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:8.3f} ms {count / steps:6g}x {key[:100]}", flush=True)


@contextlib.contextmanager
def executed_plans():
    """Every CompiledNetwork whose plan is executed inside the block, by
    plan key: each execution takes its executor from
    `CompiledNetwork.executor` (the scheduler's `profile` runs, its replan
    candidates', and `ServingEngine.execute_plan`)."""
    from repro_torch.api import CompiledNetwork

    seen = {}
    real = CompiledNetwork.executor

    def executor(self, **kw):
        seen.setdefault(self.key, self)
        return real(self, **kw)

    CompiledNetwork.executor = executor
    try:
        yield seen
    finally:
        CompiledNetwork.executor = real


def offered_load(label: str, traffic, rep) -> str:
    """The wall-clock run's offered load against what the card served:
    slot-steps (the scheduler prefills one prompt token a step, and the
    last prompt step emits the first token, so a request holds a slot
    prompt + new - 1 steps) per second of arrivals, against the slots
    over the run's mean step."""
    need = sum(len(r.prompt) + r.max_new_tokens - 1 for r in traffic)
    span = max(r.arrival_s for r in traffic)
    step = rep.duration_s / rep.steps
    capacity = SERVE_MAX_BATCH / step
    ratio = need / span / capacity
    verdict = (f"{ratio:.2f}x overloaded: its TTFT and latency measure a "
               f"backlog draining, not serving latency" if ratio > 1 else
               f"{ratio:.2f} of capacity")
    return (f"{label}: offered {need} slot-steps over {span:.4f} s of "
            f"arrivals ({need / span:.1f}/s); the card served at most "
            f"{capacity:.1f}/s ({SERVE_MAX_BATCH} slots / the run's mean "
            f"step {step * 1e3:.3f} ms, plan executions included): "
            f"{verdict}; TTFT includes each prompt's token-by-token prefill")


def _report_line(label: str, rep, host_s: float) -> str:
    return (f"{label}: {len(rep.stats)} requests, {rep.total_tokens} tokens "
            f"in {rep.steps} steps; {rep.clock} clock {rep.duration_s:.4f} "
            f"s, {rep.tokens_per_s:.1f} tok/s; TTFT p50 "
            f"{rep.ttft_p(50) * 1e3:.2f} ms, latency p50 "
            f"{rep.latency_p(50) * 1e3:.2f} ms p99 "
            f"{rep.latency_p(99) * 1e3:.2f} ms; bucket steps "
            f"{dict(sorted(rep.bucket_steps.items()))}, switches "
            f"{rep.bucket_switches}, replans {len(rep.replan_events)}; host "
            f"wall {host_s:.3f} s ({rep.total_tokens / host_s:.1f} tok/s)")


def serve_phase(peaks: dict, tallies: dict, smi: str) -> dict:
    """The serving path at codeqwen1.5-7b's published widths and full
    depth (`SERVE_ARCH`), its weights seeded draws made on the card:

    - a portfolio (`SERVE_BUCKETS`) compiled on this host, cold then warm;
      each entry's plan run as a main path is (`main_path`) and every
      kernel call of one of its requests held against its plain version
      (`hold_walk_calls`);
    - the reduced model on the card against the CPU (`serve_reduced_check`);
    - in fp32: `ContinuousScheduler` over `SERVE_TRAFFIC` greedy Poisson
      requests on the virtual clock, its plans executed every
      `SERVE_FIDELITY_EVERY` steps, each completion equal to the request
      served alone by the fixed-batch engine, token for token;
    - in bf16: the fixed-batch `ServingEngine` on `SERVE_FIXED_REQUESTS`
      requests shipping the b4 entry (`compiled=`, one `execute_plan`), and
      the scheduler again on the wall clock, whose tokens/s, TTFT and
      latency percentiles are printed beside the card's name and limit,
      with its offered load against the card's service (`offered_load`);
      then a profiled decode step at batch 1 and 4 (`decode_breakdown`);
    - the scheduler twice more with a simulated throttle, over the
      traffic above and over the sparse one (`throttled_scheduler`):
      every committed in-place replan must lower the fidelity error, and
      the sparse run must commit one that moved a node;
    - every plan the runs above executed (`executed_plans`: replanned
      entries and rejected candidates alike, and the plan the engine
      shipped) that the entries did not hold: run and its kernel calls
      held as above.

    Returns the walks as {walk: (times key, launch counts)}: counters set
    to 0 just before each walk, read just after."""
    import repro_torch
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import (ContinuousScheduler,
                                     FixedBatchReference, Request,
                                     SchedulerConfig, ServingEngine)

    # earlier phases' executors and CUDA graphs may sit in reference
    # cycles: collect them, so the peaks below are this phase's
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(SERVE_ARCH)
    name = cfg.name
    n = cfg.param_count()
    print(f"serve {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim} (kv {cfg.n_kv_heads}), "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n / 1e9:.3f} B "
          f"parameters ({2 * n / 1e9:.1f} GB bf16, {4 * n / 1e9:.1f} GB "
          f"fp32); {held:.1f} GB allocated on the card before the phase",
          flush=True)
    walks = {}
    zero, read = zero_counts, read_counts
    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_") as tmp:
        target = repro_torch.Target(device="moto2022")
        kw = dict(buckets=SERVE_BUCKETS, cache=Path(tmp, "plans"),
                  predictor_cache=Path(tmp, "predictors"))
        t = time.perf_counter()
        pf = repro_torch.compile_portfolio(cfg, target, **kw)
        cold = time.perf_counter() - t
        t = time.perf_counter()
        again = repro_torch.compile_portfolio(cfg, target, **kw)
        warm = time.perf_counter() - t
        if not all(c.from_cache for c in again.entries.values()):
            raise AssertionError("serve: the second portfolio compile was "
                                 "not all warm hits")
        print(f"serve portfolio {pf}: cold {cold:.3f} s, warm {warm:.3f} s; "
              f"checksum {pf.to_json()['checksum']}", flush=True)
        for b, c in pf.entries.items():
            splits = ", ".join(
                f"{nid} {d.axis} {d.c_cpu}/{d.c_gpu}"
                for nid, d in c.plan.decisions_by_node.items()
                if not d.exclusive)
            print(f"  {b.tag}: key {c.key}, end-to-end "
                  f"{c.plan.end_to_end_us / 1e3:.3f} ms on the simulated "
                  f"phone; splits: {splits or 'none'}", flush=True)
            label = f"{name} {b.tag}"
            make = decode_input(b.batch, cfg.d_model)
            counts, exe, _, _ = main_path(label, c, make,
                                          (b.batch, cfg.d_model),
                                          PORTFOLIO_REQUESTS, SERVE_E2E_RTOL)
            walks[label] = (label, counts)
            hold_walk_calls(label, kernel_calls(exe, make(0)),
                            expected_counts(c.plan), peaks, tallies)
        serve_reduced_check(cfg)

        largest = pf.entries[pf.buckets[-1]]
        cost = largest.plan.end_to_end_us * 1e-6
        traffic = serve_traffic(cfg, cost)
        fixed = FixedBatchReference(largest, max_batch=SERVE_MAX_BATCH)
        print(f"serve traffic: {SERVE_TRAFFIC} greedy Poisson requests at "
              f"{0.33 / cost:.2f} req/s (0.33 / the {pf.buckets[-1].tag} "
              f"plan's {cost * 1e3:.3f} ms); the fixed-batch reference on "
              f"that plan: {fixed.run(traffic).summary()}", flush=True)

        def scheduler(model, params, clock, store, throttle=None, **conf):
            conf = {"fidelity_every": SERVE_FIDELITY_EVERY, **conf}
            return ContinuousScheduler(
                cfg, model, params, portfolio=pf, device="cuda",
                measurement_store=Path(tmp, store),
                plan_cache=Path(tmp, "plans"), throttle=throttle,
                config=SchedulerConfig(max_batch=SERVE_MAX_BATCH,
                                       max_len=SERVE_MAX_LEN, clock=clock,
                                       **conf))

        # every plan the runs below execute: the scheduler's fidelity runs,
        # its replan candidates (committed or not) and the fixed batch's
        # execute_plan; the entries above are held already
        held = {c.key for c in pf.entries.values()}
        events = []
        with executed_plans() as executed:
            # fp32 (TF32 off): the scheduler's completions against solo
            # runs
            model = build_model(dataclasses.replace(cfg, dtype="float32"))
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            params = model.init(
                torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            print(f"serve fp32 weights: drawn on the card in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
            label = f"{name} serve fp32 virtual"
            zero()
            t = time.perf_counter()
            rep = scheduler(model, params, "virtual",
                            "meas_fp32").run(traffic)
            host = time.perf_counter() - t
            walks[label] = (None, read())
            events += rep.replan_events
            print(_report_line(label, rep, host) + f"; {smi}", flush=True)
            got = {c.rid: c.tokens for c in rep.completions}
            t = time.perf_counter()
            for r in traffic:
                solo = ServingEngine(cfg, model, params, max_batch=1,
                                     max_len=SERVE_MAX_LEN, device="cuda")
                want = solo.run([dataclasses.replace(r, arrival_s=0.0)]
                                )[0].tokens
                if got.get(r.rid) != want:
                    raise AssertionError(
                        "serve fp32: the scheduler's tokens differ from the "
                        "solo run's: " + _first_divergence(
                            model, params, r, got.get(r.rid, []), want))
            print(f"serve fp32: all {len(traffic)} scheduler completions "
                  f"equal the requests served alone by the fixed-batch "
                  f"engine, token for token ({sum(map(len, got.values()))} "
                  f"tokens; solo runs {time.perf_counter() - t:.1f} s); peak "
                  f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
                  flush=True)
            del model, params, solo
            torch.cuda.empty_cache()

            # bf16, the configuration's serving dtype
            model = build_model(cfg)
            torch.cuda.reset_peak_memory_stats()
            params = model.init(
                torch.Generator(device="cuda").manual_seed(0))
            rng = np.random.default_rng(0)
            reqs = [Request(rid=i, prompt=rng.integers(
                        0, cfg.vocab_size, size=rng.integers(4, 17)
                    ).astype(np.int32), max_new_tokens=SERVE_MAX_NEW,
                        temperature=(0.0, 0.7)[i % 2])
                    for i in range(SERVE_FIXED_REQUESTS)]
            engine = ServingEngine(cfg, model, params,
                                   max_batch=SERVE_MAX_BATCH,
                                   max_len=64 + SERVE_MAX_NEW,
                                   compiled=pf.entries[pf.buckets[-1]],
                                   device="cuda")
            engine.run(reqs[:1])                   # warm the allocator
            label = f"{name} serve bf16 fixed"
            zero()
            t = time.perf_counter()
            done = engine.run(reqs)
            host = time.perf_counter() - t
            _, report = engine.execute_plan()
            walks[label] = (None, read())
            tokens = sum(len(c.tokens) for c in done)
            if (tokens != SERVE_FIXED_REQUESTS * SERVE_MAX_NEW or not all(
                    0 <= v < cfg.vocab_size for c in done
                    for v in c.tokens)):
                raise AssertionError(
                    f"serve bf16 fixed: {tokens} tokens, want "
                    f"{SERVE_FIXED_REQUESTS * SERVE_MAX_NEW} in [0, "
                    f"{cfg.vocab_size})")
            print(f"{label}: {len(done)} requests (greedy and T=0.7 in "
                  f"turns) in batches of {SERVE_MAX_BATCH}, {tokens} tokens "
                  f"in {host:.3f} s ({tokens / host:.1f} tok/s on {smi}); "
                  f"execute_plan: {report.fidelity_summary()}", flush=True)
            label = f"{name} serve bf16 wall"
            zero()
            t = time.perf_counter()
            rep = scheduler(model, params, "wall", "meas_bf16").run(traffic)
            host = time.perf_counter() - t
            walks[label] = (None, read())
            events += rep.replan_events
            if (len(rep.completions) != len(traffic)
                    or rep.total_tokens != sum(r.max_new_tokens
                                               for r in traffic)):
                raise AssertionError(f"{label}: {len(rep.completions)} "
                                     f"completions, {rep.total_tokens} "
                                     f"tokens")
            print(_report_line(label, rep, host) + f"; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; {smi}",
                  flush=True)
            print(offered_load(label, traffic, rep), flush=True)
            for batch in (1, SERVE_MAX_BATCH):
                decode_breakdown(f"{name} bf16", model, params, batch)

            # the drift-triggered in-place replan: a simulated throttle
            # scales the recorded plan walls from 100 steps' cost on (the
            # reference's acceptance test), a bucket's monitor fires on a
            # wholly throttled window, and the scheduler replans it,
            # verifies the new plan, executes it on the card and commits it
            # only if its fidelity error is lower; once over this phase's
            # traffic and once over the sparse one, whose b1s64 replan
            # must commit and move nodes (`THROTTLE_SCALE`)
            for walk, traffic in (("throttled", traffic),
                                  ("throttled sparse",
                                   sparse_traffic(cfg, cost))):
                label = f"{name} serve bf16 {walk}"
                zero()
                t = time.perf_counter()
                rep, attempts = throttled_scheduler(
                    cfg, model, params,
                    repro_torch.compile_portfolio(cfg, target, **kw),
                    Path(tmp, f"meas_{walk}"), Path(tmp, "plans"), cost,
                    traffic)
                host = time.perf_counter() - t
                walks[label] = (None, read())
                print(_report_line(label, rep, host) + "; replans: "
                      + replan_attempts(attempts, rep), flush=True)
                faults = throttle_faults(rep, walk == "throttled sparse")
                if faults:
                    raise AssertionError(f"{label}: {'; '.join(faults)}")
                events += rep.replan_events
            del model, params, engine
            torch.cuda.empty_cache()

        for ev in events:
            print(f"  replan [{ev.bucket}] at step {ev.step} ({ev.time_s:.3f}"
                  f" s): {ev.changes} nodes moved, fidelity error "
                  f"{ev.pre_fidelity:.3f} -> {ev.post_fidelity:.3f}, key "
                  f"{ev.old_key} -> {ev.new_key}", flush=True)
            if not ev.post_fidelity < ev.pre_fidelity:
                raise AssertionError(f"serve: a committed replan did not "
                                     f"lower the fidelity error")
        # hold every executed plan the entries above did not hold: its run
        # against run_oracle and every kernel call of one of its requests
        if not executed:
            raise AssertionError("serve: no plan execution was recorded")
        committed = {ev.new_key for ev in events}
        for key, c in executed.items():
            if key in held:
                continue
            shape = tuple(c.executor(device="cuda").input_template().shape)
            tag = (f"{name} b{shape[0]} plan {key[:8]} "
                   f"{'replanned' if key in committed else 'not committed'}")
            make = decode_input(*shape)
            counts, exe, _, _ = main_path(tag, c, make, shape,
                                          PORTFOLIO_REQUESTS, SERVE_E2E_RTOL)
            walks[tag] = (tag, counts)
            hold_walk_calls(tag, kernel_calls(exe, make(0)),
                            expected_counts(c.plan), peaks, tallies)
            held.add(key)
        print(f"serve: {len(executed)} distinct plans executed by the "
              f"scheduler and the engine, each held against its plain "
              f"version ({len(committed)} committed replans): "
              + ", ".join(sorted(executed)), flush=True)
    for k in ("split_matmul", "decode_attention"):
        for walk in ("fp32 virtual", "bf16 fixed", "bf16 wall",
                     "bf16 throttled", "bf16 throttled sparse"):
            walk = f"{name} serve {walk}"
            if not walks[walk][1][k]:
                raise AssertionError(f"{k} was not launched on the {walk} "
                                     f"walk")
    return walks


def tune_ops():
    """The sweep's ops, one per kind at the main paths' shapes: (label,
    op).  The M = 64 linear is the one op off the paths: the tiled product
    only runs at M > 8."""
    from repro_torch.core.types import AttnOp, ConvOp, LinearOp, SSMOp
    return [
        ("VGG16 n7 conv", ConvOp(56, 56, 256, 256)),       # P = 784
        ("zamba2-7b in_proj M=1", LinearOp(1, 3584, 5696)),
        ("zamba2-7b in_proj M=4", LinearOp(4, 3584, 5696)),
        ("q_proj M=64", LinearOp(64, 3584, 3584)),
        ("zamba2-7b b8.attn S=3072", AttnOp(H=32, S=3072, KV=32, hd=112)),
        ("SSD prefill T=4096", SSMOp(T=4096, H=112, hd=64, N=64)),
    ]


def tune_operands(op, gen):
    """Seeded float32 arguments of the op's kernel call on the card, drawn
    as the kernel phases draw them, with the wrapper, its plain version
    (for a launch), the call's (bytes, operations) and what the kernel's
    planner picks for it (the default launch)."""
    import importlib

    from repro_torch.kernels import build, registry
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.split_matmul.split_matmul import (
        split_matmul, split_matmul_plain)
    from repro_torch.kernels.ssd_chunk.ssd_chunk import (
        CHUNK, ssd_chunk_scan, ssd_chunk_scan_plain)
    from repro_torch.kernels.winograd_conv.winograd_conv import (
        hadamard_matmul, hadamard_matmul_plain, plan_hadamard)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    da, sm, sc = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
                  for m in ("decode_attention", "split_matmul", "ssd_chunk"))
    kind = registry.op_kind(op)
    if kind == "linear":
        m, k, n = op.L, op.C_in, op.C_out
        args = (rand(m, k), rand(k, n) / k ** 0.5, 0, n)
        plan = sm.plan_call(*args)
        return (args, split_matmul,
                lambda launch, *a: split_matmul_plain(*a),
                lambda elt: (elt * (m * k + k * n + m * n), 2 * m * k * n),
                f"bm{plan.mt}/bn{plan.tile}" if plan.variant == sm.TILED
                else f"splits {plan.splits} x {plan.col_tiles} column tiles")
    if kind == "conv":
        p = -(-op.H_in // 2) * -(-op.W_in // 2)
        k, n = op.C_in, op.C_out
        args = (rand(16, p, k), rand(16, k, n) / k ** 0.5)
        plan = plan_hadamard(16, p, k, n, 4, (0, 0, 0), build.sm_count(0))
        return (args, hadamard_matmul,
                lambda launch, *a: hadamard_matmul_plain(*a),
                lambda elt: (elt * 16 * (p * k + k * n + p * n),
                             2 * 16 * p * k * n),
                f"bm{plan.bm}/bn{plan.bn}, {plan.blocks} blocks")
    if kind == "attention":
        h, kv, hd, s = op.H, op.KV, op.hd, op.S
        args = (rand(h, hd), rand(s, kv, hd), rand(s, kv, hd), s - 1, 0)
        plan = da.plan_call(*args)
        return (args,
                lambda *a, launch: decode_attention(*a[:4], window=a[4],
                                                    launch=launch),
                lambda launch, *a: decode_attention_plain(*a[:4],
                                                          window=a[4]),
                lambda elt: (elt * (2 * h * hd + 2 * s * kv * hd) + 4 * h,
                             4 * h * s * hd),
                f"run_tiles {plan.run_tiles} ({plan.nsplit} runs per KV "
                f"head)")
    b, t, h, hd, n = 1, op.T, op.H, op.hd, op.N
    args = (rand(b, t, h, hd), rand(b, t, n) / n ** 0.5,
            rand(b, t, n) / n ** 0.5, 0.05 + 0.2 * torch.sigmoid(rand(b, t, h)),
            -(0.1 + rand(h).abs()), rand(b, h, hd, n) / n ** 0.5)
    plan = sc.plan_call(*args, torch.empty_like(args[5]))
    return (args, ssd_chunk_scan,
            lambda launch, *a: ssd_chunk_scan_plain(
                *a, chunk=launch.get("chunk") or CHUNK),
            lambda elt: (elt * (2 * b * t * h * hd + 2 * b * t * n + b * t * h
                                + h + 2 * b * h * hd * n),
                         6 * b * t * h * hd * n),
            f"chunk {plan.chunk}")


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def sweep_op(label: str, op, gen, peaks: dict) -> dict:
    """Every candidate launch of the op's Hopper spec, both search modes'
    grids (`LaunchSpec.configs`, `preserve_numerics=False`): each held
    against the plain version in float32 and bfloat16 within
    `KERNEL_RTOL`, each output-tiling one `torch.equal` to the default
    launch's output in float32, each timed in float32 (`time_ms`).
    Prints each candidate's time, the default's, the winner of each
    search mode with `autotune`'s hysteresis and the winner's bound;
    returns {launch label: ms}."""
    from repro_torch.kernels import registry, tiles
    from repro_torch.runtime.autotune import TUNE_HYSTERESIS
    kind = registry.op_kind(op)
    spec = tiles.launch_spec(kind)
    extents = registry.launch_extents(op)
    grid = spec.configs(extents, preserve_numerics=False)
    preserving = spec.configs(extents)
    args32, kernel, plain, work, picked = tune_operands(op, gen)
    default = _outputs(kernel(*args32, launch=spec.default()))
    times, errs, identical = {}, dict.fromkeys(DTYPES, 0.0), 0
    for launch in grid:
        for dtype in DTYPES:
            args = tuple(a.to(dtype) if torch.is_tensor(a) else a
                         for a in args32)
            got = _outputs(kernel(*args, launch=launch))
            want = _outputs(plain(launch, *args))
            for i, (g, w) in enumerate(zip(got, want)):
                errs[dtype] = max(errs[dtype], check(
                    f"tune {label} {launch.label()} {dtype} output {i}", g,
                    w, KERNEL_RTOL[dtype]))
            if dtype != torch.float32:
                continue
            tiling = not any(spec.param(n).reduction
                             for n, _ in launch.values)
            if tiling and not all(torch.equal(g, d)
                                  for g, d in zip(got, default)):
                raise AssertionError(
                    f"tune {label}: the output-tiling launch "
                    f"{launch.label()} is not bit-identical to the default "
                    f"launch in float32")
            identical += tiling
            times[launch.label()] = time_ms(
                lambda: kernel(*args, launch=launch))
    base = times["default"]

    def winner(cands):
        best = min(cands, key=lambda c: times[c.label()])
        if times[best.label()] > base * (1.0 - TUNE_HYSTERESIS):
            return spec.default()
        return best
    bnd, tb, to = bound_ms(*work(4), torch.float32, peaks)
    shown = ", ".join(f"{c.label()} {times[c.label()]:.4f}" for c in grid)
    print(f"tune {label} ({registry.op_label(op)}, {kind}; the planner "
          f"picks {picked}): float32 ms {shown}; {len(grid)} candidates "
          f"within KERNEL_RTOL of the plain version (max_abs_err float32 "
          f"{errs[torch.float32]:.3e}, bfloat16 {errs[torch.bfloat16]:.3e}),"
          f" {identical} output-tiling ones (the default included) "
          f"bit-identical to the default launch", flush=True)
    for mode, cands in (("numerics-preserving", preserving),
                        ("all candidates", grid)):
        best = winner(cands)
        ms = times[best.label()]
        print(f"tune {label}: {mode} winner {best.label()} {ms:.4f} ms "
              f"(default {base:.4f} ms, {base / ms - 1:+.1%}; "
              f"{'beats' if not best.is_default else 'none beats'} the "
              f"default by more than {TUNE_HYSTERESIS:.0%}); bound "
              f"{bnd:.4f} ms by {'bytes' if tb >= to else 'operations'} "
              f"({bnd / ms:.1%} of it)", flush=True)
    return times


def observed_launches(calls: dict) -> dict:
    """(kernel, launch label) -> calls, of one request's kernel calls
    (`kernel_calls`: a signature's last element is its launch)."""
    seen = {}
    for name, sigs in calls.items():
        for sig, (n, _) in sigs.items():
            label = "default" if sig[-1] is None else sig[-1].label()
            seen[(name, label)] = seen.get((name, label), 0) + n
    return seen


def expected_launches(exe) -> dict:
    """(kernel, launch label) -> calls of one request of the executor's
    per-node walk: each node's tuned launch, on a split's sides fitted to
    each side (a channel side's width, a typed side's sub-op)."""
    from repro_torch.kernels import registry, tiles
    kernel = {"linear": "split_matmul", "conv": "hadamard_matmul",
              "attention": "decode_attention", "ssm": "ssd_chunk_scan"}
    want = {}
    for spec, launch in zip(exe.specs, exe.launches):
        if spec.op is None or not registry.launch_extents(spec.op):
            continue
        launch = launch or tiles.Launch(spec.unit)
        if not spec.coexec:
            sides = [launch]
        elif spec.axis == "channel":
            sides = [registry.fit_launch(launch, spec.op, n=w)
                     for w in (spec.c_fast, spec.c_slow) if w]
        else:
            axis = registry.axis_spec(spec.unit, spec.axis)
            sides = [registry.fit_launch(launch, axis.sub(spec.op, n))
                     for n in (spec.c_fast, axis.size(spec.op) - spec.c_fast)]
        for side in sides:
            key = (kernel[spec.unit], side.label())
            want[key] = want.get(key, 0) + 1
    return want


def tuned_path(name: str, network, target, mode: str, predictors,
               make_input, out_shape, tmp: Path, peaks: dict,
               tallies: dict) -> dict:
    """`compile(tune=True)` of one main path into fresh plan and tune
    caches: cold (its measurements counted), then warm (no measurement,
    tune-cache hits only); its key against the untuned compile's, its
    document the untuned one's but for `provenance.tune`; saved with its
    sidecar, loaded strictly, run per node and fused against its
    run_oracle (`main_path`, `fused_path`), every kernel call of one
    request checked to carry its op's tuned launch fitted to its side
    (`check_launches`); then the same plan tuned with its reduction axes
    too (`preserve_numerics=False`), run and checked alike, its kernel
    calls held against their plain versions (`hold_walk_calls`); the
    tuned, relaxed and untuned walls in turns.  Returns the walks."""
    import repro_torch
    import repro_torch.runtime.autotune as at
    from repro_torch.api import CompiledNetwork
    from repro_torch.kernels.registry import op_label

    measured = [0]
    real = at.measure_tile_us

    def counted(*a, **k):
        measured[0] += 1
        return real(*a, **k)

    kw = dict(mode=mode, cache=tmp / "plans", predictors=predictors)
    runs = {}
    at.measure_tile_us = counted
    try:
        for run in ("cold", "warm"):
            tc = at.TuneCache(tmp / "tune")
            measured[0] = 0
            t = time.perf_counter()
            net = repro_torch.compile(network, target, tune=True,
                                      tune_cache=tc, **kw)
            runs[run] = (net, time.perf_counter() - t, measured[0], tc)
    finally:
        at.measure_tile_us = real
    untuned = repro_torch.compile(network, target, **kw)
    (tuned, cold_s, cold_n, cold_tc), (warm, warm_s, warm_n, warm_tc) = \
        runs["cold"], runs["warm"]
    ops = len(tuned.tuned)
    if tuned.from_cache or not warm.from_cache or warm.key != tuned.key:
        raise AssertionError(f"{name} tuned: the first compile must miss "
                             f"and the second hit the plan cache")
    if warm_n or warm_tc.misses or warm_tc.hits != ops \
            or warm.tuned != tuned.tuned:
        raise AssertionError(f"{name} tuned: the warm compile measured "
                             f"{warm_n} times with {warm_tc.misses} tune "
                             f"misses and {warm_tc.hits} hits for {ops} ops")
    a = json.loads(untuned.plan.dumps())
    b = json.loads(tuned.plan.dumps())
    tag = b["provenance"].pop("tune")
    if tuned.key == untuned.key or a != b or \
            tag != at.tune_cache_version():
        raise AssertionError(f"{name} tuned: the tuned document must be "
                             f"the untuned one with provenance.tune only")
    moved = {op: l for op, l in tuned.launches.items() if not l.is_default}
    print(f"{name} tuned: {ops} unique ops, {cold_n} measurements "
          f"({cold_tc.misses} tune misses) cold in {cold_s:.3f} s; warm "
          f"{warm_s:.3f} s with {warm_n} measurements and {warm_tc.hits} "
          f"tune-cache hits; key {tuned.key} (untuned {untuned.key}); the "
          f"documents differ only in provenance.tune = {tag}; launches off "
          f"the default: " + ("; ".join(sorted(
              f"{op_label(op)} -> {l.label()}" for op, l in moved.items()))
              or "none"), flush=True)
    path = tuned.save(tmp / f"{name}.tuned.coexec.json")
    loaded = CompiledNetwork.load(path)
    if loaded.launches != tuned.launches or loaded.key != tuned.key:
        raise AssertionError(f"{name} tuned: the saved artifact and its "
                             f"sidecar do not load back as they were")
    label = f"{name} tuned"
    counts, exe, want, refs = main_path(label, loaded, make_input, out_shape,
                                        REPLAN_REQUESTS, E2E_RTOL[name])
    walks = {label: (None, counts),
             f"{label} fused": (None, fused_path(label, exe, want, refs,
                                                 E2E_RTOL[name]))}
    check_launches(label, exe, kernel_calls(exe, make_input(0)))

    # the relaxed search (preserve_numerics=False) of the same plan: the
    # split-K factors, runs and chunks too, tolerance-exact, run likewise
    t = time.perf_counter()
    entries = at.annotate_plan_tiles(loaded.plan, cache=at.TuneCache(
        tmp / "tune"), preserve_numerics=False)
    relaxed = CompiledNetwork(plan=loaded.plan, target=loaded.target,
                              mode=loaded.mode, tuned=entries)
    print(f"{name} relaxed: {len(entries)} ops searched with their "
          f"reduction axes in {time.perf_counter() - t:.3f} s; launches off "
          f"the default: " + ("; ".join(sorted(
              f"{op_label(op)} -> {l.label()}"
              for op, l in relaxed.launches.items() if not l.is_default))
              or "none"), flush=True)
    label_r = f"{name} relaxed"
    counts, exe_r, want, refs = main_path(label_r, relaxed, make_input,
                                          out_shape, REPLAN_REQUESTS,
                                          E2E_RTOL[name])
    walks[label_r] = (label_r, counts)
    walks[f"{label_r} fused"] = (label_r, fused_path(label_r, exe_r, want,
                                                     refs, E2E_RTOL[name]))
    calls = kernel_calls(exe_r, make_input(0))
    check_launches(label_r, exe_r, calls)
    hold_walk_calls(label_r, calls, want, peaks, tallies)
    alternating_walls({label: exe, label_r: exe_r, f"{name} untuned":
                       untuned.executor(device="cuda")},
                      make_input(REQUESTS), TUNE_WALL_PAIRS)
    return walks


def check_launches(label: str, exe, calls: dict) -> None:
    """Every kernel call of one request of `exe`'s per-node walk
    (`kernel_calls`) carries its op's tuned launch fitted to its side
    (`expected_launches`)."""
    seen = observed_launches(calls)
    expect = expected_launches(exe)
    if seen != expect:
        raise AssertionError(f"{label}: the kernels were called with "
                             f"{seen}, the tuned launches give {expect}")
    print(f"{label}: every kernel call carried its op's tuned launch: "
          + ", ".join(f"{k} {l} x{n}" for (k, l), n in sorted(seen.items())),
          flush=True)


def tune_input(name: str, artifact: Path, compiled) -> tuple:
    """(network, target, mode, predictors) of a main path, as the compile
    phase compiled it."""
    import repro_torch
    from repro_torch.graph.frontends import from_model
    doc = json.loads(artifact.read_text())
    network = from_model(ZAMBA, **ZAMBA_GRAPH) if name == ZAMBA else name
    return (network, repro_torch.Target.from_json(doc["target"]),
            doc["mode"], compiled.predictors)


def tune_phase(peaks: dict, tallies: dict, tune_inputs: dict) -> dict:
    """The autotuner on the card: (a) the sweep (`sweep_op`) of one op
    per kind; (b) the tuned compiles of VGG16 and the zamba2-7b step
    (`tuned_path`).  Returns the tuned walks."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    t = time.perf_counter()
    for label, op in tune_ops():
        sweep_op(label, op, gen, peaks)
    print(f"tune sweep: {time.perf_counter() - t:.1f} s", flush=True)
    walks = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_tune_") as tmp:
        for name, make_input, out_shape in TUNE_PATHS:
            network, target, mode, predictors = tune_inputs[name]
            walks.update(tuned_path(name, network, target, mode, predictors,
                                    make_input, out_shape, Path(tmp, name),
                                    peaks, tallies))
            torch.cuda.empty_cache()
    return walks


def image_input(size: int):
    """Seeded (1, size, size, 3) requests of a CNN path."""
    def make(r: int) -> np.ndarray:
        return np.random.default_rng(100 + r).standard_normal(
            (1, size, size, 3)).astype(np.float32)
    return make


vgg16_input = image_input(224)


def decode_input(batch: int, d: int = None):
    """Seeded (batch, d) requests of a decode step (d: zamba2-7b's
    width unless given)."""
    def make(r: int) -> np.ndarray:
        return np.random.default_rng(300 + r).standard_normal(
            (batch, d or ZAMBA_D)).astype(np.float32)
    return make




#: the device-kernel names of each wrapper's main pass on the main paths,
#: one of which runs per launch: `split_matmul`'s split-K GEMV (M <= 8) or
#: tiled product (rwkv6-1.6b's prefill plan, M = 512); the SSD scan's
#: decode kernel (T <= 16) or the first of its chunk kernels
TRACE_NAMES = {"split_matmul": ("splitk_gemv<float", "tc_gemm<float"),
               "hadamard_matmul": ("hadamard_gemm<float",),
               "decode_attention": ("attn_runs<float",),
               "ssd_chunk_scan": ("ssd_decode<float",
                                  "ssd_chunk_state<float")}
#: CUDA runtime calls by which the host puts work on the card
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
                     "cudaMemset", "cudaGraphLaunch")
#: second passes, counted apart from their wrappers' launches
SECOND_PASSES = {"split_matmul": ("splitk_reduce<float",
                                  "splitk_reduce_rows<float"),
                 "decode_attention": ("attn_merge<float",)}


def device_breakdown(name: str, exe, x, requests: int = 2,
                     top: int = 12, fused: bool = False) -> None:
    """`requests` requests under torch.profiler: device time per request
    of the kernels they ran, by kernel name, against the request wall; and
    each wrapper's launches in the trace against its launch counter (for
    the fused walk, the launches credited at the graphs' replays) and the
    graph launches the trace shows.  Raises if the trace holds no device
    time at all."""
    counters = kernel_counters()
    exe.run(x, fused=fused)
    before = {k: fn.launches for k, fn in counters.items()}
    if fused:
        name = f"{name} fused"
    rows, busy, wall, calls, _ = _profile(name,
                                          lambda: exe.run(x, fused=fused),
                                       requests)
    print(f"profile {name}: {requests} requests; per request wall "
          f"{wall:.3f} ms under the profiler, kernels {busy:.3f} ms of "
          f"device time in {sum(r[1] for r in rows) / requests:g} launches "
          f"(the two streams may overlap, so the card is idle for at least "
          f"{1 - busy / wall:.1%} of the wall); host calls per request "
          f"{sum(calls.values()):g} ("
          + ", ".join(f"{k} {n:g}" for k, n in sorted(calls.items())) + ")")
    for ms, count, key in rows[:top]:
        print(f"  {ms:8.3f} ms {count:4d}x {key[:100]}")
    seen = {k: sum(c for _, c, key in rows
                   if any(name in key for name in TRACE_NAMES[k]))
            for k in KERNEL_NAMES}
    second = {k: sum(c for _, c, key in rows
                     if any(pattern in key for pattern in patterns))
              for k, patterns in SECOND_PASSES.items()}
    graphs = round(calls.get("cudaGraphLaunch", 0) * requests)
    print(f"profile {name}: launches in the trace / by the counters over "
          f"the {requests} requests: " + ", ".join(
              f"{k} {seen[k]}/{counters[k].launches - before[k]}"
              for k in KERNEL_NAMES
              if counters[k].launches - before[k] or seen[k])
          + "; second passes in the trace: " + ", ".join(
              f"{k} {n}" for k, n in second.items())
          + f"; cudaGraphLaunch calls in the trace: {graphs}", flush=True)
    for k in KERNEL_NAMES:
        counted = counters[k].launches - before[k]
        if counted and not seen[k]:
            print(f"profile {name}: the trace lists none of the {counted} "
                  f"{k} launches the counter holds", flush=True)


#: the zamba2-7b path's graph: 9 blocks, a 4096-position KV cache; its
#: model width (d_model)
ZAMBA_GRAPH = dict(blocks=9, cache_len=4096)
ZAMBA_D = 3584
#: rwkv6-1.6b's model width, and its plans' prefill tokens
RWKV_D = 2048
RWKV_TOKENS = 512
#: deepseek-v2-lite-16b's model width and its committed plan
DS_D = 2048
DS_ARTIFACT = ARTIFACTS / "deepseek-v2-lite-16b_b27_moto2022_t1.coexec.json"
#: the model-graph paths: (model, `from_model` arguments) of each
GRAPHS = {ZAMBA: ("zamba2-7b", ZAMBA_GRAPH),
          RWKV: ("rwkv6-1.6b", dict(blocks=24)),
          RWKV_PREFILL: ("rwkv6-1.6b", dict(blocks=24, tokens=RWKV_TOKENS)),
          DS: ("deepseek-v2-lite-16b", dict(blocks=27))}
#: the paths whose every distinct kernel call of one request is held
#: against its plain version and timed (`hold_walk_calls`) right after
#: the path: their times in the kernels line are those calls' own
HELD_PATHS = (RWKV, RWKV_PREFILL, DS)

#: the calibrate phase: its paths, the per-node runs it records (then one
#: fused run), and the requests each replanned walk runs
CALIBRATE_PATHS = (VGG, ZAMBA)
RECORD_RUNS = 2
REPLAN_REQUESTS = 2

#: the portfolio phase: the committed zamba2-7b portfolio, the requests
#: each of its entries runs per walk, and the live step (batch, seq) whose
#: entry it recalibrates, replans and replaces (`select` gives b4s256)
PORTFOLIO = ARTIFACTS / "zamba2-7b_b9_moto2022_t1.portfolio.json"
PORTFOLIO_REQUESTS = 2
PORTFOLIO_STEP = (4, 200)

#: the tune phase's tuned compiles: (path, request maker, output shape),
#: each run for `REPLAN_REQUESTS` requests per walk, and its rounds of
#: tuned and untuned walls in turns
TUNE_PATHS = ((VGG, vgg16_input, (1, 1000)),
              (ZAMBA, decode_input(1), (1, ZAMBA_D)))
TUNE_WALL_PAIRS = 4

#: the serve phase: the model (codeqwen1.5-7b at its published widths and
#: full depth), its portfolio's (batch, seq) buckets, the fixed-batch
#: engine's requests, new tokens per request and batch, the scheduler's
#: per-slot cache length, its Poisson requests and plan-execution cadence
SERVE_ARCH = "codeqwen15_7b"
SERVE_BUCKETS = ((1, 64), (4, 64))
SERVE_FIXED_REQUESTS = 8
SERVE_MAX_NEW = 12
SERVE_MAX_BATCH = 4
SERVE_MAX_LEN = 64
SERVE_TRAFFIC = 24
SERVE_FIDELITY_EVERY = 8
#: the reduced model's logits on the card against the CPU's, relative to
#: the largest |CPU logit| (fp32 sums in another order through 2 layers);
#: a serve plan's run against its run_oracle, as zamba2-7b's (fp32 GEMV
#: sums to K = 13440 and the split attention's merge)
SERVE_LOGIT_RTOL = 1e-4
SERVE_E2E_RTOL = 1e-4

#: the throttled scheduler runs (`throttled_scheduler`): the wall scale
#: from 100 steps' cost on; the scheduler's drift settings: a window of
#: 2 reports (median = mean) and a threshold between log(8) / 2 = 1.04
#: (one of the two reports throttled) and log(8) = 2.08 (both), so the
#: monitor fires only on a wholly throttled window; and the sparse
#: traffic (THROTTLE_RATE / the b4s64 plan's cost), in which most steps
#: run one request, in the b1s64 bucket.  The b4s64 plan co-executes all
#: six of its nodes, so a fit to its records holds only (kind, "coexec")
#: corrections and none of the per-kind aggregates the planner applies:
#: its replan is the same plan with the same predictions, no node moves,
#: and whether it commits turns on the card's noise (ROADMAP Queue 3).
#: The b1s64 plan runs its linears alone, so its replan is priced anew
#: and moves nodes.  The serve traffic (mostly b4s64) shows the first;
#: the sparse traffic must show the second.  x8 keeps the firing drift
#: and the half-window drift furthest from the threshold
THROTTLE_SCALE = 8.0
THROTTLE_CONFIG = dict(fidelity_every=4, fidelity_window=2,
                       drift_threshold=1.5, drift_cooldown=2)
THROTTLE_REQUESTS = 12
THROTTLE_RATE = 0.05

#: the Whisper phase (whisper-large-v3, full width and depth): the fp32
#: check's batch, prompt and teacher-fed decode steps; the bf16 engine's
#: requests and new tokens each (batch MODEL_SERVE_BATCH)
WHISPER_ARCH = "whisper_large_v3"
WHISPER_BATCH = 2
WHISPER_PROMPT = 64
WHISPER_DECODE_STEPS = 8
WHISPER_REQUESTS = 8
WHISPER_NEW = 32
#: the train phase: whisper-large-v3's steps, batch, target tokens and
#: learning rate (bf16 params 4.0 GB, grads 4.0 GB, fp32 moments 16.2 GB
#: and the encoder's saved activations, ~22 GB at batch 2: the
#: reference's default batch 8 would not fit the card); the reduced
#: card-vs-CPU step's target tokens (past `SSD_DECODE_T_MAX`, so Mamba2
#: layers take the chunk kernels, with a ragged last chunk) and its
#: tolerance, relative to the CPU loss and to each leaf's largest |CPU
#: gradient| (fp32 sums in another order through a backward pass, the
#: SSD chunk kernels' 3xTF32 products included)
TRAIN_STEPS = 20
TRAIN_BATCH = 2
TRAIN_SEQ = 128
TRAIN_LR = 3e-4
TRAIN_CHECK_SEQ = 96
TRAIN_RTOL = 1e-4
#: zamba2-7b's training through the mesh path at its published widths:
#: its layers (9 of 81: one group of Mamba2 layers and the shared
#: attention block once), steps, batch and tokens
ZAMBA_TRAIN_LAYERS = 9
ZAMBA_TRAIN_STEPS = 4
ZAMBA_TRAIN_BATCH = 2
ZAMBA_TRAIN_SEQ = 512
#: the dry-run phase: the reference's CI combinations
#: (`tests/test_dryrun_small.py`) on the test meshes (multi_pod: 2x2x2,
#: else 2x4) and the status its test expects of each
DRYRUN_CI = (("rwkv6_1b6", "decode_32k", False, "ok"),
             ("rwkv6_1b6", "long_500k", True, "ok"),
             ("deepseek_v2_lite", "decode_32k", False, "ok"),
             ("gemma3_12b", "long_500k", False, "ok"),
             ("llama3_405b", "long_500k", False, "skipped"))

#: the model phases: zamba2-7b and rwkv6-1.6b at their published widths
#: and full depth; the fp32 prompt lengths (a multiple of the reference's
#: chunk, 256 tokens for Mamba2's SSD and 64 for RWKV6's WKV, and one that
#: is not) at batch MODEL_FP32_BATCH, the decode steps after each, and the
#: tolerance of their logits against `forward`, relative to the largest
#: |logit| (the zamba2-7b plan's: fp32 sums of the chunk and decode
#: kernels in another order than one chunk pass, through 81 layers; for
#: rwkv6-1.6b the chunked WKV against the step recurrence through 24); the
#: fp32 engine's equal-length greedy requests; the bf16 engine's
#: requests, batch, prompt and new tokens
MODEL_ARCHS = ("zamba2_7b", "rwkv6_1b6")
MODEL_PROMPTS = (512, 300)
MODEL_FP32_BATCH = 2
MODEL_DECODE_STEPS = 4
MODEL_LOGIT_RTOL = 1e-4
MODEL_EQUAL_REQUESTS = 4
MODEL_EQUAL_PROMPT = 64
MODEL_EQUAL_NEW = 6
MODEL_SERVE_REQUESTS = 8
MODEL_SERVE_BATCH = 4
MODEL_SERVE_PROMPT = 512
MODEL_SERVE_NEW = 32
#: the model walks whose float32 SSD times the kernels line adds to the
#: main paths': one prefill and one decode step
MODEL_TIMED = (f"{ZAMBA} model prefill", f"{ZAMBA} model decode")

#: the deepseek-v2-lite-16b phase (full width and depth): its fp32
#: prefill-vs-forward batch and prompt; one MLA layer's (prefill T, cache
#: S), dense then flash in both (the reference's thresholds: T 2048, S
#: 8192); one MoE layer's (batch, tokens)
DS_ARCH = "deepseek_v2_lite"
DS_FP32_BATCH = 2
DS_FP32_PROMPT = 512
DS_MLA_CASES = ((512, 1024), (2048, 8192))
DS_MOE_TOKENS = (2, 256)
#: the llama4-scout phase: its layers (of 48; reduced: depth only), the
#: bf16 prefill-vs-forward batch and prompt, the scheduler's requests
L4_ARCH = "llama4_scout"
L4_LAYERS = 6
L4_BATCH = 2
L4_PROMPT = 512
L4_REQUESTS = 8

#: the main paths: (name, committed artifact, request maker, output shape);
#: the compile phase compiles each and must reproduce its artifact
PATHS = [
    (VGG, ARTIFACT, vgg16_input, (1, 1000)),
    (ZAMBA, ZAMBA_ARTIFACT, decode_input(1), (1, ZAMBA_D)),
    (R18, ARTIFACTS / "resnet18_moto2022.coexec.json", image_input(224),
     (1, 1000)),
    (R34, ARTIFACTS / "resnet34_moto2022.coexec.json", image_input(224),
     (1, 1000)),
    (INC, ARTIFACTS / "inception_v3_moto2022.coexec.json", image_input(299),
     (1, 1000)),
    (RWKV, ARTIFACTS / "rwkv6-1.6b_b24_moto2022_t1.coexec.json",
     decode_input(1, RWKV_D), (1, RWKV_D)),
    (RWKV_PREFILL, ARTIFACTS / "rwkv6-1.6b_b24_tok512_moto2022_t1.coexec.json",
     decode_input(RWKV_TOKENS, RWKV_D), (RWKV_TOKENS, RWKV_D)),
    (DS, DS_ARTIFACT, decode_input(1, DS_D), (1, DS_D)),
]


class Phases:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f} s (total "
              f"{now - self.t0:.1f} s)", flush=True)
        self.t = now


SOURCES = {
    "split_matmul": ("src/repro_torch/csrc/split_matmul.cu",
                     "src/repro/kernels/split_matmul/split_matmul.py:44"),
    "hadamard_matmul": ("src/repro_torch/csrc/hadamard_matmul.cu",
                        "src/repro/kernels/winograd_conv/winograd_conv.py:55"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:72"),
    "ssd_chunk_scan": ("src/repro_torch/csrc/ssd_chunk.cu",
                       "src/repro/kernels/ssd_chunk/ssd_chunk.py:67"),
}


def ssd_times(src: Path) -> int:
    """`--ssd-times SRC`: the SSD scan of the checkout at SRC (its
    `src/repro_torch`, its kernels built under SRC) at `SSD_COMPARE` in
    float32 (`time_ms`, median of 20, beside the fp32 CUDA-core and the
    3xTF32 tensor-core bound), then zamba2-7b's bf16 prefill of
    `MODEL_SERVE_BATCH` x `MODEL_SERVE_PROMPT` tokens at full depth: the
    bare wall (median of 3) and, under torch.profiler, the device time and
    the SSD chunk kernels' share of it.  Prints one JSON line.  Run it for
    two checkouts in turns (parent, change, change, parent) in one call to
    compare them on one card."""
    sys.path.insert(0, str(src.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_scan
    from repro_torch.models import build_model, get_config

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["ssd_chunk"])
    peaks = card_peaks()
    gen = torch.Generator(device="cuda").manual_seed(14)
    cases = []
    for b, t in SSD_COMPARE:
        h, hd, n = 112, 64, 64
        ins = ssd_inputs(gen, b, t, h, hd, n, torch.float32)
        ops = 6 * b * t * h * hd * n
        bnd, t_bytes, _ = bound_ms(nbytes(*ins, ins[0], ins[5]), ops,
                                   torch.float32, peaks)
        ms = time_ms(lambda: ssd_chunk_scan(*ins), reps=20)
        cases.append({"B": b, "T": t, "ms": ms, "bound_ms": bnd,
                      "tf32_bound_ms": tf32_bound_ms(t_bytes, ops, peaks)})
        del ins
    cfg = get_config("zamba2_7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, t_len = MODEL_SERVE_BATCH, MODEL_SERVE_PROMPT
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (b, t_len))).cuda()
    cache = model.init_cache(b, t_len + MODEL_SERVE_NEW, device="cuda")

    def prefill():
        model.prefill(params, toks, cache)

    prefill()
    torch.cuda.synchronize()
    bare = []
    for _ in range(3):
        t = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t) * 1e3)
    rows, busy, wall, _, _ = _profile(f"{cfg.name} prefill", prefill, 2)
    ssd, phases = ssd_device_ms(rows)
    print(json.dumps({"ssd_times": {
        "src": str(src), "card": smi, "cases": cases,
        "prefill": {"batch": b, "tokens": t_len, "dtype": cfg.dtype,
                    "wall_ms": statistics.median(bare), "walls_ms": bare,
                    "device_ms": busy, "profiled_wall_ms": wall,
                    "ssd_ms": ssd, "ssd_share": ssd / busy,
                    "ssd_kernels": phases}}}), flush=True)
    return 0


def plan_panels(compiled) -> dict:
    """{(K, N, width): calls per request} of the tiled `split_matmul`
    calls of a prefill plan: both sides of each channel-split linear node,
    each on its (K, c_pad) panel of the packed weights."""
    from repro_torch.core.coexec import SplitPlan
    out = {}
    for d in compiled.decisions:
        if type(d.op).__name__ != "LinearOp" or d.axis != "channel":
            continue
        split = SplitPlan(c_out=d.op.C_out, c_fast=d.c_gpu)
        for side in range(2):
            key = (d.op.C_in, split.c_pad, split.width(side))
            out[key] = out.get(key, 0) + 1
    return out


def split_times(src: Path) -> int:
    """`--split-times SRC`: `split_matmul` of the checkout at SRC (its
    `src/repro_torch`, its kernels built under SRC), on the card:
    - the tiled product at M = 512 on rwkv6-1.6b's whole weights
      (`SPLIT_WHOLE`) and the panels of its 512-token plan
      (`plan_panels`), in float32 and bfloat16, with `torch.matmul` on the
      same operands (`time_ms`, median of 20), each held against the plain
      version; the sum over one request of the plan's calls, beside the
      fp32, 3xTF32 and bf16 bounds;
    - the launch sweep: every candidate of the "linear" launch spec at
      each of those shapes (both search modes, splits up to
      `SWEEP_MAX_SPLITS`), timed, its fastest beside the default;
    - the GEMV's time per request of VGG16 and the zamba2-7b step
      (`SPLIT_CASES` with their launches per request);
    - the plan's per-node and fused request walls (`alternating_walls`,
      `WALL_PAIRS` rounds) after one request held against `run_oracle`.
    Prints one JSON line.  Run it for two checkouts in turns (parent,
    change, change, parent) in one call to compare them on one card."""
    sys.path.insert(0, str(src.resolve() / "src"))
    import repro_torch
    from repro_torch.kernels import build, tiles
    from repro_torch.kernels.split_matmul.split_matmul import (
        plan_call, split_matmul, split_matmul_plain)

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["split_matmul"])
    peaks = card_peaks()
    gen = torch.Generator(device="cuda").manual_seed(11)
    artifact = ARTIFACTS / "rwkv6-1.6b_b24_tok512_moto2022_t1.coexec.json"
    compiled = repro_torch.CompiledNetwork.load(artifact)
    panels = plan_panels(compiled)
    spec = tiles.launch_spec("linear")
    m = RWKV_TOKENS
    cases, sweep = [], []
    totals = {}
    for dtype in DTYPES:
        name = str(dtype).split(".")[-1]
        for (k, n, width), per in ([(w, 0) for w in SPLIT_WHOLE]
                                   + sorted(panels.items())):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            want = split_matmul_plain(x, w, 0, width)
            err = check(f"split_times {k}x{n}|{width} {name}",
                        split_matmul(x, w, 0, width), want,
                        KERNEL_RTOL[dtype])
            ms = time_ms(lambda: split_matmul(x, w, 0, width), reps=20)
            lib = time_ms(lambda: torch.matmul(x, w[:, :width]), reps=20)
            ops = 2 * m * k * width
            _, t_bytes, t_ops = bound_ms(
                x.element_size() * (m * k + k * width + m * width), ops,
                dtype, peaks)
            plan = plan_call(x, w, 0, width)
            cases.append({"dtype": name, "K": k, "N": n, "width": width,
                          "per_request": per, "ms": ms, "library_ms": lib,
                          "max_abs_err": err, "plan": str(plan),
                          "bound_ms": max(t_bytes, t_ops),
                          "tf32_bound_ms": tf32_bound_ms(t_bytes, ops,
                                                         peaks)})
            agg = totals.setdefault(name, dict.fromkeys(
                ("ms", "library_ms", "bound_ms", "tf32_bound_ms"), 0.0))
            for key in agg:
                agg[key] += cases[-1][key] * per
            timed = {}
            for launch in spec.configs({"m": m, "k": k, "n": width},
                                       preserve_numerics=False):
                if (launch.get("splits") or 0) > SWEEP_MAX_SPLITS:
                    continue
                check(f"split_times sweep {launch.label()}",
                      split_matmul(x, w, 0, width, launch=launch), want,
                      KERNEL_RTOL[dtype])
                timed[launch.label()] = time_ms(
                    lambda: split_matmul(x, w, 0, width, launch=launch))
            best = min(timed, key=timed.get)
            sweep.append({"dtype": name, "K": k, "width": width,
                          "default_ms": timed["default"], "best": best,
                          "best_ms": timed[best], "ms": timed})
            print(f"split_times {name} M={m} K={k} N={n} width={width} "
                  f"x{per}: kernel {ms:.4f} ms, torch.matmul {lib:.4f} ms; "
                  f"sweep: default {timed['default']:.4f}, best {best} "
                  f"{timed[best]:.4f} ms; {plan}", flush=True)
            del x, w, want
    gemv = {}
    for label, gm, k, n, c0, width, per_path in SPLIT_CASES:
        for path in (VGG, ZAMBA):
            if path not in per_path:
                continue
            x = torch.randn((gm, k), generator=gen, device="cuda")
            w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
            gemv[path] = gemv.get(path, 0.0) + per_path[path] * time_ms(
                lambda: split_matmul(x, w, c0, width), reps=20)
    exe = compiled.executor(device="cuda")
    x = decode_input(RWKV_TOKENS, RWKV_D)(0)
    exe.run(warmup=True)
    y, _ = exe.run(x)
    oracle = exe.run_oracle(x)
    err = float((y - oracle).abs().max()) / max(1.0, float(
        oracle.abs().max()))
    if not err <= E2E_RTOL[RWKV_PREFILL]:
        raise AssertionError(f"split_times: the plan's output is {err:.3e} "
                             f"of its largest |oracle| from run_oracle")
    fused, _ = exe.run(x, fused=True)
    if not torch.equal(fused, y):
        raise AssertionError("split_times: the fused walk's output differs "
                             "from the per-node walk's")
    walls = {}
    for _ in range(WALL_PAIRS):
        for walk in (False, True):
            t = time.perf_counter()
            exe.run(x, fused=walk)
            walls.setdefault("fused" if walk else "per-node", []).append(
                (time.perf_counter() - t) * 1e3)
    print(json.dumps({"split_times": {
        "src": str(src), "card": smi, "per_request": totals,
        "gemv_per_request_ms": gemv, "cases": cases,
        "plan_walls_ms": {k: statistics.median(v) for k, v in walls.items()},
        "plan_walls_all_ms": walls, "plan_rel_err": err,
        "sweep": sweep}}), flush=True)
    return 0


def mesh_phases(smi: str, peaks: dict, tallies: dict, phases) -> dict:
    """The mesh path's phases: zamba2-7b's published-width training
    (`zamba_train_phase`), the dry run (`dryrun_phase`) and the production
    mesh's refusal (`production_mesh_check`).  Returns the walks."""
    walks = zamba_train_phase(smi, peaks, tallies)
    phases.done("zamba2-7b train")
    dryrun_phase()
    production_mesh_check()
    phases.done("dryrun")
    return walks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if "--ssd-times" in sys.argv[1:]:
        return ssd_times(Path(sys.argv[sys.argv.index("--ssd-times") + 1]))
    if "--split-times" in sys.argv[1:]:
        return split_times(Path(sys.argv[sys.argv.index("--split-times")
                                         + 1]))
    throttle_only = ("--throttle-runs" in sys.argv[1:] and int(
        sys.argv[sys.argv.index("--throttle-runs") + 1]))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    phases = Phases()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build(build.KERNELS, ptxas_verbose=True)
    print(f"build: {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s -> {build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    phases.done("build")

    if throttle_only:
        return throttle_runs(throttle_only, smi)

    peaks = card_peaks()
    results = {}
    for name, phase in (("split_matmul", split_matmul_phase),
                        ("hadamard_matmul", hadamard_phase),
                        ("decode_attention", decode_attention_phase),
                        ("ssd_chunk_scan", ssd_phase)):
        results[name] = phase(peaks)
        phases.done(f"kernel {name}")
    if "--kernels-only" in sys.argv[1:]:
        return 0

    compiled_nets = compile_phase(PATHS)
    tuned_names = {name for name, _, _ in TUNE_PATHS}
    tune_inputs = {name: tune_input(name, artifact, compiled_nets[name])
                   for name, artifact, _, _ in PATHS if name in tuned_names}
    phases.done("compile")

    # each walk ("<path>", "<path> fused", "<path> bf16", ...) with the
    # key of its float32 times in the tallies (None: no times) and its
    # launch counts
    walks = {}
    kept = {}                  # the calibrate phase's compiled networks
    for name, _, make_input, out_shape in PATHS:
        compiled = compiled_nets.pop(name)
        counts, exe, want, refs = main_path(name, compiled, make_input,
                                            out_shape, REQUESTS,
                                            E2E_RTOL[name])
        walks[name] = (name, counts)
        device_breakdown(name, exe, make_input(REQUESTS))
        if name in HELD_PATHS:
            hold_walk_calls(name, kernel_calls(exe, make_input(0)), want,
                            peaks, results)
        phases.done(f"{name} per-node")
        walks[f"{name} fused"] = (name, fused_path(name, exe, want, refs,
                                                   E2E_RTOL[name]))
        alternating_walls({name: exe}, make_input(REQUESTS), WALL_PAIRS)
        device_breakdown(name, exe, make_input(REQUESTS), fused=True)
        phases.done(f"{name} fused")
        if name in BF16_PATHS:
            walks.update((walk, (None, c)) for walk, c in
                         bf16_path(name, compiled, want, refs).items())
            phases.done(f"{name} bf16")
        if name in CALIBRATE_PATHS:
            kept[name] = (compiled, make_input, out_shape)
        if name == DS:
            ds_compiled = compiled       # its executor serves the engine
        del compiled, exe, refs
        torch.cuda.empty_cache()
    for k in KERNEL_NAMES:
        for suffix in ("", " fused"):
            if sum(walks[f"{p[0]}{suffix}"][1][k] for p in PATHS) == 0:
                raise AssertionError(f"{k} was not launched on a main "
                                     f"path's{suffix or ' per-node'} walk")

    for name in CALIBRATE_PATHS:
        cal_walks, _ = calibrate_path(name, name, *kept.pop(name), peaks,
                                      results)
        walks.update(cal_walks)
        phases.done(f"{name} calibrate")
        torch.cuda.empty_cache()
    walks.update(portfolio_phase(peaks, results))
    phases.done("portfolio")
    walks.update(serve_phase(peaks, results, smi))
    phases.done("serve")
    for arch in MODEL_ARCHS:
        walks.update(model_phase(arch, peaks, results, smi))
        phases.done(f"{arch} model")
    walks.update(deepseek_phase(smi, ds_compiled))
    del ds_compiled
    phases.done(f"{DS_ARCH} model")
    walks.update(llama4_phase(smi))
    phases.done(f"{L4_ARCH} model")
    walks.update(whisper_phase(smi))
    phases.done(f"{WHISPER_ARCH} model")
    walks.update(train_phase(smi, peaks, results))
    phases.done("train")
    walks.update(mesh_phases(smi, peaks, results, phases))
    walks.update(tune_phase(peaks, results, tune_inputs))
    phases.done("tune")

    def by_path(name: str, t: Tally) -> dict:
        """Each walk's launches of kernel `name`, with the float32 times
        of one request where the walk has them."""
        out = {}
        for walk, (key, counts) in walks.items():
            if not counts[name] and key not in t.by_path:
                continue
            out[walk] = {"launches": counts[name]}
            if key in t.by_path:
                out[walk].update(
                    {k: (None if k == "library_ms" and not t.library else v)
                     for k, v in t.by_path[key].items()})
        return out

    mains = [p[0] for p in PATHS] + list(MODEL_TIMED)
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": sum(c[name] for _, c in walks.values()),
        "max_abs_err": t.max_abs_err,
        "max_abs_err_bf16": t.max_abs_err_bf16,
        "ms": t.total("ms", mains), "plain_ms": t.total("plain_ms", mains),
        "bound_ms": t.total("bound_ms", mains),
        "bound_by": ("bytes" if t.total("t_bytes", mains)
                     >= t.total("t_ops", mains) else "operations"),
        "library_ms": t.total("library_ms", mains),
        "per": (f"launches: the {REQUESTS} requests of each main path's "
                f"per-node and fused walks, the {BF16_REQUESTS} of each "
                f"bf16 walk, the {RECORD_RUNS + 1} recorded runs of each "
                f"calibrate walk, the {REPLAN_REQUESTS} requests of each "
                f"replanned walk, the {PORTFOLIO_REQUESTS} of each "
                f"portfolio entry's walks, of each serve bucket's plan and "
                f"of each tuned walk, the serve walks' plan executions "
                f"(every "
                f"{SERVE_FIDELITY_EVERY} scheduler steps, one execute_plan), "
                f"the zamba2-7b and rwkv6-1.6b model walks (each prefill, its "
                f"{MODEL_DECODE_STEPS} decode steps, the engines' runs), the "
                f"deepseek-v2-lite-16b engine's execute_plan, the "
                f"reduced zamba2-7b train step (its forward's launches, "
                f"each with a gradient), the {ZAMBA_TRAIN_STEPS} zamba2-7b "
                f"train steps at published widths on the mesh path; "
                f"times: one request of each main path (rwkv6-1.6b's two "
                f"plans and deepseek-v2-lite-16b's: the calls of one "
                f"request, each held) and one "
                f"prefill and one decode step of the zamba2-7b model, "
                f"float32 (by_path: "
                f"one request, prefill or decode step of each walk)"),
        "by_path": by_path(name, t)}
        for name, t in results.items()]}
    phases.done("paths")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
