#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits non-zero before the final ``ok`` line:

1. the card: its name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels of ``src/repro_torch/csrc`` (one nvcc call,
   sm_90a) and print the build seconds; then the PRNG: the threefry twin
   on the card against Random123's vectors and against constants of
   ``jax.random`` (keys, split, fold_in, bits, uniforms at the
   quickstart's (10, 784, 100), permutations of 600 and 10**4; normal
   within NORMAL_ULPS);
3. hold each kernel against its plain PyTorch version on the card, in
   fp32 and bf16, at the MLP's leaves (N=10), at ragged edges and at large
   leaves (a VGG conv and CNN2's fc), and importance also at fc0 of one
   client (N=1, fp32: the loop's launch), with the tolerances of the CPU
   tests (the Eq. (5) merge exact); ``sparse_agg``'s mean mode (Eq. (4)
   finished in the kernel, as the engine calls it) against its plain
   version (the partials' tolerances; one bf16 ulp for a bf16 output) and
   bit for bit against ``finish_masked_mean`` over the partials mode, with
   and without a previous global, one channel uploaded by no client; time
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (a yardstick the port never uses), as medians
   of CUDA-event pairs with a cold L2, and at each shape an ``eq4_leaf``
   row: the mean mode against the partials plus the eager finish.
   ``sparse_agg``'s elementwise-mask mode (a ragged fleet's zero-padded
   Eq. (4) canvas: each client a leading box of the leaf under a channel
   mask) the same way, both modes, at the ragged and large shapes and at
   the hetero-a canvas (5, 3, 3, 512, 512), counted under its own route.
   Eq. (5) also as the engine calls it: the MLP's six leaves in one call
   of the grouped merge, which must launch once and equal the plain
   version leaf by leaf, timed beside the six single-leaf launches; and
   one bf16 client leaf of 2**31 + 65536 elements (several descriptors,
   one launch) equal to ``torch.where`` and the plain version.
   The flash-attention kernels are held the same way (3e-5 fp32, 2e-2
   bf16, and in bf16 every output row within max|want|/64) over the CPU
   tests' sweep (causal, window 24, non-causal), odd lengths and head
   dims 16-256, each call's route counter checked against the rule (bf16
   at hd 64-256: the tensor-core kernel; fp32 and bf16 at hd 16-96: the
   CUDA-core one), and at the serving path's heads (B=1, 32/16 heads,
   hd 128, window 0 and 1024) over every row at S=8192 and at the
   prefill's S=32768 (the plain version there in chunks of 1024 query
   rows), with bf16 inputs and again with fp32 ones, and at the jamba and
   pixtral prefills' shapes (1, 8192, 64/8, 128) and (1, 8448, 32/8, 128);
   at each of them the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls:
   causal through its flash backend, the window through its
   memory-efficient backend with an additive band mask) are timed in
   bf16.  The client-batched convolutions (``kernels/conv``): each pass
   (forward, input gradient, weight gradient) against its plain version
   in float64 (error norm within 1e-5 of the output's) and twice
   bit-equal, at the benchmark cell's three CNN2 convs (100 clients x 50
   images, in the step's layouts), CNN1's 5x5 convs and VGG convs at
   256-512 channels; the cell's rows timed with their bound, the plain
   version and today's vmapped cuDNN call with its kernel count; one
   vmapped CNN2 step (launches by pass, no ATen convolution dispatched,
   no cuDNN kernel, bit-equal twice; the parent's ``F.conv2d`` step's
   kernels counted and both steps timed); the cell's program twice
   from one seed for 6 rounds, the global models bit-equal;
4. one engine step on the card against the same step on the CPU (the
   plain versions), for a FedDD round, a full FedDD round and FedAvg; and
   one with a round key, CommConfig(auto, 8) and random masks (densities,
   masks, wire overhead and int8-decoded uploads equal);
5. the FedDD path: the quickstart configuration (synthetic MNIST
   6000/1500, 10 clients, the paper's MLP, A_server=0.6, h=5, lr 0.1) for
   5 FedDD rounds and then 3 FedAvg rounds on cuda, with every kernel's
   launch count set to 0 just before and read just after: the three FedDD
   kernels launch (``sparse_agg`` in its mean mode only, ``masked_merge``
   once per partial FedDD round for all six leaves), flash attention
   does not; then this slice's path, the same configuration in
   CommConfig(auto, 8) for 5 FedDD rounds (wire bytes under the raw
   bytes from round 2, accuracy >= 0.85 after round 5), and once more
   with random masks (no importance launch), each with the counts set
   to 0 just before and read just after.  Then three more runs of the
   quickstart configuration, each with the counts set to 0 just before
   and read just after: the per-client reference loop (batched=False,
   track_epsilon=True, 5 FedDD rounds: importance at N = 1 for every
   client and leaf, 300 launches; sparse_agg 30, mean mode; masked_merge
   40, one per client and partial round for all six leaves; every
   epsilon finite and >= 0), held against an engine run at the same seed
   (equal rates, clock and participants, bytes within one float32 ulp of
   each client's density, masks that differ only at near-ties of the k-th
   score and, while they agree, equal parameters and accuracy); FedCS and
   Oort on the engine, 3 rounds each (fewer than 10 participants, the
   uploaded fraction within A_server, sparse_agg in mean mode and no
   importance or masked_merge launch); and the default-comm FedDD run
   with obs off and with a JSONL log under
   ``torch.cuda.set_sync_debug_mode("warn")`` (the same number of
   synchronising calls, equal records and parameters, the log loading
   back to the history), printing each phase's span median over rounds
   2-5 and the report's phase section.  Then the fused and scanned paths
   (``scan_phase``): the paper's MLP over 10 IID clients (600 samples
   each) with a vmapped one-epoch SGD trainer (``batched_train_fn``) and
   ``allocator="jax"``: 10 FedDD rounds per-round fused (K = 1) and
   scanned at K = 5 and K = 4, bit-equal, each launching importance 60,
   sparse_agg 60 and masked_merge 8 times, accuracy >= 0.85; FedAvg,
   FedCS and Oort, robust trimmed and clip (sparse_agg's partials mode)
   and CommConfig(auto, 8), scanned against per-round, bit-equal; no
   synchronising CUDA call inside ``BatchedRoundEngine.run`` for a K = 5
   chunk; and, printed only, host s per round of the three modes, the
   ``allocate`` span of each allocator, the device ops of one "jax"
   solve and the reference benchmark's 64-client fleet in rounds/s.
   Then the shape-grouped engine for ragged fleets (``grouped_phase``):
   the paper's §6.4 run (``python -m repro_torch.heterogeneous``: the
   five Table 3 VGG sub-models at full width, synthetic CIFAR-10,
   6 rounds) and a 20-client fleet cycling them (3 rounds), each on the
   grouped engine and the per-client loop, every client's scores and
   masks, the records and the parameters bit-equal, the launches as
   predicted (importance with the coverage division, sparse_agg
   elementwise at the rank-2+ leaves, masked_merge once a group and
   partial round); no synchronising call inside
   ``GroupedRoundEngine.step``; and, printed only, the reference
   benchmark's ragged 64-client MLP fleet in rounds/s, grouped against
   the loop.  Then the simulator (``sim_phase``) and the client-sharded
   mesh (``sharded_phase``): the quickstart on one shard (bit-equal to
   the engine) and on 4 virtual shards of the card (within 2e-6, dense
   and sparse collectives, launches per shard, no sync and no device
   copy inside a step), the reference's 256-client sharded fleet in
   rounds/s, hetero-a grouped on virtual shards (each step against the
   unsharded step), the simulator with ``mesh=1`` (bit-equal), the
   sparse collectives against a float64 oracle, and ``sparse_agg``'s
   ``select`` flag against its plain version, timed at fc0.  Then the
   quickstart's command line (``quickstart_cli_phase``,
   ``repro_torch.quickstart.main``): 3 rounds of the fault and outage
   flags with ``--robust-agg trimmed`` and ``--checkpoint-dir``, resumed to 5, bit-equal to an uninterrupted 5;
   and the 100,000-client population by cohorts of 256 for 3 rounds (host
   s per round, peak memory); each launching all three FedDD kernels;
6. the serving path: gemma3-27b at full width (d 5376, 32/16 heads,
   hd 128, d_ff 21504, vocab 262144) cut to 12 layers (two 5:1
   local:global periods), seeded random bf16 weights on cuda.  Two
   prefills of one 32768-token request (``lm.prefill``: every layer
   launches flash attention once, on the tensor-core route), 32 greedy
   decode steps at batch 4 with
   a 40-slot cache (no kernel launches), each with the counts set to 0
   just before and read just after; the kernel route of an 8192-token
   prefill against the plain-attention route; and decode from an empty
   cache over 64 prompt tokens against ``lm.forward`` at every position
   (asserted in fp32, reported in bf16);
6b. the serving path on a virtual (2, 2) (data, model) mesh of the card
   (``lm_mesh_phase``): the same gemma3 placed by ``lm.place_params``
   (each device's parameter bytes equal to ``local_shape``'s count), one
   prefill of 2 x 32768 tokens (flash once per layer and device, 48 on
   (1, 32768, 16/8, 128) blocks, sm90) and 32 decode steps at batch 4 on
   the same tokens as the unmeshed run, both within 3e-2 of its logits;
   qwen3-moe (4 layers) prefilled at 2 x 8192 on the expert-parallel
   path (``moe.dispatch_counts``) against the unmeshed dispatch in 2
   blocks: every expert flip a near-tie, rows whose last position kept
   its experts within 5e-2, two meshed runs bit-equal; times and peaks
   beside the unmeshed ones.  The flash kernel is also held against its
   plain version and timed at the mesh shard's shape in phase 3;
7. LM training: granite-3-8b at full width (d 4096, 32/8 heads, d_ff
   12800, vocab 49155) cut to 8 layers, AdamW (``launch.specs``'s
   policy), 8 microbatches, 8 x 2048 tokens a step: one warm-up and 3
   timed steps (s/step, tokens/s, the 6ND share of the bf16 peak, peak
   memory), a finite loss and no flash launch; one 2-layer step at 8192
   tokens, which takes the chunked attention route (no flash launch);
   the flash wrapper raising on inputs that require grad;
7b. LM training on the virtual (2, 2) mesh (``lm_mesh_train_phase``):
   phase 7's model, weights and tokens in 4 microbatches of 2 x 2048
   (each data row 1 x 2048), meshed (``lm.place_train_state``,
   ``make_train_step(mesh=)``) and unmeshed: the gathered gradients of
   one ``value_and_grad`` within 3e-2 of each leaf's largest, the first
   step's loss within 1e-2 and grad norm within 2e-2, each device's
   parameter and moment bytes equal to ``local_shape``'s count, every
   replica bit-equal after the step; one warm-up and 3 timed steps of
   each (s/step, tokens/s, peak memory); one AdamW step of qwen3-moe (4
   layers, 4 x 1024) on the expert-parallel path in every layer, its
   loss within 5e-2 of the unmeshed 2-block forward routed as the mesh
   routed; no flash launch;
8. FedDD across pods (``python -m repro_torch.launch.federated``): the
   same model cut to 4 layers on 4 virtual pods of the card, 2 local SGD
   steps on 8 x 256 tokens, the allocation LP, 3 rounds: s/round, the
   importance launches (one per rank-2+ leaf, pod and round, asserted)
   and the collective's bytes (``account_collective``); the importance
   kernel is also held against its plain version and timed at three of
   its bf16 leaves (``LM_IMPORTANCE``) beside the kernel checks;
9. the MoE family: qwen3-moe-30b-a3b at full width (d 2048, 128 experts
   top-8, d_ff 768, vocab 151936) cut to 4 layers: one 8192-token
   prefill (flash on every layer, sm90), 16 greedy decode steps at batch
   4 (no kernel), one AdamW step at 4 x 1024 tokens (no flash, a
   positive load-balance loss);
10. the remaining families (``families_phase``), each built, driven and
   freed before the next: jamba-1.5-large-398b at full width (d 8192,
   64/8 heads, NoPE, 16 experts top-2, Mamba d_state 16) cut to 4 layers
   (mamba, attn+moe, mamba, mamba+moe): one 8192-token prefill (flash
   once, sm90; the Mamba layers' share timed), 32 greedy decode steps at
   batch 4, bf16 decode against forward over 32 tokens within 5e-2 (no
   dispatch dropping a token; each row held up to its first near-tie
   expert flip); xlstm-1.3b (48 layers): a 2048-token prefill (no flash;
   the sLSTM layers' share and a sLSTM step's device ops), decode, decode
   against forward in bf16 (reported: at random init xLSTM amplifies a
   rounding difference ~7x every 8 layers) and in fp32 over one period (8
   layers) within 1e-3; pixtral-12b (40 layers): 256
   patch embeddings + 8192 tokens (flash 40, sm90), text-only decode;
   whisper-medium (24 + 24 layers): the encoder over 1500 frames, a
   448-token decoder prefill (no flash), decode over the cached encoder
   output, decode against forward within 3e-2.  The flash launches of
   the jamba and pixtral prefills are held against the plain version on
   their own inputs.  Every number of phases 7-10 is printed beside the
   card's name and power limit;
11. the launch tooling (``launch_phase``): (a) the dry-run
   (``python -m repro_torch.launch.dryrun``) traces decode_32k and
   long_500k of every arch and prefill_32k of all but xlstm and jamba on
   meta tensors and writes its records to ``results/dryrun_torch/``;
   (b) its cost counter runs phase 6's prefill and phase 7's train step
   once on meta and once on the card: equal flops and bytes op by op
   (differences printed, none on device ops with a cost), the flash
   cost the wrapper reports the same on meta and on the card (the same
   shapes reached the kernel) and its flops equal to the config's own
   count of unmasked pairs, the predicted peak
   within 10% of the card's ``max_memory_allocated`` rise, and the
   roofline bound of the count under the measured step time; (c) the
   pods' sync of granite-3-8b on (pod=2, data=16, model=16)
   (``launch.perf_federated``): one cell's local shards on 2 virtual
   pods, bytes per device by mode, the exchange's wall ms, importance
   launched once per rank-2+ leaf and pod in each compacted mode and
   every score held against its plain version; (d) one train step of
   jamba, pixtral, whisper and xlstm (512 tokens: two mLSTM chunks) at
   full width and batch 1, each at the deepest cut whose dry-run peak
   fits in 70 GiB (searched on meta in a worker process started before
   the build), with a finite loss, the predicted peak beside the
   measured one.

The line before the last is a JSON object with one entry per kernel (the
launches of its own path: the auto/8 FedDD run for the three FedDD
kernels, with the default-comm, random and loop runs' beside them
(``launches_loop``), the scanned K = 5 run's (``launches_scan``) and the
hetero-a run's on the grouped engine and the loop (``launches_grouped``,
``launches_grouped_loop``), the sharded quickstart's
(``launches_sharded`` on 4 virtual shards, ``launches_sharded_one``,
``launches_sharded_grouped``), and importance's N = 1 row under ``n1``,
``sparse_agg``'s elementwise mode under ``elementwise``, the prefill for
flash attention, with the mesh's and the MoE, jamba and pixtral
prefills', the
training steps' and the launch phase's counted prefill beside them, and
importance's federated-pods and whole-model-sync launches and its
LM-leaf rows under ``lm_leaves``; ``sparse_agg``'s times are its
mean mode's, named by its ``mode`` key, with the partials mode's and the
unfused Eq. (4)'s beside them; ``masked_merge``'s at fc0, with the
grouped launch of the six leaves (``mode: "grouped"``) and the six
single-leaf launches beside them; flash attention's times at the
prefill's shape, causal, named by its ``shape`` and ``window`` keys, and
the launches by route under ``dispatch``); the last line is ``{"ok":
true, "device": {...}}``.
``--out`` also writes every measurement as JSON.  Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MLP_N = 10
MLP_LEAVES = [(784, 100), (100,), (100, 64), (64,), (64, 10), (10,)]
RAGGED = [(7, (257, 513)), (3, (3, 3)), (5, (1000, 7)), (2, (33,))]
# the full-width VGG conv of the Table 3 fleet, and CNN2's first fc
LARGE = [(16, (3, 3, 512, 512)), (16, (1024, 500))]
# the grouped engine's Eq. (4) canvas of the five hetero-a clients at the
# widest conv (sparse_agg's elementwise-mask mode; its `kernels` row)
VGG_CANVAS = (5, (3, 3, 512, 512))
MAIN_SHAPE = (MLP_N, (784, 100))     # fc0.w, the main path's largest leaf
LOOP_IMPORTANCE_SHAPE = (1, (784, 100))   # fc0.w of one client (the loop)
# one bf16 client leaf past 2**31 elements: the merge takes it in several
# descriptors (ops.split_leaf); the plain version checks it in row chunks
BIG_MERGE = (32769, 65536)
BIG_MERGE_ROWS = 2048
COMM = dict(codec="auto", qbits=8)   # the slice's wire format
COMM_ROUNDS = 5
COMM_MIN_ACC = 0.85     # after round 5; the port's CPU run reaches 0.917
A_SERVER = 0.6          # the quickstart's budget
LOOP_ROUNDS = 5         # the per-client loop phase (4 partial rounds at h=5)
BASELINE_ROUNDS = 3     # FedCS and Oort on the engine
OBS_ROUNDS = 5          # the obs phase: span medians over rounds 2-5
OBS_PHASES = ("local_train", "engine_step", "host_transfer", "allocate",
              "eval")
SCAN_ROUNDS = 10        # the scan phase: FedDD rounds of (a), (e), (f)
SCAN_BASELINE_ROUNDS = 6
SCAN_VARIANT_ROUNDS = 5
SCAN_MIN_ACC = 0.85     # after 10 IID rounds
SCAN_STEPS, SCAN_BATCH, SCAN_LR = 9, 64, 0.1   # one epoch of a 600 shard
HETERO_ROUNDS = 6       # the grouped phase's (a): the example's 6 rounds
HETERO_FLEET = 20       # (b): clients cycling the five hetero-a specs
HETERO_FLEET_ROUNDS = 3
HETERO_PERF_CLIENTS = 64       # (c): benchmarks/heterogeneous.py's fleet
HETERO_PERF_WIDTHS = (128, 96, 64)
HETERO_PERF_ROUNDS = 5
FLEET_SPEC = [("fc", 64, 128), ("fc", 128, 64), ("fc", 64, 10)]
FLEET_CLIENTS, FLEET_SHARD, FLEET_K, FLEET_ROUNDS = 64, 32, 8, 16
SIM_FC0 = (16, (784, 100))  # the sim rows of the kernel checks: fc0 at
                            # the fault grid's 16 clients
SIM_ROUNDS = 10             # sim phase (a): the straggler demo's rounds
SIM_CLIENTS = 8
SIM_POLICIES = ("sync", "deadline", "async")
SIM_ORDER = ("deadline", "async", "sync")   # final sim_time, ascending:
                                            # the CPU's order at SIM_ROUNDS
# launches of each policy's run: a FedDD step per round (async: per merge
# of 2 clients, SIM_ROUNDS * 4 merges), masked_merge on the partial ones
SIM_LAUNCHES = {
    "sync": dict(importance=60, sparse_agg=60, masked_merge=8,
                 merges={6: 8}),
    "deadline": dict(importance=60, sparse_agg=60, masked_merge=8,
                     merges={6: 8}),
    "async": dict(importance=240, sparse_agg=240, masked_merge=32,
                  merges={6: 32})}
SIM_SPANS = ("local_train", "engine_step", "allocate")
FAULT_CLIENTS = 16          # (c) the fault-tolerance grid at rate 0.35
FAULT_ROUNDS = 6
FAULT_KW = dict(crash_rate=0.175, loss_rate=0.35, corrupt_rate=0.0875,
                corrupt_kind="mix", quorum=0.25, seed=0)
POP_SIZE = 100_000          # (d) the population throughput demo
POP_COHORT = 256
POP_ROUNDS = 4
POP_SHARDS = 16
POP_STORE_BYTES = 1 << 30   # the sticky store's bound
RESUME_ROUNDS = 6           # (e) crash-resume: snapshots every 2 rounds,
RESUME_EVERY = 2            # SIGKILL in round 5
RESUME_KILL = 5
SHARD_ROUNDS = 5            # sharded phase (a): the quickstart's rounds
SHARD_VIRTUAL = 4           # virtual shards of the multi-shard mesh
SHARD_TOL = 2e-6            # rtol = atol against the unsharded run
SHARD_DROP = 0.75           # (a) the keep-0.8 step's uniform dropout
SHARD_KEEP = 0.8
SHARD_FLEET = 256           # (b) benchmarks/perf_federated.py sharded_ab
SHARD_FLEET_SAMPLES = 8
SHARD_FLEET_ROUNDS, SHARD_FLEET_WARM = 6, 2
SHARD_HETERO_ROUNDS, SHARD_HETERO_SHARDS = 2, 2     # (c)
SHARD_SIM_ROUNDS = 3        # (d)
CLI_FAULTS = ["--fault-rate", "0.2", "--cells", "3", "--robust-agg",
              "trimmed"]           # quickstart_cli (a)
CLI_CRASH_ROUNDS = 3               # (a): checkpointed, then resumed to
CLI_ROUNDS = 5                     # CLI_ROUNDS against an uninterrupted run
CLI_POPULATION = ["--clients", "32", "--population", "100000", "--cohort",
                  "256", "--availability", "bernoulli"]   # (b)
CLI_POP_ROUNDS = 3
_SHARD_LEAVES = len(MLP_LEAVES)
_SHARD_BIASES = sum(len(s) == 1 for s in MLP_LEAVES)


def _shard_launches(shards: int, mode: str) -> dict:
    """The FedDD kernels' launches over SHARD_ROUNDS quickstart rounds
    (h = 5: rounds 1-4 partial) on ``shards`` shards: importance and
    sparse_agg once a shard and leaf a round (the engine: its mean mode,
    a shard: the partials mode), masked_merge once a shard and partial
    round for all six leaves, sparse_agg's select flag at the 1-D
    leaves."""
    per = shards * _SHARD_LEAVES * SHARD_ROUNDS
    partial = shards * (SHARD_ROUNDS - 1)
    routes = {"partials": 0, "mean": 0, "partials:elementwise": 0,
              "mean:elementwise": 0}
    routes[mode] = per
    return dict(launches=dict(importance=per, sparse_agg=per,
                              masked_merge=partial, flash_attention=0, conv=0),
                sparse_agg=routes, merges={_SHARD_LEAVES: partial},
                select=shards * _SHARD_BIASES * SHARD_ROUNDS)


SHARD_LAUNCHES = {"engine": _shard_launches(1, "mean"),
                  "one": _shard_launches(1, "partials"),
                  "four": _shard_launches(SHARD_VIRTUAL, "partials"),
                  "four_sparse": _shard_launches(SHARD_VIRTUAL, "partials")}
# (c) hetero-a: 5 groups of one, each padded to a row a shard; 16 leaves
# (8 of them 1-D), 2 partial rounds
_HET = 5 * SHARD_HETERO_SHARDS * SHARD_HETERO_ROUNDS
SHARD_HETERO_LAUNCHES = dict(
    launches=dict(importance=16 * _HET, sparse_agg=16 * _HET,
                  masked_merge=_HET, flash_attention=0, conv=0),
    sparse_agg={"partials": 16 * _HET, "mean": 0,
                "partials:elementwise": 0, "mean:elementwise": 0},
    select=8 * _HET)
SCAN_SPANS = ("local_train", "engine_step", "host_transfer", "allocate",
              "chunk_dispatch")
TIE_RTOL = 5e-5         # importance's rtol: closer to the k-th score is a tie
SLEEP_CYCLES = 40_000_000            # ~20 ms of device time ahead of a burst
TIMED_LAUNCHES = 30

KERNEL_INFO = {
    "importance": dict(
        source="src/repro_torch/csrc/importance.cu",
        replaces="src/repro/kernels/importance/importance.py:56"),
    "sparse_agg": dict(
        source="src/repro_torch/csrc/sparse_agg.cu",
        replaces="src/repro/kernels/sparse_agg/sparse_agg.py:40"),
    "masked_merge": dict(
        source="src/repro_torch/csrc/masked_merge.cu",
        replaces="src/repro/kernels/masked_merge/masked_merge.py:31"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:87"),
    "conv": dict(
        source="src/repro_torch/csrc/conv.cu",
        replaces="none: the JAX package leaves its convolutions to XLA"),
}
FEDDD_KERNELS = ("importance", "sparse_agg", "masked_merge")
# the mean mode against its plain version, by (values, output) dtype: the
# partials' tolerances, and one bf16 ulp (2**-7) for a bf16 output, which
# an fp32 quotient an ulp away from the plain one can round to
MEAN_RTOL = {("float32", "float32"): 3e-5, ("bfloat16", "float32"): 5e-3,
             ("bfloat16", "bfloat16"): 2.0 ** -7}

# flash attention: the CPU tests' sweep (B, S, H, Hkv, hd), odd lengths and
# the head dims of the LM configs, each in causal / window / bidirectional
FLASH_SWEEP = [(2, 64, 4, 2, 32), (1, 100, 8, 8, 16), (2, 96, 4, 1, 32),
               (1, 130, 4, 2, 48), (2, 333, 8, 2, 64), (1, 517, 4, 1, 128),
               (1, 200, 2, 2, 256), (3, 77, 6, 3, 96), (1, 333, 8, 2, 192)]
FLASH_MODES = [(True, 0), (True, 24), (False, 0)]
SLICE_FLASH = (1, 8192, 32, 16, 128)      # the serving path's heads, S=8192
SLICE_WINDOWS = (0, 1024)                 # global and local gemma3 layers
PREFILL_SEQ = 32768                       # prefill_32k's sequence
PLAIN_ROWS = 1024                         # query rows per plain-version chunk
ROW_TOL = 1 / 64                          # bf16: per row, of its max |want|
LONG_TIMED = 5                            # event pairs for the long calls

SERVE_ARCH = "gemma3_27b"
SERVE_LAYERS = 12                         # two 5:1 periods: n_super = 2
PREFILL_CALLS = 2
DECODE_BATCH, DECODE_CACHE, DECODE_STEPS = 4, 40, 32
ROUTE_SEQ = 8192                          # kernel vs plain-attention route
CONSIST_BATCH, CONSIST_T = 2, 64
CONSIST_TOL_FP32 = 1e-4                   # of the largest |logit|
ROUTE_TOL = 5e-2                          # bf16, of the largest |logit|

# phase 6b, the serving path on a virtual (data, model) mesh of the card:
# gemma3 as in phase 6 at batch 2 (the data axis splits it: flash runs on
# each shard's (1, 32768, 16/8, 128) block) and qwen3-moe (4 layers) at
# batch 2 x MOE_PREFILL_SEQ, which takes the expert-parallel path
MESH_SHAPE = (2, 2)
MESH_PREFILL_BATCH = 2
MESH_TOL = 3e-2                           # bf16, of the largest |logit|
MESH_MOE_BATCH, MESH_MOE_TOL = 2, 5e-2
MESH_FLASH = (1, 32768, 16, 8, 128)       # one model shard's heads
MESH_MOE_FLASH = (1, 8192, 16, 2, 128)    # qwen3-moe's, qk-normed
# an expert the meshed MoE picked where the unmeshed run, given the same
# routing in every layer, would not: at most this far below the unmeshed
# k-th router logit, in units of that token's router-logit std over its
# E experts.  A router input rounded differently by a relative r moves
# each logit by ~r std; r is ~1% after two bf16 layers of the reduced
# config on the CPU, a real routing fault moves an expert by ~1 std
MESH_TIE_STD = 0.25

TRAIN_ARCH = "granite_3_8b"               # train and federated phases
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 2048          # 8 microbatches (policy_for)
TRAIN_STEPS = 3                           # timed, after one warm-up step
LONG_LAYERS, LONG_SEQ = 2, 8192           # one step on the chunked route
# phase 7b, training on the virtual MESH_SHAPE mesh: phase 7's model and
# tokens in MESH_TRAIN_MICRO microbatches of 2 x 2048 (each data row 1 x
# 2048), against the unmeshed step at the same split; qwen3-moe one step
MESH_TRAIN_MICRO = 4
MESH_LOSS_TOL, MESH_GNORM_TOL = 1e-2, 2e-2    # bf16, relative
FED_LAYERS, FED_PODS, FED_ROUNDS = 4, 4, 3
FED_LOCAL_STEPS, FED_BATCH, FED_SEQ = 2, 8, 256
MOE_ARCH, MOE_LAYERS = "qwen3_moe_30b_a3b", 4
MOE_PREFILL_SEQ = 8192
MOE_DECODE_BATCH, MOE_DECODE_STEPS = 4, 16
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 1024
# importance at every distinct rank-2+ leaf shape of the federated phase
# (granite-3-8b, 4 layers stacked): bf16 weights, among them wq (C = 128)
# and the tied embedding, and the fp32 stacked norm scales (fan-in 4)
LM_IMPORTANCE = [("wq", (FED_LAYERS, 4096, 32, 128), "bfloat16"),
                 ("wk/wv", (FED_LAYERS, 4096, 8, 128), "bfloat16"),
                 ("wo", (FED_LAYERS, 32, 128, 4096), "bfloat16"),
                 ("embed", (49155, 4096), "bfloat16"),
                 ("w_up/w_gate", (FED_LAYERS, 4096, 12800), "bfloat16"),
                 ("w_down", (FED_LAYERS, 12800, 4096), "bfloat16"),
                 ("norms", (FED_LAYERS, 4096), "float32")]
IMP_RTOL, IMP_ATOL = 5e-5, 1e-5           # importance against its plain one
MOE_FLASH = (1, MOE_PREFILL_SEQ, 32, 4, 128)   # qwen3-moe's prefill heads
# the families phase: jamba (full width, 4 layers), xlstm-1.3b, pixtral-12b
# and whisper-medium (full configs), each prefilled, then decoded at batch 4
JAMBA_ARCH, JAMBA_LAYERS, JAMBA_PREFILL = "jamba_1p5_large_398b", 4, 8192
XLSTM_ARCH, XLSTM_PREFILL = "xlstm_1p3b", 2048      # its training context
PIXTRAL_ARCH, PIXTRAL_TEXT = "pixtral_12b", 8192    # after 256 patches
WHISPER_ARCH, WHISPER_DEC = "whisper_medium", 448   # frames: encoder_seq_cap
FAMILY_DECODE_BATCH, FAMILY_DECODE_STEPS = 4, 32
FAMILY_CONSIST_BATCH, FAMILY_CONSIST_T = 2, 32      # decode = forward, bf16
FAMILY_TOL = {JAMBA_ARCH: 5e-2, WHISPER_ARCH: 3e-2}
# xLSTM at random init amplifies a rounding difference ~7x every 8 layers
# (the JAX package's own fp32 decode vs forward at full width: 1.5e-4 at
# 8 layers, 1.1e-3 at 16), so its decode = forward is asserted in fp32 over
# one period (7 mLSTM + 1 sLSTM) and only reported at 48 layers in bf16
XLSTM_CONSIST_LAYERS, XLSTM_FP32_TOL = 8, 1e-3
NEAR_TIE = 0.02          # router probability gap where bf16 may flip experts
SLSTM_PROFILE_SEQ = 256  # one sLSTM layer profiled at this length
# the flash kernel at the prefill shapes of jamba (NoPE, 8 query heads a kv
# head) and pixtral (8448 = 256 patches + 8192 tokens, not a power of two)
JAMBA_FLASH = (1, JAMBA_PREFILL, 64, 8, 128)
PIXTRAL_FLASH = (1, 256 + PIXTRAL_TEXT, 32, 8, 128)
# the launch phase: (a) the dry-run pairs traced on meta: decode_32k and
# long_500k of every arch, and prefill_32k of every arch but these two,
# whose traces step a Python loop per position (xLSTM's sLSTM) or per
# chunk (Mamba) over 32768 tokens; those, and every train_4k pair, take
# minutes to trace (``python -m repro_torch.launch.dryrun`` sweeps them)
LAUNCH_DECODE_SHAPES = ("decode_32k", "long_500k")
LAUNCH_PREFILL_SKIP = (XLSTM_ARCH, JAMBA_ARCH)
PEAK_TOL = 0.10          # (b): predicted peak against the card's, relative
# (d): one train step of each family at batch 1: (tokens, patch
# embeddings, encoder frames), xLSTM last; xLSTM's 512 tokens run two
# mLSTM chunks of 256 (the cross-chunk recurrence) and are cut from its
# 2048 context because its sLSTM layers step a Python loop per position,
# on the card and in the meta trace of the depth search
FAMILY_TRAIN = {JAMBA_ARCH: (2048, 0, 0), PIXTRAL_ARCH: (1024, 256, 0),
                WHISPER_ARCH: (448, 0, 1500), XLSTM_ARCH: (512, 0, 0)}
FAMILY_SEARCH_TIMEOUT = 900      # s: (d) waits this long for a depth
FAMILY_TRAIN_LIMIT = 70 * 2 ** 30   # the dry-run's one-card peak, bytes
# phase 10b, the four families on the virtual MESH_SHAPE mesh against the
# unmeshed path on the same weights and inputs (``lm.place_params``): jamba
# cut to its first MESH_JAMBA_LAYERS layers (Mamba + dense, attention +
# MoE: 11.9 B parameters), xlstm over one period in fp32 (bf16 drifts with
# depth), pixtral MESH_PIXTRAL_LAYERS layers, whisper whole; a prefill at
# batch MESH_FAMILY_BATCH, FAMILY_DECODE_STEPS teacher-forced decode steps
# at FAMILY_DECODE_BATCH, and one AdamW step at MESH_FAMILY_BATCH x
# MESH_FAMILY_TRAIN's tokens at MESH_FAMILY_TRAIN_LAYERS layers (0: all;
# AdamW's moments of jamba's 11.9 B parameters alone would take 95 GB).
# Jamba trains 2 x 1024 tokens, the tokens of FAMILY_TRAIN's 1 x 2048: a
# Mamba layer keeps its out-of-place scan passes for the backward, and at
# 2 x 2048 they overflowed the card (77.8 GB allocated)
MESH_FAMILY_BATCH = 2
MESH_JAMBA_LAYERS, MESH_PIXTRAL_LAYERS = 2, 12
MESH_FAMILY_TOL = {JAMBA_ARCH: FAMILY_TOL[JAMBA_ARCH],
                   XLSTM_ARCH: XLSTM_FP32_TOL, PIXTRAL_ARCH: MESH_TOL,
                   WHISPER_ARCH: FAMILY_TOL[WHISPER_ARCH]}
MESH_FAMILY_TRAIN_LAYERS = {JAMBA_ARCH: 1, XLSTM_ARCH: XLSTM_CONSIST_LAYERS,
                            PIXTRAL_ARCH: 8, WHISPER_ARCH: 0}
MESH_FAMILY_TRAIN = dict(FAMILY_TRAIN, **{JAMBA_ARCH: (1024, 0, 0)})
# the train half's backward: each leaf of one value_and_grad's gathered
# gradients within MESH_GRAD_TOL of the unmeshed leaf in L2 norm, the first
# step's grad norm within MESH_GNORM_TOL.  In bf16 the meshed and the
# unmeshed gradients are each ~1.5e-2 from the fp32 ones and apart by as
# much (tests/test_torch_lm_mesh_families.py
# ::test_meshed_bf16_gradients_as_close_to_fp32_as_unmeshed), ~2.8e-2 for
# pixtral's 8 full-width layers; a missing sum or a misplaced transpose
# moves a whole leaf, O(1)
MESH_GRAD_TOL = 5e-2
# the flash kernel on one model shard's heads of those prefills
JAMBA_MESH_FLASH = (1, JAMBA_PREFILL, 32, 4, 128)
PIXTRAL_MESH_FLASH = (1, 256 + PIXTRAL_TEXT, 16, 4, 128)


# ---- the PRNG phase: known answers the card's threefry must reproduce.
# Random123's threefry2x32-20 vectors ((key), (counter), (output)); the
# rest is PRNG_RECIPE's output under jax.random (tests/test_torch_prng.py
# recomputes it with jax and holds these constants to it).
THREEFRY_KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0))]
PRNG_SEEDS = (0, 1, 2 ** 31 - 1, 2 ** 32 - 1)
PRNG_FOLDS = (0, 7, 10_003, 20_009)
NORMAL_ULPS = 8          # normal: XLA's log1p and multiply-adds vs torch's
# float32 bits of jax.random.normal(PRNGKey(0), (16,))
NORMAL_BITS = (1070576317, 1073847792, -1092747241, -1113521630, 1043616044,
               -1082598697, -1090676788, 1056775985, 1059721932, -1082966550,
               1074494829, -1074118048, 1052219029, 1042388236, 1067677571,
               1069635305)
PRNG_VECTORS = {'seed0': {'key': [0, 0],
                          'split2': [1797259609, 2579123966, 928981903, 3453687069],
                          'split3': [1797259609, 2579123966, 928981903, 3453687069,
                                     4146024105, 2718843009],
                          'fold': [[1797259609, 2579123966], [2716826189, 292468403],
                                   [1412222969, 2821336035], [3891080679, 1795844587]],
                          'bits': [4070199207, 4202968722, 1427181096, 2012915765,
                                   2447653815, 710830403, 1332275837, 2961296638,
                                   3207338339, 734502358, 4232062733, 108588429,
                                   2748958889, 2416739154, 3862094091],
                          'uniform': [1064475214, 1064993846, 1051337244, 1055913296,
                                      1058137146, 1042905504, 1050595796],
                          'perm': [[0], [0, 1], [0, 1, 4, 3, 2],
                                   [0, 1, 19, 31, 8, 12, 16, 5, 24, 6, 20, 18, 4, 13, 30,
                                    25, 28, 14, 3, 21, 32, 10, 17, 29, 2, 7, 15, 26, 23,
                                    11, 22, 27, 9]]},
                'seed1': {'key': [0, 1],
                          'split2': [507451445, 1853169794, 1948878966, 4237131848],
                          'split3': [507451445, 1853169794, 1948878966, 4237131848,
                                     2441914641, 3819641963],
                          'fold': [[507451445, 1853169794], [954670714, 4016809582],
                                   [2261852804, 1758459451], [242816504, 2441224810]],
                          'bits': [1883912375, 2292451390, 1915204986, 1882898417,
                                   3854144420, 2400655036, 4225756532, 3616323604,
                                   1656910982, 2748596072, 1028623903, 1730928758,
                                   3487851715, 3367688912, 3491717864],
                          'uniform': [1054905456, 1057530888, 1055149928, 1054897532,
                                      1063631250, 1057953558, 1065082860],
                          'perm': [[0], [0, 1], [3, 2, 0, 1, 4],
                                   [19, 30, 7, 6, 23, 16, 21, 3, 26, 32, 2, 20, 0, 8, 22,
                                    13, 29, 18, 24, 1, 5, 27, 10, 15, 17, 28, 9, 4, 12,
                                    14, 31, 25, 11]]},
                'seed2147483647': {'key': [0, 2147483647],
                                   'split2': [3894554595, 3657610310, 2391852627,
                                              3342111533],
                                   'split3': [3894554595, 3657610310, 2391852627,
                                              3342111533, 1746298583, 1015193934],
                                   'fold': [[3894554595, 3657610310],
                                            [2576940018, 2245239479],
                                            [2045989122, 164528802],
                                            [871037108, 2733670316]],
                                   'bits': [840997797, 1235506558, 1419036569, 1650994062,
                                            3053628459, 3320296850, 38724216, 474700101,
                                            3745550650, 3820039427, 664327823, 2424924220,
                                            3649996120, 1406378204, 853885788],
                                   'uniform': [1044939368, 1049839784, 1051273612,
                                               1053085780, 1060504236, 1061545908,
                                               1007925376],
                                   'perm': [[0], [1, 0], [4, 2, 3, 1, 0],
                                            [29, 4, 6, 11, 14, 21, 15, 26, 20, 18, 22, 28,
                                             17, 32, 30, 16, 9, 7, 2, 5, 23, 19, 3, 27, 1,
                                             0, 13, 31, 12, 10, 25, 24, 8]]},
                'seed4294967295': {'key': [0, 4294967295],
                                   'split2': [2973345818, 897673333, 3461607691,
                                              1112781462],
                                   'split3': [2973345818, 897673333, 3461607691,
                                              1112781462, 3122495753, 3444035234],
                                   'fold': [[2973345818, 897673333],
                                            [614485078, 1000807227],
                                            [3737653371, 337070578],
                                            [1286265749, 3436378525]],
                                   'bits': [2226700399, 2348827549, 2002407339,
                                            3973470413, 1347664280, 1591134625, 119674969,
                                            520574829, 827288690, 1669566182, 2875948738,
                                            2474516107, 4144159968, 4147057620,
                                            371840038],
                                   'uniform': [1057274048, 1057751106, 1055831196,
                                               1064097368, 1050716016, 1052618128,
                                               1021592320],
                                   'perm': [[0], [0, 1], [2, 0, 1, 4, 3],
                                            [20, 8, 12, 5, 15, 2, 30, 9, 11, 10, 14, 0,
                                             19, 29, 16, 24, 32, 31, 1, 21, 17, 22, 7, 23,
                                             13, 27, 4, 6, 28, 26, 3, 18, 25]]},
                'quickstart': {'round_key': [928981903, 3453687069],
                               'qkeys': [1477084122, 63226778, 1635551788, 1058746241,
                                         1558139299, 10459743, 1984345098, 622127814,
                                         2802637759, 238957769, 2943490008, 2035243433,
                                         2749201110, 1719685005, 3328108551, 2587502283,
                                         2499374099, 3235229803, 3548863884, 764595689],
                               'uniform_10x784x100': [825354843404338,
                                                      9942888416281150682, 1046248784,
                                                      1056754104, 983458816, 1057904700,
                                                      1017332352, 1012666368, 1051795848,
                                                      1057387272],
                               'scores_10x100': [1052958494066, 527043617627824],
                               'perm_600': [179700, 53802459, 492, 285, 97, 136, 329, 434,
                                            215, 396],
                               'perm_10000': [49995000, 251170514090, 5553, 6802, 4799,
                                              1475, 3976, 5410, 5782, 6247]}}


def digest(values) -> list:
    """[sum, index-weighted sum] of 32-bit words (uint64 wrap-around):
    an exact fingerprint of a large draw, order included."""
    import numpy as np
    v = np.asarray(values).reshape(-1).astype(np.uint64)
    w = np.arange(1, v.size + 1, dtype=np.uint64)
    return [int(np.sum(v, dtype=np.uint64)),
            int(np.sum(v * w, dtype=np.uint64))]


def prng_recipe(api) -> dict:
    """Keys, bits, uniforms and permutations at a few keys and at the
    quickstart's shapes, through ``api`` (key, split, fold_in, bits,
    uniform, permutation; stacked keys (K, 2) draw (K, *shape)), as
    JSON-able ints: keys whole, large draws by :func:`digest` (float32
    uniforms by their bits) and their first and last values."""
    import numpy as np

    def words(x):
        return [int(v) for v in np.asarray(x).reshape(-1)]

    def fbits(u):
        return np.asarray(u, np.float32).view(np.uint32)

    out = {}
    for s in PRNG_SEEDS:
        k = api.key(s)
        out[f"seed{s}"] = dict(
            key=words(k), split2=words(api.split(k, 2)),
            split3=words(api.split(k, 3)),
            fold=[words(api.fold_in(k, d)) for d in PRNG_FOLDS],
            bits=words(api.bits(k[None], (3, 5))),
            uniform=words(fbits(api.uniform(k[None], (7,)))),
            perm=[words(api.permutation(k, n)) for n in (1, 2, 5, 33)])
    rk = api.split(api.key(0), 2)[1]
    ids = np.arange(10)
    # the quickstart's round 1: int8 noise of fc0.w (leaf 1 in flatten
    # order) for its 10 clients, 'random' scores of fc0.w, client 3's
    # epoch-0 shuffle of 600 samples, and a 10**4 shuffle (two rounds)
    qkeys = api.fold_in(api.fold_in(rk, 20_000 + ids), 1)
    u = fbits(api.uniform(qkeys, (784, 100)))
    mkeys = api.fold_in(api.fold_in(rk, 10_000 + ids), 1)
    scores = fbits(api.uniform(mkeys, (100,)))
    perm = api.permutation(api.fold_in(api.fold_in(rk, 3), 0), 600)
    big = api.permutation(rk, 10_000)
    out["quickstart"] = dict(
        round_key=words(rk), qkeys=words(qkeys),
        uniform_10x784x100=digest(u) + words(u.reshape(-1)[:4])
        + words(u.reshape(-1)[-4:]),
        scores_10x100=digest(scores),
        perm_600=digest(perm) + words(perm[:8]),
        perm_10000=digest(big) + words(big[:8]))
    return out


class PortPRNG:
    """:func:`prng_recipe`'s api over ``repro_torch.prng``: keys on the
    host, bulk draws on ``dev``, results back as numpy."""

    def __init__(self, dev):
        self.dev = dev

    def key(self, seed):
        from repro_torch import prng
        return prng.PRNGKey(seed)

    def split(self, key, num):
        from repro_torch import prng
        return prng.split(key, num)

    def fold_in(self, key, data):
        from repro_torch import prng
        return prng.fold_in(key, data)

    def bits(self, keys, shape):
        from repro_torch import prng
        return prng.random_bits(keys, shape, self.dev).cpu().numpy()

    def uniform(self, keys, shape):
        from repro_torch import prng
        return prng.uniform(keys, shape, self.dev).cpu().numpy()

    def permutation(self, key, n):
        from repro_torch import prng
        return prng.permutation(key, n, self.dev).cpu().numpy()


def prng_phase(dev="cuda") -> dict:
    """The PRNG phase: Random123's vectors through the hash on ``dev``,
    then :func:`prng_recipe` through the port with its bulk draws on
    ``dev``, equal to the constants; ``normal`` within NORMAL_ULPS of
    jax's (its first values under PRNGKey(0), also constants)."""
    import numpy as np
    import torch
    from repro_torch import prng

    for key, ctr, want in THREEFRY_KAT:
        got = prng.threefry2x32(np.asarray(key, np.uint32), ctr[0], ctr[1],
                                device=dev)
        got = tuple(int(t.item()) for t in got)
        if got != want:
            raise AssertionError(f"threefry2x32{key, ctr} on {dev}: "
                                 f"{got} != {want}")
    t0 = time.perf_counter()
    got = prng_recipe(PortPRNG(dev))
    secs = time.perf_counter() - t0
    for name, want in PRNG_VECTORS.items():
        if got[name] != want:
            bad = [k for k in want if got[name][k] != want[k]]
            raise AssertionError(f"PRNG vectors {name} {bad} differ on "
                                 f"{dev}")
    normal = prng.normal(prng.PRNGKey(0), (len(NORMAL_BITS),), dev)
    bits = normal.cpu().numpy().view(np.int32).astype(np.int64)
    ulps = int(np.abs(bits - np.asarray(NORMAL_BITS, np.int64)).max())
    if ulps > NORMAL_ULPS:
        raise AssertionError(f"normal on {dev} is {ulps} ulps from jax's")
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    print(f"  PRNG on {dev}: {len(THREEFRY_KAT)} Random123 vectors, "
          f"{len(PRNG_VECTORS)} recipe groups equal to jax.random (keys, "
          f"split, fold_in, bits, uniform (10, 784, 100), permutations of "
          f"600 and 10**4) in {secs:.2f} s; normal within {ulps} ulps",
          flush=True)
    return dict(kat=len(THREEFRY_KAT), groups=len(PRNG_VECTORS),
                recipe_s=secs, normal_max_ulps=ulps)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


class Card:
    """Peak rates of the card, from NVIDIA's data sheets (dense)."""

    def __init__(self, name: str):
        self.line = name            # nvidia-smi's name and power limit
        pcie = "PCIe" in name
        self.bytes_per_s = 2.0e12 if pcie else 3.35e12
        self.fp32_flops = 51e12 if pcie else 67e12
        self.bf16_flops = 756e12 if pcie else 989e12   # tensor cores

    def bound(self, nbytes: float, flops: float, peak: float = None):
        t_bytes = nbytes / self.bytes_per_s * 1e3
        t_ops = flops / (peak or self.fp32_flops) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def time_ms(fn, flush, reps: int = TIMED_LAUNCHES) -> float:
    """Median device time of ``fn`` over ``reps`` event pairs.

    A sleep kernel keeps the card busy while the host queues the burst,
    so each pair brackets device work and not the host's launch overhead;
    an L2-sized memset before each launch makes the inputs cold."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_checks(card: Card, flush, records: list, dev="cuda",
                  timer=time_ms) -> dict:
    """Phase 3: every kernel against its plain version; returns per-kernel
    max_abs_err and the timings at the main path's shape."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.importance import ops as imp_ops
    from repro_torch.kernels.importance.ref import channel_importance_ref
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.masked_merge.ref import masked_merge_ref
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.kernels.sparse_agg.ref import (finish_masked_mean,
                                                    masked_weighted_mean_ref,
                                                    masked_weighted_sum_ref)

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {k: 0.0 for k in KERNEL_INFO}
    main = {}
    shapes = ([(MLP_N, leaf) for leaf in MLP_LEAVES] + RAGGED + LARGE)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        for n, leaf in shapes:
            a, c, b = _lib.split_at(leaf, len(leaf) - 1)
            r = a * b
            elems = n * r * c
            is_main = (n, leaf) == MAIN_SHAPE and dtype == torch.float32

            # ---- importance (Eq. (20)/(21))
            wo = randn(n, *leaf).to(dtype)
            wn = (wo.float() + 0.1 * randn(n, *leaf)).to(dtype)
            for cov in (None, torch.rand((c,), generator=gen, device=dev)
                        + 0.5):
                got = imp_ops.channel_importance_batched(wo, wn,
                                                         coverage=cov)
                want = channel_importance_ref(wo.view(n, a, c, b),
                                              wn.view(n, a, c, b), cov)
                torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-5)
                max_err["importance"] = max(
                    max_err["importance"], (got - want).abs().max().item())
            kern = lambda: imp_ops.channel_importance_batched(wo, wn)  # noqa
            plain = lambda: channel_importance_ref(                     # noqa
                wo.view(n, a, c, b), wn.view(n, a, c, b))
            rec = _timed(card, flush, timer, "importance", n, leaf, dtype,
                         kern,
                         plain, None, 2 * elems * es + n * c * 4, 5 * elems)
            records.append(rec)
            if is_main:
                main["importance"] = rec

            # ---- sparse_agg (Eq. (4) partials), channel and dense masks
            vals = randn(n, *leaf).to(dtype)
            wts = torch.rand((n,), generator=gen, device=dev) + 0.5
            mshape = (n,) + (1,) * (len(leaf) - 1) + (c,)
            chan = (torch.rand(mshape, generator=gen, device=dev)
                    > 0.5).to(dtype)
            dense = torch.ones((n,) + (1,) * len(leaf), dtype=dtype,
                               device=dev)
            for mask, mc in ((chan, c), (dense, 1)):
                num, den = agg_ops.masked_weighted_sum(vals, mask, wts)
                wnum, wden = masked_weighted_sum_ref(
                    vals.view(n, a, c, b), mask.view(n, mc), wts)
                torch.testing.assert_close(
                    num, wnum.view(leaf),
                    rtol=5e-3 if dtype == torch.bfloat16 else 3e-5,
                    atol=1e-4)
                torch.testing.assert_close(den, wden.view(leaf), rtol=3e-5,
                                           atol=1e-5)
                max_err["sparse_agg"] = max(
                    max_err["sparse_agg"],
                    (num - wnum.view(leaf)).abs().max().item(),
                    (den - wden.view(leaf)).abs().max().item())
            v3 = vals.view(n, a, c)          # channels last: b == 1
            m2 = chan.view(n, c)
            kern = lambda: agg_ops.masked_weighted_sum(vals, chan, wts)  # noqa
            plain = lambda: masked_weighted_sum_ref(                     # noqa
                vals.view(n, a, c, b), m2, wts)
            lib = lambda: torch.einsum(                                  # noqa
                "n,nrc,nc->rc", wts.to(dtype), v3, m2)
            rec = _timed(card, flush, timer, "sparse_agg", n, leaf, dtype,
                         kern,
                         plain, lib,
                         elems * es + n * c * es + n * 4 + 2 * r * c * 4,
                         5 * elems)
            records.append(rec)
            partials_rec = rec

            # ---- sparse_agg mean mode (Eq. (4) finished in the kernel): the
            # plain version, and bit for bit finish_masked_mean over the
            # partials mode; channel 0 of `fill` is uploaded by no client
            gprev = randn(*leaf).to(dtype)
            fill = chan.clone()
            fill[..., 0] = 0
            for mask, mc in ((fill, c), (dense, 1)):
                num, den = agg_ops.masked_weighted_sum(vals, mask, wts)
                for g in (None, gprev):
                    for out_dt in dict.fromkeys((dtype, torch.float32)):
                        got = agg_ops.masked_weighted_mean(vals, mask, wts, g,
                                                           out_dt)
                        want = masked_weighted_mean_ref(
                            vals.view(n, a, c, b), mask.view(n, mc), wts,
                            None if g is None else g.view(a, c, b),
                            out_dt).view(leaf)
                        torch.testing.assert_close(
                            got.float(), want.float(),
                            rtol=MEAN_RTOL[_name(dtype), _name(out_dt)],
                            atol=1e-4)
                        if not torch.equal(got, finish_masked_mean(
                                num, den, g, out_dt)):
                            raise AssertionError(
                                f"sparse_agg mean mode differs from "
                                f"finish_masked_mean over its partials at "
                                f"{(n,) + leaf} {dtype} -> {out_dt}")
                        if g is not None and mc == c and not torch.equal(
                                got[..., 0], g[..., 0].to(out_dt)):
                            raise AssertionError("sparse_agg mean mode did "
                                                 "not keep gprev where no "
                                                 "client uploaded")
                        max_err["sparse_agg"] = max(
                            max_err["sparse_agg"],
                            (got.float() - want.float()).abs().max().item())
            den = masked_weighted_sum_ref(vals.view(n, a, c, b), m2, wts)[1]
            filled = int((den <= 1e-12).sum())     # gprev elements read
            kern = lambda: agg_ops.masked_weighted_mean(  # noqa: E731
                vals, chan, wts, gprev, dtype)
            plain = lambda: masked_weighted_mean_ref(     # noqa: E731
                vals.view(n, a, c, b), m2, wts, gprev.view(a, c, b), dtype)
            unfused = lambda: finish_masked_mean(         # noqa: E731
                *agg_ops.masked_weighted_sum(vals, chan, wts), gprev, dtype)
            rec = _timed(card, flush, timer, "eq4_leaf", n, leaf, dtype,
                         kern, plain, None,
                         elems * es + n * c * es + n * 4 + r * c * es
                         + filled * es, 5 * elems + r * c,
                         extra={"unfused": unfused})
            rec.update(mode="mean", partials_ms=partials_rec["ms"],
                       partials_bound_ms=partials_rec["bound_ms"])
            records.append(rec)
            if is_main:
                main["sparse_agg"] = rec

            # ---- masked_merge (Eq. (5)): an exact select
            g = randn(*leaf).to(dtype)
            loc = randn(n, *leaf).to(dtype)
            out = merge_ops.masked_merge(g, loc, chan)
            want = masked_merge_ref(g.view(a, c, b), loc.view(n, a, c, b),
                                    m2).view(loc.shape)
            if not torch.equal(out, want):
                raise AssertionError(f"masked_merge differs from its plain "
                                     f"version at {(n,) + leaf} {dtype}")
            sel = torch.where(chan.bool(), g[None], loc)
            if not torch.equal(out, sel):
                raise AssertionError("masked_merge is not a select of G "
                                     "and L for a binary mask")
            dense_out = merge_ops.masked_merge(g, loc, dense)
            if not torch.equal(dense_out, g[None].expand_as(loc)):
                raise AssertionError("masked_merge with an all-ones mask is "
                                     "not the global")
            kern = lambda: merge_ops.masked_merge(g, loc, chan)  # noqa
            plain = lambda: masked_merge_ref(                    # noqa
                g.view(a, c, b), loc.view(n, a, c, b), m2)
            cb = chan.bool()
            lib = lambda: torch.where(cb, g[None], loc)          # noqa
            rec = _timed(card, flush, timer, "masked_merge", n, leaf, dtype,
                         kern,
                         plain, lib, 2 * elems * es + r * c * es + n * c * es,
                         4 * elems)
            records.append(rec)
            if is_main:
                main["masked_merge"] = rec
        rec = merge_group_check(card, flush, dtype, dev, gen, timer)
        records.append(rec)
        if dtype == torch.float32:
            main["masked_merge_group"] = rec

    # ---- sparse_agg with an elementwise mask (a ragged fleet's canvas)
    for dtype in (torch.float32, torch.bfloat16):
        for n, leaf in RAGGED + LARGE + [VGG_CANVAS]:
            if len(leaf) < 2:       # a 1-D leaf's mask is channel-shaped
                continue
            rec, err = elementwise_check(card, flush, dtype, dev, gen, timer,
                                         n, leaf)
            records.append(rec)
            max_err["sparse_agg"] = max(max_err["sparse_agg"], err)
            if (n, leaf) == VGG_CANVAS and dtype == torch.float32:
                main["sparse_agg_elementwise"] = rec

    # ---- importance at N = 1, fc0 fp32: the per-client loop's launch
    n, leaf = LOOP_IMPORTANCE_SHAPE
    a, c, b = _lib.split_at(leaf, len(leaf) - 1)
    elems = n * a * c * b
    wo = randn(n, *leaf)
    wn = wo + 0.1 * randn(n, *leaf)
    err = 0.0
    for cov in (None, torch.rand((c,), generator=gen, device=dev) + 0.5):
        got = imp_ops.channel_importance_batched(wo, wn, coverage=cov)
        want = channel_importance_ref(wo.view(n, a, c, b),
                                      wn.view(n, a, c, b), cov)
        torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-5)
        err = max(err, (got - want).abs().max().item())
    max_err["importance"] = max(max_err["importance"], err)
    kern = lambda: imp_ops.channel_importance_batched(wo, wn)  # noqa: E731
    plain = lambda: channel_importance_ref(                     # noqa: E731
        wo.view(n, a, c, b), wn.view(n, a, c, b))
    rec = _timed(card, flush, timer, "importance", n, leaf, torch.float32,
                 kern, plain, None, 2 * elems * 4 + n * c * 4, 5 * elems)
    rec["max_abs_err"] = err
    if wo.is_cuda:      # the fan-in split at N = 1 and at the engine's N
        vec = _lib.vector_width(c, wo, wn) if b == 1 else 1
        sms = imp_ops.sm_count(wo.device)
        rec.update(splits=imp_ops.work_plan(n, a, c, b, sms, vec).splits,
                   splits_engine=imp_ops.work_plan(MLP_N, a, c, b, sms,
                                                   vec).splits)
    records.append(rec)
    main["importance_n1"] = rec

    # ---- sparse_agg's mean mode on the simulator's new inputs
    for rec in sim_kernel_checks(card, flush, dev, gen, timer):
        records.append(rec)
        main[rec["kernel"]] = rec
        max_err["sparse_agg"] = max(max_err["sparse_agg"],
                                    rec["max_abs_err"])
    return {"max_abs_err": max_err, "main": main}


def sim_kernel_checks(card: Card, flush, dev, gen, timer) -> list:
    """``sparse_agg``'s mean mode at fc0 of the fault grid's 16 clients
    (fp32), held against its plain version on the two inputs the
    simulator adds: (1) channel masks cut to each client's delivered
    prefix (``aggregation.truncate_masks_to_prefix``: deadline partial
    aggregation), and (2) uploads the validation screen let through with
    NaN, +-Inf and an all-ones exponent (bitflip) at a kept and at a
    dropped channel, one of the rows at weight 0 (``equal_nan``: the
    kernel keeps ``W * M * w``, so NaN * 0 stays NaN)."""
    import numpy as np
    import torch
    from repro_torch.core import aggregation
    from repro_torch.kernels import _lib
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.kernels.sparse_agg.ref import masked_weighted_mean_ref

    n, leaf = SIM_FC0
    a, c, b = _lib.split_at(leaf, len(leaf) - 1)
    elems = n * a * c * b
    vals = torch.randn((n, *leaf), generator=gen, device=dev)
    gprev = torch.randn(leaf, generator=gen, device=dev)
    wts = torch.rand((n,), generator=gen, device=dev) + 0.5
    keep = (torch.rand((n, 1, c), generator=gen, device=dev) > 0.4).float()
    cut = np.full(n, np.iinfo(np.int32).max, np.int32)
    cut[: n // 2] = np.arange(n // 2) * 5        # 0, 5, ..., 35 channels
    prefix = aggregation.truncate_masks_to_prefix(
        [keep], [torch.from_numpy(cut).to(dev)])[0]
    rank = torch.cumsum(keep, dim=2)
    if not torch.equal(prefix, keep * (rank <= torch.from_numpy(
            cut.astype(np.float32)).to(dev).view(n, 1, 1))):
        raise AssertionError("truncate_masks_to_prefix is not the prefix "
                             "of each client's kept channels")
    bad = vals.clone()
    flat = bad.view(n, a, c)
    for row, val in ((3, float("nan")), (5, float("inf")),
                     (7, float("-inf"))):
        kept = int(torch.nonzero(keep[row, 0])[0])
        dropped = int(torch.nonzero(keep[row, 0] == 0)[0])
        flat[row, 1, kept] = val
        flat[row, 2, dropped] = val
    bits = flat[9].view(torch.int32)
    bits[0, int(torch.nonzero(keep[9, 0])[0])] |= 0x7F800000
    w_bad = wts.clone()
    w_bad[3] = 0.0
    out = []
    for name, v, m, w in (("eq4_prefix", vals, prefix, wts),
                          ("eq4_nonfinite", bad, keep, w_bad)):
        got = agg_ops.masked_weighted_mean(v, m, w, gprev, torch.float32)
        want = masked_weighted_mean_ref(v.view(n, a, c, b), m.view(n, c), w,
                                        gprev.view(a, c, b),
                                        torch.float32).view(leaf)
        torch.testing.assert_close(got, want, rtol=3e-5, atol=1e-4,
                                   equal_nan=True)
        if name == "eq4_nonfinite" and not bool(
                (~torch.isfinite(got)).any()):
            raise AssertionError("a kept non-finite value did not reach "
                                 "Eq. (4)")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        kern = lambda: agg_ops.masked_weighted_mean(  # noqa: E731
            v, m, w, gprev, torch.float32)
        plain = lambda: masked_weighted_mean_ref(     # noqa: E731
            v.view(n, a, c, b), m.view(n, c), w, gprev.view(a, c, b),
            torch.float32)
        den = (m.view(n, 1, c) * w.view(n, 1, 1)).sum(0).expand(a, c)
        filled = int((den <= 1e-12).sum())      # gprev elements read
        rec = _timed(card, flush, timer, name, n, leaf, torch.float32, kern,
                     plain, None, elems * 4 + n * c * 4 + n * 4 + a * c * 4
                     + filled * 4, 5 * elems + a * c)
        rec.update(mode="mean", max_abs_err=err,
                   non_finite=int((~torch.isfinite(got)).sum()))
        out.append(rec)
    return out


def ragged_canvas_mask(gen, dev, n, leaf, dtype):
    """A ragged fleet's Eq. (4) canvas mask: client i uploads a leading
    box of the leaf (its own widths; the rest is zero padding) under a
    random channel mask, and no client uploads channel 0."""
    import torch
    chan = (torch.rand((n,) + (1,) * (len(leaf) - 1) + leaf[-1:],
                       generator=gen, device=dev) > 0.4).to(dtype)
    m = torch.zeros((n,) + tuple(leaf), dtype=dtype, device=dev)
    for i in range(n):
        box = tuple(slice(0, max(1, s - (s * (i % 3)) // 4)) for s in leaf)
        m[(i,) + box] = chan[i].expand(leaf)[box]
    m[..., 0] = 0
    return m


def elementwise_check(card: Card, flush, dtype, dev, gen, timer, n,
                      leaf) -> tuple:
    """Phase 3, sparse_agg's elementwise-mask mode at one shape: both
    modes against the plain version (the partials' tolerances, MEAN_RTOL
    for the mean), the mean mode bit for bit against finish_masked_mean
    over the partials mode and equal to gprev where no client uploaded;
    the mean mode timed beside its plain version -> (record, max error).
    The bound reads the values and the mask (the same bytes) once, the
    weights, gprev where it fills, and writes the leaf once."""
    import torch
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.kernels.sparse_agg.ref import (finish_masked_mean,
                                                    masked_weighted_mean_ref,
                                                    masked_weighted_sum_ref)
    es = torch.finfo(dtype).bits // 8
    a = math.prod(leaf[:-1])
    c = leaf[-1]
    elems = n * a * c
    vals = torch.randn((n, *leaf), generator=gen, device=dev).to(dtype)
    mask = ragged_canvas_mask(gen, dev, n, leaf, dtype)
    wts = torch.rand((n,), generator=gen, device=dev) + 0.5
    gprev = torch.randn(leaf, generator=gen, device=dev).to(dtype)
    v4, m4 = vals.view(n, a, c, 1), mask.view(n, a, c, 1)
    before = agg_ops.route_counts()
    num, den = agg_ops.masked_weighted_sum(vals, mask, wts)
    wnum, wden = masked_weighted_sum_ref(v4, m4, wts)
    torch.testing.assert_close(
        num, wnum.view(leaf), rtol=5e-3 if dtype == torch.bfloat16 else 3e-5,
        atol=1e-4)
    torch.testing.assert_close(den, wden.view(leaf), rtol=3e-5, atol=1e-5)
    err = max((num - wnum.view(leaf)).abs().max().item(),
              (den - wden.view(leaf)).abs().max().item())
    got = agg_ops.masked_weighted_mean(vals, mask, wts, gprev, dtype)
    moved = {k: v - before[k] for k, v in agg_ops.route_counts().items()}
    if dev.type == "cuda" and moved != {"partials": 0, "mean": 0,
                                        "partials:elementwise": 1,
                                        "mean:elementwise": 1}:
        raise AssertionError(f"elementwise masks took the routes {moved}")
    want = masked_weighted_mean_ref(v4, m4, wts, gprev.view(a, c, 1),
                                    dtype).view(leaf)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=MEAN_RTOL[_name(dtype), _name(dtype)],
                               atol=1e-4)
    if not torch.equal(got, finish_masked_mean(num, den, gprev, dtype)):
        raise AssertionError(f"sparse_agg elementwise mean mode differs from "
                             f"finish_masked_mean over its partials at "
                             f"{(n,) + leaf} {dtype}")
    if not torch.equal(got[..., 0], gprev[..., 0]):
        raise AssertionError("sparse_agg elementwise mean mode did not keep "
                             "gprev where no client uploaded")
    err = max(err, (got.float() - want.float()).abs().max().item())
    filled = int((wden <= 1e-12).sum())
    rec = _timed(card, flush, timer, "eq4_elementwise", n, leaf, dtype,
                 lambda: agg_ops.masked_weighted_mean(vals, mask, wts, gprev,
                                                      dtype),
                 lambda: masked_weighted_mean_ref(v4, m4, wts,
                                                  gprev.view(a, c, 1), dtype),
                 None, 2 * elems * es + n * 4 + a * c * es + filled * es,
                 5 * elems + a * c)
    rec.update(mode="mean", mask="elementwise", max_abs_err=err)
    return rec, err


def merge_group_check(card: Card, flush, dtype, dev, gen, timer) -> dict:
    """Phase 3, Eq. (5) as the engine calls it: the MLP's six leaves
    (N = MLP_N, channel-last binary masks) in one call, which must launch
    the kernel once and equal the plain version leaf by leaf; timed beside
    the six single-leaf launches (each alone, and back to back) and the
    plain version over the six."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.masked_merge.ref import masked_merge_ref

    es = torch.finfo(dtype).bits // 8
    gs, ls, ms = [], [], []
    nbytes = 0
    for leaf in MLP_LEAVES:
        c = leaf[-1]
        gs.append(torch.randn(leaf, generator=gen, device=dev).to(dtype))
        ls.append(torch.randn((MLP_N, *leaf), generator=gen, device=dev
                              ).to(dtype))
        ms.append((torch.rand((MLP_N,) + (1,) * (len(leaf) - 1) + (c,),
                              generator=gen, device=dev) > 0.5).to(dtype))
        size = gs[-1].numel()
        nbytes += 2 * MLP_N * size * es + size * es + MLP_N * c * es

    def plain():
        return [masked_merge_ref(g.view(-1, g.shape[-1], 1),
                                 l.view(MLP_N, -1, l.shape[-1], 1),
                                 m.view(MLP_N, -1)).view(l.shape)
                for g, l, m in zip(gs, ls, ms)]

    before = launch_counts()["masked_merge"]
    got = merge_ops.masked_merge_many(gs, ls, ms)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if launch_counts()["masked_merge"] != before + 1:
            raise AssertionError("the grouped merge of the MLP's six leaves "
                                 "did not launch exactly once")
    for leaf, out, want in zip(MLP_LEAVES, got, plain()):
        if not torch.equal(out, want):
            raise AssertionError(f"grouped masked_merge differs from its "
                                 f"plain version at leaf {leaf} {dtype}")
    singles = [(lambda g=g, l=l, m=m: merge_ops.masked_merge(g, l, m))
               for g, l, m in zip(gs, ls, ms)]

    def burst():
        for fn in singles:
            fn()

    bound_ms, bound_by = card.bound(nbytes, 4 * sum(
        l.numel() for l in ls))
    rec = dict(kernel="masked_merge_group", shape=[MLP_N],
               leaves=len(MLP_LEAVES), dtype=_name(dtype),
               ms=timer(lambda: merge_ops.masked_merge_many(gs, ls, ms),
                        flush),
               per_leaf_ms=[timer(fn, flush) for fn in singles],
               per_leaf_burst_ms=timer(burst, flush),
               plain_ms=timer(plain, flush), library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
    rec["per_leaf_sum_ms"] = sum(rec["per_leaf_ms"])
    print(f"  masked_merge grouped, the MLP's {len(MLP_LEAVES)} leaves "
          f"{_name(dtype):8s}: one launch, equal to the plain version; "
          f"grouped {rec['ms'] * 1e3:.1f} us, six launches "
          f"{rec['per_leaf_sum_ms'] * 1e3:.1f} us timed one by one "
          f"({rec['per_leaf_burst_ms'] * 1e3:.1f} us back to back), plain "
          f"{rec['plain_ms'] * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by})", flush=True)
    return rec


def big_merge_check(card: Card, flush, dev="cuda", timer=time_ms) -> dict:
    """Phase 3, Eq. (5) past 32-bit indices: one bf16 client leaf of
    BIG_MERGE (2,147,549,184 elements) in one launch of several
    descriptors, equal to ``torch.where(M > 0, G, L)`` and to the plain
    version (in chunks of BIG_MERGE_ROWS rows) exactly; timed beside
    ``torch.where``.  Its 13 GB are freed before it returns."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.masked_merge.ref import masked_merge_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, c = BIG_MERGE
    g = torch.randn(BIG_MERGE, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    loc = torch.randn((1,) + BIG_MERGE, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    m = (torch.rand((1, 1, c), generator=gen, device=dev) > 0.5).to(
        torch.bfloat16)
    before = launch_counts()["masked_merge"]
    out = merge_ops.masked_merge(g, loc, m)
    _sync(dev)
    if torch.device(dev).type == "cuda" and \
            launch_counts()["masked_merge"] != before + 1:
        raise AssertionError("the 2**31-element merge did not launch once")
    pieces = len(merge_ops.split_leaf((rows, c, 1)))
    take = m > 0
    if not torch.equal(out, torch.where(take, g[None], loc)):
        raise AssertionError(f"masked_merge at {BIG_MERGE} bf16 differs "
                             f"from torch.where")
    for r0 in range(0, rows, BIG_MERGE_ROWS):
        r1 = min(rows, r0 + BIG_MERGE_ROWS)
        want = masked_merge_ref(g[r0:r1].reshape(-1, c, 1),
                                loc[:, r0:r1].reshape(1, -1, c, 1),
                                m.view(1, c))
        if not torch.equal(out[:, r0:r1], want.view(1, r1 - r0, c)):
            raise AssertionError(f"masked_merge at {BIG_MERGE} rows "
                                 f"{r0}:{r1} differs from the plain version")
    del out, want
    elems = rows * c
    nbytes = 3 * elems * 2 + c * 2
    bound_ms, bound_by = card.bound(nbytes, 4 * elems)
    rec = dict(kernel="masked_merge_2_31", shape=[1, rows, c],
               dtype="bfloat16", descriptors=pieces,
               ms=timer(lambda: merge_ops.masked_merge(g, loc, m), flush,
                        LONG_TIMED),
               plain_ms=None, plain="checked in row chunks, not timed",
               library_ms=timer(lambda: torch.where(take, g[None], loc),
                                flush, LONG_TIMED),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
    print(f"  masked_merge {(1, rows, c)} bfloat16 ({elems} elements a "
          f"client, {pieces} descriptors): one launch, equal to torch.where"
          f" and to the plain version; kernel {rec['ms']:.3f} ms  "
          f"torch.where {rec['library_ms']:.3f} ms  bound {bound_ms:.3f} ms"
          f" ({bound_by})", flush=True)
    del g, loc, m, take
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _timed(card, flush, timer, name, n, leaf, dtype, kern, plain, lib,
           nbytes, flops, extra=None) -> dict:
    """Time the kernel, its plain version, the library call (or None) and
    each of ``extra`` (stored as ``<name>_ms``) -> the record."""
    bound_ms, bound_by = card.bound(nbytes, flops)
    rec = dict(kernel=name, shape=[n, *leaf], dtype=_name(dtype),
               ms=timer(kern, flush), plain_ms=timer(plain, flush),
               library_ms=None if lib is None else timer(lib, flush),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    more = ""
    for key, fn in (extra or {}).items():
        rec[f"{key}_ms"] = timer(fn, flush)
        more += f"  {key} {rec[f'{key}_ms'] * 1e3:.1f} us"
    lib_col = ("-" if rec["library_ms"] is None
               else f"{rec['library_ms'] * 1e3:.1f}")
    print(f"  {name:12s} {str(tuple(rec['shape'])):22s} {rec['dtype']:8s} "
          f"kernel {rec['ms'] * 1e3:8.1f} us  plain "
          f"{rec['plain_ms'] * 1e3:8.1f} us  library {lib_col:>8s} us  "
          f"bound {bound_ms * 1e3:7.2f} us ({bound_by}){more}", flush=True)
    return rec


def flash_bytes_flops(b, sq, skv, h, hkv, hd, causal, window, es):
    """Bytes (q, k, v read once, out written once) and the flops of the
    unmasked (query, key) pairs: 2 * hd for q.k and 2 * hd for p.v."""
    from repro_torch.kernels.flash_attention.ref import valid_pairs
    pairs = valid_pairs(sq, skv, causal, window)
    nbytes = (2 * b * sq * h * hd + 2 * b * skv * hkv * hd) * es
    return nbytes, 4 * b * h * hd * pairs, pairs


def flash_checks(card: Card, flush, records: list, dev="cuda",
                 timer=time_ms) -> dict:
    """Phase 3, flash attention: the kernels against their plain version
    over the sweep, and over every row at the slice's shape and the
    prefill's (bf16 and fp32 inputs); times at both.  Returns max_abs_err
    and the record of the line: the prefill's shape, causal."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        gqa_attention_ref, gqa_attention_ref_chunked, worst_row_error)

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    worst_row = 0.0

    def qkv(b, s, h, hkv, hd, dtype):
        return [torch.randn((b, s, n, hd), generator=gen, device=dev
                            ).to(dtype) for n in (h, hkv, hkv)]

    def check(q, k, v, causal, window, plain=gqa_attention_ref):
        nonlocal max_err, worst_row
        before = launch_counts()["flash_attention"]
        routes = ops.route_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = plain(q, k, v, causal=causal, window=window)
        if dev.type == "cuda":
            if launch_counts()["flash_attention"] != before + 1:
                raise AssertionError("flash_attention did not count its "
                                     "launch")
            which = ("sm90" if q.dtype == torch.bfloat16
                     and q.shape[-1] in (64, 128, 192, 256) else "fma")
            after = ops.route_counts()
            if after[which] != routes[which] + 1:
                raise AssertionError(f"flash_attention {tuple(q.shape)} "
                                     f"{q.dtype} did not take the {which} "
                                     f"route: {routes} -> {after}")
        tol = 3e-5 if q.dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        row = None
        if q.dtype == torch.bfloat16:
            row = worst_row_error(got, want)
            worst_row = max(worst_row, row)
            if not row <= ROW_TOL:
                raise AssertionError(
                    f"flash_attention {tuple(q.shape)} causal={causal} "
                    f"window={window}: a row differs by {row:.4g} of its "
                    f"max |want| (limit {ROW_TOL:.4g})")
        return err, row

    def chunked(q, k, v, *, causal, window):
        return gqa_attention_ref_chunked(q, k, v, causal=causal,
                                         window=window, rows=PLAIN_ROWS)

    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SWEEP:
            q, k, v = qkv(*shape, dtype)
            for causal, window in FLASH_MODES:
                check(q, k, v, causal, window)
        print(f"  flash_attention sweep {str(dtype).split('.')[-1]}: "
              f"{len(FLASH_SWEEP) * len(FLASH_MODES)} cases agree, max err "
              f"so far {max_err:.3g}, worst bf16 row {worst_row:.3g} of its "
              f"scale; routes {ops.route_counts()}", flush=True)

    def measure(qs, ks, vs, window, plain_fn, note=""):
        """Every row of a long causal call against ``plain_fn`` (bf16 and
        fp32 inputs), then the bf16 kernel, its plain version and sdpa
        timed, with the bound -> the record."""
        b, s, h, hd = qs.shape
        hkv = ks.shape[2]
        q32, k32, v32 = (t.float() for t in (qs, ks, vs))
        qt, kt, vt = (t.transpose(1, 2) for t in (qs, ks, vs))
        (err, row), (err32, _) = (
            check(qs, ks, vs, True, window, plain_fn),
            check(q32, k32, v32, True, window, plain_fn))
        del q32, k32, v32
        kern = lambda: ops.flash_attention(qs, ks, vs, causal=True,  # noqa
                                           window=window)
        plain = lambda: plain_fn(qs, ks, vs, causal=True,            # noqa
                                 window=window)
        lib, lib_note = sdpa_yardstick(qt, kt, vt, window, flush, timer)
        nbytes, flops, pairs = flash_bytes_flops(b, s, s, h, hkv, hd,
                                                 True, window, 2)
        bound_ms, bound_by = card.bound(nbytes, flops, card.bf16_flops)
        rec = dict(kernel="flash_attention", shape=[b, s, h, hkv, hd],
                   window=window, dtype="bfloat16", max_abs_err=err,
                   max_abs_err_fp32=err32, worst_row=row,
                   plain=plain_fn.__name__,
                   ms=timer(kern, flush, LONG_TIMED),
                   plain_ms=timer(plain, flush, LONG_TIMED),
                   library_ms=lib, library=lib_note,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, pairs=pairs)
        records.append(rec)
        lib_col = ("-" if rec["library_ms"] is None
                   else f"{rec['library_ms']:.3f}")
        print(f"  flash_attention {(b, s, h, hkv, hd)}{note} window "
              f"{window:4d}: every row agrees, max err bf16 {err:.3g} "
              f"(worst row {row:.3g} of its scale) fp32 {err32:.3g}; "
              f"bf16 kernel {rec['ms']:.3f} ms  plain "
              f"{rec['plain_ms']:.3f} ms  sdpa {lib_col} ms ({lib_note})"
              f"  bound {bound_ms:.3f} ms ({bound_by}; "
              f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s)", flush=True)
        return rec

    b, _, h, hkv, hd = SLICE_FLASH
    line_rec = None
    q, k, v = qkv(b, PREFILL_SEQ, h, hkv, hd, torch.bfloat16)
    # the slice's shape against the whole plain version; the prefill's
    # against it in chunks of PLAIN_ROWS query rows (137 GB of scores whole)
    for s, plain_fn in ((SLICE_FLASH[1], gqa_attention_ref),
                        (PREFILL_SEQ, chunked)):
        for window in SLICE_WINDOWS:
            rec = measure(q[:, :s], k[:, :s], v[:, :s], window, plain_fn)
            if s == PREFILL_SEQ and not window:
                line_rec = rec
    del q, k, v
    def qk_normed(shape):
        """bf16 q, k, v with q and k RMS-normalised over head_dim, as
        qwen3-moe's qk-norm leaves them."""
        q, k, v = qkv(*shape, torch.bfloat16)
        q, k = (t.float() * torch.rsqrt(t.float().square().mean(
            -1, keepdim=True) + 1e-6) for t in (q, k))
        return q.to(torch.bfloat16), k.to(torch.bfloat16), v

    # the MoE prefill's shape (8 query heads a kv head), and a model
    # shard's heads of it on the (2, 2) mesh
    q, k, v = qk_normed(MOE_FLASH)
    moe_rec = measure(q, k, v, 0, gqa_attention_ref, " qk-normed")
    q, k, v = qk_normed(MESH_MOE_FLASH)
    mesh_moe_rec = measure(q, k, v, 0, gqa_attention_ref,
                           " qk-normed mesh shard")
    del q, k, v
    # a model shard's heads on the (2, 2) mesh's gemma3 prefill
    q, k, v = qkv(*MESH_FLASH, torch.bfloat16)
    mesh_recs = {w: measure(q, k, v, w, chunked, " mesh shard")
                 for w in SLICE_WINDOWS}
    del q, k, v
    # the families phase's prefills: jamba's attention layer and pixtral's
    # 40 layers (held against the plain version in row chunks)
    # and a model shard's heads of each on the (2, 2) mesh (phase 10b)
    fam = {}
    for name, shape in (("jamba", JAMBA_FLASH), ("pixtral", PIXTRAL_FLASH),
                        ("jamba_mesh", JAMBA_MESH_FLASH),
                        ("pixtral_mesh", PIXTRAL_MESH_FLASH)):
        q, k, v = qkv(*shape, torch.bfloat16)
        fam[name] = measure(q, k, v, 0, chunked, f" {name}")
        del q, k, v
    return {"max_abs_err": max_err, "worst_row": worst_row, "main": line_rec,
            "moe": moe_rec, "mesh": mesh_recs, "mesh_moe": mesh_moe_rec,
            **fam}


def sdpa_yardstick(qt, kt, vt, window, flush, timer):
    """Time ``scaled_dot_product_attention`` on the flash kernel's inputs
    ((B, H, S, hd) views), the function the port never calls: causal through
    its flash backend with ``enable_gqa``; a window through its
    memory-efficient backend with an additive bf16 band mask (2.1 GB at
    32768) and k/v expanded to the query heads before the timed call.
    Returns (ms or None, what was timed or why nothing was)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention.ref import band_mask

    if not window:
        return timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush,
            LONG_TIMED), "flash backend, is_causal, enable_gqa"
    s, g = qt.shape[2], qt.shape[1] // kt.shape[1]
    mask = torch.zeros((s, s), dtype=qt.dtype, device=qt.device)
    mask.masked_fill_(~band_mask(s, s, True, window, qt.device),
                      float("-inf"))
    ke, ve = (t.repeat_interleave(g, dim=1) for t in (kt, vt))

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qt, ke, ve, attn_mask=mask)
    try:
        call()
    except RuntimeError as e:   # the yardstick only: the port never calls it
        note = f"refused by the memory-efficient backend: {e}".splitlines()[0]
        print(f"  sdpa yardstick at window {window}: {note}", flush=True)
        return None, note
    ms = timer(call, flush, LONG_TIMED)
    del mask, ke, ve
    return ms, "memory-efficient backend, additive band mask, k/v expanded"


def engine_check(dev="cuda") -> None:
    """Phase 4: one engine step on the card vs the same step on the CPU."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.core.round_engine import (BatchedRoundEngine,
                                               stack_pytrees)
    from repro_torch.fl import MLP_SPEC, init_cnn_spec

    rng = np.random.default_rng(0)
    gp = init_cnn_spec(MLP_SPEC, seed=1, device="cpu")
    old = stack_pytrees([tree.tree_map(
        lambda x: x + torch.from_numpy(
            rng.normal(0, 0.05, x.shape).astype(np.float32)), gp)
        for _ in range(MLP_N)])
    new = tree.tree_map(lambda x: x + torch.from_numpy(
        rng.normal(0, 0.02, x.shape).astype(np.float32)), old)
    rates = rng.uniform(0.0, 0.8, MLP_N)
    weights = rng.integers(100, 1000, MLP_N).astype(float)
    engine = BatchedRoundEngine()
    on_dev = lambda t: tree.tree_map(lambda x: x.to(dev), t)  # noqa: E731
    for full, dense in ((False, False), (True, False), (True, True)):
        want = engine.step(old, new, gp, rates, weights, full_round=full,
                           dense_masks=dense)
        got = engine.step(on_dev(old), on_dev(new), on_dev(gp), rates,
                          weights, full_round=full, dense_masks=dense)
        torch.testing.assert_close(got.densities.cpu(), want.densities,
                                   rtol=0, atol=0)
        for part in ("global_params", "client_params"):
            for g, w in zip(tree.leaves(getattr(got, part)),
                            tree.leaves(getattr(want, part))):
                if g.device.type != torch.device(dev).type:
                    raise AssertionError(f"{part} left the {dev} device")
                torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
        print(f"  engine step full_round={full} dense_masks={dense}: {dev} "
              f"matches cpu", flush=True)


def main_path(dev="cuda") -> dict:
    """Phase 5: the FedDD quickstart configuration on cuda, kernels
    counted."""
    import numpy as np
    import torch
    from repro_torch import kernels, tree
    from repro_torch.core.baselines import round_times
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.quickstart import FEDDD_H, run

    def show(scheme, r):
        print(f"  {scheme:6s} round {r.round}  acc="
              f"{r.metrics['accuracy']:.4f}  loss={r.mean_loss:.5f}  "
              f"sim_t={r.sim_time:.1f}s  uploaded="
              f"{r.uploaded_fraction:.4f}  host={r.host_wall_time:.4f}s",
              flush=True)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    feddd, fedavg, tel = run(5, fedavg_rounds=3, device=dev,
                             on_round=show)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    modes = agg_ops.mode_counts()
    merged = merge_ops.leaf_counts()
    print(f"  FedDD path: {wall:.2f} s, launches {counts}, sparse_agg by "
          f"mode {modes}, masked_merge launches by leaves merged {merged}",
          flush=True)

    for res in (feddd, fedavg):
        for rec in res.history:
            if not math.isfinite(rec.mean_loss):
                raise AssertionError(f"round {rec.round}: loss "
                                     f"{rec.mean_loss}")
        if not all(l.device.type == torch.device(dev).type
                   for l in tree.leaves(res.global_params)):
            raise AssertionError("global params left the card")
    for name in FEDDD_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "FedDD path")
    if counts["flash_attention"] != 0:
        raise AssertionError("flash_attention launched on the FedDD path")
    if modes != {"partials": 0, "mean": counts["sparse_agg"]}:
        raise AssertionError(f"Eq. (4) did not run in the kernel's mean "
                             f"mode alone: {modes}")
    partial = sum(r.round % FEDDD_H != 0 for r in feddd.history)
    leaves = len(tree.leaves(feddd.global_params))
    if counts["masked_merge"] != partial or merged != {leaves: partial}:
        raise AssertionError(f"Eq. (5) did not launch once per partial "
                             f"FedDD round ({partial}) for all {leaves} "
                             f"leaves: {counts['masked_merge']} launches, "
                             f"{merged}")
    want_t1 = float(np.max(round_times(tel, np.zeros(tel.num_clients))))
    if feddd.history[0].sim_time != want_t1:
        raise AssertionError(f"round 1 sim_time {feddd.history[0].sim_time} "
                             f"!= Eq. (12) at D=0 {want_t1}")
    for rec in feddd.history[1:]:
        if not 0.55 <= rec.uploaded_fraction <= 0.65:
            raise AssertionError(f"round {rec.round} uploaded "
                                 f"{rec.uploaded_fraction}")
    acc = feddd.history[4].metrics["accuracy"]
    if acc < 0.85:
        raise AssertionError(f"accuracy after round 5 is {acc} < 0.85")
    return dict(
        launches=counts, sparse_agg_modes=modes, merge_leaf_counts=merged,
        partial_rounds=partial, wall_s=wall,
        rounds=[dict(scheme=s, round=r.round, acc=r.metrics["accuracy"],
                     loss=r.mean_loss, sim_time=r.sim_time,
                     uploaded_fraction=r.uploaded_fraction,
                     host_wall_time=r.host_wall_time)
                for s, res in (("feddd", feddd), ("fedavg", fedavg))
                for r in res.history])


def comm_engine_check(dev="cuda") -> dict:
    """The comm engine check: one engine step with a round key,
    CommConfig(auto, 8) and scheme 'random' on ``dev`` and on the CPU with
    the same inputs: densities, masks, the wire overhead and the int8
    decoded uploads equal, parameters within 1e-5.  The rates reach 0.97,
    where the index codec wins some leaves, so the overhead compared
    depends on the masks (asserted); each codec's overhead of the masks
    is compared too."""
    import numpy as np
    import torch
    from repro_torch import prng, tree
    from repro_torch.comm import CommConfig, codecs, quantize
    from repro_torch.core import selection
    from repro_torch.core.round_engine import (BatchedRoundEngine,
                                               stack_pytrees)
    from repro_torch.fl import MLP_SPEC, init_cnn_spec

    rng = np.random.default_rng(3)
    gp = init_cnn_spec(MLP_SPEC, seed=2, device="cpu")
    old = stack_pytrees([tree.tree_map(
        lambda x: x + torch.from_numpy(
            rng.normal(0, 0.05, x.shape).astype(np.float32)), gp)
        for _ in range(MLP_N)])
    new = tree.tree_map(lambda x: x + torch.from_numpy(
        rng.normal(0, 0.02, x.shape).astype(np.float32)), old)
    rates = np.concatenate([rng.uniform(0.0, 0.8, MLP_N - 3),
                            [0.9, 0.95, 0.97]])
    weights = rng.integers(100, 1000, MLP_N).astype(float)
    rk = prng.split(prng.PRNGKey(7))[1]
    sel = selection.SelectionConfig(scheme="random")
    engine = BatchedRoundEngine(sel, CommConfig(**COMM))
    on_dev = lambda t: tree.tree_map(lambda x: x.to(dev), t)  # noqa: E731
    want = engine.step(old, new, gp, rates, weights, rk, full_round=False)
    got = engine.step(on_dev(old), on_dev(new), on_dev(gp), rates, weights,
                      rk, full_round=False)
    checks = [("densities", got.densities, want.densities),
              ("wire_overhead", got.wire_overhead, want.wire_overhead)]
    wm, _ = selection.build_masks_batched(old, new, rates, config=sel,
                                          rng=rk)
    gm, _ = selection.build_masks_batched(on_dev(old), on_dev(new), rates,
                                          config=sel, rng=rk)
    checks += [("masks", a, b) for a, b in zip(tree.leaves(gm),
                                               tree.leaves(wm))]
    per_codec = {}
    for codec in ("bitmask", "index", "auto"):
        cc = CommConfig(codec=codec, qbits=COMM["qbits"])
        per_codec[codec] = codecs.mask_overhead_bytes_stacked(wm, new, cc)
        checks.append((f"{codec} overhead", codecs.mask_overhead_bytes_stacked(
            gm, on_dev(new), cc), per_codec[codec]))
    if len(set(want.wire_overhead.tolist())) < 2 or torch.equal(
            per_codec["auto"], per_codec["bitmask"]):
        raise AssertionError("comm engine step: the wire overhead "
                             f"{want.wire_overhead.tolist()} does not "
                             "depend on the masks")
    checks += [("int8 decoded", a, b) for a, b in zip(
        tree.leaves(quantize.quantize_dequantize_stacked(on_dev(new), rk,
                                                         COMM["qbits"])),
        tree.leaves(quantize.quantize_dequantize_stacked(new, rk,
                                                         COMM["qbits"])))]
    for name, a, b in checks:
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"comm engine step: {name} on {dev} "
                                 f"differ from the CPU's")
    for part in ("global_params", "client_params"):
        for g, w in zip(tree.leaves(getattr(got, part)),
                        tree.leaves(getattr(want, part))):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
    print(f"  comm engine step ({COMM['codec']}/{COMM['qbits']}, random "
          f"masks): {dev} equals cpu (densities, masks, wire overhead "
          f"{want.wire_overhead.tolist()}, index codec "
          f"{per_codec['index'].tolist()}, int8 values; params within "
          f"1e-5)", flush=True)
    return dict(wire_overhead=want.wire_overhead.tolist(),
                overhead_by_codec={c: v.tolist()
                                   for c, v in per_codec.items()},
                densities=want.densities.tolist())


def comm_run(dev="cuda") -> dict:
    """The slice's path: the quickstart configuration in CommConfig(auto,
    8), COMM_ROUNDS FedDD rounds on ``dev`` with the counts set to 0 just
    before and read just after (the three FedDD kernels launch; sparse_agg
    in mean mode on the int8-decoded uploads; Eq. (5) once a partial
    round), finite losses, wire bytes under the raw bytes from round 2 and
    accuracy >= COMM_MIN_ACC after the last round; then the same with
    scheme 'random', which launches sparse_agg and masked_merge and no
    importance."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.comm import CommConfig
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.quickstart import FEDDD_H, run

    out = {}
    for selection in ("feddd", "random"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, _, _ = run(COMM_ROUNDS, fedavg_rounds=0,
                        comm=CommConfig(**COMM), selection=selection,
                        device=dev)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        modes = agg_ops.mode_counts()
        merged = merge_ops.leaf_counts()
        for r in res.history:
            print(f"  {COMM['codec']}/{COMM['qbits']} {selection:6s} round "
                  f"{r.round}  acc={r.metrics['accuracy']:.4f}  "
                  f"loss={r.mean_loss:.5f}  uploaded={r.uploaded_bytes:.0f}"
                  f" B  wire={r.wire_bytes:.0f} B  "
                  f"host={r.host_wall_time:.4f}s", flush=True)
            if not math.isfinite(r.mean_loss):
                raise AssertionError(f"{selection} round {r.round}: loss "
                                     f"{r.mean_loss}")
            if r.round > 1 and not r.wire_bytes < r.uploaded_bytes:
                raise AssertionError(f"{selection} round {r.round}: wire "
                                     f"{r.wire_bytes} >= uploaded "
                                     f"{r.uploaded_bytes}")
            if r.survivors != r.participants:
                raise AssertionError("survivors != participants")
        partial = sum(r.round % FEDDD_H != 0 for r in res.history)
        want_imp = 6 * COMM_ROUNDS if selection == "feddd" else 0
        if (counts["importance"] != want_imp
                or counts["sparse_agg"] != 6 * COMM_ROUNDS
                or counts["masked_merge"] != partial
                or counts["flash_attention"] != 0
                or modes != {"partials": 0, "mean": 6 * COMM_ROUNDS}
                or merged != {6: partial}):
            raise AssertionError(f"{selection} launches {counts}, modes "
                                 f"{modes}, merges {merged}")
        acc = res.history[-1].metrics["accuracy"]
        print(f"  {COMM['codec']}/{COMM['qbits']} {selection}: {wall:.2f} s,"
              f" launches {counts}; accuracy after round {COMM_ROUNDS} "
              f"{acc:.4f}", flush=True)
        if selection == "feddd" and acc < COMM_MIN_ACC:
            raise AssertionError(f"accuracy after round {COMM_ROUNDS} is "
                                 f"{acc} < {COMM_MIN_ACC}")
        out[selection] = dict(
            launches=counts, sparse_agg_modes=modes, merge_leaf_counts=merged,
            wall_s=wall, accuracy=acc,
            steady_host_s=float(np.median([r.host_wall_time
                                           for r in res.history[1:]])),
            rounds=[dict(round=r.round, acc=r.metrics["accuracy"],
                         loss=r.mean_loss, uploaded_bytes=r.uploaded_bytes,
                         wire_bytes=r.wire_bytes,
                         host_wall_time=r.host_wall_time)
                    for r in res.history])
    return out


@contextlib.contextmanager
def recorded_scores(out: list):
    """Append a copy of every importance score the path computes to
    ``out`` (the engine's (N, C) and the loop's (1, C), in call order); the
    kernel launches are the path's own."""
    from repro_torch.core import importance as imp_mod
    real = imp_mod.channel_importance_batched

    def recording(*args, **kw):
        scores = real(*args, **kw)
        out.append(scores.clone())
        return scores

    imp_mod.channel_importance_batched = recording
    try:
        yield out
    finally:
        imp_mod.channel_importance_batched = real


def mask_agreement(history, eng_scores, loop_scores, n: int, leaves: int):
    """Walk the rounds of an engine run and a loop run while their masks
    agree: each client's top-k of its engine scores against the top-k of
    its loop scores, at the rates the round used.  A channel may change
    sides only as a near-tie (within TIE_RTOL of the k-th score; the stable
    sort keeps the lower index on a tie).  -> (the first round whose masks
    differ or None, scores not bit-equal, near-tie channels)."""
    import numpy as np
    import torch
    from repro_torch.core.selection import keep_count_host, mask_from_scores
    first, unequal, ties = None, 0, 0
    for r in range(len(history)):
        rates = (np.zeros(n) if r == 0 else history[r - 1].dropout_rates)
        for leaf in range(leaves):
            es = eng_scores[r * leaves + leaf]
            for i in range(n):
                ls = loop_scores[(r * n + i) * leaves + leaf][0]
                if torch.equal(es[i], ls):
                    continue
                unequal += 1
                c = ls.shape[0]
                k = keep_count_host(c, rates[i])
                moved = torch.nonzero(mask_from_scores(es[i], k, c)
                                      != mask_from_scores(ls, k, c))
                if not len(moved):
                    continue
                kth = torch.sort(es[i], descending=True).values[max(k - 1,
                                                                    0)]
                for ch in moved.flatten().tolist():
                    if abs(es[i][ch] - kth) > TIE_RTOL * abs(kth):
                        raise AssertionError(
                            f"round {r + 1} leaf {leaf} client {i}: channel "
                            f"{ch} changed sides with score {es[i][ch]} "
                            f"against the k-th {kth}")
                ties += len(moved)
                first = first or r + 1
        if first:
            break
    return first, unequal, ties


def loop_phase(dev="cuda") -> dict:
    """The per-client reference loop (batched=False, track_epsilon=True)
    for LOOP_ROUNDS FedDD rounds of the quickstart configuration, counts
    set to 0 just before and read just after: importance at N = 1 for
    every client and leaf, sparse_agg once a leaf and round (mean mode),
    masked_merge once a client and partial round for all six leaves; every
    epsilon finite and >= 0.  Held against the engine's run at the same
    seed: equal rates, Eq. (12) clock and participants, bytes within one
    float32 ulp of each client's density (the loop divides kept / total,
    the engine multiplies by the reciprocal, as their JAX twins), and,
    while the masks agree, equal parameters and accuracy."""
    import numpy as np
    import torch
    from repro_torch import kernels, tree
    from repro_torch.core import protocol
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.quickstart import FEDDD_H, run, setup

    params, tel, _, _ = setup(MLP_N, dev)
    kind = protocol.FedDDServer(
        params, protocol.ProtocolConfig(batched=False, track_epsilon=True),
        tel, device=dev).executor_kind
    if kind != "loop":
        raise AssertionError(f"batched=False routes to {kind!r}")
    eng_scores, loop_scores = [], []
    with recorded_scores(eng_scores):
        eng, _, _ = run(LOOP_ROUNDS, fedavg_rounds=0, device=dev)
    with recorded_scores(loop_scores):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loop, _, _ = run(LOOP_ROUNDS, fedavg_rounds=0, batched=False,
                         track_epsilon=True, device=dev)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        modes = agg_ops.mode_counts()
        merged = merge_ops.leaf_counts()
    leaves = len(tree.leaves(loop.global_params))
    partial = sum(r.round % FEDDD_H != 0 for r in loop.history)
    want = dict(importance=MLP_N * leaves * LOOP_ROUNDS,
                sparse_agg=leaves * LOOP_ROUNDS,
                masked_merge=MLP_N * partial, flash_attention=0, conv=0)
    if (counts != want or modes != {"partials": 0,
                                    "mean": leaves * LOOP_ROUNDS}
            or merged != {leaves: MLP_N * partial}):
        raise AssertionError(f"loop launches {counts} (want {want}), modes "
                             f"{modes}, merges {merged}")
    eps = [r.epsilon for r in loop.history]
    if not all(e is not None and math.isfinite(e) and e >= 0 for e in eps):
        raise AssertionError(f"loop epsilons {eps}")
    ulp_bytes = MLP_N * float(np.finfo(np.float32).eps) * float(
        np.max(tel.model_bytes))
    for lr, er in zip(loop.history, eng.history):
        if not np.array_equal(lr.dropout_rates, er.dropout_rates):
            raise AssertionError(f"round {lr.round}: loop rates differ")
        for field in ("sim_time", "sim_round_time", "participants"):
            if getattr(lr, field) != getattr(er, field):
                raise AssertionError(f"round {lr.round}: loop {field} "
                                     f"{getattr(lr, field)} != engine "
                                     f"{getattr(er, field)}")
        for field in ("uploaded_bytes", "wire_bytes"):
            if abs(getattr(lr, field) - getattr(er, field)) > ulp_bytes:
                raise AssertionError(f"round {lr.round}: loop {field} "
                                     f"{getattr(lr, field)} vs engine "
                                     f"{getattr(er, field)}")
    first, unequal, ties = mask_agreement(eng.history, eng_scores,
                                          loop_scores, MLP_N, leaves)
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(
        tree.leaves(loop.global_params), tree.leaves(eng.global_params)))
    acc = [(lr.metrics["accuracy"], er.metrics["accuracy"])
           for lr, er in zip(loop.history, eng.history)]
    if first is None and (diff != 0.0 or any(a != b for a, b in acc)
                          or [r.mean_loss for r in loop.history]
                          != [r.mean_loss for r in eng.history]):
        raise AssertionError(f"the masks agree in every round but the "
                             f"loop's params differ by {diff} or its "
                             f"accuracies {acc}")
    steady = lambda res: float(np.median(  # noqa: E731
        [r.host_wall_time for r in res.history[1:]]))
    agree = ("agree in every round" if first is None else
             f"differ from round {first} ({ties} near-tie channels)")
    print(f"  loop: {wall:.2f} s, launches {counts}, merges {merged}; "
          f"epsilon {['%.3e' % e for e in eps]}; masks {agree}"
          f" ({unequal} of {len(loop_scores)} client-leaf scores not "
          f"bit-equal); params vs engine max |diff| {diff}; host s per "
          f"steady round loop {steady(loop):.4f}, engine "
          f"{steady(eng):.4f}", flush=True)
    return dict(launches=counts, sparse_agg_modes=modes,
                merge_leaf_counts=merged, wall_s=wall, epsilon=eps,
                masks_differ_from_round=first, scores_not_bit_equal=unequal,
                near_tie_channels=ties, params_max_abs_diff=diff,
                accuracy_loop_engine=acc, steady_host_s=steady(loop),
                steady_host_s_engine=steady(eng))


def baselines_phase(dev="cuda") -> dict:
    """FedCS and Oort on the engine, BASELINE_ROUNDS rounds each of the
    quickstart configuration, counts set to 0 just before and read just
    after: fewer than all clients participate, the uploaded fraction stays
    within A_server, and the dense path launches sparse_agg (mean mode)
    and neither importance nor masked_merge."""
    from repro_torch import kernels
    from repro_torch.core.protocol import run_scheme
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.quickstart import FEDDD_H, setup

    params, tel, ltf, ef = setup(MLP_N, dev)
    out = {}
    for scheme in ("fedcs", "oort"):
        kernels.reset_launch_counts()
        res = run_scheme(scheme, params, tel, ltf, ef,
                         rounds=BASELINE_ROUNDS, a_server=A_SERVER,
                         h=FEDDD_H, device=dev)
        counts = kernels.launch_counts()
        modes = agg_ops.mode_counts()
        for r in res.history:
            if not (r.participants < MLP_N
                    and r.uploaded_fraction <= A_SERVER + 1e-9
                    and math.isfinite(r.mean_loss)):
                raise AssertionError(f"{scheme} round {r.round}: "
                                     f"{r.participants} participants, "
                                     f"uploaded {r.uploaded_fraction}")
        agg = 6 * BASELINE_ROUNDS
        if (counts != dict(importance=0, sparse_agg=agg, masked_merge=0,
                           flash_attention=0, conv=0)
                or modes != {"partials": 0, "mean": agg}):
            raise AssertionError(f"{scheme} launches {counts}, {modes}")
        print(f"  {scheme}: participants "
              f"{[r.participants for r in res.history]}, uploaded "
              f"{[round(r.uploaded_fraction, 4) for r in res.history]}, "
              f"accuracy {res.history[-1].metrics['accuracy']:.4f}, "
              f"launches {counts}", flush=True)
        out[scheme] = dict(
            launches=counts, participants=[r.participants
                                           for r in res.history],
            uploaded_fraction=[r.uploaded_fraction for r in res.history],
            accuracy=res.history[-1].metrics["accuracy"])
    return out


def _record_fields(rec) -> dict:
    d = dataclasses.asdict(rec)
    d.pop("host_wall_time")
    d["dropout_rates"] = d["dropout_rates"].tolist()
    return d


def obs_phase(dev="cuda") -> dict:
    """The default-comm FedDD run (OBS_ROUNDS rounds on the engine) with
    obs off and with a JSONL log (trace off), under
    ``torch.cuda.set_sync_debug_mode("warn")`` after a one-round warm-up
    under it: the same number of synchronising CUDA calls, equal histories (all but host_wall_time) and
    parameters bit for bit, and a log that loads back to the history
    exactly.  Prints each phase's span median over rounds 2..OBS_ROUNDS and
    the report's phase section."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.obs import ObsConfig, load_history, read_events, report
    from repro_torch.quickstart import run

    log = ROOT / "build" / "obs_run.jsonl"      # git-ignored, like the kernels
    log.parent.mkdir(parents=True, exist_ok=True)
    cuda = torch.device(dev).type == "cuda"
    runs, syncs = {}, {}
    # a one-round warm-up under the debug mode, not counted: the first
    # synchronising call the mode sees in a process (a torch-internal one)
    # would land in whichever run came first
    for name, cfg, rounds in (("warm-up", ObsConfig(), 1),
                              ("off", ObsConfig(), OBS_ROUNDS),
                              ("on", ObsConfig(jsonl_path=str(log)),
                               OBS_ROUNDS)):
        _sync(dev)
        counted = {}
        with _count_syncs(counted, dev):
            runs[name], _, _ = run(rounds, fedavg_rounds=0, obs=cfg,
                                   device=dev)
        syncs[name] = counted["syncs"]
    syncs.pop("warm-up")
    if (cuda and not syncs["off"]) or syncs["on"] != syncs["off"]:
        raise AssertionError(f"synchronising CUDA calls: obs off "
                             f"{syncs['off']}, on {syncs['on']}")
    on, off = runs["on"], runs["off"]
    if [_record_fields(r) for r in on.history] != [
            _record_fields(r) for r in off.history]:
        raise AssertionError("obs changed the round records")
    if not all(torch.equal(a, b) for a, b in zip(
            tree.leaves(on.global_params), tree.leaves(off.global_params))):
        raise AssertionError("obs changed the parameters")
    exact = lambda rec: dataclasses.asdict(rec) | {        # noqa: E731
        "dropout_rates": rec.dropout_rates.tolist()}
    if [exact(r) for r in load_history(str(log))] != [exact(r)
                                                      for r in on.history]:
        raise AssertionError("the JSONL log does not load back to the "
                             "history")
    events = read_events(str(log))
    spans = [e for e in events if e["event"] == "span"]
    evals = [e for e in spans if e["name"] == "eval"]    # one a round
    medians = {}
    for name in OBS_PHASES:
        durs = ([e["dur_s"] for e in evals[1:]] if name == "eval" else
                [e["dur_s"] for e in spans
                 if e["name"] == name and e["round"] >= 2])
        medians[name] = 1e3 * statistics.median(durs)
    host = [r.host_wall_time for r in on.history[1:]]
    print(f"  obs: synchronising CUDA calls off {syncs['off']} / on "
          f"{syncs['on']}; records, params and the JSONL round trip equal; "
          f"span medians over rounds 2-{OBS_ROUNDS} (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in medians.items())
          + f"; host s per round median {statistics.median(host):.4f}",
          flush=True)
    text = report.render(events)
    section = text[text.index("Phase breakdown"):]
    print("\n".join("  " + ln for ln in
                    section[:section.index("\n\n")].splitlines()),
          flush=True)
    return dict(syncs=syncs, span_medians_ms=medians,
                steady_host_s=float(np.median(host)),
                spans_total_ms_median=sum(medians.values()),
                log=str(log.relative_to(ROOT)))


def _scan_setup(dev, spec=None, clients=MLP_N):
    """The scan phase's configuration: the paper's MLP from PRNGKey(0),
    synthetic MNIST 6000/1500 over ``clients`` IID clients (equal shards,
    so the clients stack), the quickstart's telemetry, and a per-client
    step of one epoch of in-order minibatch SGD (SCAN_STEPS steps of
    SCAN_BATCH, lr SCAN_LR, the mean minibatch loss) vmapped by
    ``make_batched_train_fn`` -> (params, tel, batched_train_fn, eval_fn).
    """
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import prng, tree
    from repro_torch.core.round_engine import make_batched_train_fn
    from repro_torch.data import (label_coverage_score, make_dataset,
                                  partition_iid)
    from repro_torch.fl import (MLP_SPEC, apply_spec, init_cnn_spec,
                                make_eval_fn, model_bytes,
                                sample_system_telemetry)

    train, test = make_dataset("mnist", num_train=6000, num_test=1500)
    parts = partition_iid(train, clients, seed=0)
    params = init_cnn_spec(MLP_SPEC, prng.PRNGKey(0), device=dev)
    tel = sample_system_telemetry(
        clients, [model_bytes(params)] * clients, [len(p) for p in parts],
        [label_coverage_score(train, p) for p in parts], seed=0)
    xs = torch.from_numpy(np.stack([train.x[p].reshape(len(p), -1)
                                    for p in parts])).to(dev)
    ys = torch.from_numpy(np.stack([train.y[p] for p in parts])
                          .astype(np.int64)).to(dev)
    steps = torch.full((), float(SCAN_STEPS), device=dev)

    def loss(p, x, y):
        return F.cross_entropy(apply_spec(p, MLP_SPEC, x), y)

    def client_epoch(p, x, y):
        total = 0.0
        for s in range(0, SCAN_STEPS * SCAN_BATCH, SCAN_BATCH):
            g, l = torch.func.grad_and_value(loss)(
                p, x[s:s + SCAN_BATCH], y[s:s + SCAN_BATCH])
            p = tree.tree_map(lambda w, gw: w - SCAN_LR * gw, p, g)
            total = total + l
        return p, total / steps

    ef = make_eval_fn(MLP_SPEC, test, flatten=True, device=dev)
    return params, tel, make_batched_train_fn(client_epoch, (xs, ys)), ef


def _fleet_setup(dev, n=None, shard=None):
    """The reference benchmark's fleet (``benchmarks/perf_federated.py``
    ``make_setup``): spec 64-128-64-10, ``n`` clients (FLEET_CLIENTS) with
    ``shard`` (FLEET_SHARD) seeded normal samples each, one full-shard SGD
    step at lr 0.05 a round."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import prng, tree
    from repro_torch.core.round_engine import make_batched_train_fn
    from repro_torch.fl import (apply_spec, init_cnn_spec, model_bytes,
                                sample_system_telemetry)

    rng = np.random.default_rng(0)
    n = FLEET_CLIENTS if n is None else n
    shard = FLEET_SHARD if shard is None else shard
    xs = torch.from_numpy(rng.normal(size=(n, shard, 64))
                          .astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 10, (n, shard))).to(dev)
    params = init_cnn_spec(FLEET_SPEC, prng.PRNGKey(0), device=dev)
    tel = sample_system_telemetry(n, [model_bytes(params)] * n,
                                  [shard] * n, [1.0] * n, seed=0)

    def step(p, x, y):
        g, l = torch.func.grad_and_value(
            lambda q: F.cross_entropy(apply_spec(q, FLEET_SPEC, x), y))(p)
        return tree.tree_map(lambda w, gw: w - 0.05 * gw, p, g), l

    return params, tel, make_batched_train_fn(step, (xs, ys))


@contextlib.contextmanager
def _count_syncs(out: dict, dev):
    """Count the synchronising CUDA calls of the block under
    ``torch.cuda.set_sync_debug_mode("warn")`` into ``out["syncs"]``, by
    the Python line that made each (``out["where"]``)."""
    import collections
    import warnings

    import torch
    cuda = torch.device(dev).type == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    out["syncs"] = len(hits)
    out["where"] = dict(collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in hits).most_common())


def scan_phase(dev="cuda") -> dict:
    """The fused and scanned FedDD paths on the card (``batched_train_fn``,
    ``rounds_per_dispatch``, ``allocator="jax"``), counts set to 0 just
    before each run and read just after:

    (a) FedDD, SCAN_ROUNDS rounds, per-round fused (K = 1), scanned
        K = 5 and K = 4 (chunks 4/4/2): records, global and client params
        bit-equal; importance 60, sparse_agg 60 (mean mode), masked_merge
        8 ({6: 8}) in each; accuracy >= SCAN_MIN_ACC on the 1500 test
        samples;
    (b) FedAvg, FedCS and Oort, SCAN_BASELINE_ROUNDS rounds, K = 4
        against K = 1, bit-equal (Oort leaves a client out);
    (c) robust_agg "trimmed:0.2" and "clip:2.0", K = 5 against K = 1,
        bit-equal; clip launches sparse_agg's partials mode;
    (d) CommConfig(auto, 8), K = 5 against K = 1, bit-equal;
    (e) synchronising CUDA calls: none inside ``BatchedRoundEngine.run``
        for a K = 5 chunk (after an uncounted warm-up chunk); a whole run
        of K = 1 and of K = 5 counted beside it, by the line making each;
    (f) printed only: host s per steady round (K = 1 numpy, K = 1 "jax",
        K = 5), the ``allocate`` span of each allocator, the device ops
        and time of one "jax" solve, and the reference benchmark's
        64-client fleet per-round fused against scanned K = 8 in
        rounds/s.
    """
    import numpy as np
    import torch
    from repro_torch import kernels, prng, tree
    from repro_torch.comm import CommConfig
    from repro_torch.core import allocation, round_engine
    from repro_torch.core.protocol import FedDDServer, ProtocolConfig
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.obs import ObsConfig, read_events
    from repro_torch.quickstart import FEDDD_H

    t_phase = time.perf_counter()
    params, tel, bt, ef = _scan_setup(dev)
    base = dict(a_server=A_SERVER, h=FEDDD_H, seed=0, allocator="jax")

    def drive(rounds, k=1, obs=None, fleet=None, syncs=None, **kw):
        """One run, counted: (server, result, launches, modes, merges);
        with ``syncs`` (a dict) its synchronising calls go there too."""
        p, t, b = fleet or (params, tel, bt)
        cfg = ProtocolConfig(rounds=rounds, rounds_per_dispatch=k,
                             **{**base, **kw},
                             **({} if obs is None else dict(obs=obs)))
        srv = FedDDServer(p, cfg, t, device=dev)
        _sync(dev)
        kernels.reset_launch_counts()
        with (contextlib.nullcontext() if syncs is None
              else _count_syncs(syncs, dev)):
            res = srv.run(batched_train_fn=b)
        counts = kernels.launch_counts()
        return (srv, res, counts, agg_ops.mode_counts(),
                merge_ops.leaf_counts())

    def same(a, b, what):
        (sa, ra), (sb, rb) = a[:2], b[:2]
        if [_record_fields(r) for r in ra.history] != [
                _record_fields(r) for r in rb.history]:
            raise AssertionError(f"{what}: records differ")
        if not all(torch.equal(x, y) for x, y in zip(
                tree.leaves(ra.global_params),
                tree.leaves(rb.global_params))):
            raise AssertionError(f"{what}: global params differ")
        if not all(torch.equal(x, y) for ca, cb in zip(sa.clients,
                                                       sb.clients)
                   for x, y in zip(tree.leaves(ca.params),
                                   tree.leaves(cb.params))):
            raise AssertionError(f"{what}: client params differ")

    out = {}
    # (a) FedDD, K = 1 / 5 / 4
    runs = {k: drive(SCAN_ROUNDS, k) for k in (1, 5, 4)}
    partial = sum(t % FEDDD_H != 0 for t in range(1, SCAN_ROUNDS + 1))
    want = dict(importance=6 * SCAN_ROUNDS, sparse_agg=6 * SCAN_ROUNDS,
                masked_merge=partial, flash_attention=0, conv=0)
    for k, r in runs.items():
        if (r[2] != want or r[3] != {"partials": 0, "mean": 6 * SCAN_ROUNDS}
                or r[4] != {6: partial}):
            raise AssertionError(f"feddd K={k}: launches {r[2]}, {r[3]}, "
                                 f"{r[4]}; want {want}")
        if k != 1:
            same(runs[1], r, f"feddd K={k} vs K=1")
    acc = ef(runs[5][1].global_params)["accuracy"]
    if acc < SCAN_MIN_ACC:
        raise AssertionError(f"scanned accuracy {acc} < {SCAN_MIN_ACC}")
    hist = runs[5][1].history
    print(f"  scan (a) feddd {SCAN_ROUNDS} rounds: K=1, K=5, K=4 "
          f"bit-equal; launches {runs[5][2]}, {runs[5][3]}, merges "
          f"{runs[5][4]}; accuracy {acc:.4f}; uploaded "
          f"{[round(r.uploaded_fraction, 4) for r in hist]}", flush=True)
    out["feddd"] = dict(launches={k: r[2] for k, r in runs.items()},
                        accuracy=acc, sparse_agg_modes=runs[5][3],
                        merge_leaf_counts=runs[5][4],
                        loss=[r.mean_loss for r in hist])

    # (b) the baselines, K = 4 against K = 1
    out["baselines"] = {}
    for scheme in ("fedavg", "fedcs", "oort"):
        a = drive(SCAN_BASELINE_ROUNDS, 1, scheme=scheme)
        b = drive(SCAN_BASELINE_ROUNDS, 4, scheme=scheme)
        same(a, b, f"{scheme} K=4 vs K=1")
        part = [r.participants for r in b[1].history]
        if scheme == "oort" and min(part) >= MLP_N:
            raise AssertionError(f"oort kept every client: {part}")
        if b[2]["importance"] or b[2]["masked_merge"]:
            raise AssertionError(f"{scheme} launched {b[2]}")
        out["baselines"][scheme] = dict(participants=part,
                                        launches=b[2])
    print(f"  scan (b) fedavg/fedcs/oort K=4 vs K=1 bit-equal; "
          f"participants " + ", ".join(
              f"{s} {v['participants']}"
              for s, v in out["baselines"].items()), flush=True)

    # (c) robust Eq. (4), (d) the wire format: K = 5 against K = 1
    out["variants"] = {}
    for name, kw in (("trimmed:0.2", dict(robust_agg="trimmed:0.2")),
                     ("clip:2.0", dict(robust_agg="clip:2.0")),
                     ("auto/8", dict(comm=CommConfig("auto", 8)))):
        a = drive(SCAN_VARIANT_ROUNDS, 1, **kw)
        b = drive(SCAN_VARIANT_ROUNDS, 5, **kw)
        same(a, b, f"{name} K=5 vs K=1")
        clip = name.startswith("clip")
        if (b[3]["partials"] > 0) != clip or a[3] != b[3]:
            raise AssertionError(f"{name}: sparse_agg modes {a[3]} / {b[3]}")
        if name == "auto/8" and not all(
                r.wire_bytes < r.uploaded_bytes for r in b[1].history[1:]):
            raise AssertionError("auto/8: wire bytes not under the raw")
        out["variants"][name] = dict(launches=b[2], modes=b[3],
                                     wire_bytes=[r.wire_bytes
                                                 for r in b[1].history])
    print("  scan (c, d) trimmed:0.2, clip:2.0, auto/8 K=5 vs K=1 "
          "bit-equal; sparse_agg modes " + ", ".join(
              f"{k} {v['modes']}" for k, v in out["variants"].items()),
          flush=True)

    # (e) synchronising calls
    scan_tel = round_engine.ScanTelemetry.from_host(tel, dev)
    weights = allocation.stage(tel.num_samples, dev)
    n = tel.num_clients
    state = round_engine.ScanState(
        round_engine.stack_pytrees([params] * n),
        tree.tree_map(torch.clone, params),
        torch.ones(n, device=dev), torch.zeros(n, device=dev),
        prng.PRNGKey(0), torch.zeros((), device=dev))
    engine = round_engine.BatchedRoundEngine()
    kw = dict(num_rounds=5, batched_train_fn=bt, weights=weights,
              h=FEDDD_H, a_server=A_SERVER, d_max=0.8, delta=1.0,
              global_model_bytes=float(tel.model_bytes[0]))
    chunk = {}
    with _count_syncs({}, dev):                        # warm-up, uncounted
        state, _ = engine.run(state, scan_tel, t_start=1, **kw)
    _sync(dev)
    with _count_syncs(chunk, dev):
        state, trace = engine.run(state, scan_tel, t_start=6, **kw)
    host = trace.to_host()                 # the fetch, after the return
    if chunk["syncs"] or not np.isfinite(host.losses).all():
        raise AssertionError(f"BatchedRoundEngine.run made {chunk['syncs']}"
                             f" synchronising calls: {chunk['where']}")
    whole = {1: {}, 5: {}}
    for k, counted in whole.items():
        drive(SCAN_ROUNDS, k, syncs=counted)
    print(f"  scan (e) synchronising calls: BatchedRoundEngine.run (K=5) "
          f"{chunk['syncs']}; a whole {SCAN_ROUNDS}-round run K=1 "
          f"{whole[1]['syncs']} {whole[1]['where']}, K=5 "
          f"{whole[5]['syncs']} {whole[5]['where']}", flush=True)
    out["syncs"] = dict(chunk=chunk, whole_k1=whole[1], whole_k5=whole[5])

    # (f) printed only
    logs = {}
    steady = {}
    for name, k, alloc in (("K=1 numpy", 1, "numpy"), ("K=1 jax", 1, "jax"),
                           ("K=5", 5, "jax")):
        log = ROOT / "build" / f"scan_{k}_{alloc}.jsonl"
        log.parent.mkdir(parents=True, exist_ok=True)
        r = drive(SCAN_ROUNDS, k, obs=ObsConfig(jsonl_path=str(log)),
                  allocator=alloc)
        steady[name] = statistics.median(
            x.host_wall_time for x in r[1].history[1:])
        logs[name] = read_events(str(log))
    spans = {name: {ph: 1e3 * statistics.median(durs) for ph, durs in (
        (ph, [e["dur_s"] / (5 if ph == "chunk_dispatch" else 1)
              for e in events if e["event"] == "span" and e["name"] == ph
              and e["round"] >= 2]) for ph in SCAN_SPANS) if durs}
        for name, events in logs.items()}
    alloc_ms = {name: spans[name]["allocate"]
                for name in ("K=1 numpy", "K=1 jax")}
    solve_in = [*scan_tel, torch.rand(n, device=dev) + 0.5]
    akw = dict(a_server=A_SERVER, d_max=0.8, delta=1.0,
               global_model_bytes=float(tel.model_bytes[0]), num_iters=96)
    solve_ms = []
    for _ in range(6):
        _sync(dev)
        t0 = time.perf_counter()
        allocation.solve_dropout_rates_torch(*solve_in, **akw)
        _sync(dev)
        solve_ms.append(1e3 * (time.perf_counter() - t0))
    ops = _profile_ops(lambda: allocation.solve_dropout_rates_torch(
        *solve_in, **akw), dev)
    round_ops = _profile_ops(lambda: engine.run(state, scan_tel, t_start=11,
                                                **{**kw, "num_rounds": 1}),
                             dev)
    fleet = _fleet_setup(dev)
    rps = {}
    for name, k in (("fused", 1), ("scanned K=8", FLEET_K)):
        drive(FLEET_ROUNDS, k, fleet=fleet)                    # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        r = drive(FLEET_ROUNDS, k, fleet=fleet)
        _sync(dev)
        rps[name] = FLEET_ROUNDS / (time.perf_counter() - t0)
        rps[name + " params"] = r[1].global_params
    fleet_equal = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(rps.pop("fused params")),
        tree.leaves(rps.pop("scanned K=8 params"))))
    print(f"  scan (f) host s per steady round (median of rounds 2-"
          f"{SCAN_ROUNDS}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in steady.items())
          + "; span medians ms (chunk_dispatch per round): " + "; ".join(
              f"{k}: " + ", ".join(f"{ph} {v:.3f}" for ph, v in d.items())
              for k, d in spans.items())
          + f"; one scanned round: {round_ops['cuda_ops']} device ops, "
          f"{round_ops['cpu_ops']} top-level aten ops"
          + f"; one jax solve: {ops['cuda_ops']} device ops, "
          f"{ops['cpu_ops']} top-level aten ops, median "
          f"{statistics.median(solve_ms[1:]):.3f} ms; fleet "
          f"{FLEET_CLIENTS} clients x {FLEET_SHARD} (64-128-64-10), "
          f"{FLEET_ROUNDS} rounds: " + ", ".join(
              f"{k} {v:.2f} rounds/s" for k, v in rps.items())
          + f" (params equal: {fleet_equal}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    out.update(steady_host_s=steady, allocate_span_ms=alloc_ms,
               span_medians_ms=spans, scanned_round_ops=round_ops,
               solve=dict(ms=solve_ms, **ops), fleet_rounds_per_s=rps,
               fleet_params_equal=fleet_equal,
               wall_s=time.perf_counter() - t_phase)
    return out


@contextlib.contextmanager
def recorded_masks(out: list):
    """Append (scores, mask) copies of every top-k selection the path
    makes to ``out``, in call order: the grouped engine's (n_g, C) rows a
    group and leaf, the loop's (C,) a client and leaf."""
    from repro_torch.core import selection
    real = selection.mask_from_scores

    def recording(scores, keep, num_channels):
        mask = real(scores, keep, num_channels)
        out.append((scores.clone(), mask.clone()))
        return mask

    selection.mask_from_scores = recording
    try:
        yield out
    finally:
        selection.mask_from_scores = real


def _grouped_vs_loop(grouped_sel, loop_sel, groups, rounds, leaves) -> int:
    """Each client's scores and masks of every round and leaf, grouped
    against loop, bit for bit -> the client-leaf selections compared."""
    import torch
    n = sum(len(g.indices) for g in groups)
    per_round_g = len(groups) * leaves
    compared = 0
    for r in range(rounds):
        for gi, g in enumerate(groups):
            for leaf in range(leaves):
                gs, gm = grouped_sel[r * per_round_g + gi * leaves + leaf]
                for pos, i in enumerate(g.indices):
                    ls, lm = loop_sel[(r * n + i) * leaves + leaf]
                    if not (torch.equal(gs[pos], ls)
                            and torch.equal(gm[pos], lm)):
                        raise AssertionError(
                            f"round {r + 1} client {i} leaf {leaf}: grouped "
                            f"scores or mask differ from the loop's")
                    compared += 1
    return compared


def _same_run(a, b, what) -> None:
    """Records (all but host_wall_time), global and client params equal."""
    import torch
    from repro_torch import tree
    (sa, ra), (sb, rb) = a, b
    for x, y in zip(ra.history, rb.history):
        fx, fy = _record_fields(x), _record_fields(y)
        if fx != fy:
            raise AssertionError(f"{what}: round {x.round} records differ "
                                 f"in {[k for k in fx if fx[k] != fy[k]]}")
    if not all(torch.equal(x, y) for x, y in zip(
            tree.leaves(ra.global_params), tree.leaves(rb.global_params))):
        raise AssertionError(f"{what}: global params differ")
    if not all(torch.equal(x, y) for ca, cb in zip(sa.clients, sb.clients)
               for x, y in zip(tree.leaves(ca.params),
                               tree.leaves(cb.params))):
        raise AssertionError(f"{what}: client params differ")


def _perf_fleet(dev, n=HETERO_PERF_CLIENTS, shard=32, seed=0):
    """The reference benchmark's ragged perf fleet
    (``benchmarks/heterogeneous.py`` ``make_perf_setup``): n clients
    cycling the widths 128/96/64 of a 64-w-64-10 MLP, ``shard`` seeded
    normal samples each, one full-shard SGD step at lr 0.05 a round ->
    (global, clients, telemetry, local_train_fn)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import prng, tree
    from repro_torch.fl import (apply_spec, init_cnn_spec, model_bytes,
                                sample_system_telemetry)
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(n, shard, 64))
                          .astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 10, size=(n, shard))).to(dev)
    spec = {w: [("fc", 64, w), ("fc", w, 64), ("fc", 64, 10)]
            for w in HETERO_PERF_WIDTHS}
    widths = [HETERO_PERF_WIDTHS[i % len(HETERO_PERF_WIDTHS)]
              for i in range(n)]
    clients = [init_cnn_spec(spec[w], prng.PRNGKey(100 + i), device=dev)
               for i, w in enumerate(widths)]
    gp = init_cnn_spec(spec[max(HETERO_PERF_WIDTHS)], prng.PRNGKey(seed),
                       device=dev)
    tel = sample_system_telemetry(n, [model_bytes(p) for p in clients],
                                  [shard] * n, [1.0] * n, seed=seed)

    def local_train(p, idx, key):
        leaves, td = tree.flatten(p)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss = F.cross_entropy(apply_spec(tree.unflatten(td, leaves),
                                          spec[widths[idx]], xs[idx]),
                               ys[idx])
        grads = torch.autograd.grad(loss, leaves)
        return (tree.unflatten(td, [(l - 0.05 * g).detach()
                                    for l, g in zip(leaves, grads)]),
                float(loss.detach()))

    return gp, clients, tel, local_train


def grouped_phase(dev="cuda") -> dict:
    """The shape-grouped engine for ragged fleets (the paper's §6.4
    model-heterogeneous run), counts set to 0 just before each run and
    read just after:

    (a) the example's configuration (``python -m repro_torch.heterogeneous``:
        the five Table 3 hetero-a VGG sub-models at full width, synthetic
        CIFAR-10 3000/800 Non-IID-a, lr 0.05, A_server 0.6, h 5),
        HETERO_ROUNDS rounds on the grouped engine and on the per-client
        loop: every client's scores and masks, the records, global and
        client params bit-equal; launches as predicted (importance all
        with the coverage division; sparse_agg elementwise at the rank-2+
        leaves); accuracy, uploads and host s per steady round printed;
    (b) HETERO_FLEET clients cycling the five specs (4 a group), 6000
        train samples, HETERO_FLEET_ROUNDS rounds, grouped against loop,
        bit-equal, launches as predicted;
    (c) the reference benchmark's ragged 64-client MLP fleet: rounds/s of
        the grouped engine against the loop (params equal), printed;
    (d) synchronising CUDA calls inside ``GroupedRoundEngine.step`` with
        staged inputs (after an uncounted warm-up step): none expected.
    """
    import numpy as np
    import torch
    from repro_torch import kernels, prng, tree
    from repro_torch.core import coverage as cov_mod
    from repro_torch.core import round_engine
    from repro_torch.fl.heterogeneity import group_by_shape
    from repro_torch.heterogeneous import H, server_for, setup
    from repro_torch.kernels.importance import ops as imp_ops
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.obs import ObsConfig, read_events

    t_phase = time.perf_counter()

    def drive(fleet, rounds, loop, eval_fn=None, record=None, log=None):
        gp, clients, tel, ltf = fleet
        srv = server_for(gp, clients, tel, rounds=rounds, loop=loop,
                         device=dev, **({} if log is None else dict(
                             obs=ObsConfig(jsonl_path=str(log)))))
        _sync(dev)
        kernels.reset_launch_counts()
        with (recorded_masks(record) if record is not None
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            res = srv.run(ltf, eval_fn)
            _sync(dev)
            wall = time.perf_counter() - t0
        return dict(srv=srv, res=res, wall=wall,
                    launches=kernels.launch_counts(),
                    importance=imp_ops.route_counts(),
                    sparse_agg=agg_ops.route_counts(),
                    merges=merge_ops.leaf_counts())

    def want_launches(groups, n, leaves, rounds, loop, partial):
        return dict(importance=leaves * rounds * (n if loop else groups),
                    sparse_agg=leaves * rounds,
                    masked_merge=(n if loop else groups) * partial,
                    flash_attention=0, conv=0)

    out = {}
    for name, clients_n, rounds, num_train in (
            ("a", 5, HETERO_ROUNDS, 3000),
            ("b", HETERO_FLEET, HETERO_FLEET_ROUNDS, 6000)):
        gp, clients, tel, ltf, ef = setup(clients_n, num_train=num_train,
                                          num_test=800, device=dev)
        fleet = (gp, clients, tel, ltf)
        sel, runs, spans = {}, {}, {}
        for mode, loop in (("grouped", False), ("loop", True)):
            sel[mode] = []
            log = ROOT / "build" / f"grouped_{name}_{mode}.jsonl"
            log.parent.mkdir(parents=True, exist_ok=True)
            runs[mode] = drive(fleet, rounds, loop,
                               ef if name == "a" else None, sel[mode], log)
            durs = {}                   # each span once a round
            for e in read_events(str(log)):
                if e["event"] == "span":
                    durs.setdefault(e["name"], []).append(e["dur_s"])
            spans[mode] = {ph: 1e3 * statistics.median(d[1:])
                           for ph, d in durs.items() if len(d) > 1}
        g_srv = runs["grouped"]["srv"]
        if (g_srv.executor_kind, runs["loop"]["srv"].executor_kind) != (
                "grouped", "loop"):
            raise AssertionError(f"({name}) routed to "
                                 f"{g_srv.executor_kind}")
        _same_run((g_srv, runs["grouped"]["res"]),
                  (runs["loop"]["srv"], runs["loop"]["res"]),
                  f"grouped ({name}) vs loop")
        groups = group_by_shape([cs.params for cs in g_srv.clients])
        leaves = len(tree.leaves(gp))
        compared = _grouped_vs_loop(sel["grouped"], sel["loop"], groups,
                                    rounds, leaves)
        partial = sum(t % H != 0 for t in range(1, rounds + 1))
        elementwise = sum(l.ndim > 1 for l in tree.leaves(gp)) * rounds
        for mode, r in runs.items():
            want = want_launches(len(groups), clients_n, leaves, rounds,
                                 mode == "loop", partial)
            merges = {leaves: want["masked_merge"]} if partial else {}
            if (r["launches"] != want
                    or r["importance"] != {"plain": 0,
                                           "coverage": want["importance"]}
                    or r["sparse_agg"]["mean:elementwise"] != elementwise
                    or r["sparse_agg"]["mean"] != want["sparse_agg"]
                    - elementwise or r["merges"] != merges):
                raise AssertionError(
                    f"({name}) {mode} launches {r['launches']}, importance "
                    f"{r['importance']}, sparse_agg {r['sparse_agg']}, "
                    f"merges {r['merges']}; predicted {want}, "
                    f"{elementwise} elementwise")
        hist = runs["grouped"]["res"].history
        steady = {m: statistics.median(x.host_wall_time
                                       for x in r["res"].history[1:])
                  for m, r in runs.items()}
        acc = ([x.metrics["accuracy"] for x in hist]
               if name == "a" else None)
        print(f"  grouped ({name}) {clients_n} clients, {len(groups)} "
              f"groups, {rounds} rounds: grouped == loop bit for bit "
              f"({compared} client-leaf score/mask pairs); launches "
              f"grouped {runs['grouped']['launches']} (sparse_agg "
              f"{runs['grouped']['sparse_agg']}), loop "
              f"{runs['loop']['launches']}; importance with coverage "
              f"{runs['grouped']['importance']['coverage']}; accuracy "
              f"{acc}; uploaded "
              f"{[round(x.uploaded_fraction, 4) for x in hist]}; host s per "
              f"steady round grouped {steady['grouped']:.4f}, loop "
              f"{steady['loop']:.4f}; wall {runs['grouped']['wall']:.2f} / "
              f"{runs['loop']['wall']:.2f} s; span medians ms over rounds "
              f"2-{rounds}: " + "; ".join(
                  f"{m}: " + ", ".join(f"{ph} {v:.3f}" for ph, v in d.items())
                  for m, d in spans.items()), flush=True)
        out[name] = dict(
            clients=clients_n, groups=len(groups), rounds=rounds,
            launches={m: r["launches"] for m, r in runs.items()},
            importance_routes={m: r["importance"] for m, r in runs.items()},
            sparse_agg_routes={m: r["sparse_agg"] for m, r in runs.items()},
            merge_leaf_counts={m: r["merges"] for m, r in runs.items()},
            accuracy=acc,
            uploaded_fraction=[x.uploaded_fraction for x in hist],
            steady_host_s=steady, span_medians_ms=spans,
            wall_s={m: r["wall"] for m, r in runs.items()},
            selections_compared=compared)
        if name == "a":
            # (d) syncs inside GroupedRoundEngine.step, staged inputs
            fs = round_engine.GroupedFleetState(
                groups, [cov_mod.coverage_pytree(
                    g_srv.clients[g.indices[0]].params, g_srv.cr)
                    for g in groups],
                [cs.params for cs in g_srv.clients], g_srv.cfg.selection,
                clients_n)
            rk = prng.PRNGKey(3)
            fs.train(lambda p, i, k: (tree.tree_map(lambda l: l * 1.001, p),
                                      1.0), rk, np.ones(clients_n, bool),
                     np.ones(clients_n), np.full(clients_n, 0.4),
                     dense=False)
            weights = torch.as_tensor(tel.num_samples, dtype=torch.float32,
                                      device=dev)
            syncs = [{}, {}]
            for counted in syncs:
                _sync(dev)
                with _count_syncs(counted, dev):
                    fs.engine.step(fs.staged_batches,
                                   g_srv.global_params, weights, rk,
                                   full_round=False)
            _sync(dev)
            if syncs[1]["syncs"]:
                print(f"  grouped (d) GroupedRoundEngine.step made "
                      f"{syncs[1]['syncs']} synchronising calls: "
                      f"{syncs[1]['where']}", flush=True)
            else:
                print("  grouped (d) GroupedRoundEngine.step: 0 "
                      "synchronising calls", flush=True)
            out["step_syncs"] = syncs[1]
            del fs
        del fleet, runs, sel, clients, gp

    # (c) the reference benchmark's ragged MLP fleet, rounds/s
    fleet = _perf_fleet(dev)
    rps, final = {}, {}
    for mode, loop in (("loop", True), ("grouped", False)):
        drive(fleet, 5, loop)                                  # warm-up
        r = drive(fleet, HETERO_PERF_ROUNDS, loop)
        rps[mode] = HETERO_PERF_ROUNDS / r["wall"]
        final[mode] = r["res"].global_params
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(final["loop"]), tree.leaves(final["grouped"])))
    print(f"  grouped (c) {HETERO_PERF_CLIENTS} ragged clients "
          f"(64-{'/'.join(map(str, HETERO_PERF_WIDTHS))}-64-10), "
          f"{HETERO_PERF_ROUNDS} rounds: loop {rps['loop']:.2f}, grouped "
          f"{rps['grouped']:.2f} rounds/s ({rps['grouped'] / rps['loop']:.2f}"
          f"x; the reference's 3x target is not gated here); params equal: "
          f"{same}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    out["perf_fleet"] = dict(rounds_per_s=rps, params_equal=same,
                             speedup=rps["grouped"] / rps["loop"])
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def _launch_counts() -> dict:
    """Every counter of the three FedDD kernels since the last reset."""
    from repro_torch import kernels
    from repro_torch.kernels.importance import ops as imp_ops
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    return dict(launches=kernels.launch_counts(),
                importance=imp_ops.route_counts(),
                sparse_agg=agg_ops.route_counts(),
                merges=merge_ops.leaf_counts())


def _want_sim_launches(got: dict, steps: int, partial: int,
                       what: str) -> None:
    """A FedDD step per round: importance and sparse_agg (mean mode,
    channel masks) once a leaf, masked_merge once a partial round for all
    six leaves, no flash attention."""
    want = dict(importance=6 * steps, sparse_agg=6 * steps,
                masked_merge=partial, flash_attention=0, conv=0)
    routes = dict(importance={"plain": 6 * steps, "coverage": 0},
                  sparse_agg={"partials": 0, "mean": 6 * steps,
                              "partials:elementwise": 0,
                              "mean:elementwise": 0},
                  merges={6: partial} if partial else {})
    if got["launches"] != want or any(got[k] != v
                                      for k, v in routes.items()):
        raise AssertionError(f"{what}: launches {got}, expected {want} "
                             f"by route {routes}")


def _same_sim(a, b, what: str) -> None:
    """Event traces (kind, client, time), records and global params equal
    bit for bit."""
    import torch
    from repro_torch import tree
    if a.event_trace != b.event_trace:
        raise AssertionError(f"{what}: event traces differ")
    for x, y in zip(a.history, b.history):
        fx, fy = _record_fields(x), _record_fields(y)
        if fx != fy:
            raise AssertionError(f"{what}: round {x.round} records differ "
                                 f"in {[k for k in fx if fx[k] != fy[k]]}")
    if len(a.history) != len(b.history) or not all(
            torch.equal(x, y) for x, y in zip(tree.leaves(a.global_params),
                                              tree.leaves(b.global_params))):
        raise AssertionError(f"{what}: global params differ")


def sim_phase(dev="cuda") -> dict:
    """The event-driven simulator, the fault layer, population serving and
    crash-resume (``repro_torch.sim``, ``.population``, ``.checkpoint``) on
    the card, counts set to 0 just before each counted run and read just
    after:

    (a) the straggler demo (``python -m repro_torch.straggler_sim``: the
        paper's MLP at full width, synthetic MNIST 4000/1000 over 8
        non-IID clients, the Markov fading network, A_server 0.6, h 5):
        SIM_ROUNDS rounds of sync and deadline and SIM_ROUNDS * 4 async
        merges, each run twice (the same event trace and parameters bit
        for bit), launches as SIM_LAUNCHES, uploads within [0.55, 0.65]
        from round 2 under sync, the final ``sim_time`` in SIM_ORDER;
        host s per steady sync round and its span medians (a JSONL log in
        ``build/``) printed;
    (b) identities, bit for bit: sync over a static network against
        ``FedDDServer`` (the MLP; and the hetero-a VGG fleet for 2 rounds
        on the grouped wave fleet), a fleet-sized always-on population
        against the plain fleet, zero-rate faults against fault-free;
    (c) the fault-tolerance grid at rate 0.35 (crash 0.175, loss 0.35,
        corrupt 0.0875 mix, quorum 1/4, deadline with partial
        aggregation, 16 clients, the Markov network, FAULT_ROUNDS rounds):
        quarantines, retransmits and partial rescues each > 0, launches a
        step per committed round (``launches_sim``); a corrupted,
        quarantined client gives the params of that client's crash;
    (d) population serving: POP_SIZE clients, cohorts of POP_COHORT under
        Bernoulli availability, POP_ROUNDS rounds, rounds/s against a
        POP_COHORT-client fleet and the peak device memory printed, the
        sticky store (copies, not views) under POP_STORE_BYTES;
    (e) crash-resume: a subprocess runs the demo with faults, outages and
        ``checkpoint_every=RESUME_EVERY`` and kills itself with SIGKILL in
        round RESUME_KILL; a second one resumes from the snapshot and
        prints the uninterrupted run's digest.
    """
    import os
    import numpy as np
    import torch
    from repro_torch import kernels, sim, straggler_sim, tree
    from repro_torch import heterogeneous
    from repro_torch.core import aggregation, protocol
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.obs import ObsConfig, read_events
    from repro_torch.population import Population
    from repro_torch.sim import crash_resume

    t_phase = time.perf_counter()
    out = {}

    def counted(fn):
        _sync(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        return res, dict(_launch_counts(), wall=time.perf_counter() - t0)

    # ---- (a) the straggler demo under three policies
    params, tel, ltf, ef = straggler_sim.setup(SIM_CLIENTS, dev)

    def demo(policy, log=None, **kw):
        if log is not None:
            kw["obs"] = ObsConfig(jsonl_path=str(log))
        return sim.run_sim(
            "feddd", params, tel, ltf, None,
            sim=sim.SimConfig(policy=policy),
            network=straggler_sim.network(tel),
            rounds=straggler_sim.policy_rounds(policy, SIM_ROUNDS,
                                               SIM_CLIENTS),
            a_server=A_SERVER, h=5, seed=0, device=dev, **kw)

    a = {}
    log = ROOT / "build" / "sim_sync.jsonl"
    log.parent.mkdir(parents=True, exist_ok=True)
    for policy in SIM_POLICIES:
        res, cnt = counted(lambda: demo(
            policy, log if policy == "sync" else None))
        again = demo(policy)
        _same_sim(res, again, f"{policy} run twice")
        want = SIM_LAUNCHES[policy]
        steps = len(res.history)
        _want_sim_launches(cnt, steps, want["masked_merge"],
                           f"straggler demo, {policy}")
        if cnt["launches"]["importance"] != want["importance"]:
            raise AssertionError(f"{policy}: {cnt}")
        acc = ef(res.global_params)["accuracy"]
        a[policy] = dict(sim_time=res.history[-1].sim_time, steps=steps,
                         launches=cnt["launches"], wall_s=cnt["wall"],
                         accuracy=acc,
                         uploaded=[r.uploaded_fraction
                                   for r in res.history],
                         host_s=[r.host_wall_time for r in res.history])
    for r in a["sync"]["uploaded"][1:]:
        if not 0.55 <= r <= 0.65:
            raise AssertionError(f"sync uploaded {r} outside [0.55, 0.65]")
    order = tuple(sorted(a, key=lambda p: a[p]["sim_time"]))
    if order != SIM_ORDER:
        raise AssertionError(f"policies by final sim_time {order}, the "
                             f"CPU's {SIM_ORDER}")
    spans = [e for e in read_events(str(log)) if e["event"] == "span"]
    medians = {k: 1e3 * statistics.median(
        e["dur_s"] for e in spans if e["name"] == k and e["round"] >= 2)
        for k in SIM_SPANS}
    steady = statistics.median(a["sync"]["host_s"][1:])
    print("  sim (a): final sim_time " + ", ".join(
        f"{p} {a[p]['sim_time']:.1f} s ({a[p]['steps']} steps, acc "
        f"{a[p]['accuracy']:.3f}, {a[p]['wall_s']:.2f} s wall)"
        for p in SIM_POLICIES) + f"; order {order}; launches "
        + "; ".join(f"{p} {a[p]['launches']}" for p in SIM_POLICIES),
        flush=True)
    print(f"  sim (a): host s per steady sync round {steady:.4f}; span "
          "medians over rounds 2-10 (ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in medians.items()), flush=True)
    out["a"] = dict(policies=a, order=list(order), span_medians_ms=medians,
                    steady_host_s=steady, log=str(log.relative_to(ROOT)))

    # ---- (b) identities, bit for bit
    kw = dict(rounds=5, a_server=A_SERVER, h=5, seed=0, device=dev)
    ref = protocol.run_scheme("feddd", params, tel, ltf, None, **kw)
    got = sim.run_sim("feddd", params, tel, ltf, None,
                      sim=sim.SimConfig(policy="sync"), **kw)
    if [r.sim_time for r in ref.history] != [r.sim_time
                                             for r in got.history]:
        raise AssertionError("sync-static sim_time differs from the "
                             "protocol's Eq. (12) clock")
    if not all(torch.equal(x, y) for x, y in zip(
            tree.leaves(ref.global_params), tree.leaves(got.global_params))):
        raise AssertionError("sync-static sim params differ from the "
                             "protocol's")
    gp, clients, tel_h, ltf_h, _ = heterogeneous.setup(
        5, num_train=3000, num_test=800, device=dev)
    href = heterogeneous.server_for(gp, clients, tel_h, rounds=2,
                                    device=dev).run(ltf_h)
    hgot, hcnt = counted(lambda: sim.run_sim(
        "feddd", gp, tel_h, ltf_h, None, client_params=clients,
        sim=sim.SimConfig(policy="sync"), rounds=2, a_server=A_SERVER,
        h=heterogeneous.H, seed=0, device=dev))
    if [r.sim_time for r in href.history] != [r.sim_time
                                              for r in hgot.history] or \
            not all(torch.equal(x, y) for x, y in zip(
                tree.leaves(href.global_params),
                tree.leaves(hgot.global_params))):
        raise AssertionError("hetero-a sync-static sim differs from the "
                             "grouped protocol run")
    if hcnt["sparse_agg"]["mean:elementwise"] <= 0:
        raise AssertionError(f"the ragged sim did not run the grouped "
                             f"canvas: {hcnt}")
    plain = sim.run_sim("feddd", params, tel, ltf, None,
                        network=straggler_sim.network(tel), rounds=3,
                        a_server=A_SERVER, h=5, seed=0, device=dev)
    pop_id = sim.run_sim("feddd", params, tel, ltf, None,
                         network=straggler_sim.network(tel),
                         population=Population(tel), rounds=3,
                         a_server=A_SERVER, h=5, seed=0, device=dev)
    _same_sim(plain, pop_id, "fleet-sized always-on population")
    zero = sim.run_sim("feddd", params, tel, ltf, None,
                       network=straggler_sim.network(tel),
                       faults=sim.RandomFaults(), rounds=3,
                       a_server=A_SERVER, h=5, seed=0, device=dev)
    _same_sim(plain, zero, "zero-rate faults")
    print(f"  sim (b): sync-static == protocol (MLP, 5 rounds; hetero-a, 2 "
          f"rounds on the grouped wave fleet, launches {hcnt['launches']}, "
          f"sparse_agg {hcnt['sparse_agg']}); population of the fleet == "
          f"fleet; zero-rate faults == fault-free: all bit for bit",
          flush=True)
    out["b"] = dict(hetero_launches=hcnt["launches"],
                    hetero_sparse_agg=hcnt["sparse_agg"])
    del gp, clients, href, hgot

    # ---- (c) the fault-tolerance grid at rate 0.35
    p16, tel16, ltf16, _ = straggler_sim.setup(FAULT_CLIENTS, dev)
    flog = ROOT / "build" / "sim_faults.jsonl"
    cut_rows = []
    truncate = aggregation.truncate_masks_to_prefix

    def counting_truncate(masks, delivered):
        cut_rows.append(int((delivered[0] < np.iinfo(np.int32).max)
                            .sum()))
        return truncate(masks, delivered)

    aggregation.truncate_masks_to_prefix = counting_truncate
    try:
        fres, fcnt = counted(lambda: sim.run_sim(
            "feddd", p16, tel16, ltf16, None,
            sim=sim.SimConfig(policy=sim.DeadlinePolicy(partial=True)),
            network=straggler_sim.network(tel16),
            faults=sim.RandomFaults(**FAULT_KW), rounds=FAULT_ROUNDS,
            a_server=A_SERVER, h=5, seed=0, device=dev,
            obs=ObsConfig(jsonl_path=str(flog))))
    finally:
        aggregation.truncate_masks_to_prefix = truncate
    events = [e for e in read_events(str(flog)) if e["event"] == "fault"]
    kinds = collections.Counter(e["kind"] for e in events)
    counts = dict(quarantines=kinds["quarantine"],
                  retries=sum(r.retries for r in fres.history),
                  partial_rescues=sum(cut_rows), crashes=kinds["crash"],
                  aborts=kinds["abort"],
                  skipped=sum(r.skipped for r in fres.history))
    for k in ("quarantines", "retries", "partial_rescues"):
        if counts[k] <= 0:
            raise AssertionError(f"fault grid: no {k} in {FAULT_ROUNDS} "
                                 f"rounds: {counts}")
    steps = [r for r in fres.history if not r.skipped]
    _want_sim_launches(fcnt, len(steps),
                       sum(r.round % 5 != 0 for r in steps), "fault grid")
    for leaf in tree.leaves(fres.global_params):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("the fault grid's global is not finite")
    one = dict(rounds=1, a_server=A_SERVER, h=5, seed=0, device=dev,
               sim=sim.SimConfig(policy="sync"))
    corrupted = sim.run_sim("feddd", params, tel, ltf, None,
                            faults=sim.ScriptedFaults(
                                corrupt={(0, 0): "nan"}), **one)
    crashed = sim.run_sim("feddd", params, tel, ltf, None,
                          faults=sim.ScriptedFaults(crashes={(0, 0): 0.5}),
                          **one)
    if corrupted.history[0].participants != SIM_CLIENTS - 1 or not all(
            torch.equal(x, y) for x, y in zip(
                tree.leaves(corrupted.global_params),
                tree.leaves(crashed.global_params))):
        raise AssertionError("a corrupted, quarantined client is not the "
                             "same as its crash")
    print(f"  sim (c): fault grid over {FAULT_ROUNDS} rounds: {counts}; "
          f"launches {fcnt['launches']}; quarantine == crash bit for bit",
          flush=True)
    out["c"] = dict(counts=counts, launches=fcnt["launches"],
                    sparse_agg=fcnt["sparse_agg"], wall_s=fcnt["wall"],
                    log=str(flog.relative_to(ROOT)))

    # ---- (d) population serving: 100k clients, cohorts of 256
    ps, ptel, pltf, _ = straggler_sim.setup(POP_SHARDS, dev)

    def tiled(n):
        return dataclasses.replace(ptel, **{
            f.name: np.resize(np.asarray(getattr(ptel, f.name)), n)
            for f in dataclasses.fields(ptel)})

    def shard_ltf(p, gid, key):
        return pltf(p, int(gid) % POP_SHARDS, key)

    pkw = dict(sim=sim.SimConfig(policy="sync"), rounds=POP_ROUNDS,
               a_server=A_SERVER, h=3, seed=0, device=dev)
    _, fleet_cnt = counted(lambda: sim.run_sim(
        "feddd", ps, tiled(POP_COHORT), shard_ltf, None, **pkw))
    pop = Population(tiled(POP_SIZE), availability="bernoulli",
                     sampler="uniform", seed=7)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pres, pop_cnt = counted(lambda: sim.run_sim(
        "feddd", ps, tiled(POP_SIZE), shard_ltf, None, population=pop,
        cohort_size=POP_COHORT, **pkw))
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else 0)
    store = sum(l.numel() * l.element_size() for p in pop._params.values()
                for l in tree.leaves(p))
    for p in pop._params.values():
        for l in tree.leaves(p):
            if l.untyped_storage().nbytes() != l.numel() * l.element_size():
                raise AssertionError("the population store kept a view")
    served = int(pop.seen.sum())
    if not POP_COHORT < served <= POP_COHORT * POP_ROUNDS or \
            store > POP_STORE_BYTES:
        raise AssertionError(f"population: served {served}, store {store}")
    _want_sim_launches(pop_cnt, POP_ROUNDS,
                       sum(t % 3 != 0 for t in range(1, POP_ROUNDS + 1)),
                       "population")
    rps = {k: POP_ROUNDS / c["wall"] for k, c in (("fleet", fleet_cnt),
                                                  ("population", pop_cnt))}
    print(f"  sim (d): {POP_SIZE} clients, cohorts of {POP_COHORT}: "
          f"{rps['population']:.3f} rounds/s against the {POP_COHORT}-"
          f"client fleet's {rps['fleet']:.3f} (ratio "
          f"{rps['population'] / rps['fleet']:.3f}); served {served}; store "
          f"{store / 2**20:.1f} MiB; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    out["d"] = dict(rounds_per_s=rps, served=served, store_bytes=store,
                    peak_bytes=peak, launches=pop_cnt["launches"])
    del pop, pres

    # ---- (e) crash-resume across a SIGKILL
    ck = ROOT / "build" / "sim_resume.npz"
    for f in (ck, Path(str(ck) + ".meta")):
        if f.exists():
            f.unlink()
    rkw = dict(rounds=RESUME_ROUNDS, clients=SIM_CLIENTS,
               every=RESUME_EVERY, kill_round=RESUME_KILL)
    full = crash_resume.digest(crash_resume.run("full", str(ck), device=dev,
                                                **rkw))
    cmd = [sys.executable, "-m", "repro_torch.sim.crash_resume", None,
           str(ck), "--rounds", str(RESUME_ROUNDS), "--clients",
           str(SIM_CLIENTS), "--every", str(RESUME_EVERY), "--kill-round",
           str(RESUME_KILL), "--device", str(dev)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for mode in ("crash", "resume"):
        cmd[3] = mode
        procs[mode] = subprocess.run(cmd, capture_output=True, text=True,
                                     env=env, timeout=600, check=False)
        if mode == "crash":
            if procs[mode].returncode != -9:
                raise AssertionError(f"the crash run was not killed: rc "
                                     f"{procs[mode].returncode}\n"
                                     f"{procs[mode].stderr[-2000:]}")
            snap = ckpt_io.decode_meta(Path(str(ck) + ".meta")
                                       .read_bytes())["round"]
            if snap != RESUME_KILL - 1:
                raise AssertionError(f"last snapshot at round {snap}")
    resumed = procs["resume"]
    if resumed.returncode != 0 or resumed.stdout.strip() != full:
        raise AssertionError(f"resume digest {resumed.stdout.strip()!r} != "
                             f"{full!r}\n{resumed.stderr[-2000:]}")
    print(f"  sim (e): SIGKILL in round {RESUME_KILL} after the round-"
          f"{snap} snapshot; the resumed process's digest equals the "
          f"uninterrupted run's ({full[:16]}...)", flush=True)
    out["e"] = dict(digest=full, snapshot_round=snap)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  sim phase: {out['wall_s']:.1f} s", flush=True)
    return out



def quickstart_cli_phase(dev="cuda") -> dict:
    """The quickstart's command line (``repro_torch.quickstart.main``) on
    the card, launches counted per call (FedDD and FedAvg together):

    (a) ``--rounds 3`` of CLI_FAULTS with ``--checkpoint-dir``, then
        ``--rounds 5 --resume``, held bit for bit against an uninterrupted
        ``--rounds 5`` (every FedDD record field but host wall time, the
        global parameters);
    (b) the reference docstring's population command, CLI_POPULATION, for
        CLI_POP_ROUNDS rounds: host s per FedDD round, peak device memory.

    Each of (a) and (b) must launch importance, sparse_agg and
    masked_merge."""
    import shutil

    import torch
    from repro_torch import kernels, quickstart, tree

    def cli(argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        feddd, fedavg = quickstart.main(argv + ["--device", dev])
        _sync(dev)
        wall = time.perf_counter() - t0
        got = _launch_counts()
        for res in (feddd, fedavg):
            if not all(l.device.type == torch.device(dev).type
                       for l in tree.leaves(res.global_params)):
                raise AssertionError(f"{argv}: params left the card")
            if not all(math.isfinite(r.mean_loss) for r in res.history):
                raise AssertionError(f"{argv}: non-finite loss")
        return feddd, dict(got, wall=wall)

    def want_all(counts: list, what: str) -> dict:
        total = {k: sum(c["launches"][k] for c in counts)
                 for k in FEDDD_KERNELS}
        if not all(total.values()):
            raise AssertionError(f"quickstart_cli {what}: a FedDD kernel "
                                 f"never launched: {total}")
        return total

    t_phase = time.perf_counter()
    out = {}
    ck = ROOT / "build" / "quickstart_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    runs = {}
    for key, argv in (
            ("crash", ["--rounds", str(CLI_CRASH_ROUNDS), "--checkpoint-dir",
                       str(ck)]),
            ("resume", ["--rounds", str(CLI_ROUNDS), "--checkpoint-dir",
                        str(ck), "--resume"]),
            ("full", ["--rounds", str(CLI_ROUNDS)])):
        runs[key] = cli(CLI_FAULTS + argv)
    shutil.rmtree(ck, ignore_errors=True)
    (resumed, _), (full, _) = runs["resume"], runs["full"]
    if len(resumed.history) != CLI_ROUNDS:
        raise AssertionError(f"resumed run has {len(resumed.history)} "
                             "rounds")
    for x, y in zip(resumed.history, full.history):
        fx, fy = _record_fields(x), _record_fields(y)
        if fx != fy:
            raise AssertionError(
                f"quickstart_cli (a): round {x.round} differs in "
                f"{[k for k in fx if fx[k] != fy[k]]}")
    if not all(torch.equal(x, y) for x, y in zip(
            tree.leaves(resumed.global_params),
            tree.leaves(full.global_params))):
        raise AssertionError("quickstart_cli (a): resumed global params "
                             "differ")
    out["a"] = dict(
        launches=want_all([c for _, c in runs.values()], "(a)"),
        by_run={k: c["launches"] for k, (_, c) in runs.items()},
        sparse_agg={k: c["sparse_agg"] for k, (_, c) in runs.items()},
        wall_s={k: c["wall"] for k, (_, c) in runs.items()},
        survivors=[r.survivors for r in full.history],
        skipped=sum(r.skipped for r in full.history),
        retries=sum(r.retries for r in full.history),
        accuracy=full.history[-1].metrics["accuracy"])
    print(f"  quickstart_cli (a) {' '.join(CLI_FAULTS)}: "
          f"{CLI_CRASH_ROUNDS} rounds + resume to {CLI_ROUNDS} == "
          f"uninterrupted, bit for bit; survivors {out['a']['survivors']}, "
          f"retries {out['a']['retries']}; launches (crash / resume / full, "
          "FedDD + FedAvg) " + " / ".join(str(c["launches"])
                                          for _, c in runs.values())
          + "; sparse_agg by route (full) " + str(runs["full"][1][
              "sparse_agg"]) + "; wall s " + ", ".join(
              f"{c['wall']:.2f}" for _, c in runs.values()), flush=True)

    resident = _fresh_peak(dev)
    pop, pcnt = cli(CLI_POPULATION + ["--rounds", str(CLI_POP_ROUNDS)])
    peak = _peak_gb()
    host = [r.host_wall_time for r in pop.history]
    out["b"] = dict(launches=want_all([pcnt], "(b)"),
                    sparse_agg=pcnt["sparse_agg"], wall_s=pcnt["wall"],
                    host_s_per_round=host, peak_gib=peak,
                    resident_gib=resident,
                    accuracy=pop.history[-1].metrics["accuracy"])
    print(f"  quickstart_cli (b) {' '.join(CLI_POPULATION)} --rounds "
          f"{CLI_POP_ROUNDS}: host s per FedDD round "
          + ", ".join(f"{h:.3f}" for h in host)
          + f"; FedDD + FedAvg {pcnt['wall']:.2f} s; launches "
          f"{pcnt['launches']}; peak device memory {peak:.3f} GiB "
          f"({resident:.3f} resident before)", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  quickstart_cli phase: {out['wall_s']:.1f} s", flush=True)
    return out


@contextlib.contextmanager
def _step_densities(out: list):
    """Record the (N,) densities of every round engine step (the engine,
    the sharded engine and the grouped engine) into ``out``, on the
    device (a clone each: no sync)."""
    from repro_torch.core import round_engine as re_
    classes = (re_.BatchedRoundEngine, re_.ShardedRoundEngine,
               re_.GroupedRoundEngine)
    originals = {cls: cls.step for cls in classes}

    def wrap(f):
        def step(self, *a, **k):
            o = f(self, *a, **k)
            out.append(o.densities.clone())
            return o
        return step

    for cls, f in originals.items():
        cls.step = wrap(f)
    try:
        yield out
    finally:
        for cls, f in originals.items():
            cls.step = f


@contextlib.contextmanager
def _count_moves(out: dict):
    """Count ``Tensor.to`` calls whose result lies on another device than
    the tensor (a copy between devices) into ``out["moves"]``."""
    import torch
    orig = torch.Tensor.to
    out["moves"] = 0

    def to(self, *a, **k):
        r = orig(self, *a, **k)
        if isinstance(r, torch.Tensor) and r.device != self.device:
            out["moves"] += 1
        return r

    torch.Tensor.to = to
    try:
        yield out
    finally:
        torch.Tensor.to = orig


def _trees_within(a, b, tol: float, what: str) -> float:
    """Every leaf of ``a`` within rtol = atol = ``tol`` of ``b``; returns
    the largest absolute difference."""
    import torch
    from repro_torch import tree
    worst = 0.0
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol,
                                   msg=lambda m: f"{what}: {m}")
        worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst


def _same_trees(a, b, what: str) -> None:
    import torch
    from repro_torch import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb) or not all(torch.equal(x, y)
                                     for x, y in zip(la, lb)):
        raise AssertionError(f"{what}: not bit-equal")


def _want_counts(got: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        if got.get(k) != v:
            raise AssertionError(f"{what}: {k} {got.get(k)}, expected {v} "
                                 f"(all counts {got})")


def sharded_phase(card: Card, dev="cuda", timer=time_ms) -> dict:
    """The client-sharded mesh (``repro_torch.launch.mesh``,
    ``ShardedRoundEngine``, ``GroupedRoundEngine(mesh=)``, the protocol's
    and the simulator's ``mesh=``) on the card, counts set to 0 just
    before each counted run and read just after.  A mesh that repeats the
    one card is a mesh of virtual shards: the whole multi-shard step runs
    on it, no copy between shards.

    (a) the quickstart (synthetic MNIST 6000/1500, 10 non-IID clients, the
        paper's MLP 784-100-64-10, A_server 0.6, h 5, SHARD_ROUNDS FedDD
        rounds) through ``FedDDServer`` on the engine, on a one-shard mesh
        (bit-equal: globals, client params, every round's densities and
        records) and on SHARD_VIRTUAL virtual shards, 10 -> 12 rows
        (densities equal, params within SHARD_TOL) with the dense and the
        keep-1.0 sparse collective; launches as SHARD_LAUNCHES predicts;
        then one step on the round-1 fleet at uniform D = SHARD_DROP with
        the keep-SHARD_KEEP sparse collective (overflow 0, within
        SHARD_TOL of the engine) and at D = 0 (overflow > 0), with no
        synchronising call inside the step and no ``.to()`` copy;
    (b) the reference's sharded fleet (``benchmarks/perf_federated.py``
        ``sharded_ab``: spec 64-128-64-10, SHARD_FLEET clients x
        SHARD_FLEET_SAMPLES samples, one SGD step at lr 0.05 a round,
        ``allocator="jax"``): rounds/s of the fused engine, one shard and
        SHARD_VIRTUAL virtual shards after a warm-up (printed; on one
        card virtual shards measure launch serialisation, not scaling),
        the one shard bit-equal to fused;
    (c) the hetero-a VGG fleet (five Table 3 sub-models), 2 rounds grouped
        with ``mesh`` of SHARD_HETERO_SHARDS virtual shards: launches as
        SHARD_HETERO_LAUNCHES, round 1's densities equal to the unsharded
        grouped run's, and every sharded step against the unsharded
        grouped step on the same inputs (densities equal, params within
        SHARD_TOL); the two runs' distance after 2 rounds printed;
    (d) the straggler demo's sync policy over a static network,
        SHARD_SIM_ROUNDS rounds with ``mesh=1``: bit-equal to the run
        without a mesh, sim_time and event trace included;
    (e) ``sparse_numden_allreduce`` over SHARD_VIRTUAL virtual shards
        against a float64 oracle: lossless (overflow 0), lossy (overflow
        > 0), ragged ``k_local``; two runs bit-equal;
    (f) C5: ``sparse_agg`` at fc0 of 16 clients with the ``select`` flag,
        both modes, equal to the plain version (``equal_nan``) on a
        poisoned input; the mean mode timed with the flag off and on, the
        partials mode with it on.
    """
    import numpy as np
    import torch
    from repro_torch import heterogeneous, kernels, prng, quickstart, sim
    from repro_torch import straggler_sim, tree
    from repro_torch.core import round_engine, sparse_collective
    from repro_torch.core.protocol import FedDDServer, ProtocolConfig
    from repro_torch.heterogeneous import server_for
    from repro_torch.kernels import _lib
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.kernels.sparse_agg.ref import (masked_weighted_mean_ref,
                                                    masked_weighted_sum_ref)
    from repro_torch.launch.mesh import ClientMesh

    t_phase = time.perf_counter()
    card_dev = torch.device(dev)
    if card_dev.type == "cuda" and card_dev.index is None:
        card_dev = torch.device("cuda", torch.cuda.current_device())
    one, four = ClientMesh((card_dev,)), ClientMesh(
        (card_dev,) * SHARD_VIRTUAL)
    out = {}

    def counts():
        c = _launch_counts()
        c["select"] = agg_ops.select_counts()["select"]
        return c

    # ---- (a) the quickstart on the engine, one shard and virtual shards
    params, tel, ltf, ef = quickstart.setup(MLP_N, dev)

    def qs(mesh=None, **kw):
        srv = FedDDServer(params, ProtocolConfig(
            rounds=SHARD_ROUNDS, a_server=A_SERVER, h=quickstart.FEDDD_H,
            mesh=mesh, **kw), tel, device=dev)
        dens = []
        _sync(dev)
        kernels.reset_launch_counts()
        with _step_densities(dens):
            t0 = time.perf_counter()
            res = srv.run(ltf, ef)
            _sync(dev)
            wall = time.perf_counter() - t0
        return dict(srv=srv, res=res, dens=dens, counts=counts(), wall=wall)

    runs = {"engine": qs(), "one": qs(one), "four": qs(four),
            "four_sparse": qs(four, mesh_collective="sparse",
                              mesh_keep_fraction=1.0)}
    eng = runs["engine"]
    a = dict(launches={}, max_abs_diff={}, wall_s={}, accuracy={})
    for name, r in runs.items():
        want = SHARD_LAUNCHES[name]
        _want_counts(r["counts"]["launches"], want["launches"],
                     f"sharded (a) {name}")
        _want_counts(r["counts"]["sparse_agg"], want["sparse_agg"],
                     f"sharded (a) {name}")
        _want_counts(r["counts"]["merges"], want["merges"],
                     f"sharded (a) {name}")
        if r["counts"]["select"] != want["select"]:
            raise AssertionError(f"sharded (a) {name}: select launches "
                                 f"{r['counts']['select']}")
        a["launches"][name] = dict(r["counts"]["launches"],
                                   select=r["counts"]["select"],
                                   sparse_agg_routes=r["counts"][
                                       "sparse_agg"])
        a["wall_s"][name] = r["wall"]
        a["accuracy"][name] = r["res"].history[-1].metrics["accuracy"]
        if len(r["dens"]) != SHARD_ROUNDS or not all(
                torch.equal(x, y) for x, y in zip(r["dens"], eng["dens"])):
            raise AssertionError(f"sharded (a) {name}: densities differ "
                                 "from the engine's")
        if name == "engine":
            continue
        if name == "one":
            _same_trees(r["res"].global_params, eng["res"].global_params,
                        "one shard, global")
            for c1, c0 in zip(r["srv"].clients, eng["srv"].clients):
                _same_trees(c1.params, c0.params, "one shard, clients")
            for x, y in zip(r["res"].history, eng["res"].history):
                if (x.sim_time, x.uploaded_bytes, x.mean_loss) != (
                        y.sim_time, y.uploaded_bytes, y.mean_loss) or \
                        not np.array_equal(x.dropout_rates, y.dropout_rates):
                    raise AssertionError("one shard: records differ")
            a["max_abs_diff"][name] = 0.0
            continue
        diff = _trees_within(r["res"].global_params,
                             eng["res"].global_params, SHARD_TOL,
                             f"{name}, global")
        for c1, c0 in zip(r["srv"].clients, eng["srv"].clients):
            diff = max(diff, _trees_within(c1.params, c0.params, SHARD_TOL,
                                           f"{name}, clients"))
        a["max_abs_diff"][name] = diff
    # one step on the round-1 fleet: the keep-0.8 buffer at uniform D
    rk = prng.split(prng.PRNGKey(0))[1]
    old = round_engine.stack_pytrees([params] * MLP_N)
    new = round_engine.stack_pytrees([ltf(params, i, prng.fold_in(rk, i))[0]
                                      for i in range(MLP_N)])
    w = torch.as_tensor(np.asarray(tel.num_samples, np.float32), device=dev)
    sparse = round_engine.ShardedRoundEngine(
        mesh=four, collective="sparse", keep_fraction=SHARD_KEEP)
    steps = {}
    for d in (SHARD_DROP, 0.0):
        dd = torch.full((MLP_N,), d, dtype=torch.float32, device=dev)
        base = round_engine.BatchedRoundEngine().step(
            old, new, params, dd, w, rk, full_round=False)
        got = sparse.step(old, new, params, dd, w, rk, full_round=False)
        steps[d] = dict(overflow=float(got.collective_overflow))
        if d:
            if steps[d]["overflow"] != 0.0:
                raise AssertionError(f"keep {SHARD_KEEP} at D = {d}: "
                                     f"overflow {steps[d]['overflow']}")
            if not torch.equal(base.densities, got.densities):
                raise AssertionError("keep-0.8 step: densities differ")
            steps[d]["max_abs_diff"] = _trees_within(
                got.global_params, base.global_params, SHARD_TOL,
                "keep-0.8 step")
            sync_counts = [{}, {}]
            moves = {}
            for c in sync_counts:
                _sync(dev)
                with _count_syncs(c, dev), _count_moves(moves):
                    sparse.step(old, new, params, dd, w, rk,
                                full_round=False)
            if sync_counts[1]["syncs"] or moves["moves"]:
                raise AssertionError(
                    f"sharded step on the virtual mesh: syncs "
                    f"{sync_counts[1]}, device copies {moves['moves']}")
            steps[d].update(syncs=sync_counts[1]["syncs"],
                            moves=moves["moves"])
        elif steps[d]["overflow"] <= 0.0:
            raise AssertionError("zero dropout at keep 0.8 did not "
                                 "overflow")
    a["steps"] = {str(k): v for k, v in steps.items()}
    print(f"  sharded (a): quickstart {SHARD_ROUNDS} rounds, launches "
          + "; ".join(f"{k} {v}" for k, v in a["launches"].items())
          + "; max |diff| vs engine " + ", ".join(
              f"{k} {v:.3g}" for k, v in a["max_abs_diff"].items())
          + f"; accuracy {a['accuracy']}; wall s "
          + ", ".join(f"{k} {v:.2f}" for k, v in a["wall_s"].items())
          + f"; keep-{SHARD_KEEP} step at D {SHARD_DROP}: "
          f"{steps[SHARD_DROP]}, at D 0: overflow {steps[0.0]['overflow']}",
          flush=True)
    out["a"] = a

    # ---- (b) the reference's sharded fleet: rounds/s
    fparams, ftel, btf = _fleet_setup(dev, n=SHARD_FLEET,
                                      shard=SHARD_FLEET_SAMPLES)

    def fleet(rounds, mesh):
        srv = FedDDServer(fparams, ProtocolConfig(
            scheme="feddd", rounds=rounds, a_server=A_SERVER, h=5, seed=0,
            allocator="jax", mesh=mesh), ftel, device=dev)
        return srv.run(batched_train_fn=btf)

    b = dict(rounds_per_s={})
    fleet_params = {}
    for name, mesh in (("fused", None), ("one shard", one),
                       (f"{SHARD_VIRTUAL} virtual shards", four)):
        fleet(SHARD_FLEET_WARM, mesh)
        _sync(dev)
        t0 = time.perf_counter()
        res = fleet(SHARD_FLEET_ROUNDS, mesh)
        _sync(dev)
        b["rounds_per_s"][name] = SHARD_FLEET_ROUNDS / (time.perf_counter()
                                                        - t0)
        fleet_params[name] = res.global_params
    _same_trees(fleet_params["one shard"], fleet_params["fused"],
                "(b) one shard against fused")
    b["max_abs_diff_virtual"] = max(
        float((x - y).abs().max()) for x, y in zip(
            tree.leaves(fleet_params[f"{SHARD_VIRTUAL} virtual shards"]),
            tree.leaves(fleet_params["fused"])))
    print(f"  sharded (b): {SHARD_FLEET} clients x {SHARD_FLEET_SAMPLES} "
          f"(64-128-64-10), {SHARD_FLEET_ROUNDS} rounds after "
          f"{SHARD_FLEET_WARM}: " + ", ".join(
              f"{k} {v:.3f} rounds/s" for k, v in b["rounds_per_s"].items())
          + " (virtual shards on one card measure launch serialisation, "
          f"not scaling); one shard == fused; virtual max |diff| "
          f"{b['max_abs_diff_virtual']:.3g}", flush=True)
    out["b"] = b

    # ---- (c) the hetero-a VGG fleet on a mesh of virtual shards
    gp, clients, tel_h, ltf_h, _ = heterogeneous.setup(
        5, num_train=3000, num_test=800, device=dev)
    hmesh = ClientMesh((card_dev,) * SHARD_HETERO_SHARDS)

    def hetero(mesh):
        dens = []
        srv = server_for(gp, clients, tel_h, rounds=SHARD_HETERO_ROUNDS,
                         device=dev, mesh=mesh)
        _sync(dev)
        kernels.reset_launch_counts()
        with _step_densities(dens):
            res = srv.run(ltf_h)
            _sync(dev)
        return srv, res, dens, counts()

    h0, hr0, hd0, _ = hetero(None)
    h1, hr1, hd1, hc = hetero(hmesh)
    if len(hd1) != SHARD_HETERO_ROUNDS or not torch.equal(hd0[0], hd1[0]):
        raise AssertionError("(c) round-1 densities differ from the "
                             "grouped run's")
    # each sharded step against the unsharded grouped step on the same
    # inputs (an uncounted third run): densities equal, params within
    # SHARD_TOL.  Across rounds the two runs are not held to SHARD_TOL:
    # round 2 trains on globals an ulp apart, and the VGG's SGD moves
    # scores across near-ties of the k-th (printed below).
    shadow = []
    orig_step = round_engine.GroupedRoundEngine.step

    def checked(self, groups, global_params, weights, rng, **kw):
        got = orig_step(self, groups, global_params, weights, rng, **kw)
        if self.mesh is not None:
            want = round_engine._grouped_round_step(
                tuple(groups), global_params, torch.as_tensor(
                    weights, dtype=torch.float32, device=dev), rng,
                sel_cfg=self.selection_cfg, comm=self.comm, **{
                    "full_round": kw["full_round"],
                    "dense_masks": kw.get("dense_masks", False)})
            if not torch.equal(got.densities, want.densities):
                raise AssertionError("(c) a sharded grouped step's "
                                     "densities differ")
            d = _trees_within(got.global_params, want.global_params,
                              SHARD_TOL, "(c) step global")
            for x, y in zip(got.group_client_params,
                            want.group_client_params):
                d = max(d, _trees_within(x, y, SHARD_TOL,
                                         "(c) step clients"))
            shadow.append(d)
        return got

    round_engine.GroupedRoundEngine.step = checked
    try:
        server_for(gp, clients, tel_h, rounds=SHARD_HETERO_ROUNDS,
                   device=dev, mesh=hmesh).run(ltf_h)
    finally:
        round_engine.GroupedRoundEngine.step = orig_step
    if len(shadow) != SHARD_HETERO_ROUNDS:
        raise AssertionError(f"(c) {len(shadow)} checked steps")
    hdiff = max(float((x - y).abs().max()) for x, y in zip(
        tree.leaves(hr1.global_params), tree.leaves(hr0.global_params)))
    dens_equal = [bool(torch.equal(x, y)) for x, y in zip(hd0, hd1)]
    want = SHARD_HETERO_LAUNCHES
    _want_counts(hc["launches"], want["launches"], "(c)")
    _want_counts(hc["sparse_agg"], want["sparse_agg"], "(c)")
    if hc["select"] != want["select"]:
        raise AssertionError(f"(c) select launches {hc['select']}")
    print(f"  sharded (c): hetero-a, {SHARD_HETERO_ROUNDS} rounds grouped "
          f"on {SHARD_HETERO_SHARDS} virtual shards: each step against the "
          f"unsharded step on its inputs, max |diff| "
          + ", ".join(f"{d:.3g}" for d in shadow)
          + f"; the two runs after {SHARD_HETERO_ROUNDS} rounds: max "
          f"|diff| {hdiff:.3g}, densities equal by round {dens_equal}; "
          f"launches {hc['launches']}, sparse_agg {hc['sparse_agg']}, "
          f"select {hc['select']}", flush=True)
    out["c"] = dict(step_max_abs_diff=shadow, run_max_abs_diff=hdiff,
                    run_densities_equal=dens_equal,
                    launches=dict(hc["launches"], select=hc["select"]))

    # ---- (d) the simulator with mesh=1
    sparams, stel, sltf, _ = straggler_sim.setup(SIM_CLIENTS, dev)

    def demo(**kw):
        return sim.run_sim("feddd", sparams, stel, sltf, None,
                           sim=sim.SimConfig(policy="sync"),
                           rounds=SHARD_SIM_ROUNDS, a_server=A_SERVER, h=5,
                           seed=0, device=dev, **kw)

    s0 = demo()
    _sync(dev)
    kernels.reset_launch_counts()
    s1 = demo(mesh=1)
    _sync(dev)
    scnt = counts()
    _same_trees(s1.global_params, s0.global_params, "(d) sim mesh=1")
    if [r.sim_time for r in s1.history] != [r.sim_time for r in s0.history] \
            or s1.event_trace != s0.event_trace:
        raise AssertionError("(d) sim_time or event trace differ")
    n_leaves = len(MLP_LEAVES)
    _want_counts(scnt["launches"], dict(
        importance=n_leaves * SHARD_SIM_ROUNDS,
        sparse_agg=n_leaves * SHARD_SIM_ROUNDS,
        masked_merge=SHARD_SIM_ROUNDS), "(d)")
    print(f"  sharded (d): sync sim {SHARD_SIM_ROUNDS} rounds, mesh=1 "
          f"bit-equal (sim_time {s1.history[-1].sim_time:.3f} s); launches "
          f"{scnt['launches']}", flush=True)
    out["d"] = dict(sim_time=[r.sim_time for r in s1.history],
                    launches=scnt["launches"])

    # ---- (e) the sparse collectives against a float64 oracle
    rng = np.random.default_rng(7)
    p_, c_, f_ = SHARD_VIRTUAL, 100, 784
    e = {}

    def reduce(num, den, k, k_local=None):
        return sparse_collective.sparse_numden_allreduce(
            [torch.from_numpy(x).to(dev) for x in num],
            [torch.from_numpy(x).to(dev) for x in den], k, four,
            k_local=k_local)

    def oracle(num, den, keep_rows=None):
        on = np.zeros((c_, f_), np.float64)
        od = np.zeros((c_,), np.float64)
        for s in range(p_):
            rows = (np.flatnonzero(den[s] > 0) if keep_rows is None
                    else keep_rows[s])
            on[rows] += num[s, rows]
            od[rows] += den[s, rows]
        return on, od

    num = np.zeros((p_, c_, f_), np.float32)
    den = np.zeros((p_, c_), np.float32)
    for s in range(p_):
        keep = rng.choice(c_, size=rng.integers(10, 31), replace=False)
        den[s, keep] = rng.uniform(0.5, 2.0, keep.size)
        num[s, keep] = rng.normal(size=(keep.size, f_)) * den[s, keep][:,
                                                                      None]
    cases = {"lossless": (num, den, 32, None)}
    full = rng.normal(size=(p_, c_, f_)).astype(np.float32)
    cases["lossy"] = (full, np.ones((p_, c_), np.float32), 30, None)
    dr = rng.uniform(0.5, 2.0, size=(p_, c_)).astype(np.float32)
    cases["ragged"] = (full, dr, 40, [10 * (s + 1) for s in range(p_)])
    for name, (nm, dn, k, kl) in cases.items():
        got = reduce(nm, dn, k, None if kl is None else
                     [torch.tensor(x, device=dev) for x in kl])
        again = reduce(nm, dn, k, None if kl is None else
                       [torch.tensor(x, device=dev) for x in kl])
        if not all(torch.equal(x[0], y[0]) for x, y in zip(got, again)):
            raise AssertionError(f"(e) {name}: two runs differ")
        if not all(t is got[0][0] for t in got[0]):
            raise AssertionError(f"(e) {name}: a copy per virtual shard")
        ovf = float(got[2][0])
        if name == "lossy":
            if ovf != p_ * (c_ - k):
                raise AssertionError(f"(e) lossy overflow {ovf}")
            e[name] = dict(overflow=ovf)
            continue
        keep_rows = (None if kl is None else
                     [np.argsort(-dn[s], kind="stable")[:kl[s]]
                      for s in range(p_)])
        on, od = oracle(nm, dn, keep_rows)
        if name == "lossless" and ovf != 0.0:
            raise AssertionError(f"(e) lossless overflow {ovf}")
        err = max(float(np.abs(got[0][0].cpu().numpy() - on).max()),
                  float(np.abs(got[1][0].cpu().numpy() - od).max()))
        np.testing.assert_allclose(got[0][0].cpu().numpy(), on, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[1][0].cpu().numpy(), od, rtol=1e-5,
                                   atol=1e-5)
        e[name] = dict(overflow=ovf, max_abs_err=err)
    print(f"  sharded (e): sparse_numden_allreduce over {p_} virtual "
          f"shards, ({c_}, {f_}) partials: {e}", flush=True)
    out["e"] = e

    # ---- (f) C5: sparse_agg's select flag at fc0 of 16 clients
    n, leaf = SIM_FC0
    a_, cc, b_ = _lib.split_at(leaf, len(leaf) - 1)
    gen = torch.Generator(device=card_dev).manual_seed(21)
    vals = torch.randn((n, *leaf), generator=gen, device=dev)
    keep = (torch.rand((n, 1, cc), generator=gen, device=dev) > 0.4).float()
    wts = torch.rand((n,), generator=gen, device=dev) + 0.5
    bad = vals.clone()
    flat = bad.view(n, a_, cc)
    for row, val in ((3, float("nan")), (5, float("inf")),
                     (7, float("-inf"))):
        flat[row, 1, int(torch.nonzero(keep[row, 0])[0])] = val
        flat[row, 2, int(torch.nonzero(keep[row, 0] == 0)[0])] = val
    f = {}
    kernels.reset_launch_counts()
    for sel in (True, False):
        got_m = agg_ops.masked_weighted_mean(bad, keep, wts, None,
                                             torch.float32, select=sel)
        want_m = masked_weighted_mean_ref(bad.view(n, a_, cc, b_),
                                          keep.view(n, cc), wts, None,
                                          torch.float32, sel).view(leaf)
        got_n, got_d = agg_ops.masked_weighted_sum(bad, keep, wts,
                                                   select=sel)
        want_n, want_d = masked_weighted_sum_ref(
            bad.view(n, a_, cc, b_), keep.view(n, cc), wts, sel)
        torch.testing.assert_close(got_m, want_m, rtol=3e-5, atol=1e-4,
                                   equal_nan=True)
        torch.testing.assert_close(got_n, want_n.view(leaf), rtol=3e-5,
                                   atol=1e-4, equal_nan=True)
        torch.testing.assert_close(got_d, want_d.view(leaf), rtol=3e-5,
                                   atol=1e-5)
        fin = torch.isfinite(want_m)
        f["on" if sel else "off"] = dict(
            non_finite=int((~torch.isfinite(got_m)).sum()),
            max_abs_err=float((got_m[fin] - want_m[fin]).abs().max()))
    if f["on"]["non_finite"] >= f["off"]["non_finite"]:
        raise AssertionError(f"(f) select skipped nothing: {f}")
    _sync(dev)
    if agg_ops.select_counts()["select"] != 2:
        raise AssertionError(f"(f) select launches "
                             f"{agg_ops.select_counts()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    elems = n * a_ * cc * b_
    rec = _timed(
        card, flush, timer, "eq4_select", n, leaf, torch.float32,
        lambda: agg_ops.masked_weighted_mean(vals, keep, wts, None,
                                             torch.float32, select=True),
        lambda: masked_weighted_mean_ref(vals.view(n, a_, cc, b_),
                                         keep.view(n, cc), wts, None,
                                         torch.float32, True),
        None, elems * 4 + n * cc * 4 + n * 4 + a_ * cc * 4,
        2 * elems + a_ * cc,
        extra=dict(mean_off=lambda: agg_ops.masked_weighted_mean(
                       vals, keep, wts, None, torch.float32),
                   partials_on=lambda: agg_ops.masked_weighted_sum(
                       vals, keep, wts, select=True),
                   partials_off=lambda: agg_ops.masked_weighted_sum(
                       vals, keep, wts)))
    del flush
    rec.update(mode="mean", select=f)
    out["f"] = rec
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  sharded (f): select on/off {f}; sharded phase "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def _profile_ops(fn, dev) -> dict:
    """Device operations of one call of ``fn`` under torch.profiler:
    CUDA kernels, memsets and copies, and the aten ops the host issued
    that no other aten op called (profiler scopes do not count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        _sync(dev)
    events = prof.events()
    cuda = sum(1 for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA)
    def outermost(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("aten::"):
            p = p.cpu_parent
        return p is None

    top = sum(1 for e in events
              if e.name.startswith("aten::") and outermost(e))
    return dict(cuda_ops=cuda, cpu_ops=top)


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def serving_phase(dev="cuda") -> dict:
    """Phase 6: gemma3-27b at full width, 12 layers, on cuda: prefill,
    greedy decode, the kernel route against the plain route, and decode
    against forward."""
    import dataclasses
    import torch
    from repro_torch import kernels, tree
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models import attention, lm

    _sync(dev)
    t0 = time.perf_counter()
    cfg, params, gen = serve.build(SERVE_ARCH, reduced=False,
                                   num_layers=SERVE_LAYERS, device=dev)
    plan = lm.plan_for(cfg)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"  {cfg.name} d={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads} hd={cfg.head_dim_} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} (n_super "
          f"{plan.n_super}, period {len(plan.period)}): {n_params / 1e9:.3f}"
          f" B params, init {init_s:.2f} s", flush=True)

    def on_card(t) -> bool:
        return t.device.type == torch.device(dev).type

    # ---- prefill: one request of PREFILL_SEQ tokens, PREFILL_CALLS times
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_SEQ),
                           generator=gen, device=dev)
    prefill_s = []
    kernels.reset_launch_counts()
    for _ in range(PREFILL_CALLS):
        _sync(dev)
        t0 = time.perf_counter()
        last = lm.prefill(params, cfg, {"tokens": tokens})
        _sync(dev)
        prefill_s.append(time.perf_counter() - t0)
    prefill_counts = kernels.launch_counts()
    print(f"  prefill B=1 S={PREFILL_SEQ}: {prefill_s} s, launches "
          f"{prefill_counts}", flush=True)
    if tuple(last.shape) != (1, cfg.vocab_size) or not bool(
            torch.isfinite(last).all()):
        raise AssertionError(f"prefill logits {tuple(last.shape)} not "
                             f"finite")
    prefill_routes = flash_ops.route_counts()
    print(f"  prefill flash launches by route: {prefill_routes}", flush=True)
    want = {k: 0 for k in kernels.KERNELS}
    want["flash_attention"] = cfg.num_layers * PREFILL_CALLS
    if prefill_counts != want:
        raise AssertionError(f"prefill launches {prefill_counts} != {want}")
    if prefill_routes != {"sm90": want["flash_attention"], "fma": 0}:
        raise AssertionError(f"prefill flash launches by route "
                             f"{prefill_routes}: not all on sm90")
    del last, tokens

    # ---- the kernel route against the plain-attention route, in-model
    toks = torch.randint(0, cfg.vocab_size, (1, ROUTE_SEQ), generator=gen,
                         device=dev)
    by_kernel = lm.prefill(params, cfg, {"tokens": toks})
    saved = attention.FLASH_MIN_SEQ
    attention.FLASH_MIN_SEQ = ROUTE_SEQ + 1
    try:
        by_plain = lm.prefill(params, cfg, {"tokens": toks})
    finally:
        attention.FLASH_MIN_SEQ = saved
    route_err = _rel_err(by_kernel, by_plain)
    route_top1 = bool((by_kernel.argmax(-1) == by_plain.argmax(-1)).all())
    print(f"  S={ROUTE_SEQ} prefill, kernel route vs plain route: max "
          f"|diff| / max |logit| = {route_err:.3g}, same top-1 "
          f"{route_top1}", flush=True)
    if not route_err <= ROUTE_TOL:
        raise AssertionError(f"kernel route differs by {route_err}")
    del by_kernel, by_plain, toks

    # ---- decode: DECODE_STEPS greedy steps at DECODE_BATCH, in two halves
    state = lm.init_decode_state(params, cfg, DECODE_BATCH, DECODE_CACHE)
    tok = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, 1), generator=gen,
                        device=dev)
    kernels.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    first, _, state = serve.generate(params, cfg, state, tok,
                                     DECODE_STEPS // 2)
    _sync(dev)
    half = time.perf_counter()
    rest, logits, state = serve.generate(params, cfg, state, first[:, -1:],
                                         DECODE_STEPS - DECODE_STEPS // 2)
    _sync(dev)
    t1 = time.perf_counter()
    decode_counts = kernels.launch_counts()
    decode_ms = (t1 - t0) / DECODE_STEPS * 1e3
    steady_ms = (t1 - half) / (DECODE_STEPS - DECODE_STEPS // 2) * 1e3
    print(f"  decode B={DECODE_BATCH} cache={DECODE_CACHE} "
          f"{DECODE_STEPS} greedy steps: {decode_ms:.2f} ms/token "
          f"(second half {steady_ms:.2f}), launches {decode_counts}",
          flush=True)
    if any(decode_counts.values()):
        raise AssertionError(f"decode launched kernels: {decode_counts}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits not finite")
    if not (all(on_card(t) for t in tree.leaves(params)) and all(
            on_card(c.k) and on_card(c.v) for c in tree.leaves(state.stack))):
        raise AssertionError("params or cache left the card")
    seq = torch.cat([first, rest[:, 1:]], 1).cpu()
    del state, logits

    # ---- decode from an empty cache against forward, bf16 then fp32
    prompt = torch.randint(0, cfg.vocab_size, (CONSIST_BATCH, CONSIST_T),
                           generator=gen, device=dev)

    def consistency(p, c) -> float:
        full, _ = lm.forward(p, c, {"tokens": prompt})
        st = lm.init_decode_state(p, c, CONSIST_BATCH, CONSIST_T)
        stp = lm.make_serve_step(c)
        outs = []
        for t in range(CONSIST_T):
            lg, st = stp(p, st, prompt[:, t:t + 1])
            outs.append(lg)
        return _rel_err(torch.stack(outs, 1), full)

    consist_bf16 = consistency(params, cfg)
    params = tree.tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    consist_fp32 = consistency(params, cfg32)
    print(f"  decode vs forward over {CONSIST_T} tokens, batch "
          f"{CONSIST_BATCH}: max |diff| / max |logit| = {consist_fp32:.3g} "
          f"fp32 (limit {CONSIST_TOL_FP32}), {consist_bf16:.3g} bf16",
          flush=True)
    if not consist_fp32 <= CONSIST_TOL_FP32:
        raise AssertionError(f"decode differs from forward by "
                             f"{consist_fp32} in fp32")
    del params
    return dict(config=dict(arch=SERVE_ARCH, layers=cfg.num_layers,
                            n_params=n_params, n_super=plan.n_super),
                init_s=init_s, prefill_seq=PREFILL_SEQ, prefill_s=prefill_s,
                prefill_launches=prefill_counts,
                prefill_routes=prefill_routes, route_seq=ROUTE_SEQ,
                route_err=route_err, route_same_top1=route_top1,
                decode_batch=DECODE_BATCH, decode_cache=DECODE_CACHE,
                decode_steps=DECODE_STEPS, decode_ms_per_token=decode_ms,
                decode_steady_ms_per_token=steady_ms,
                decode_launches=decode_counts,
                request0_tokens=seq[0, :8].tolist(),
                consistency_fp32=consist_fp32, consistency_bf16=consist_bf16)


def _placed_bytes(placed, params) -> dict:
    """Each device's bytes of a placement against ``local_shape``'s
    count of one device (equal, or the phase fails)."""
    from repro_torch.models import sharding
    per_dev = sharding.device_bytes(placed)
    want = sharding.local_bytes(params, placed.specs, placed.mesh)
    if per_dev != [want] * placed.mesh.size:
        raise AssertionError(f"bytes per device {per_dev}, local_shape "
                             f"count {want}")
    return dict(per_device=per_dev, local_shape=want)


def _mesh_layer_routes(meshed: list, mesh, n_layers: int) -> list:
    """The meshed prefill's routings (one per device and layer; block r
    on row r) as one (ids (T, k), router probabilities (T, E)) a layer,
    in token order, read from the devices of model column 0."""
    import torch
    if len(meshed) != n_layers * mesh.size:
        raise AssertionError(f"{len(meshed)} meshed routings for "
                             f"{n_layers} layers")
    out = []
    for layer in range(n_layers):
        recs = meshed[layer * mesh.size:(layer + 1) * mesh.size]
        col0 = [recs[k] for k in range(mesh.size) if mesh.col(k) == 0]
        out.append(tuple(torch.cat(parts) for parts in zip(*col0)))
    return out


def _mesh_route_flips(ref: list, meshed: list, b: int, s: int):
    """The meshed prefill's routings (:func:`_mesh_layer_routes`) against
    the unmeshed one's (one per layer): how many tokens a layer sent to
    other experts, the largest router gap (k-th minus (k+1)-th
    probability, unmeshed) at them, and whether a row's last position is
    among them in any layer."""
    flips, gap, last = 0, 0.0, [False] * b
    for (r_ids, r_probs), (m_ids, _) in zip(ref, meshed):
        k = r_ids.shape[1]
        diff = (r_ids.sort(-1).values != m_ids.sort(-1).values).any(-1)
        idx = diff.nonzero().flatten()
        if len(idx):
            probs = r_probs[idx].sort(-1, descending=True).values
            gap = max(gap, float((probs[:, k - 1] - probs[:, k]).max()))
        flips += len(idx)
        for r in range(b):
            last[r] = last[r] or bool(diff[(r + 1) * s - 1])
    return flips, gap, last


@contextlib.contextmanager
def _forced_routes(meshed: list, out: list):
    """Route the i-th MoE call to the experts of ``meshed[i]`` (ids, router
    probabilities), each token's gate weights taken from this run's own
    router probabilities at those experts, normalised as ``moe.route``
    does.  Appends, a layer: the tokens whose own top-k differs, how far
    the forced set's weakest expert falls below this run's k-th router
    logit, and the largest change of a router logit between the two runs
    (centred a token), both in units of the token's router-logit std."""
    import torch
    from repro_torch.models import moe
    real = moe.route
    calls = iter(meshed)

    def forced(p, x, mcfg):
        ids, m_probs = next(calls)
        _, _, aux = real(p, x, mcfg)
        probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
        logp = probs.log()
        std = logp.std(-1)
        own = logp.topk(mcfg.top_k, -1).indices
        kth = logp.gather(1, own[:, -1:]).squeeze(1)
        below = (kth - logp.gather(1, ids).min(-1).values).clamp(min=0)
        moved = m_probs.log() - logp
        moved = (moved - moved.mean(-1, keepdim=True)).abs().max(-1).values
        out.append(dict(
            flips=int((own.sort(-1).values != ids.sort(-1).values).any(-1)
                      .sum()),
            below=float((below / std).max()),
            moved=float((moved / std).max())))
        top_p = torch.gather(probs, 1, ids)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        return ids, top_p.to(x.dtype), aux

    moe.route = forced
    try:
        yield out
    finally:
        moe.route = real


def lm_mesh_phase(card: Card, dev="cuda") -> dict:
    """Phase 6b: the serving path on a virtual MESH_SHAPE (data, model)
    mesh of the card, against the unmeshed path on the same weights and
    inputs: gemma3-27b (phase 6's model) prefill at MESH_PREFILL_BATCH x
    PREFILL_SEQ and DECODE_STEPS teacher-forced decode steps at
    DECODE_BATCH, and qwen3-moe (MOE_LAYERS layers) prefill at
    MESH_MOE_BATCH x MOE_PREFILL_SEQ on the expert-parallel path against
    the unmeshed dispatch in 2 blocks."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import lm, moe, sharding

    t_phase = time.perf_counter()
    resident = _fresh_peak(dev)
    mesh = LMMesh.virtual(dev, *MESH_SHAPE)
    cfg, params, gen = serve.build(SERVE_ARCH, reduced=False,
                                   num_layers=SERVE_LAYERS, device=dev)
    _sync(dev)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    placed = lm.place_params(params, cfg, mesh)
    _sync(dev)
    place_s = time.perf_counter() - t0
    alloc = torch.cuda.memory_allocated() - before
    pbytes = _placed_bytes(placed, params)
    if not sum(pbytes["per_device"]) <= alloc <= 1.01 * sum(
            pbytes["per_device"]) + (1 << 20):
        raise AssertionError(f"placement allocated {alloc} bytes for "
                             f"{pbytes}")
    print(f"  mesh {mesh.shape} (virtual, {mesh.size} shards of the card): "
          f"{cfg.name} {cfg.num_layers} layers placed in {place_s:.2f} s, "
          f"{pbytes['per_device'][0] / 2 ** 30:.3f} GiB of parameters a "
          f"device (local_shape count {pbytes['local_shape'] / 2 ** 30:.3f}"
          f"), allocated {alloc / 2 ** 30:.3f} GiB in all", flush=True)

    # ---- prefill: the batch split over data, flash per device
    tokens = torch.randint(0, cfg.vocab_size, (MESH_PREFILL_BATCH,
                                               PREFILL_SEQ), generator=gen,
                           device=dev)
    _fresh_peak(dev)
    _sync(dev)
    t0 = time.perf_counter()
    want = lm.prefill(params, cfg, {"tokens": tokens})
    _sync(dev)
    plain_s = time.perf_counter() - t0
    plain_peak = _peak_gb()
    _fresh_peak(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = lm.prefill(placed, cfg, {"tokens": tokens}, mesh=mesh)
    _sync(dev)
    mesh_s = time.perf_counter() - t0
    mesh_peak = _peak_gb()
    g_counts, g_routes = kernels.launch_counts(), flash_ops.route_counts()
    _want_flash(cfg, g_counts, g_routes, cfg.num_layers * mesh.size)
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"meshed prefill logits {tuple(got.shape)}")
    prefill_err = _rel_err(got, want)
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    print(f"  prefill {MESH_PREFILL_BATCH} x {PREFILL_SEQ}: mesh {mesh_s:.3f}"
          f" s (flash {g_routes}, {cfg.num_layers} layers x {mesh.size} "
          f"devices), unmeshed {plain_s:.3f} s; max |diff| / max |logit| "
          f"{prefill_err:.3g} (limit {MESH_TOL}), same top-1 {top1}; peak "
          f"{mesh_peak:.2f} GiB meshed, {plain_peak:.2f} unmeshed "
          f"({resident:.2f} resident at the start)  [{card.line}]",
          flush=True)
    if not prefill_err <= MESH_TOL:
        raise AssertionError(f"meshed prefill differs by {prefill_err}")
    del got, want
    # once more, untimed: every device's flash output against the plain
    # version on its very inputs
    g_held = _prefill_flash_held(placed, cfg, {"tokens": tokens}, mesh)
    print(f"  meshed prefill's own flash inputs, {g_held['launches']} "
          f"launches: kernel vs plain max err {g_held['max_abs_err']:.3g}, "
          f"worst row {g_held['worst_row']:.3g} of its scale (limit "
          f"{ROW_TOL:.4g})", flush=True)
    if g_held["launches"] != cfg.num_layers * mesh.size:
        raise AssertionError(f"meshed prefill flash inputs: {g_held}")
    del tokens

    # ---- decode: the same DECODE_STEPS tokens fed to both, batch split
    seq = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_STEPS),
                        generator=gen, device=dev)

    def decode(p, m):
        st = lm.init_decode_state(p, cfg, DECODE_BATCH, DECODE_CACHE,
                                  mesh=m)
        step = lm.make_serve_step(cfg, m)
        outs = []
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(DECODE_STEPS):
            lg, st = step(p, st, seq[:, t:t + 1])
            outs.append(lg)
        _sync(dev)
        return (torch.stack(outs, 1),
                (time.perf_counter() - t0) / DECODE_STEPS * 1e3, st)

    kernels.reset_launch_counts()
    dec, dec_ms, st = decode(placed, mesh)
    dec_counts = kernels.launch_counts()
    dec0, dec0_ms, _ = decode(params, None)
    if any(dec_counts.values()) or not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"meshed decode launches {dec_counts}")
    for shard in st.stack.shards:
        for t, sp, full in zip(tree.named_values(shard),
                               tree.named_values(st.stack.specs),
                               tree.named_values(lm.abstract_decode_state(
                                   cfg, DECODE_BATCH, DECODE_CACHE).stack)):
            if t.device.type != torch.device(dev).type or tuple(
                    t.shape) != sharding.local_shape(
                    full.shape, sp, mesh):
                raise AssertionError(f"cache block {tuple(t.shape)} under "
                                     f"{sp}")
    state_bytes = sharding.device_bytes(st.stack)
    decode_err = _rel_err(dec, dec0)
    print(f"  decode {DECODE_BATCH} x {DECODE_STEPS} steps (cache "
          f"{DECODE_CACHE}): mesh {dec_ms:.2f} ms/token, unmeshed "
          f"{dec0_ms:.2f}; max |diff| / max |logit| {decode_err:.3g} (limit "
          f"{MESH_TOL}); cache {state_bytes[0] / 2 ** 20:.2f} MiB a device; "
          f"launches {dec_counts}  [{card.line}]", flush=True)
    if not decode_err <= MESH_TOL:
        raise AssertionError(f"meshed decode differs by {decode_err}")
    del dec, dec0, st, placed, params
    torch.cuda.empty_cache()

    # ---- qwen3-moe: the expert-parallel path against 2 blocks unmeshed
    mcfg, mparams, mgen = serve.build(MOE_ARCH, reduced=False,
                                      num_layers=MOE_LAYERS, device=dev)
    mplaced = lm.place_params(mparams, mcfg, mesh)
    mbytes = _placed_bytes(mplaced, mparams)
    toks = torch.randint(0, mcfg.vocab_size, (MESH_MOE_BATCH,
                                              MOE_PREFILL_SEQ),
                         generator=mgen, device=dev)
    def two_blocks():
        return _two_blocks(lambda: lm.prefill(mparams, mcfg,
                                              {"tokens": toks}))

    ref_routes, mesh_routes = [], []
    moe.reset_dispatch_counts()
    with _recorded_routes(ref_routes):
        want = two_blocks()
    ref_paths = moe.dispatch_counts()
    moe.reset_dispatch_counts()
    kernels.reset_launch_counts()
    with _recorded_routes(mesh_routes):
        got = lm.prefill(mplaced, mcfg, {"tokens": toks}, mesh=mesh)
    paths = moe.dispatch_counts()
    counts, routes = kernels.launch_counts(), flash_ops.route_counts()
    _want_flash(mcfg, counts, routes, mcfg.num_layers * mesh.size)
    if paths != {"one_block": 0, "blocked": 0, "ep": mcfg.num_layers} or \
            ref_paths != {"one_block": 0, "blocked": mcfg.num_layers,
                          "ep": 0}:
        raise AssertionError(f"MoE dispatch paths: mesh {paths}, unmeshed "
                             f"{ref_paths}")
    mesh_layers = _mesh_layer_routes(mesh_routes, mesh, mcfg.num_layers)
    flips, gap, last = _mesh_route_flips(ref_routes, mesh_layers,
                                         MESH_MOE_BATCH, MOE_PREFILL_SEQ)
    scale = want.float().abs().max()
    row_err = [((got[r].float() - want[r].float()).abs().max()
                / scale).item() for r in range(MESH_MOE_BATCH)]
    held = [r for r in range(MESH_MOE_BATCH) if not last[r]]
    moe_err = max((row_err[r] for r in held), default=None)
    # the unmeshed dispatch once more, every layer routed as the mesh
    # routed it: each row is held, and each routing difference is a tie
    # of the router up to the rounding of its input
    ties = []
    with _forced_routes(mesh_layers, ties):
        forced = two_blocks()
    forced_err = ((got.float() - forced.float()).abs().max()
                  / forced.float().abs().max()).item()
    if len(ties) != mcfg.num_layers:
        raise AssertionError(f"{len(ties)} forced routings for "
                             f"{mcfg.num_layers} layers")
    tie = max(t["below"] for t in ties)
    moved = max(t["moved"] for t in ties)
    m_held = _prefill_flash_held(mplaced, mcfg, {"tokens": toks}, mesh)
    del ref_routes, mesh_routes
    _sync(dev)
    t0 = time.perf_counter()
    again = lm.prefill(mplaced, mcfg, {"tokens": toks}, mesh=mesh)
    _sync(dev)
    moe_mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two_blocks()
    _sync(dev)
    moe_plain_s = time.perf_counter() - t0
    if not torch.equal(again, got):
        raise AssertionError("two meshed MoE prefills differ")
    print(f"  {mcfg.name} {mcfg.num_layers} layers, prefill "
          f"{MESH_MOE_BATCH} x {MOE_PREFILL_SEQ}: dispatch {paths} (2 blocks"
          f" unmeshed: {ref_paths}), flash {routes}; mesh {moe_mesh_s:.4f} "
          f"s, unmeshed {moe_plain_s:.4f} s; {mbytes['per_device'][0] / 2 ** 30:.3f}"
          f" GiB of parameters a device; {flips} token-layers routed "
          f"elsewhere (router probability gap <= {gap:.3g}); rows' max "
          f"|diff| / max |logit| {[round(e, 5) for e in row_err]}, held "
          f"rows {held} (a row whose last position flipped an expert is "
          f"not held) {moe_err} (limit {MESH_MOE_TOL}); two meshed runs "
          f"bit-equal  [{card.line}]", flush=True)
    print(f"  unmeshed, routed as the mesh routed: max |diff| / max |logit| "
          f"{forced_err:.3g} over every row (limit {MESH_MOE_TOL}); "
          f"{[t['flips'] for t in ties]} tokens a layer where its own "
          f"router differs, the mesh's weakest expert <= {tie:.3g} router-"
          f"logit std below its k-th (limit {MESH_TIE_STD}); router logits "
          f"moved <= {moved:.3g} std; flash on the meshed prefill's own "
          f"inputs, {m_held['launches']} launches: max err "
          f"{m_held['max_abs_err']:.3g}, worst row {m_held['worst_row']:.3g}"
          f" (limit {ROW_TOL:.4g})  [{card.line}]", flush=True)
    if moe_err is not None and not moe_err <= MESH_MOE_TOL:
        raise AssertionError(f"meshed MoE prefill differs by {moe_err}")
    if not forced_err <= MESH_MOE_TOL:
        raise AssertionError(f"meshed MoE prefill differs from the unmeshed"
                             f" one routed alike by {forced_err}")
    if not tie <= MESH_TIE_STD:
        raise AssertionError(f"the meshed MoE picked an expert {tie} "
                             f"router-logit std below the k-th: {ties}")
    if m_held["launches"] != mcfg.num_layers * mesh.size:
        raise AssertionError(f"meshed MoE prefill flash inputs: {m_held}")
    del mplaced, mparams, got, again, want, forced
    wall = time.perf_counter() - t_phase
    print(f"  lm mesh phase wall {wall:.2f} s  [{card.line}]", flush=True)
    return dict(mesh=list(MESH_SHAPE), virtual=True, phase_wall_s=wall,
                gemma=dict(arch=SERVE_ARCH, layers=cfg.num_layers,
                           place_s=place_s, param_bytes=pbytes,
                           allocated_bytes=alloc,
                           prefill_batch=MESH_PREFILL_BATCH,
                           prefill_seq=PREFILL_SEQ, prefill_s=mesh_s,
                           prefill_plain_s=plain_s, prefill_err=prefill_err,
                           prefill_same_top1=top1,
                           prefill_peak_gib=mesh_peak,
                           prefill_plain_peak_gib=plain_peak,
                           resident_gib=resident,
                           prefill_launches=g_counts,
                           prefill_routes=g_routes, flash_held=g_held,
                           decode_batch=DECODE_BATCH,
                           decode_steps=DECODE_STEPS, decode_ms=dec_ms,
                           decode_plain_ms=dec0_ms, decode_err=decode_err,
                           decode_launches=dec_counts,
                           cache_bytes=state_bytes),
                moe=dict(arch=MOE_ARCH, layers=mcfg.num_layers,
                         param_bytes=mbytes, batch=MESH_MOE_BATCH,
                         seq=MOE_PREFILL_SEQ, dispatch=paths,
                         dispatch_plain=ref_paths, prefill_s=moe_mesh_s,
                         prefill_plain_s=moe_plain_s, flips=flips,
                         max_gap=gap, row_err=row_err, held=held,
                         err=moe_err, forced_err=forced_err, ties=ties,
                         tie_std=tie, moved_std=moved, flash_held=m_held,
                         launches=counts, routes=routes))


def _peak_gb() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _fresh_peak(dev) -> float:
    """Reset the peak-memory counter; returns the GiB still allocated
    (what earlier phases left), which every peak below includes."""
    import torch
    _sync(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


# the client-batched convolutions (kernels/conv) at the benchmark cell's
# three CNN2 convs, 100 clients x 50 images: (C, O, H, k)
CONV_CLIENTS, CONV_BATCH = 100, 50
CONV_CELL = [(3, 16, 32, 3), (16, 32, 16, 3), (32, 64, 8, 3)]
# held against the plain version only: CNN1's 5x5 convs and VGG convs at
# 256-512 channels, (N, B, C, O, H, k)
CONV_MORE = [(10, 32, 1, 10, 16, 5), (10, 32, 10, 20, 8, 5),
             (4, 16, 256, 512, 4, 3), (4, 16, 512, 512, 2, 3)]
CONV_REL_TOL = 1e-5          # error norm over the float64 output's norm
# one vmapped CNN2 step on the card: 3 forward, 2 input-gradient (the
# images take none), 3 weight-gradient launches and the 3 sums of their
# splits (every CNN2 wgrad splits on 132 SMs: kernels/conv/ops.wgrad_plan)
CONV_STEP_LAUNCHES = {"fprop": 3, "dgrad": 2, "wgrad": 3, "wgrad_reduce": 3}
# cuDNN's kernels of a vmapped convolution, by name
CUDNN_CONV = ("cudnn", "implicit_gemm", "implicit_convolve", "conv2d_grouped",
              "winograd", "genericTranspose", "dgrad2d", "wgrad2d")


def conv_pass_cost(n, b, c, o, h, k):
    """{pass: (bytes, flops)} of one client-batched SAME convolution of
    N clients: each operand read once and the output written once, and
    2 flops a tap that falls inside the image."""
    p = (k - 1) // 2
    taps = sum(h - abs(t - p) for t in range(k)) ** 2
    flops = 2.0 * n * b * taps * c * o
    x, w, y = n * b * c * h * h, n * o * c * k * k, n * b * o * h * h
    return {"fprop": (4 * (x + w + y), flops),
            "dgrad": (4 * (y + w + x), flops),
            "wgrad": (4 * (x + y + w), flops)}


def _kernel_names(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def conv_checks(card: Card, flush, records: list, dev="cuda",
                timer=time_ms) -> dict:
    """Each pass of the client-batched convolutions against the plain
    version in float64 (error norm within CONV_REL_TOL of the output's)
    at the cell's shapes and CONV_MORE, and twice bit-equal; at the
    cell's shapes timed with its bound, the plain version and today's
    vmapped cuDNN call (``library_ms``, with its kernel launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.fl import models
    from repro_torch.kernels.conv import ops as conv_ops
    from repro_torch.kernels.conv import ref as conv_ref
    models._full_fp32()
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    rows = {}
    shapes = ([(CONV_CLIENTS, CONV_BATCH) + s for s in
               ((c, o, h, k) for c, o, h, k in CONV_CELL)] + CONV_MORE)
    for li, (n, b, c, o, h, k) in enumerate(shapes):
        cell = li < len(CONV_CELL)
        # the step's layouts: the images an NHWC view, a later conv's
        # input the NCHW output of a pool; the weights HWIO viewed as OIHW
        x = (torch.randn((n, b, h, h, c), generator=gen,
                         device=dev).permute(0, 1, 4, 2, 3) if c <= 3
             else torch.randn((n, b, c, h, h), generator=gen, device=dev))
        w = (torch.randn((n, k, k, c, o), generator=gen, device=dev)
             / math.sqrt(k * k * c)).permute(0, 4, 3, 1, 2)
        g = torch.randn((n, b, o, h, h), generator=gen, device=dev)
        d = [t.double() for t in (x, w, g)]
        passes = {
            "fprop": (lambda: conv_ops.fprop_batched(x, w),
                      lambda: conv_ref.conv_fprop_ref(x, w),
                      lambda: torch.func.vmap(conv_ops._fprop_plain)(x, w),
                      lambda: conv_ref.conv_fprop_ref(d[0], d[1])),
            "dgrad": (lambda: conv_ops.dgrad_batched(g, w),
                      lambda: conv_ref.conv_dgrad_ref(g, w),
                      lambda: torch.func.vmap(conv_ops._dgrad_plain)(
                          g, x, w),
                      lambda: conv_ref.conv_dgrad_ref(d[2], d[1])),
            "wgrad": (lambda: conv_ops.wgrad_batched(x, g, k),
                      lambda: conv_ref.conv_wgrad_ref(x, g, k),
                      lambda: torch.func.vmap(conv_ops._wgrad_plain)(
                          x, g, w),
                      lambda: conv_ref.conv_wgrad_ref(d[0], d[2], k))}
        cost = conv_pass_cost(n, b, c, o, h, k)
        for name, (kern, plain, lib, exact) in passes.items():
            got = kern()
            want = exact()
            err = ((got.double() - want).norm() / want.norm()).item()
            if not err <= CONV_REL_TOL:
                raise AssertionError(f"conv {name} at {(n, b, c, o, h, k)}: "
                                     f"error norm {err:.3e} of the output's")
            if not torch.equal(got, kern()):
                raise AssertionError(f"conv {name} at {(n, b, c, o, h, k)} "
                                     f"differs between two runs")
            worst = max(worst, err)
            del want
            if not cell or (li == 0 and name == "dgrad"):
                print(f"  conv {name:5s} {str((n, b, c, o, h, k)):28s} "
                      f"rel err {err:.2e}", flush=True)
                continue
            nbytes, flops = cost[name]
            rec = _timed(card, flush, timer, f"conv_{name}", n,
                         (b, c, o, h, k), torch.float32, kern, plain, lib,
                         nbytes, flops)
            kernels.reset_launch_counts()
            kern()
            rec.update(conv=f"conv{li}", rel_err=err,
                       library_launches=len(_kernel_names(lib)),
                       launches=kernels.launch_counts()["conv"])
            records.append(rec)
            rows[f"conv{li}_{name}"] = rec
        torch.cuda.empty_cache()
    step = conv_step_check(dev)
    repeat = conv_cell_repeat(dev)
    main = dict(rows["conv2_fprop"])
    return {"rows": rows, "max_rel_err": worst, "step": step,
            "cell_repeat": repeat, "main": main}


def conv_cell_repeat(dev="cuda", seed=2718281829, rounds=6) -> dict:
    """The benchmark cell's program (``perfbench``: CNN2, 100 clients,
    vmapped local SGD on the batched engine) twice from one seed for its
    checked rounds: the global models are bit-equal, and the conv
    kernels ran."""
    import torch
    from perfbench import harness, inputs, program
    from repro_torch.kernels.conv import ops as conv_ops
    from repro_torch import kernels
    cell = harness.load_cell(ROOT, "cnn2.c100.fused")
    finals = []
    for _ in range(2):
        kernels.reset_launch_counts()
        prog = program.build(cell.cfg, cell.traffic, inputs.make_inputs(
            cell.cfg, cell.traffic, seed, torch.device(dev)), None)
        prog.run(rounds)
        finals.append({n: {k: t.clone() for k, t in lay.items()}
                       for n, lay in prog.state()[0].items()})
        launches = conv_ops.route_counts()
        del prog
    for n, lay in finals[0].items():
        for k, t in lay.items():
            if not torch.equal(t, finals[1][n][k]):
                raise AssertionError(f"two runs of the cell differ at {n}.{k}")
    if launches["fprop"] != 3 * 10 * rounds:
        raise AssertionError(f"the cell's rounds launched {launches}")
    print(f"  cell {rounds} rounds twice from seed {seed}: global models "
          f"bit-equal, conv launches {launches}", flush=True)
    return dict(seed=seed, rounds=rounds, bit_equal=True, launches=launches)


def conv_step_check(dev="cuda") -> dict:
    """One vmapped CNN2 step (``grad_and_value`` and SGD, as the
    benchmark's trainer) of CONV_CLIENTS x CONV_BATCH: launches by pass
    equal CONV_STEP_LAUNCHES, no ATen convolution is dispatched and no
    cuDNN kernel runs, two runs are bit-equal; the same step with the
    parent's ``F.conv2d`` counts its kernels; both are timed."""
    import torch
    import torch.nn.functional as F
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import kernels, tree
    from repro_torch.core.round_engine import make_batched_train_fn
    from repro_torch.fl import models
    from repro_torch.kernels.conv import ops as conv_ops
    spec = models.CNN2_SPEC
    gen = torch.Generator(device=dev).manual_seed(5)
    params = models.init_cnn_spec(spec, seed=0, device=dev)
    stacked = {n: {k: t.expand(CONV_CLIENTS, *t.shape).clone()
                   for k, t in lay.items()} for n, lay in params.items()}
    x = torch.rand((CONV_CLIENTS, CONV_BATCH, 32, 32, 3), generator=gen,
                   device=dev)
    y = torch.randint(0, 10, (CONV_CLIENTS, CONV_BATCH), generator=gen,
                      device=dev)

    def client_step(p, xb, yb):
        gr, l = torch.func.grad_and_value(
            lambda q: models._ce(models.apply_spec(q, spec, xb), yb))(p)
        return tree.tree_map(lambda a, b: a - 0.05 * b, p, gr), l

    step = make_batched_train_fn(client_step, (x, y))

    class Convs(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "convolution" in func.__name__:
                Convs.count += 1
            return func(*args, **(kwargs or {}))

    runs = [step(stacked, None) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(tree.leaves(runs[0][0]) + [runs[0][1]],
                    tree.leaves(runs[1][0]) + [runs[1][1]]):
        if not torch.equal(a, b):
            raise AssertionError("two vmapped CNN2 steps differ")
    kernels.reset_launch_counts()
    with Convs():
        step(stacked, None)
    torch.cuda.synchronize()
    got = conv_ops.route_counts()
    if got != CONV_STEP_LAUNCHES or Convs.count:
        raise AssertionError(f"a vmapped CNN2 step launched {got} and "
                             f"dispatched {Convs.count} ATen convolutions")
    names = _kernel_names(lambda: step(stacked, None))
    foreign = sorted({n for n in names if any(s in n for s in CUDNN_CONV)})
    if foreign:
        raise AssertionError(f"cuDNN kernels in the vmapped step: {foreign}")

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in ev:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    ms = timed(lambda: step(stacked, None))
    orig = models.conv2d_same
    models.conv2d_same = lambda a, w: F.conv2d(a, w, padding="same")
    try:
        parent_names = _kernel_names(lambda: step(stacked, None))
        parent_ms = timed(lambda: step(stacked, None))
    finally:
        models.conv2d_same = orig
    out = dict(launches=got, kernels=len(names),
               parent_kernels=len(parent_names), ms=ms, parent_ms=parent_ms,
               parent_conv_kernels=sum(any(s in n for s in CUDNN_CONV)
                                       for n in parent_names))
    print(f"  vmapped CNN2 step ({CONV_CLIENTS} x {CONV_BATCH}): {out}",
          flush=True)
    return out


def lm_importance_checks(card: Card, flush, records: list, dev="cuda",
                         timer=time_ms) -> list:
    """The importance kernel at every distinct rank-2+ leaf shape of the
    federated phase (one pod's leaf, N = 1, channels last), against its
    plain version (rtol 5e-5, atol 1e-5), timed with its bound."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.importance import ops as imp_ops
    from repro_torch.kernels.importance.ref import channel_importance_ref
    gen = torch.Generator(device=dev).manual_seed(7)
    out = []
    for name, leaf, dtype_name in LM_IMPORTANCE:
        dtype = getattr(torch, dtype_name)
        a, c, b = _lib.split_at(leaf, len(leaf) - 1)
        wo = (torch.randn((1, *leaf), generator=gen, device=dev)
              * 0.02).to(dtype)
        wn = (wo.float() + 1e-3 * torch.randn(
            (1, *leaf), generator=gen, device=dev)).to(dtype)
        got = imp_ops.channel_importance_batched(wo, wn)
        want = channel_importance_ref(wo.view(1, a, c, b),
                                      wn.view(1, a, c, b))
        torch.testing.assert_close(got, want, rtol=IMP_RTOL, atol=IMP_ATOL)
        err = (got - want).abs().max().item()
        plan = imp_ops.work_plan(1, a, c, b, imp_ops.sm_count(wo.device),
                                 _lib.vector_width(c, wo, wn))
        elems = wo.numel()
        rec = _timed(card, flush, timer, "importance", 1, list(leaf), dtype,
                     lambda: imp_ops.channel_importance_batched(wo, wn),
                     lambda: channel_importance_ref(wo.view(1, a, c, b),
                                                    wn.view(1, a, c, b)),
                     None, 2 * elems * wo.element_size() + c * 4, 5 * elems)
        rec.update(leaf=name, max_abs_err=err, blocks=plan.blocks,
                   splits=plan.splits)
        print(f"    {name}: {plan.blocks} blocks (splits {plan.splits}), "
              f"{rec['ms'] / rec['bound_ms']:.2f}x its bound, max |err| "
              f"{err:.3g}", flush=True)
        records.append(rec)
        out.append(rec)
        del wo, wn, got, want
    return out


def train_phase(card: Card, dev="cuda") -> dict:
    """granite-3-8b at full width cut to TRAIN_LAYERS layers: AdamW by
    ``policy_for``, its 8 microbatches, TRAIN_BATCH x TRAIN_SEQ tokens, one
    warm-up and TRAIN_STEPS timed steps; then one LONG_LAYERS-layer step at
    LONG_SEQ tokens on the chunked attention route; the flash wrapper
    refuses inputs that require grad."""
    import dataclasses
    import torch
    from repro_torch import kernels, tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import specs, train
    from repro_torch.models import lm

    t_phase = time.perf_counter()

    def run(layers, batch, seq, steps, microbatches):
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers)
        opt = train.optimizer_for(cfg, 3e-4)
        gen = torch.Generator(device=dev).manual_seed(0)
        resident.append(_fresh_peak(dev))
        state = lm.init_train_state(cfg, opt, gen, dev)
        n_params = sum(t.numel() for t in tree.leaves(state.params))
        step = lm.make_train_step(cfg, opt, microbatches)
        toks = torch.randint(0, cfg.vocab_size, (steps + 1, batch, seq),
                             generator=gen, device=dev)
        kernels.reset_launch_counts()
        times, losses = [], []
        for i in range(steps + 1):
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": toks[i]})
            losses.append(float(m["loss"]))        # waits for the device
            times.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        peak = _peak_gb()
        gnorm = float(m["grad_norm"])
        del state, m
        if not all(math.isfinite(x) for x in losses + [gnorm]):
            raise AssertionError(f"train losses {losses}, grad norm {gnorm}")
        if counts["flash_attention"]:
            raise AssertionError(f"training launched flash: {counts}")
        return cfg, n_params, times, losses, counts, peak

    resident = []
    pol = specs.policy_for(get_config(TRAIN_ARCH))
    cfg, n_params, times, losses, counts, peak = run(
        TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
        pol.num_microbatches)
    s_step = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = 6 * n_params * tokens / card.bf16_flops / s_step
    print(f"  {cfg.name} d={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.num_layers}: {n_params / 1e9:.3f} B params, "
          f"{pol.optimizer}, {pol.num_microbatches} microbatches of "
          f"{TRAIN_BATCH // pol.num_microbatches} x {TRAIN_SEQ}", flush=True)
    print(f"  train steps (s, the first a warm-up): "
          f"{[round(t, 4) for t in times]}; {s_step:.4f} s/step, "
          f"{tokens / s_step:.0f} tokens/s, 6ND share of the bf16 peak "
          f"{share:.3f}; losses {[round(x, 4) for x in losses]}; peak "
          f"{peak:.2f} GiB ({resident[0]:.2f} resident at the start); "
          f"launches {counts}  [{card.line}]", flush=True)
    long_cfg, long_params, long_t, long_loss, long_counts, long_peak = run(
        LONG_LAYERS, 1, LONG_SEQ, 0, 1)
    print(f"  {LONG_LAYERS}-layer step at S={LONG_SEQ} (chunked route): "
          f"{long_t[0]:.3f} s, loss {long_loss[0]:.4f}, peak "
          f"{long_peak:.2f} GiB, launches {long_counts}  [{card.line}]",
          flush=True)
    q = torch.randn(1, 256, 32, 128, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn(1, 256, 8, 128, device=dev, dtype=torch.bfloat16)
    try:
        flash_ops.flash_attention(q, kv, kv)
    except RuntimeError as e:
        refused = str(e).splitlines()[0]
    else:
        raise AssertionError("flash_attention took inputs that require grad")
    wall = time.perf_counter() - t_phase
    print(f"  flash wrapper with grad-requiring inputs: raised "
          f"({refused[:60]}...); train phase wall {wall:.2f} s  "
          f"[{card.line}]", flush=True)
    return dict(arch=TRAIN_ARCH, phase_wall_s=wall, layers=TRAIN_LAYERS,
                n_params=n_params, optimizer=pol.optimizer,
                microbatches=pol.num_microbatches, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, step_s=times, s_per_step=s_step,
                tokens_per_s=tokens / s_step, peak_share=share,
                losses=losses, peak_gib=peak, resident_gib=resident,
                launches=counts,
                long=dict(layers=LONG_LAYERS, seq=LONG_SEQ,
                          n_params=long_params, step_s=long_t[0],
                          loss=long_loss[0], peak_gib=long_peak,
                          launches=long_counts))


def _replicas_bit_equal(placed) -> int:
    """Every replica of every block equal to its first holder's, bit for
    bit (the phase fails otherwise); returns how many were compared."""
    import torch
    from repro_torch import tree
    from repro_torch.models import sharding
    per = [tree.named_values(sh) for sh in placed.shards]
    n = 0
    for i, sp in enumerate(tree.named_values(placed.specs)):
        for ks in sharding.holders(sp, placed.mesh):
            for k in ks[1:]:
                if not torch.equal(per[k][i], per[ks[0]][i]):
                    raise AssertionError(f"replica {k} of leaf {i} ({sp}) "
                                         f"differs from device {ks[0]}'s")
                n += 1
    return n


def _steps_timed(step, state, toks, dev, after_first=None):
    """One warm-up and ``len(toks) - 1`` timed steps of ``step`` from
    ``state`` (consumed): (s each step, losses, the first step's metrics,
    peak GiB).  ``after_first(state)`` runs untimed after the first."""
    times, losses, first = [], [], None
    for i in range(len(toks)):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": toks[i]})
        losses.append(float(m["loss"]))           # waits for the device
        times.append(time.perf_counter() - t0)
        if i == 0:
            first = {k: float(v) for k, v in m.items()}
            if after_first is not None:
                after_first(state)
    del state, m
    return times, losses, first, _peak_gb()


def lm_mesh_train_phase(card: Card, dev="cuda") -> dict:
    """Phase 7b: training on a virtual MESH_SHAPE (data, model) mesh of
    the card.  granite-3-8b as in phase 7 (TRAIN_LAYERS layers, AdamW),
    the same weights and tokens meshed (``lm.place_train_state``,
    ``make_train_step(mesh=)``) and unmeshed, each in MESH_TRAIN_MICRO
    microbatches of TRAIN_BATCH / MESH_TRAIN_MICRO x TRAIN_SEQ: the
    gathered gradients of one ``value_and_grad`` within MESH_TOL of each
    leaf's largest, the first step's loss and grad norm within
    MESH_LOSS_TOL and MESH_GNORM_TOL, every device's parameter and moment
    bytes equal to ``local_shape``'s count, every replica bit-equal after
    the step; one warm-up and TRAIN_STEPS timed steps of each.  Then one
    AdamW step of qwen3-moe (MOE_LAYERS layers) at MOE_TRAIN_BATCH x
    MOE_TRAIN_SEQ on the mesh: the expert-parallel path in every layer
    (forward and remat recompute), a finite loss within MESH_MOE_TOL of
    the unmeshed 2-block forward routed as the mesh routed.  No flash
    launch (training takes the chunked or plain attention route)."""
    import dataclasses
    import torch
    from repro_torch import kernels, tree
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import lm, moe, sharding
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    resident = _fresh_peak(dev)
    mesh = LMMesh.virtual(dev, *MESH_SHAPE)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    opt = train.optimizer_for(cfg, 3e-4)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_model(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_STEPS + 1, TRAIN_BATCH,
                                             TRAIN_SEQ), generator=gen,
                         device=dev)
    micro = {"tokens": toks[0, :TRAIN_BATCH // MESH_TRAIN_MICRO]}
    kernels.reset_launch_counts()

    # ---- one value_and_grad on the first microbatch, gathered
    _, _, want = lm.value_and_grad(params, cfg, micro)
    placed = lm.place_params(params, cfg, mesh)
    _, _, got = lm.value_and_grad(placed, cfg, micro, mesh=mesh)
    del placed
    got = sharding.gather(got)
    grad_errs = {"/".join(n): ((a.float() - b.float()).abs().max()
                               / b.float().abs().max()).item()
                 for (n, a), b in zip(tree.named_leaves(got),
                                      tree.leaves(want))}
    worst = max(grad_errs, key=grad_errs.get)
    grad_err = grad_errs[worst]
    del got, want
    print(f"  {cfg.name} {cfg.num_layers} layers on a virtual {mesh.shape} "
          f"mesh: gathered gradients of one {micro['tokens'].shape[0]} x "
          f"{TRAIN_SEQ} microbatch within {grad_err:.3g} of each leaf's "
          f"largest (limit {MESH_TOL}; worst {worst}, median "
          f"{statistics.median(grad_errs.values()):.3g})", flush=True)
    if not grad_err <= MESH_TOL:
        raise AssertionError(f"meshed gradients differ by {grad_err}")

    def fresh():
        return lm.TrainState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=dev))

    # ---- unmeshed, then meshed, at the same split
    _fresh_peak(dev)
    times0, losses0, first0, peak0 = _steps_timed(
        lm.make_train_step(cfg, opt, MESH_TRAIN_MICRO), fresh(), toks, dev)
    box = [lm.place_train_state(fresh(), cfg, mesh)]  # the step's only ref
    pbytes = _placed_bytes(box[0].params, params)
    obytes = _placed_bytes(box[0].opt_state,
                           lm.abstract_train_state(cfg, opt).opt_state)
    _fresh_peak(dev)
    checked = []
    times, losses, first, peak = _steps_timed(
        lm.make_train_step(cfg, opt, MESH_TRAIN_MICRO, mesh=mesh), box.pop(),
        toks, dev, lambda st: checked.append(
            _replicas_bit_equal(st.params)
            + _replicas_bit_equal(st.opt_state)))
    counts = kernels.launch_counts()
    s_step, s_step0 = (statistics.median(times[1:]),
                       statistics.median(times0[1:]))
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    loss_err = abs(first["loss"] - first0["loss"]) / abs(first0["loss"])
    gnorm_err = abs(first["grad_norm"] - first0["grad_norm"]) / abs(
        first0["grad_norm"])
    print(f"  {MESH_TRAIN_MICRO} microbatches of "
          f"{TRAIN_BATCH // MESH_TRAIN_MICRO} x {TRAIN_SEQ}: mesh steps (s, "
          f"the first a warm-up) {[round(t, 4) for t in times]}, "
          f"{s_step:.4f} s/step, {n_tok / s_step:.0f} tokens/s, peak "
          f"{peak:.2f} GiB; unmeshed {[round(t, 4) for t in times0]}, "
          f"{s_step0:.4f} s/step, {n_tok / s_step0:.0f} tokens/s, peak "
          f"{peak0:.2f} GiB ({resident:.2f} resident at the start); "
          f"ratio {s_step / s_step0:.3f}  [{card.line}]", flush=True)
    print(f"  first step: loss {first['loss']:.5f} mesh, "
          f"{first0['loss']:.5f} unmeshed (rel {loss_err:.3g}, limit "
          f"{MESH_LOSS_TOL}); grad norm {first['grad_norm']:.5f}, "
          f"{first0['grad_norm']:.5f} (rel {gnorm_err:.3g}, limit "
          f"{MESH_GNORM_TOL}); {checked[0]} replicas bit-equal after it; "
          f"a device holds {pbytes['per_device'][0] / 2 ** 30:.3f} GiB of "
          f"parameters and {obytes['per_device'][0] / 2 ** 30:.3f} GiB of "
          f"moments (local_shape counts {pbytes['local_shape'] / 2 ** 30:.3f}"
          f", {obytes['local_shape'] / 2 ** 30:.3f}); losses "
          f"{[round(x, 4) for x in losses]} mesh, "
          f"{[round(x, 4) for x in losses0]} unmeshed; launches {counts}",
          flush=True)
    if not (loss_err <= MESH_LOSS_TOL and gnorm_err <= MESH_GNORM_TOL):
        raise AssertionError(f"meshed first step {first}, unmeshed {first0}")
    if not all(math.isfinite(x) for x in losses + losses0) or any(
            counts.values()):
        raise AssertionError(f"mesh train losses {losses}, launches "
                             f"{counts}")
    del params
    torch.cuda.empty_cache()

    # ---- qwen3-moe: one AdamW step on the expert-parallel path
    mcfg, mparams, mgen = serve.build(MOE_ARCH, reduced=False,
                                      num_layers=MOE_LAYERS, device=dev)
    mtoks = torch.randint(0, mcfg.vocab_size,
                          (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ), generator=mgen,
                          device=dev)
    mopt = adamw(3e-4)
    mst = lm.place_train_state(lm.TrainState(
        mparams, mopt.init(mparams), torch.zeros((), dtype=torch.int32,
                                                 device=dev)), mcfg, mesh)
    routes = []
    moe.reset_dispatch_counts()
    kernels.reset_launch_counts()
    _fresh_peak(dev)
    _sync(dev)
    t0 = time.perf_counter()
    with _recorded_routes(routes):
        mst, m = lm.make_train_step(mcfg, mopt, mesh=mesh)(
            mst, {"tokens": mtoks})
        moe_loss = float(m["loss"])
    moe_s = time.perf_counter() - t0
    moe_peak = _peak_gb()
    paths, m_counts = moe.dispatch_counts(), kernels.launch_counts()
    n_moe = _replicas_bit_equal(mst.params)
    del mst, m
    want_paths = {"one_block": 0, "blocked": 0, "ep": 2 * mcfg.num_layers}
    if paths != want_paths or any(m_counts.values()) or not math.isfinite(
            moe_loss):
        raise AssertionError(f"meshed MoE step: dispatch {paths}, launches "
                             f"{m_counts}, loss {moe_loss}")
    layers_ = _mesh_layer_routes(routes[:mcfg.num_layers * mesh.size], mesh,
                                 mcfg.num_layers)
    del routes
    ties = []
    with torch.no_grad(), _forced_routes(layers_, ties):
        ref_loss = float(_two_blocks(lambda: lm.loss_fn(
            mparams, mcfg, {"tokens": mtoks})[0]))
    moe_err = abs(moe_loss - ref_loss) / abs(ref_loss)
    print(f"  {mcfg.name} {mcfg.num_layers} layers, one AdamW step "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} on the mesh: {moe_s:.4f} s, "
          f"dispatch {paths} (forward and remat recompute), loss "
          f"{moe_loss:.5f}; the unmeshed 2-block forward routed as the mesh "
          f"routed {ref_loss:.5f} (rel {moe_err:.3g}, limit "
          f"{MESH_MOE_TOL}); {n_moe} replicas bit-equal; peak "
          f"{moe_peak:.2f} GiB  [{card.line}]", flush=True)
    if not moe_err <= MESH_MOE_TOL:
        raise AssertionError(f"meshed MoE loss {moe_loss}, unmeshed routed "
                             f"alike {ref_loss}")
    del mparams
    wall = time.perf_counter() - t_phase
    print(f"  lm mesh train phase wall {wall:.2f} s  [{card.line}]",
          flush=True)
    return dict(mesh=list(MESH_SHAPE), virtual=True, phase_wall_s=wall,
                arch=TRAIN_ARCH, layers=cfg.num_layers,
                microbatches=MESH_TRAIN_MICRO, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, grad_err=grad_err, grad_errs=grad_errs,
                step_s=times,
                plain_step_s=times0, s_per_step=s_step,
                plain_s_per_step=s_step0, tokens_per_s=n_tok / s_step,
                plain_tokens_per_s=n_tok / s_step0, peak_gib=peak,
                plain_peak_gib=peak0, resident_gib=resident, first=first,
                plain_first=first0, loss_err=loss_err, gnorm_err=gnorm_err,
                losses=losses, plain_losses=losses0, param_bytes=pbytes,
                moment_bytes=obytes, replicas_checked=checked[0],
                launches=counts,
                moe=dict(arch=MOE_ARCH, layers=mcfg.num_layers,
                         batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
                         step_s=moe_s, loss=moe_loss, ref_loss=ref_loss,
                         err=moe_err, dispatch=paths, ties=ties,
                         peak_gib=moe_peak, launches=m_counts,
                         replicas_checked=n_moe))


def federated_phase(card: Card, dev="cuda") -> dict:
    """``python -m repro_torch.launch.federated`` at granite-3-8b's full
    width cut to FED_LAYERS layers: FED_PODS virtual pods of the card,
    FED_LOCAL_STEPS local SGD steps on FED_BATCH x FED_SEQ tokens, the
    allocation LP, FED_ROUNDS rounds; importance launches once for every
    rank-2+ leaf of every pod and round."""
    import numpy as np
    import torch
    from repro_torch import kernels, tree
    from repro_torch.comm.payload import WireSpec, account_collective
    from repro_torch.kernels import _lib
    from repro_torch.kernels.importance.ref import channel_importance_ref
    from repro_torch.launch import federated

    argv = ["--pods", str(FED_PODS), "--rounds", str(FED_ROUNDS),
            "--local-steps", str(FED_LOCAL_STEPS), "--batch", str(FED_BATCH),
            "--seq", str(FED_SEQ), "--full-config", "--num-layers",
            str(FED_LAYERS), "--device", str(dev)]
    # the same run first, untimed: every score the rounds compute against
    # importance's plain version on the same leaves
    scored = []
    kernel = federated.channel_importance

    def held(w_old, w_new, *, channel_axis=-1, coverage=None):
        got = kernel(w_old, w_new, channel_axis=channel_axis,
                     coverage=coverage)
        a, c, b = _lib.split_at(tuple(w_new.shape),
                                channel_axis % w_new.ndim)
        want = channel_importance_ref(w_old.reshape(1, a, c, b),
                                      w_new.reshape(1, a, c, b), coverage)[0]
        torch.testing.assert_close(got, want, rtol=IMP_RTOL, atol=IMP_ATOL)
        scored.append((tuple(w_new.shape), str(w_new.dtype).split(".")[-1],
                       (got - want).abs().max().item()))
        return got

    federated.channel_importance = held
    try:
        federated.main(argv)
    finally:
        federated.channel_importance = kernel
    shapes = sorted({(sh, dt) for sh, dt, _ in scored})
    score_err = max(e for _, _, e in scored)
    print(f"  every Eq. (20) score of the rounds against the plain version: "
          f"{len(scored)} scores over {len(shapes)} leaf shapes "
          f"{[sh for sh, _ in shapes]}, max |err| {score_err:.3g}",
          flush=True)

    resident = _fresh_peak(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pods, rounds = federated.main(argv)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = _peak_gb()
    ranked = sum(t.ndim >= 2 for t in tree.leaves(pods[0]))
    want = ranked * FED_PODS * FED_ROUNDS
    spec = WireSpec.from_params(pods[0])
    n_params = sum(t.numel() for t in tree.leaves(pods[0]))
    finite = all(bool(torch.isfinite(t.float()).all())
                 for p in pods for t in tree.leaves(p))
    on_card = all(t.device.type == torch.device(dev).type
                  for p in pods for t in tree.leaves(p))
    del pods
    coll = [account_collective(spec, FED_PODS, mode="sparse",
                               k_fraction=r["k_frac"]) for r in rounds]
    secs = [r["seconds"] for r in rounds]
    print(f"  {FED_PODS} virtual pods x {n_params / 1e9:.3f} B params "
          f"({FED_LAYERS} layers), {FED_ROUNDS} rounds: s/round "
          f"{[round(x, 4) for x in secs]} (phase wall {wall:.2f} s), "
          f"k_frac {[r['k_frac'] for r in rounds]}, peak {peak:.2f} GiB "
          f"({resident:.2f} resident at the start)  [{card.line}]",
          flush=True)
    print(f"  importance launches {counts['importance']} (predicted "
          f"{ranked} rank-2+ leaves x {FED_PODS} pods x {FED_ROUNDS} rounds "
          f"= {want}); collective bytes dense / actual per round "
          + ", ".join(f"{d / 1e9:.3f} / {a / 1e9:.3f} GB" for d, a in coll),
          flush=True)
    if counts["importance"] != want or counts["flash_attention"]:
        raise AssertionError(f"federated launches {counts}, importance "
                             f"predicted {want}")
    if len(scored) != want:
        raise AssertionError(f"{len(scored)} scores held, {want} predicted")
    if not (finite and on_card and all(np.isfinite(r["losses"]).all()
                                       for r in rounds)):
        raise AssertionError("federated params or losses not finite, or "
                             "off the card")
    return dict(arch=TRAIN_ARCH, layers=FED_LAYERS, pods=FED_PODS,
                rounds=FED_ROUNDS, local_steps=FED_LOCAL_STEPS,
                batch=FED_BATCH, seq=FED_SEQ, n_params=n_params,
                s_per_round=secs, wall_s=wall, launches=counts,
                importance_predicted=want, ranked_leaves=ranked,
                scores_held=len(scored), score_max_abs_err=score_err,
                score_shapes=[[list(sh), dt] for sh, dt in shapes],
                k_frac=[r["k_frac"] for r in rounds],
                d=[r["d"].tolist() for r in rounds],
                losses=[r["losses"].tolist() for r in rounds],
                collective_bytes=[dict(dense=d, actual=a) for d, a in coll],
                peak_gib=peak, resident_gib=resident)


def moe_phase(card: Card, dev="cuda") -> dict:
    """qwen3-moe-30b-a3b at full width cut to MOE_LAYERS layers: one
    MOE_PREFILL_SEQ-token prefill (flash on every layer, sm90), greedy
    decode at MOE_DECODE_BATCH for MOE_DECODE_STEPS steps (no kernel), and
    one AdamW step at MOE_TRAIN_BATCH x MOE_TRAIN_SEQ (no flash)."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    resident = [_fresh_peak(dev)]
    cfg, params, gen = serve.build(MOE_ARCH, reduced=False,
                                   num_layers=MOE_LAYERS, device=dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_PREFILL_SEQ),
                           generator=gen, device=dev)
    prefill_s, prefill_counts, routes = _prefill_timed(
        params, cfg, {"tokens": tokens}, {"tokens": tokens[:, :256]}, dev)
    _want_flash(cfg, prefill_counts, routes, cfg.num_layers)
    # once more, untimed: the kernel's output in every layer against its
    # plain version on the very (qk-normed) inputs the prefill gives it
    held = _prefill_flash_held(params, cfg, {"tokens": tokens})
    in_err, in_row = held["max_abs_err"], held["worst_row"]
    print(f"  MoE prefill's own flash inputs, {held['launches']} layers: "
          f"kernel vs plain max err {in_err:.3g}, worst row {in_row:.3g} of "
          f"its scale (limit {ROW_TOL:.4g})", flush=True)
    if held["launches"] != cfg.num_layers:
        raise AssertionError(f"MoE prefill flash inputs: {held}")
    del tokens

    state = lm.init_decode_state(params, cfg, MOE_DECODE_BATCH,
                                 MOE_DECODE_STEPS + 1)
    tok = torch.randint(0, cfg.vocab_size, (MOE_DECODE_BATCH, 1),
                        generator=gen, device=dev)
    kernels.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    seq, logits, state = serve.generate(params, cfg, state, tok,
                                        MOE_DECODE_STEPS)
    _sync(dev)
    ms_token = (time.perf_counter() - t0) / MOE_DECODE_STEPS * 1e3
    decode_counts = kernels.launch_counts()
    if any(decode_counts.values()) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"MoE decode launches {decode_counts} or "
                             f"non-finite logits")
    del state, logits
    serve_peak = _peak_gb()

    resident.append(_fresh_peak(dev))
    opt = adamw(3e-4)
    st = lm.TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    del params
    step = lm.make_train_step(cfg, opt)
    toks = torch.randint(0, cfg.vocab_size,
                         (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ), generator=gen,
                         device=dev)
    kernels.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    st, m = step(st, {"tokens": toks})
    loss, aux = float(m["loss"]), float(m["moe_aux"])
    train_s = time.perf_counter() - t0
    train_counts = kernels.launch_counts()
    train_peak = _peak_gb()
    del st, m
    if not (math.isfinite(loss) and aux > 0.0) or train_counts[
            "flash_attention"]:
        raise AssertionError(f"MoE train loss {loss}, aux {aux}, launches "
                             f"{train_counts}")
    print(f"  {cfg.name} d={cfg.d_model} experts={cfg.moe.num_experts} "
          f"top-{cfg.moe.top_k} d_ff={cfg.moe.d_ff_expert} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers}: "
          f"{n_params / 1e9:.3f} B params", flush=True)
    print(f"  prefill S={MOE_PREFILL_SEQ}: {prefill_s:.4f} s (flash "
          f"{routes}); decode B={MOE_DECODE_BATCH} x {MOE_DECODE_STEPS}: "
          f"{ms_token:.2f} ms/token; peak {serve_peak:.2f} GiB "
          f"({resident[0]:.2f} resident at the start); train step "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}: {train_s:.4f} s/step, loss "
          f"{loss:.4f} (moe_aux {aux:.4f}), peak {train_peak:.2f} GiB; "
          f"moe phase wall {time.perf_counter() - t_phase:.2f} s  "
          f"[{card.line}]", flush=True)
    return dict(arch=MOE_ARCH, phase_wall_s=time.perf_counter() - t_phase,
                layers=MOE_LAYERS, n_params=n_params,
                prefill_seq=MOE_PREFILL_SEQ, prefill_s=prefill_s,
                prefill_launches=prefill_counts, prefill_routes=routes,
                prefill_inputs_err=in_err, prefill_inputs_row=in_row,
                decode_batch=MOE_DECODE_BATCH,
                decode_steps=MOE_DECODE_STEPS, ms_per_token=ms_token,
                decode_launches=decode_counts, serve_peak_gib=serve_peak,
                train_batch=MOE_TRAIN_BATCH, train_seq=MOE_TRAIN_SEQ,
                train_s=train_s, train_loss=loss, train_moe_aux=aux,
                train_launches=train_counts, train_peak_gib=train_peak,
                resident_gib=resident,
                request0_tokens=seq[0, :8].tolist())


@contextlib.contextmanager
def _recorded_routes(out: list):
    """Append (expert ids (T, k), router probabilities (T, E) fp32) of
    every MoE routing to ``out`` (device tensors: no sync)."""
    import torch
    from repro_torch.models import moe
    real = moe.route

    def recording(p, x, mcfg):
        ids, probs, aux = real(p, x, mcfg)
        out.append((ids.clone(), torch.softmax(
            torch.matmul(x.float(), p["router"]), dim=-1)))
        return ids, probs, aux

    moe.route = recording
    try:
        yield out
    finally:
        moe.route = real


@contextlib.contextmanager
def _no_drops(out: list):
    """Record whether every MoE dispatch kept every assignment."""
    from repro_torch.models import moe
    real = moe._positions_in_expert

    def recording(flat_ids, e, cap):
        pos, keep = real(flat_ids, e, cap)
        out.append(bool(keep.all()))
        return pos, keep

    moe._positions_in_expert = recording
    try:
        yield out
    finally:
        moe._positions_in_expert = real


@contextlib.contextmanager
def _timed_calls(module, name: str, dev, out: dict):
    """Sum the wall seconds of every call of ``module.name`` (synchronised
    before and after) into ``out["s"]`` and count them in ``out["n"]``."""
    real = getattr(module, name)
    out.update(s=0.0, n=0)

    def timed(*a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        r = real(*a, **k)
        _sync(dev)
        out["s"] += time.perf_counter() - t0
        out["n"] += 1
        return r

    setattr(module, name, timed)
    try:
        yield out
    finally:
        setattr(module, name, real)


def _first_route_differences(fwd, dec, b: int, t_len: int):
    """Each row's first position where decode routed a token to other
    experts than the forward did, in any MoE layer (``t_len`` if nowhere),
    and the forward's gap between its k-th and (k+1)-th router
    probabilities there: (first (b,), gaps {row: gap})."""
    import torch
    n_moe = len(fwd)
    if len(dec) != n_moe * t_len:
        raise AssertionError(f"{len(dec)} decode routings for {n_moe} MoE "
                             f"layers x {t_len} steps")
    first, gaps = [t_len] * b, {}
    for layer, (f_ids, f_probs) in enumerate(fwd):
        k = f_ids.shape[1]
        f_ids = f_ids.view(b, t_len, k).sort(-1).values
        d_ids = torch.stack([dec[t * n_moe + layer][0] for t in
                             range(t_len)], 1).sort(-1).values
        probs = f_probs.view(b, t_len, -1).sort(-1, descending=True).values
        for r, t in (f_ids != d_ids).any(-1).nonzero().tolist():
            if t < first[r]:
                first[r] = t
                gaps[r] = float(probs[r, t, k - 1] - probs[r, t, k])
    return first, gaps


def _decode_vs_forward(params, cfg, gen, dev, frames=None) -> dict:
    """bf16 decode from empty states over FAMILY_CONSIST_T tokens at batch
    FAMILY_CONSIST_BATCH against ``lm.forward`` on them: the largest
    difference over the largest |logit|.  With MoE layers each row is held
    up to its first position where decode picked other experts than the
    forward (a bf16 near-tie of two router probabilities, which must be
    within NEAR_TIE), and no dispatch may drop an assignment."""
    import torch
    from repro_torch.models import lm
    b, t_len = FAMILY_CONSIST_BATCH, FAMILY_CONSIST_T
    prompt = torch.randint(0, cfg.vocab_size, (b, t_len), generator=gen,
                           device=dev)
    batch = {"tokens": prompt}
    if frames is not None:
        batch["enc_frames"] = frames[:b]
    fwd, dec, kept = [], [], []
    with _no_drops(kept), torch.inference_mode():
        with _recorded_routes(fwd):
            full, _ = lm.forward(params, cfg, batch)
        st = lm.init_decode_state(params, cfg, b, t_len,
                                  enc_frames=batch.get("enc_frames"))
        step = lm.make_serve_step(cfg)
        outs = []
        with _recorded_routes(dec):
            for t in range(t_len):
                lg, st = step(params, st, prompt[:, t:t + 1])
                outs.append(lg)
    logits = torch.stack(outs, 1)
    if not all(kept):
        raise AssertionError("an expert dropped an assignment: decode = "
                             "forward needs none")
    first, gaps = ([t_len] * b, {}) if not fwd else \
        _first_route_differences(fwd, dec, b, t_len)
    bad = {r: g for r, g in gaps.items() if not g <= NEAR_TIE}
    if bad or sum(first) < b * t_len // 2:
        raise AssertionError(f"decode picked other experts than the forward "
                             f"at rows {first} with gaps {gaps}")
    scale = full.float().abs().max()
    err = max(((logits[r, :first[r]].float() - full[r, :first[r]].float())
               .abs().max() / scale).item() for r in range(b) if first[r])
    del st, full, logits
    return dict(err=err, held=first, gaps=gaps, dispatches=len(kept))


def _prefill_timed(params, cfg, batch, warm, dev):
    """One warm-up prefill on ``warm``, then ``batch`` timed with the counts
    set to 0 just before -> (seconds, launches, flash launches by route)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import lm
    lm.prefill(params, cfg, warm)
    kernels.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    last = lm.prefill(params, cfg, batch)
    _sync(dev)
    secs = time.perf_counter() - t0
    counts, routes = kernels.launch_counts(), flash_ops.route_counts()
    b = batch["tokens"].shape[0]
    if tuple(last.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(last).all()):
        raise AssertionError(f"{cfg.name} prefill logits "
                             f"{tuple(last.shape)} not finite")
    return secs, counts, routes


def _want_flash(cfg, counts: dict, routes: dict, flash: int) -> None:
    """A prefill launched flash attention ``flash`` times, all on the
    sm90 route, and no other kernel."""
    from repro_torch import kernels
    want = {k: 0 for k in kernels.KERNELS}
    want["flash_attention"] = flash
    if counts != want or routes != {"sm90": flash, "fma": 0}:
        raise AssertionError(f"{cfg.name} prefill launches {counts}, "
                             f"routes {routes}; want flash {flash} on sm90")


def _prefill_flash_held(params, cfg, batch, mesh=None) -> dict:
    """The prefill (on ``mesh`` if given) once more, untimed, each flash
    launch held against the plain version on its very inputs (in row
    chunks) at 2e-2 and per row within ROW_TOL of its scale -> launches,
    max error, worst row."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        gqa_attention_ref_chunked, worst_row_error)
    from repro_torch.models import lm
    errs = []
    kernel = flash_ops.flash_attention

    def held(q, k, v, *, causal=True, window=0):
        out = kernel(q, k, v, causal=causal, window=window)
        want = gqa_attention_ref_chunked(q, k, v, causal=causal,
                                         window=window, rows=PLAIN_ROWS)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        errs.append(((out.float() - want.float()).abs().max().item(),
                     worst_row_error(out, want)))
        del want
        return out

    flash_ops.flash_attention = held
    try:
        lm.prefill(params, cfg, batch, mesh=mesh)
    finally:
        flash_ops.flash_attention = kernel
    worst = max((r for _, r in errs), default=0.0)
    if not worst <= ROW_TOL:
        raise AssertionError(f"{cfg.name} prefill flash rows: {errs}")
    return dict(launches=len(errs), max_abs_err=max(
        (e for e, _ in errs), default=0.0), worst_row=worst)


def _decode_timed(params, cfg, gen, dev, frames=None) -> dict:
    """FAMILY_DECODE_STEPS greedy steps at FAMILY_DECODE_BATCH from empty
    states (and the encoder over ``frames``), with the counts set to 0
    just before: no kernel launches, finite logits, states on the card."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.launch import serve
    from repro_torch.models import lm
    b, steps = FAMILY_DECODE_BATCH, FAMILY_DECODE_STEPS
    state = lm.init_decode_state(params, cfg, b, steps + 1,
                                 enc_frames=frames)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        device=dev)
    kernels.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    seq, logits, state = serve.generate(params, cfg, state, tok, steps)
    _sync(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    counts = kernels.launch_counts()
    if any(counts.values()) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} decode launches {counts} or "
                             f"non-finite logits")
    dev_type = torch.device(dev).type
    if not all(f.device.type == dev_type
               for nt in tree.leaves(state.stack) for f in nt):
        raise AssertionError(f"{cfg.name} decode states left the device")
    return dict(ms_per_token=ms, launches=counts,
                request0_tokens=seq[0, :8].tolist())


def _no_moe_drops(cfg):
    """The config with room in every expert for every token (E / k)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def families_phase(card: Card, dev="cuda") -> dict:
    """Phase 10: jamba (full width, JAMBA_LAYERS layers), xlstm-1.3b,
    pixtral-12b and whisper-medium (full configs), one at a time: a
    prefill (launches as predicted; flash held against its plain version
    on its own inputs), greedy decode at FAMILY_DECODE_BATCH, and bf16
    decode against forward where the check is asked for."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.launch import serve
    from repro_torch.models import lm, ssm, xlstm

    t_phase = time.perf_counter()
    out = {}

    def start(arch, layers=0):
        resident = _fresh_peak(dev)
        t0 = time.perf_counter()
        cfg, params, gen = serve.build(arch, reduced=False,
                                       num_layers=layers, device=dev)
        _sync(dev)
        n = sum(t.numel() for t in tree.leaves(params))
        print(f"  {cfg.name} d={cfg.d_model} heads={cfg.num_heads}/"
              f"{cfg.num_kv_heads} layers={cfg.num_layers}"
              f"{f' + {cfg.encoder_layers} encoder' if cfg.is_encdec else ''}"
              f" vocab={cfg.vocab_size}: {n / 1e9:.3f} B params, init "
              f"{time.perf_counter() - t0:.2f} s ({resident:.2f} GiB "
              f"resident at the start)", flush=True)
        return cfg, params, gen, dict(arch=arch, layers=cfg.num_layers,
                                      n_params=n, resident_gib=resident)

    def report(rec, cfg):
        rec.update(peak_gib=_peak_gb(), wall_s=time.perf_counter() - t0)
        flash = rec.get("flash_held", {})
        print(f"  {cfg.name}: prefill {rec['prefill_seq']} positions "
              f"{rec['prefill_s']:.4f} s, launches "
              f"{rec['prefill_launches']}; decode B={FAMILY_DECODE_BATCH} x "
              f"{FAMILY_DECODE_STEPS}: {rec['decode']['ms_per_token']:.2f} "
              f"ms/token; peak {rec['peak_gib']:.2f} GiB"
              + (f"; flash held on its own inputs: {flash['launches']} "
                 f"launches, max err {flash['max_abs_err']:.3g}, worst row "
                 f"{flash['worst_row']:.3g} of its scale" if flash else "")
              + (f"; decode vs forward bf16 {rec['consistency']['err']:.3g}"
                 f" (limit {FAMILY_TOL.get(rec['arch'], 'none')}, rows held"
                 f" to {rec['consistency']['held']})" if "consistency" in rec
                 else "")
              + f"; {rec['wall_s']:.1f} s  [{card.line}]", flush=True)

    # ---- (a) jamba at full width, 4 layers: mamba, attn+moe, mamba, mamba+moe
    t0 = time.perf_counter()
    cfg, params, gen, rec = start(JAMBA_ARCH, JAMBA_LAYERS)
    layout = [(s.mixer, s.ff) for s in cfg.layout()]
    if layout != [("mamba", "dense"), ("attn", "moe"), ("mamba", "dense"),
                  ("mamba", "moe")]:
        raise AssertionError(f"jamba layout {layout}")
    toks = torch.randint(0, cfg.vocab_size, (1, JAMBA_PREFILL),
                         generator=gen, device=dev)
    batch = {"tokens": toks}
    secs, counts, routes = _prefill_timed(params, cfg, batch,
                                          {"tokens": toks[:, :256]}, dev)
    _want_flash(cfg, counts, routes, 1)
    mamba = {}
    with _timed_calls(ssm, "mamba_forward", dev, mamba):
        _sync(dev)
        t1 = time.perf_counter()
        lm.prefill(params, cfg, batch)
        _sync(dev)
        whole = time.perf_counter() - t1
    rec.update(prefill_seq=JAMBA_PREFILL, prefill_s=secs,
               prefill_launches=counts, prefill_routes=routes,
               mamba_layers=mamba["n"], mamba_s=mamba["s"],
               mamba_share=mamba["s"] / whole,
               flash_held=_prefill_flash_held(params, cfg, batch))
    print(f"  jamba prefill: the {mamba['n']} mamba layers take "
          f"{mamba['s']:.4f} s of an instrumented {whole:.4f} s "
          f"({mamba['s'] / whole:.1%})", flush=True)
    del toks, batch
    rec["decode"] = _decode_timed(params, cfg, gen, dev)
    rec["consistency"] = _decode_vs_forward(params, _no_moe_drops(cfg),
                                            gen, dev)
    report(rec, cfg)
    if not rec["consistency"]["err"] <= FAMILY_TOL[JAMBA_ARCH]:
        raise AssertionError(f"jamba decode vs forward {rec['consistency']}")
    out["jamba"] = rec
    del params

    # ---- (b) xlstm-1.3b, the full config (48 layers)
    t0 = time.perf_counter()
    cfg, params, gen, rec = start(XLSTM_ARCH)
    toks = torch.randint(0, cfg.vocab_size, (1, XLSTM_PREFILL),
                         generator=gen, device=dev)
    batch = {"tokens": toks}
    secs, counts, routes = _prefill_timed(params, cfg, batch,
                                          {"tokens": toks[:, :256]}, dev)
    _want_flash(cfg, counts, routes, 0)
    slstm = {}
    with _timed_calls(xlstm, "slstm_forward", dev, slstm):
        _sync(dev)
        t1 = time.perf_counter()
        lm.prefill(params, cfg, batch)
        _sync(dev)
        whole = time.perf_counter() - t1
    # device operations a sLSTM step issues: one layer at a short length
    pi = next(i for i, s in enumerate(lm.plan_for(cfg).period)
              if s.mixer == "slstm")
    layer = tree.tree_map(lambda t: t[0],
                          params["stack"]["super"][f"p{pi}"]["mixer"])
    h = torch.randn((1, SLSTM_PROFILE_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        ops = _profile_ops(lambda: xlstm.slstm_forward(layer, cfg, h), dev)
    rec.update(prefill_seq=XLSTM_PREFILL, prefill_s=secs,
               prefill_launches=counts, prefill_routes=routes,
               slstm_layers=slstm["n"], slstm_s=slstm["s"],
               slstm_share=slstm["s"] / whole,
               slstm_ops_per_step=ops["cuda_ops"] / SLSTM_PROFILE_SEQ)
    print(f"  xlstm prefill: the {slstm['n']} sLSTM layers take "
          f"{slstm['s']:.4f} s of an instrumented {whole:.4f} s "
          f"({slstm['s'] / whole:.1%}); a sLSTM layer issues "
          f"{ops['cuda_ops']} device ops over {SLSTM_PROFILE_SEQ} steps "
          f"({rec['slstm_ops_per_step']:.1f} a step)", flush=True)
    del toks, batch, layer, h
    rec["decode"] = _decode_timed(params, cfg, gen, dev)
    rec["consistency"] = _decode_vs_forward(params, cfg, gen, dev)
    report(rec, cfg)
    del params
    # decode = forward in fp32 over one period at full width (TF32 off)
    _, params, gen = serve.build(XLSTM_ARCH, reduced=False,
                                 num_layers=XLSTM_CONSIST_LAYERS, device=dev)
    params = tree.tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, num_layers=XLSTM_CONSIST_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec["consistency_fp32"] = _decode_vs_forward(params, cfg32, gen, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err32 = rec["consistency_fp32"]["err"]
    print(f"  xlstm decode vs forward, fp32, {XLSTM_CONSIST_LAYERS} layers: "
          f"{err32:.3g} (limit {XLSTM_FP32_TOL})", flush=True)
    if not err32 <= XLSTM_FP32_TOL:
        raise AssertionError(f"xlstm fp32 decode vs forward {err32}")
    out["xlstm"] = rec
    del params

    # ---- (c) pixtral-12b: 256 patch embeddings + 8192 text tokens
    t0 = time.perf_counter()
    cfg, params, gen, rec = start(PIXTRAL_ARCH)
    toks = torch.randint(0, cfg.vocab_size, (1, PIXTRAL_TEXT),
                         generator=gen, device=dev)
    patches = torch.randn((1, cfg.num_patch_tokens, cfg.d_model),
                          generator=gen, device=dev).to(torch.bfloat16)
    batch = {"tokens": toks, "patch_embeds": patches}
    secs, counts, routes = _prefill_timed(
        params, cfg, batch, {"tokens": toks[:, :256],
                             "patch_embeds": patches}, dev)
    _want_flash(cfg, counts, routes, cfg.num_layers)
    rec.update(prefill_seq=cfg.num_patch_tokens + PIXTRAL_TEXT,
               prefill_s=secs, prefill_launches=counts,
               prefill_routes=routes,
               flash_held=_prefill_flash_held(params, cfg, batch))
    del toks, patches, batch
    rec["decode"] = _decode_timed(params, cfg, gen, dev)
    report(rec, cfg)
    out["pixtral"] = rec
    del params

    # ---- (d) whisper-medium: the encoder over 1500 frames, a 448-token
    # decoder prefill, decode over the cached encoder output
    t0 = time.perf_counter()
    cfg, params, gen, rec = start(WHISPER_ARCH)
    frames = torch.randn((FAMILY_DECODE_BATCH, cfg.encoder_seq_cap,
                          cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (1, WHISPER_DEC),
                         generator=gen, device=dev)
    batch = {"tokens": toks, "enc_frames": frames[:1]}
    secs, counts, routes = _prefill_timed(
        params, cfg, batch, {"tokens": toks[:, :64],
                             "enc_frames": frames[:1]}, dev)
    _want_flash(cfg, counts, routes, 0)
    rec.update(prefill_seq=WHISPER_DEC, encoder_frames=cfg.encoder_seq_cap,
               prefill_s=secs, prefill_launches=counts,
               prefill_routes=routes)
    rec["decode"] = _decode_timed(params, cfg, gen, dev, frames)
    rec["consistency"] = _decode_vs_forward(params, cfg, gen, dev, frames)
    report(rec, cfg)
    if not rec["consistency"]["err"] <= FAMILY_TOL[WHISPER_ARCH]:
        raise AssertionError(f"whisper decode vs forward "
                             f"{rec['consistency']}")
    out["whisper"] = rec
    del params, frames, toks, batch
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  families phase: {out['wall_s']:.1f} s", flush=True)
    return out


def _mesh_family_model(arch: str, layers: int, fp32: bool, dev):
    """``serve.build`` of ``arch`` at full width (``layers`` > 0 cuts its
    depth), in fp32 if asked: (cfg, params, generator)."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import serve
    cfg, params, gen = serve.build(arch, reduced=False, num_layers=layers,
                                   device=dev)
    if fp32:
        params = tree.tree_map(lambda t: t.float(), params)
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    _sync(dev)
    return cfg, params, gen


def _mesh_family_batch(cfg, b: int, seq: int, patches: int, frames: int,
                       gen, dev) -> dict:
    """Random tokens (b, seq), and the patch embeddings and encoder frames
    the family takes, in its dtype."""
    import torch
    dt = torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, seq),
                                   generator=gen, device=dev)}
    for key, n in (("patch_embeds", patches), ("enc_frames", frames)):
        if n:
            out[key] = torch.randn((b, n, cfg.d_model), generator=gen,
                                   device=dev).to(dt)
    return out


def _two_blocks(fn):
    """``fn()`` with the MoE dispatched in 2 blocks, as the (2, 2) mesh's
    2 rows dispatch it."""
    import functools
    from repro_torch.models import moe
    real = moe.apply_moe
    moe.apply_moe = functools.partial(real, n_blocks=2)
    try:
        return fn()
    finally:
        moe.apply_moe = real


def _teacher_forced(params, cfg, seq, frames, dev, mesh=None):
    """FAMILY_DECODE_STEPS serve steps fed ``seq``'s tokens from empty
    states: (logits (B, steps, V), ms per step, the state)."""
    import torch
    from repro_torch.models import lm
    b, steps = seq.shape
    st = lm.init_decode_state(params, cfg, b, steps, enc_frames=frames,
                              mesh=mesh)
    step = lm.make_serve_step(cfg, mesh)
    outs = []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(steps):
        lg, st = step(params, st, seq[:, t:t + 1])
        outs.append(lg)
    _sync(dev)
    return torch.stack(outs, 1), (time.perf_counter() - t0) / steps * 1e3, st


def _mesh_family_serve(card: Card, arch: str, mesh, dev) -> dict:
    """Phase 10b's serving half for one family: the unmeshed prefill and
    teacher-forced decode, then the same on the mesh (the whole
    parameters freed where they and the mesh's gathered blocks would not
    fit together, and gathered back after), flash launches and every
    device's bytes asserted, each launch held on its own inputs; MoE
    layers compared as ``lm_mesh_phase`` compares them."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import lm, moe, sharding
    from repro_torch.models.attention import FLASH_MIN_SEQ

    t0 = time.perf_counter()
    resident = _fresh_peak(dev)
    layers = {JAMBA_ARCH: MESH_JAMBA_LAYERS, PIXTRAL_ARCH: MESH_PIXTRAL_LAYERS,
              XLSTM_ARCH: XLSTM_CONSIST_LAYERS}.get(arch, 0)
    cfg, params, gen = _mesh_family_model(arch, layers, arch == XLSTM_ARCH,
                                          dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    tol = MESH_FAMILY_TOL[arch]
    b = MESH_FAMILY_BATCH
    text = {JAMBA_ARCH: JAMBA_PREFILL, XLSTM_ARCH: XLSTM_PREFILL,
            PIXTRAL_ARCH: PIXTRAL_TEXT, WHISPER_ARCH: WHISPER_DEC}[arch]
    patches = cfg.num_patch_tokens if cfg.family == "vlm" else 0
    frames_n = cfg.encoder_seq_cap if cfg.is_encdec else 0
    batch = _mesh_family_batch(cfg, b, text, patches, frames_n, gen, dev)
    warm = dict(batch, tokens=batch["tokens"][:, :64])
    seq = torch.randint(0, cfg.vocab_size, (FAMILY_DECODE_BATCH,
                                            FAMILY_DECODE_STEPS),
                        generator=gen, device=dev)
    frames = (_mesh_family_batch(cfg, FAMILY_DECODE_BATCH, 1, 0, frames_n,
                                 gen, dev)["enc_frames"] if frames_n
              else None)
    n_attn = sum(s.mixer in ("attn", "attn_local") for s in cfg.layout())
    flash = n_attn * mesh.size if text + patches >= FLASH_MIN_SEQ else 0
    n_moe = sum(s.ff == "moe" for s in cfg.layout())
    ref = ((lambda p, bt: _two_blocks(lambda: lm.prefill(p, cfg, bt)))
           if n_moe else (lambda p, bt: lm.prefill(p, cfg, bt)))
    print(f"  {cfg.name} d={cfg.d_model} layers={cfg.num_layers}"
          f"{f' + {cfg.encoder_layers} encoder' if cfg.is_encdec else ''} "
          f"{cfg.param_dtype}: {n_params / 1e9:.3f} B params; prefill {b} x "
          f"({f'{patches} patches + ' if patches else ''}"
          f"{f'{frames_n} frames + ' if frames_n else ''}{text} tokens)",
          flush=True)

    # ---- unmeshed: prefill (MoE in 2 blocks), teacher-forced decode
    ref(params, warm)
    _fresh_peak(dev)
    ref_routes = []
    t1 = time.perf_counter()
    with _recorded_routes(ref_routes):
        want = ref(params, batch)
    _sync(dev)
    plain_s = time.perf_counter() - t1
    plain_peak = _peak_gb()
    dec0, dec0_ms, _ = _teacher_forced(params, cfg, seq, frames, dev)

    # ---- the mesh
    placed = lm.place_params(params, cfg, mesh)
    pbytes = _placed_bytes(placed, params)
    if n_moe:     # jamba: the MoE layer's gathered experts need the room
        del params
        torch.cuda.empty_cache()
    lm.prefill(placed, cfg, warm, mesh=mesh)
    _fresh_peak(dev)
    mesh_routes, mesh_dec_routes = [], []
    moe.reset_dispatch_counts()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    with _recorded_routes(mesh_routes):
        got = lm.prefill(placed, cfg, batch, mesh=mesh)
    _sync(dev)
    mesh_s = time.perf_counter() - t1
    mesh_peak = _peak_gb()
    counts, routes = kernels.launch_counts(), flash_ops.route_counts()
    paths = moe.dispatch_counts()
    _want_flash(cfg, counts, routes, flash)
    if tuple(got.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name} meshed prefill logits "
                             f"{tuple(got.shape)}")
    held = (_prefill_flash_held(placed, cfg, batch, mesh) if flash
            else None)
    if held is not None and held["launches"] != flash:
        raise AssertionError(f"{cfg.name} meshed flash inputs: {held}")
    moe.reset_dispatch_counts()
    kernels.reset_launch_counts()
    with _recorded_routes(mesh_dec_routes):
        dec, dec_ms, st = _teacher_forced(placed, cfg, seq, frames, dev,
                                          mesh)
    dec_paths, dec_counts = moe.dispatch_counts(), kernels.launch_counts()
    if any(dec_counts.values()) or not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{cfg.name} meshed decode launches "
                             f"{dec_counts}")
    shapes = lm.abstract_decode_state(cfg, FAMILY_DECODE_BATCH,
                                      FAMILY_DECODE_STEPS, frames_n)
    sbytes = _placed_bytes(st.stack, shapes.stack)
    if frames_n:
        sbytes["enc"] = _placed_bytes(st.enc, shapes.enc)
    replicas = (_replicas_bit_equal(st.stack) + _replicas_bit_equal(placed)
                + (_replicas_bit_equal(st.enc) if frames_n else 0))
    del st
    rec = dict(arch=arch, layers=cfg.num_layers, dtype=cfg.param_dtype,
               n_params=n_params, resident_gib=resident, batch=b,
               prefill_text=text, patches=patches, frames=frames_n,
               param_bytes=pbytes, state_bytes=sbytes, tol=tol,
               prefill_s=mesh_s, prefill_plain_s=plain_s,
               prefill_peak_gib=mesh_peak, prefill_plain_peak_gib=plain_peak,
               prefill_launches=counts, prefill_routes=routes,
               flash_held=held, decode_batch=FAMILY_DECODE_BATCH,
               decode_steps=FAMILY_DECODE_STEPS, decode_ms=dec_ms,
               decode_plain_ms=dec0_ms, decode_launches=dec_counts,
               replicas_checked=replicas)

    rec["prefill_err"] = _rel_err(got, want)
    rec["decode_err"] = _rel_err(dec, dec0)
    if n_moe:
        # the mesh's routings: the prefill's EP blocks by row, decode's one
        # block routed whole on every device (device 0's read)
        if paths != {"one_block": 0, "blocked": 0, "ep": n_moe} or \
                dec_paths != {"one_block": n_moe * FAMILY_DECODE_STEPS,
                              "blocked": 0, "ep": 0}:
            raise AssertionError(f"{cfg.name} meshed dispatch: prefill "
                                 f"{paths}, decode {dec_paths}")
        mesh_layers = _mesh_layer_routes(mesh_routes, mesh, n_moe)
        flips, gap, last = _mesh_route_flips(ref_routes, mesh_layers, b,
                                             text)
        params = sharding.gather(placed)
        del placed
        torch.cuda.empty_cache()
        ties, dec_ties = [], []
        with _forced_routes(mesh_layers, ties):
            forced = ref(params, batch)
        with _forced_routes(mesh_dec_routes[::mesh.size], dec_ties):
            dec_forced, _, _ = _teacher_forced(params, cfg, seq, frames, dev)
        scale = want.float().abs().max()
        row_err = [((got[r].float() - want[r].float()).abs().max()
                    / scale).item() for r in range(b)]
        rows = [r for r in range(b) if not last[r]]
        rec.update(dispatch=paths, decode_dispatch=dec_paths, flips=flips,
                   max_gap=gap, row_err=row_err, held_rows=rows,
                   forced_err=_rel_err(got, forced),
                   decode_forced_err=_rel_err(dec, dec_forced),
                   ties=ties + dec_ties,
                   tie_std=max(t["below"] for t in ties + dec_ties),
                   moved_std=max(t["moved"] for t in ties + dec_ties))
        bad = [rec["forced_err"], rec["decode_forced_err"]] + [
            row_err[r] for r in rows]
        del forced, dec_forced
    else:
        bad = [rec["prefill_err"], rec["decode_err"]]
    del params, got, want, dec, dec0
    if len(ref_routes) != n_moe or len(mesh_dec_routes) != \
            n_moe * FAMILY_DECODE_STEPS * mesh.size:
        raise AssertionError(f"{cfg.name} routings recorded: "
                             f"{len(ref_routes)}, {len(mesh_dec_routes)}")
    rec["wall_s"] = time.perf_counter() - t0
    print(f"  {cfg.name} on {mesh.shape}: prefill {rec['prefill_s']:.4f} s "
          f"(unmeshed {rec['prefill_plain_s']:.4f}), flash {routes} held on "
          f"its own inputs {held}; decode {FAMILY_DECODE_BATCH} x "
          f"{FAMILY_DECODE_STEPS}: {dec_ms:.2f} ms/token (unmeshed "
          f"{dec0_ms:.2f}); max |diff| / max |logit| prefill "
          f"{rec['prefill_err']:.3g}, decode {rec['decode_err']:.3g} (limit "
          f"{tol}); {pbytes['per_device'][0] / 2 ** 30:.3f} GiB of "
          f"parameters and {sbytes['per_device'][0] / 2 ** 20:.2f} MiB of "
          f"decode state a device (local_shape counts); {replicas} replicas "
          f"bit-equal after decode; peak {mesh_peak:.2f} GiB meshed, "
          f"{plain_peak:.2f} unmeshed ({resident:.2f} resident); "
          f"{rec['wall_s']:.1f} s  [{card.line}]", flush=True)
    if n_moe:
        print(f"  {cfg.name} MoE: dispatch {paths} / decode {dec_paths}; "
              f"{flips} token-layers routed elsewhere in the prefill (gap <= "
              f"{gap:.3g}); rows {[round(e, 5) for e in rec['row_err']]} "
              f"held {rows}; routed as the mesh routed: prefill "
              f"{rec['forced_err']:.3g}, decode "
              f"{rec['decode_forced_err']:.3g} (limit {tol}); the mesh's "
              f"weakest expert <= {rec['tie_std']:.3g} router-logit std "
              f"below the k-th (limit {MESH_TIE_STD})", flush=True)
        if not rec["tie_std"] <= MESH_TIE_STD:
            raise AssertionError(f"{cfg.name}: the mesh picked an expert "
                                 f"{rec['tie_std']} std below the k-th")
    if not all(e <= tol for e in bad):
        raise AssertionError(f"{cfg.name} meshed against unmeshed: {bad} "
                             f"(limit {tol})")
    return rec


def _mesh_family_train(card: Card, arch: str, mesh, dev) -> dict:
    """Phase 10b's training half at MESH_FAMILY_BATCH x MESH_FAMILY_TRAIN's
    tokens: one ``value_and_grad`` unmeshed and on the mesh, each leaf's
    gathered gradient within MESH_GRAD_TOL of it in L2 norm (its largest
    element's error reported); then AdamW steps unmeshed and on the mesh
    from the same state (the unmeshed one freed first): the first steps'
    losses within MESH_LOSS_TOL and grad norms within MESH_GNORM_TOL,
    every device's parameter and moment bytes ``local_shape``'s, every
    replica bit-equal after the first step, no kernel launched; a second
    step of each timed."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.models import lm, sharding
    from repro_torch.optim import adamw

    cfg, params, gen = _mesh_family_model(
        arch, MESH_FAMILY_TRAIN_LAYERS[arch], arch == XLSTM_ARCH, dev)
    batch = _mesh_family_batch(cfg, MESH_FAMILY_BATCH,
                               *MESH_FAMILY_TRAIN[arch], gen, dev)
    opt = adamw(3e-4)
    kernels.reset_launch_counts()

    def errs(got, want):
        """Each leaf's |difference| over |gradient|: (largest over
        largest, the L2 norm over the L2 norm)."""
        out = {}
        for (n, a), b in zip(tree.named_leaves(got), tree.leaves(want)):
            d, b = a.float() - b.float(), b.float()
            out["/".join(n)] = ((d.abs().max() / b.abs().max()).item(),
                                (d.norm() / b.norm()).item())
        return out

    def worst(e, i):
        name = max(e, key=lambda n: e[n][i])
        return name, e[name][i], statistics.median(v[i] for v in e.values())

    # ---- one value_and_grad, gathered, against the unmeshed one
    _, _, want = lm.value_and_grad(params, cfg, batch)
    placed = lm.place_params(params, cfg, mesh)
    _, _, got = lm.value_and_grad(placed, cfg, batch, mesh=mesh)
    del placed
    grad_errs = errs(sharding.gather(got), want)
    grad_counts = kernels.launch_counts()
    del got, want
    torch.cuda.empty_cache()
    l2_leaf, grad_err, l2_med = worst(grad_errs, 1)
    max_leaf, grad_max_err, max_med = worst(grad_errs, 0)
    print(f"  {cfg.name} {cfg.num_layers} layers, gathered gradients of one "
          f"{MESH_FAMILY_BATCH} x {MESH_FAMILY_TRAIN[arch]} batch, "
          f"{len(grad_errs)} leaves: |diff| / |grad| (L2) worst "
          f"{grad_err:.3g} ({l2_leaf}), median {l2_med:.3g} (limit "
          f"{MESH_GRAD_TOL}); max |diff| / max |grad| worst "
          f"{grad_max_err:.3g} ({max_leaf}), median {max_med:.3g}",
          flush=True)
    if not grad_err <= MESH_GRAD_TOL or any(grad_counts.values()):
        raise AssertionError(f"{cfg.name} meshed gradients differ by "
                             f"{grad_err} ({l2_leaf}); launches "
                             f"{grad_counts}")

    def fresh():
        return lm.TrainState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=dev))

    def two(state, mesh_=None):
        """The first step (its loss and grad norm, and the replicas after
        it) and a second, timed: (loss, grad norm, s, peak GiB,
        replicas)."""
        _fresh_peak(dev)
        kernels.reset_launch_counts()
        step = lm.make_train_step(cfg, opt, mesh=mesh_)
        state, m = step(state, batch)
        loss = float(m["loss"])                    # waits for the device
        gnorm = float(m["grad_norm"])
        replicas = 0 if mesh_ is None else (
            _replicas_bit_equal(state.params)
            + _replicas_bit_equal(state.opt_state))
        t1 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        return loss, gnorm, time.perf_counter() - t1, _peak_gb(), replicas

    loss0, gnorm0, s0, peak0, _ = two(fresh())
    box = [lm.place_train_state(fresh(), cfg, mesh)]   # the step's only ref
    pbytes = _placed_bytes(box[0].params, params)
    obytes = _placed_bytes(box[0].opt_state,
                           lm.abstract_train_state(cfg, opt).opt_state)
    loss, gnorm, s, peak, replicas = two(box.pop(), mesh)
    counts = kernels.launch_counts()
    del params
    err = abs(loss - loss0) / abs(loss0)
    gnorm_err = abs(gnorm - gnorm0) / abs(gnorm0)
    print(f"  {cfg.name} {cfg.num_layers} layers, AdamW at "
          f"{MESH_FAMILY_BATCH} x {MESH_FAMILY_TRAIN[arch]} (tokens, "
          f"patches, frames), the second step timed: mesh {s:.4f} s, first "
          f"loss {loss:.5f}, grad norm {gnorm:.5g}, peak {peak:.2f} GiB; "
          f"unmeshed {s0:.4f} s, loss {loss0:.5f}, grad norm {gnorm0:.5g}, "
          f"peak {peak0:.2f} GiB (rel {err:.3g}, limit {MESH_LOSS_TOL}; "
          f"{gnorm_err:.3g}, limit {MESH_GNORM_TOL}); "
          f"{pbytes['per_device'][0] / 2 ** 30:.3f} GiB of parameters and "
          f"{obytes['per_device'][0] / 2 ** 30:.3f} GiB of moments a device; "
          f"{replicas} replicas bit-equal; launches {counts}  [{card.line}]",
          flush=True)
    if not (math.isfinite(loss) and err <= MESH_LOSS_TOL
            and gnorm_err <= MESH_GNORM_TOL) or any(counts.values()):
        raise AssertionError(f"{cfg.name} meshed step loss {loss}, grad "
                             f"norm {gnorm}, unmeshed {loss0}, {gnorm0}, "
                             f"launches {counts}")
    return dict(layers=cfg.num_layers, tokens=MESH_FAMILY_TRAIN[arch],
                batch=MESH_FAMILY_BATCH, step_s=s, plain_step_s=s0,
                loss=loss, plain_loss=loss0, loss_err=err, grad_norm=gnorm,
                plain_grad_norm=gnorm0, grad_norm_err=gnorm_err,
                grad_err=grad_err, grad_worst=l2_leaf,
                grad_max_err=grad_max_err,
                peak_gib=peak,
                plain_peak_gib=peak0, param_bytes=pbytes,
                moment_bytes=obytes, replicas_checked=replicas,
                launches=counts)


def lm_mesh_families_phase(card: Card, dev="cuda") -> dict:
    """Phase 10b: jamba, xlstm, pixtral and whisper on a virtual
    MESH_SHAPE (data, model) mesh of the card against the unmeshed path on
    the same weights and inputs (see MESH_FAMILY_TOL and the constants
    beside it): each family's prefill, teacher-forced decode and one
    AdamW step."""
    import torch
    from repro_torch.launch.mesh import LMMesh

    t_phase = time.perf_counter()
    mesh = LMMesh.virtual(dev, *MESH_SHAPE)
    out = {}
    for name, arch in (("jamba", JAMBA_ARCH), ("xlstm", XLSTM_ARCH),
                       ("pixtral", PIXTRAL_ARCH), ("whisper", WHISPER_ARCH)):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = arch != XLSTM_ARCH and tf32
        try:
            out[name] = _mesh_family_serve(card, arch, mesh, dev)
            torch.cuda.empty_cache()
            out[name]["train"] = _mesh_family_train(card, arch, mesh, dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  lm mesh families phase wall {out['wall_s']:.2f} s  "
          f"[{card.line}]", flush=True)
    return out


def _device_totals(counter) -> dict:
    """Flops and bytes of a count's device ops (host-side ops left out)."""
    ops = {k: v for k, v in counter.by_op().items()
           if not k.endswith("@host")}
    return dict(flops=sum(v["flops"] for v in ops.values()),
                bytes=sum(v["bytes"] for v in ops.values()))


def _card_against_meta(name: str, run_card, run_meta, time_card, dev
                       ) -> dict:
    """Launch-phase (b): one step counted on the card and on meta under
    ``CostCounter``; equal device flops and bytes op by op (differences
    named), the wrappers' reported kernel cost equal on both (the same
    shapes reached each kernel), the predicted peak
    within PEAK_TOL of the card's ``max_memory_allocated`` rise, and the
    roofline bound of the count under the step's measured time
    (``time_card``: seconds of one synchronised run without a counter)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.hlo_analysis import (CostCounter, Hardware,
                                                 costly_device_differences,
                                                 op_differences)
    _sync(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    with CostCounter(torch.device(dev).type) as on_card:
        run_card()
        _sync(dev)
    rise = torch.cuda.max_memory_allocated() - base
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    with CostCounter("meta") as on_meta:
        run_meta()
    trace_s = time.perf_counter() - t0
    step_s = time_card()
    diff = op_differences(on_meta.by_op(), on_card.by_op())
    costly = costly_device_differences(diff)
    for op, (m, c) in diff.items():
        print(f"    differs: {op}: meta {m}, card {c}", flush=True)
    if costly:
        raise AssertionError(f"{name}: meta and card counts differ in "
                             f"device ops {sorted(costly)}")
    dm, dc = _device_totals(on_meta), _device_totals(on_card)
    if dm != dc:
        raise AssertionError(f"{name}: device totals {dm} != {dc}")
    kern = {k: (on_meta.by_op().get(k), on_card.by_op().get(k))
            for k in set(on_meta.by_op()) | set(on_card.by_op())
            if k.startswith("kernel:")}
    if any(m != c for m, c in kern.values()):
        raise AssertionError(f"{name}: reported kernel costs differ {kern}")
    peak = on_meta.totals()["peak_live_bytes"]
    gap = (peak - rise) / max(rise, 1)
    hw = Hardware()
    bound_s = max(dm["flops"] / hw.peak_flops, dm["bytes"] / hw.hbm_bw)
    print(f"  {name}: flops {dm['flops']:.6e}, bytes {dm['bytes']:.6e} "
          f"(meta = card, {on_meta.totals()['ops']} ops, trace "
          f"{trace_s:.2f} s); peak live predicted {peak / 2**30:.3f} GiB, "
          f"card rise {rise / 2**30:.3f} GiB (gap {gap:+.2%}); bound "
          f"{bound_s * 1e3:.2f} ms vs measured {step_s * 1e3:.2f} ms "
          f"(share {bound_s / step_s:.3f}); kernel costs "
          f"{ {k: c for k, (m, c) in kern.items()} }; launches {launches}",
          flush=True)
    if abs(gap) > PEAK_TOL:
        raise AssertionError(f"{name}: predicted peak {peak} vs card rise "
                             f"{rise}: {gap:+.2%} beyond {PEAK_TOL:.0%}")
    if bound_s > step_s:
        raise AssertionError(f"{name}: bound {bound_s} s exceeds the "
                             f"measured {step_s} s: the count is wrong")
    return dict(flops=dm["flops"], bytes=dm["bytes"],
                ops=on_meta.totals()["ops"], trace_s=trace_s,
                predicted_peak_bytes=peak, card_rise_bytes=rise,
                peak_gap=gap, bound_s=bound_s, step_s=step_s,
                bound_share=bound_s / step_s, launches=launches,
                kernel_cost={k: c for k, (m, c) in kern.items()},
                named_differences={k: list(v) for k, v in diff.items()})


def _family_batch(fam, seq: int, patches: int, frames: int, device,
                  gen=None) -> dict:
    """(d)'s batch of one sequence: random tokens, patch embeddings and
    encoder frames on ``device`` (empty on meta)."""
    import torch

    def draw(shape, dtype):
        if device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    b = {"tokens": (torch.empty((1, seq), dtype=torch.int32, device=device)
                    if device.type == "meta" else
                    torch.randint(0, fam.vocab_size, (1, seq), generator=gen,
                                  device=device, dtype=torch.int32))}
    if patches:
        b["patch_embeds"] = draw((1, patches, fam.d_model), torch.bfloat16)
    if frames:
        b["enc_frames"] = draw((1, frames, fam.d_model), torch.bfloat16)
    return b


def family_depth(arch: str) -> tuple:
    """(d)'s dry-run depth search for one family on meta tensors
    (``dryrun.max_depth`` within FAMILY_TRAIN_LIMIT): (the chosen depth's
    prediction, every prediction, the search's seconds)."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    fam = get_config(arch)
    t0 = time.perf_counter()
    best, tried = dryrun.max_depth(
        fam, _family_batch(fam, *FAMILY_TRAIN[arch], torch.device("meta")),
        FAMILY_TRAIN_LIMIT)
    return best, tried, time.perf_counter() - t0


def start_family_depths():
    """Start (d)'s depth searches in one worker process, in FAMILY_TRAIN's
    order: (pool, {arch: async result}).  The searches are host work on
    meta tensors (the xLSTM one traces a Python loop per position for
    minutes), so they run on a spare host core while the card runs the
    earlier phases; the caller terminates the pool."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, {arch: pool.apply_async(family_depth, (arch,))
                  for arch in FAMILY_TRAIN}


def launch_phase(card: Card, depths: dict, dev="cuda") -> dict:
    """The launch tooling: (a) the dry-run's pairs (LAUNCH_DECODE_SHAPES
    for every arch, prefill_32k but for LAUNCH_PREFILL_SKIP) traced on
    meta, records written to ``results/dryrun_torch/``; (b) the cost
    counter held against the card on phase 6's gemma3 prefill (12 layers,
    32768 tokens, flash 12 launches) and phase 7's granite AdamW step
    (8 layers, 8 microbatches of 1 x 2048); (c) the pods' sync of
    granite-3-8b on the (2, 16, 16) mesh: one cell's local shards on 2
    virtual pods, every mode, importance launched and held as predicted;
    (d) one train step of jamba, pixtral, whisper and xlstm at full
    width, each at the deepest cut whose dry-run one-card peak stays
    within FAMILY_TRAIN_LIMIT, with the policy's optimizer; ``depths``
    holds the searches (``start_family_depths``, started before the
    build).  Cuts: the depth (the dry-run's choice); the batch, to one
    sequence (the policy's global batch is 256); the length
    (FAMILY_TRAIN: jamba 2048, xlstm 512 against its 2048 context, two
    mLSTM chunks, pixtral 256 patches + 1024 text tokens, whisper 448
    decoder tokens over 1500 frames, its caps); one microbatch (the
    policy's 4-8 split a batch of one)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels.importance.ref import channel_importance_ref
    from repro_torch.launch import dryrun, serve, specs, train
    from repro_torch.launch import perf_federated as pf
    from repro_torch.launch.federated import pod_mesh
    from repro_torch.launch.hlo_analysis import Hardware, model_flops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    meta = torch.device("meta")
    print(f"  {_fresh_peak(dev):.2f} GiB resident at the start", flush=True)
    # ---- (a) the dry-run sweep on meta
    t0 = time.perf_counter()
    records = dryrun.main(["--shape", *LAUNCH_DECODE_SHAPES, "--force"])
    records += dryrun.main(
        ["--arch", *[a for a in ARCH_IDS if a not in LAUNCH_PREFILL_SKIP],
         "--shape", "prefill_32k", "--force"])
    sweep_s = time.perf_counter() - t0
    errors = [r for r in records if r["status"] == "error"]
    if errors:
        raise AssertionError("dry-run errors: " + "; ".join(
            f"{r['arch']} {r['shape']}: {r['error']}" for r in errors))
    n_ok = sum(r["status"] == "ok" for r in records)
    print(f"  (a) {len(records)} dry-run records ({n_ok} ok) in "
          f"{sweep_s:.2f} s on the host", flush=True)

    # ---- (b) the counter against the card
    cfg, params, gen = serve.build(SERVE_ARCH, reduced=False,
                                   num_layers=SERVE_LAYERS, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_SEQ), generator=gen,
                         device=dev, dtype=torch.int32)
    lm.prefill(params, cfg, {"tokens": toks})       # warm-up
    abstract = lm.abstract_params(cfg)
    meta_toks = torch.empty((1, PREFILL_SEQ), dtype=torch.int32, device=meta)

    def time_prefill():
        _sync(dev)
        t = time.perf_counter()
        lm.prefill(params, cfg, {"tokens": toks})
        _sync(dev)
        return time.perf_counter() - t

    prefill = _card_against_meta(
        f"{cfg.name} {cfg.num_layers} layers prefill S={PREFILL_SEQ}",
        lambda: lm.prefill(params, cfg, {"tokens": toks}),
        lambda: lm.prefill(abstract, cfg, {"tokens": meta_toks}),
        time_prefill, dev)
    if prefill["launches"]["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"prefill flash launches {prefill['launches']}")
    # the flash flops reported, against the config's own count: 4 * H * hd
    # per unmasked causal pair, row i keeping min(i + 1, window) keys
    rows = np.arange(1, PREFILL_SEQ + 1, dtype=np.int64)
    want_flash = sum(4 * cfg.num_heads * cfg.head_dim_ * int(
        np.minimum(rows, spec.window or PREFILL_SEQ).sum())
        for spec in cfg.layout())
    got_flash = prefill["kernel_cost"]["kernel:flash_attention"]["flops"]
    print(f"  flash flops reported {got_flash:.6e}, the layout's count "
          f"{want_flash:.6e}", flush=True)
    if got_flash != want_flash:
        raise AssertionError(f"flash flops {got_flash} != {want_flash}")
    prefill["flash_flops_layout"] = want_flash
    del params, toks, abstract
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(get_config(TRAIN_ARCH),
                               num_layers=TRAIN_LAYERS)
    opt = train.optimizer_for(tcfg, 3e-4)
    mb = specs.policy_for(tcfg).num_microbatches
    gen = torch.Generator(device=dev).manual_seed(0)
    holder = {"state": lm.init_train_state(tcfg, opt, gen, dev)}
    step = lm.make_train_step(tcfg, opt, mb)
    ttoks = torch.randint(0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                          generator=gen, device=dev, dtype=torch.int32)

    def train_once():
        holder["state"], m = step(holder["state"], {"tokens": ttoks})
        holder["loss"] = m["loss"]

    def time_train():
        _sync(dev)
        t = time.perf_counter()
        train_once()
        _sync(dev)
        return time.perf_counter() - t

    train_once()                                     # warm-up
    ts_meta = lm.abstract_train_state(tcfg, opt)
    meta_ttoks = torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                             device=meta)
    train_rec = _card_against_meta(
        f"{tcfg.name} {TRAIN_LAYERS} layers AdamW step {mb} x "
        f"({TRAIN_BATCH // mb} x {TRAIN_SEQ})", train_once,
        lambda: step(ts_meta, {"tokens": meta_ttoks}), time_train, dev)
    loss = float(holder["loss"])
    mf_share = (model_flops(tcfg, TRAIN_SEQ, TRAIN_BATCH, "train")
                / Hardware().peak_flops / train_rec["step_s"])
    print(f"  train step: loss {loss:.4f}, model_flops share of the bf16 "
          f"peak {mf_share:.3f}  [{card.line}]", flush=True)
    if not math.isfinite(loss) or train_rec["launches"]["flash_attention"]:
        raise AssertionError(f"train loss {loss}, launches "
                             f"{train_rec['launches']}")
    train_rec.update(loss=loss, model_flops_share=mf_share)
    del holder, step, ttoks, ts_meta
    torch.cuda.empty_cache()

    # ---- (c) the pods' sync of one cell on 2 virtual pods
    fcfg = get_config(TRAIN_ARCH)
    mesh = make_production_mesh(multi_pod=True)
    pods = pod_mesh(mesh.shape["pod"], dev)
    _, local = pf.build_sync(fcfg, mesh, "dense")
    cell = pf.random_cell(fcfg, local, pods)
    ranked = sum(len(sh) >= 2 for sh in tree.leaves(local))
    compacted = sum(m == "feddd" for m, _, _ in pf.MODES)
    want = ranked * len(pods.devices) * compacted
    scored = []
    kernel = pf.channel_importance

    def held(w_old, w_new, *, channel_axis=-1, coverage=None):
        got = kernel(w_old, w_new, channel_axis=channel_axis,
                     coverage=coverage)
        a, c, b = _lib.split_at(tuple(w_new.shape),
                                channel_axis % w_new.ndim)
        ref = channel_importance_ref(w_old.reshape(1, a, c, b),
                                     w_new.reshape(1, a, c, b), coverage)[0]
        torch.testing.assert_close(got, ref, rtol=IMP_RTOL, atol=IMP_ATOL)
        scored.append((got - ref).abs().max().item())
        return got

    pf.channel_importance = held
    try:
        for mode, d, q in pf.MODES:
            pf.run_one(fcfg, mesh, pods, mode, d, q, cell)
    finally:
        pf.channel_importance = kernel
    sync = []
    for mode, d, q in pf.MODES:
        rec, out = pf.run_one(fcfg, mesh, pods, mode, d, q, cell)
        if not all(bool(torch.isfinite(t.float()).all())
                   and t.device.type == torch.device(dev).type
                   for o in out for t in tree.leaves(o)):
            raise AssertionError(f"{rec['tag']}: synced shards not finite "
                                 f"or off the card")
        n_imp = ranked * len(pods.devices) if mode == "feddd" else 0
        if rec["importance_launches"] != n_imp:
            raise AssertionError(f"{rec['tag']}: importance launches "
                                 f"{rec['importance_launches']} != {n_imp}")
        kinds = {k: v for k, v in rec["collective_per_device"].items() if v}
        print(f"  (c) {rec['tag']:>18}: "
              f"{rec['collective_bytes_per_device'] / 1e6:.6f} MB/dev "
              f"{kinds}, term {rec['collective_term_s'] * 1e3:.5f} ms on "
              f"{Hardware().link_bw / 1e9:.0f} GB/s, wall "
              f"{rec['wall_ms']:.3f} ms, importance "
              f"{rec['importance_launches']}  [{card.line}]", flush=True)
        sync.append(rec)
        del out
    launches_sync = sum(r["importance_launches"] for r in sync)
    if launches_sync != want or len(scored) != want:
        raise AssertionError(f"importance launches {launches_sync}, scores "
                             f"held {len(scored)}, predicted {want}")
    print(f"  (c) importance {launches_sync} launches = {ranked} rank-2+ "
          f"leaves x {len(pods.devices)} pods x {compacted} compacted "
          f"modes; {len(scored)} scores held, max |err| {max(scored):.3g}",
          flush=True)
    del cell
    torch.cuda.empty_cache()

    # ---- (d) one train step of each remaining family
    families = {}
    for arch, (seq, patches, frames) in FAMILY_TRAIN.items():
        fam = get_config(arch)
        t0 = time.perf_counter()
        best, tried, search_s = depths[arch].get(FAMILY_SEARCH_TIMEOUT)
        waited_s = time.perf_counter() - t0
        if best is None:
            raise AssertionError(f"{arch}: one layer does not fit")
        fcut = dataclasses.replace(fam, num_layers=best["num_layers"])
        _sync(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        g = torch.Generator(device=dev).manual_seed(0)
        fopt = train.optimizer_for(fcut, 3e-4)
        state = lm.init_train_state(fcut, fopt, g, dev)
        fstep = lm.make_train_step(fcut, fopt, 1)
        batch = _family_batch(fam, seq, patches, frames,
                              torch.device(dev), g)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = fstep(state, batch)
        floss = float(m["loss"])
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        gnorm = float(m["grad_norm"])
        del state, m, batch
        torch.cuda.empty_cache()
        tried_gib = [(t["num_layers"],
                      round(t["peak_bytes_one_card"] / 2**30, 2))
                     for t in tried]
        print(f"  (d) {fam.name}: {best['num_layers']} of {fam.num_layers} "
              f"layers (depths tried {tried_gib} GiB, {search_s:.2f} s in "
              f"the worker, {waited_s:.2f} s waited), "
              f"batch 1 x {seq}"
              f"{f' + {patches} patches' if patches else ''}"
              f"{f' + {frames} frames' if frames else ''}, "
              f"{specs.policy_for(fcut).optimizer}: loss {floss:.4f}, grad "
              f"norm {gnorm:.4g}, step {step_s:.3f} s; peak predicted "
              f"{best['peak_bytes_one_card'] / 2**30:.2f} GiB, measured "
              f"{peak / 2**30:.2f} GiB  [{card.line}]", flush=True)
        if not (math.isfinite(floss) and math.isfinite(gnorm)):
            raise AssertionError(f"{arch}: loss {floss}, grad norm {gnorm}")
        families[arch] = dict(layers=best["num_layers"], seq=seq,
                              patches=patches, frames=frames,
                              optimizer=specs.policy_for(fcut).optimizer,
                              loss=floss, grad_norm=gnorm, step_s=step_s,
                              predicted_peak_bytes=best[
                                  "peak_bytes_one_card"],
                              measured_peak_bytes=peak, search_s=search_s,
                              waited_s=waited_s, tried=tried)
    wall = time.perf_counter() - t_phase
    print(f"  launch phase wall {wall:.2f} s  [{card.line}]", flush=True)
    return dict(sweep_s=sweep_s, records=records, prefill=prefill,
                train=train_rec, sync=sync, sync_ranked_leaves=ranked,
                sync_importance_launches=launches_sync,
                sync_scores_held=len(scored),
                sync_score_max_abs_err=max(scored), families=families,
                phase_wall_s=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement here as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 2
    pool = None
    try:
        line = card_line()
        print(line, flush=True)
        card = Card(line)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}", flush=True)

        pool, depths = start_family_depths()
        path, secs, log = kernels.build()
        print(f"build: {secs:.2f} s -> {path.name}", flush=True)
        for ln in log.splitlines():
            if ("registers" in ln or "spill" in ln
                    or "Compiling entry function" in ln):
                print(f"  {ln.strip()}")

        prng_out = prng_phase()
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        records: list = []
        checks = kernel_checks(card, flush, records)
        big = big_merge_check(card, flush)
        records.append(big)
        flash = flash_checks(card, flush, records)
        lm_importance = lm_importance_checks(card, flush, records)
        conv_out = conv_checks(card, flush, records)
        del flush
        torch.cuda.empty_cache()
        engine_check()
        comm_check = comm_engine_check()
        path_out = main_path()
        comm_out = comm_run()
        loop_out = loop_phase()
        base_out = baselines_phase()
        obs_out = obs_phase()
        scan_out = scan_phase()
        grouped_out = grouped_phase()
        sim_out = sim_phase()
        shard_out = sharded_phase(card)
        cli_out = quickstart_cli_phase()
        serve_out = serving_phase()
        torch.cuda.empty_cache()
        mesh_out = lm_mesh_phase(card)
        torch.cuda.empty_cache()
        train_out = train_phase(card)
        torch.cuda.empty_cache()
        mesh_train_out = lm_mesh_train_phase(card)
        fed_out = federated_phase(card)
        moe_out = moe_phase(card)
        fam_out = families_phase(card)
        torch.cuda.empty_cache()
        mesh_fam_out = lm_mesh_families_phase(card)
        torch.cuda.empty_cache()
        launch_out = launch_phase(card, depths)
        torch.cuda.synchronize()
    except Exception:      # any failed phase: report it and exit non-zero
        traceback.print_exc()
        return 1
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()

    checks["main"]["flash_attention"] = flash["main"]
    checks["max_abs_err"]["flash_attention"] = flash["max_abs_err"]
    checks["main"]["conv"] = conv_out["main"]
    checks["max_abs_err"]["conv"] = conv_out["max_rel_err"]
    # the FedDD kernels' launches on this slice's path: the quickstart in
    # CommConfig(auto, 8) (the default-comm and random runs beside them)
    launches = dict(comm_out["feddd"]["launches"])
    launches["flash_attention"] = serve_out["prefill_launches"][
        "flash_attention"]
    launches["conv"] = sum(conv_out["step"]["launches"].values())
    line_kernels = []
    for name, info in KERNEL_INFO.items():
        rec = checks["main"][name]
        line_kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=launches[name],
            path=("prefill" if name == "flash_attention" else
                  "vmapped CNN2 step" if name == "conv" else
                  f"quickstart {COMM['codec']}/{COMM['qbits']}"),
            max_abs_err=checks["max_abs_err"][name], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=rec["shape"], dtype=rec["dtype"]))
        if "window" in rec:
            line_kernels[-1]["window"] = rec["window"]
        if name == "flash_attention":
            line_kernels[-1]["dispatch"] = dict(
                route="sm90", launches=serve_out["prefill_routes"])
            moe_rec = flash["moe"]
            line_kernels[-1].update(
                moe_prefill={k: moe_rec[k] for k in (
                    "shape", "dtype", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err", "worst_row")},
                moe_prefill_inputs=dict(max_abs_err=moe_out[
                    "prefill_inputs_err"], worst_row=moe_out[
                    "prefill_inputs_row"]),
                launches_moe_prefill=moe_out["prefill_launches"][name],
                launches_jamba_prefill=fam_out["jamba"]["prefill_launches"][
                    name],
                launches_pixtral_prefill=fam_out["pixtral"][
                    "prefill_launches"][name],
                **{f"launches_mesh_{fam}_prefill": mesh_fam_out[fam][
                    "prefill_launches"][name]
                   for fam in ("jamba", "xlstm", "pixtral", "whisper")},
                launches_mesh_families_train={
                    fam: mesh_fam_out[fam]["train"]["launches"][name]
                    for fam in ("jamba", "xlstm", "pixtral", "whisper")},
                **{f"{fam}_prefill": {k: flash[fam][k] for k in (
                    "shape", "dtype", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err", "worst_row")}
                   for fam in ("jamba", "pixtral", "jamba_mesh",
                               "pixtral_mesh")},
                **{f"{fam}_mesh_prefill_inputs": {
                    k: mesh_fam_out[fam]["flash_held"][k] for k in (
                        "launches", "max_abs_err", "worst_row")}
                   for fam in ("jamba", "pixtral")},
                **{f"{fam}_prefill_inputs": {
                    k: fam_out[fam]["flash_held"][k] for k in (
                        "launches", "max_abs_err", "worst_row")}
                   for fam in ("jamba", "pixtral")},
                launches_mesh_prefill=mesh_out["gemma"]["prefill_launches"][
                    name],
                launches_mesh_moe_prefill=mesh_out["moe"]["launches"][name],
                mesh_shard_prefill={w: {k: flash["mesh"][w][k] for k in (
                    "shape", "dtype", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err", "worst_row")}
                    for w in SLICE_WINDOWS},
                mesh_moe_shard_prefill={k: flash["mesh_moe"][k] for k in (
                    "shape", "dtype", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err", "worst_row")},
                **{f"{key}_inputs": {k: mesh_out[fam]["flash_held"][k]
                                     for k in ("launches", "max_abs_err",
                                               "worst_row")}
                   for key, fam in (("mesh_prefill", "gemma"),
                                    ("mesh_moe_prefill", "moe"))},
                launches_train=train_out["launches"][name],
                launches_mesh_train=mesh_train_out["launches"][name],
                launches_mesh_moe_train=mesh_train_out["moe"]["launches"][
                    name],
                launches_train_long=train_out["long"]["launches"][name],
                launches_launch_prefill=launch_out["prefill"]["launches"][
                    name],
                launch_prefill_cost=launch_out["prefill"]["kernel_cost"].get(
                    f"kernel:{name}"))
        if name == "sparse_agg":
            ew = checks["main"]["sparse_agg_elementwise"]
            line_kernels[-1].update(
                mode=rec["mode"], modes=comm_out["feddd"]["sparse_agg_modes"],
                modes_default_comm=path_out["sparse_agg_modes"],
                partials_ms=rec["partials_ms"],
                partials_bound_ms=rec["partials_bound_ms"],
                unfused_eq4_ms=rec["unfused_ms"],
                elementwise=dict(
                    shape=ew["shape"], dtype=ew["dtype"], ms=ew["ms"],
                    plain_ms=ew["plain_ms"], bound_ms=ew["bound_ms"],
                    bound_by=ew["bound_by"], max_abs_err=ew["max_abs_err"]),
                routes_grouped=grouped_out["a"]["sparse_agg_routes"][
                    "grouped"],
                routes_sharded=shard_out["a"]["launches"]["four"][
                    "sparse_agg_routes"],
                launches_select=dict(
                    engine=shard_out["a"]["launches"]["engine"]["select"],
                    sharded=shard_out["a"]["launches"]["four"]["select"]),
                select=dict(shape=shard_out["f"]["shape"],
                            mean_ms=shard_out["f"]["ms"],
                            mean_off_ms=shard_out["f"]["mean_off_ms"],
                            partials_ms=shard_out["f"]["partials_on_ms"],
                            partials_off_ms=shard_out["f"][
                                "partials_off_ms"],
                            plain_ms=shard_out["f"]["plain_ms"],
                            bound_ms=shard_out["f"]["bound_ms"],
                            max_abs_err=shard_out["f"]["select"]["on"][
                                "max_abs_err"]))
        if name in FEDDD_KERNELS:
            line_kernels[-1].update(
                launches_default_comm=path_out["launches"][name],
                launches_random=comm_out["random"]["launches"][name],
                launches_loop=loop_out["launches"][name],
                launches_scan=scan_out["feddd"]["launches"][5][name],
                launches_grouped=grouped_out["a"]["launches"]["grouped"][
                    name],
                launches_grouped_loop=grouped_out["a"]["launches"]["loop"][
                    name],
                launches_sim=sim_out["c"]["launches"][name],
                launches_sharded=shard_out["a"]["launches"]["four"][name],
                launches_sharded_one=shard_out["a"]["launches"]["one"][
                    name],
                launches_sharded_grouped=shard_out["c"]["launches"][name],
                launches_sim_policies={
                    p: v["launches"][name]
                    for p, v in sim_out["a"]["policies"].items()},
                launches_quickstart_cli_faults=cli_out["a"]["launches"][
                    name],
                launches_quickstart_cli_population=cli_out["b"][
                    "launches"][name])
        if name == "conv":
            line_kernels[-1].update(
                max_rel_err=conv_out["max_rel_err"],
                launches_by_pass=conv_out["step"]["launches"],
                passes={k: {f: r[f] for f in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_launches", "launches")}
                    for k, r in conv_out["rows"].items()},
                step=conv_out["step"], cell_repeat=conv_out["cell_repeat"])
        if name == "importance":
            line_kernels[-1]["launches_federated_pods"] = fed_out[
                "launches"]["importance"]
            line_kernels[-1]["launches_perf_federated"] = launch_out[
                "sync_importance_launches"]
            line_kernels[-1]["federated_pods_scores"] = dict(
                held=fed_out["scores_held"],
                max_abs_err=fed_out["score_max_abs_err"])
            line_kernels[-1]["lm_leaves"] = [
                {k: r[k] for k in ("leaf", "shape", "dtype", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "blocks", "splits")}
                for r in lm_importance]
            n1 = checks["main"]["importance_n1"]
            line_kernels[-1]["n1"] = {k: n1[k] for k in (
                "shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "splits", "splits_engine")}
        if name == "masked_merge":
            group = checks["main"]["masked_merge_group"]
            line_kernels[-1].update(
                big_leaf=dict(shape=big["shape"], dtype=big["dtype"],
                              descriptors=big["descriptors"], ms=big["ms"],
                              library_ms=big["library_ms"],
                              bound_ms=big["bound_ms"]),
                mode="grouped", leaves=group["leaves"],
                leaf_counts=comm_out["feddd"]["merge_leaf_counts"],
                leaf_counts_default_comm=path_out["merge_leaf_counts"],
                grouped_ms=group["ms"], grouped_bound_ms=group["bound_ms"],
                grouped_plain_ms=group["plain_ms"],
                per_leaf_sum_ms=group["per_leaf_sum_ms"],
                per_leaf_burst_ms=group["per_leaf_burst_ms"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=line, build_s=secs, prng=prng_out, kernels=records,
            comm_engine=comm_check, main_path=path_out, comm_run=comm_out,
            loop=loop_out, baselines=base_out, obs=obs_out, scan=scan_out,
            grouped=grouped_out, sim=sim_out, sharded=shard_out,
            quickstart_cli=cli_out,
            serving=serve_out, lm_mesh=mesh_out, train=train_out,
            lm_mesh_train=mesh_train_out,
            federated=fed_out,
            moe=moe_out, families=fam_out,
            lm_mesh_families=mesh_fam_out, launch=launch_out,
            lm_importance=lm_importance, conv=conv_out,
            summary=line_kernels),
            indent=1))
    steady = [r["host_wall_time"] for r in path_out["rounds"]
              if r["scheme"] == "feddd" and r["round"] > 1]
    print(f"host s per steady FedDD round: default comm "
          f"{statistics.median(steady):.4f}, {COMM['codec']}/{COMM['qbits']}"
          f" {comm_out['feddd']['steady_host_s']:.4f}, loop "
          f"{loop_out['steady_host_s']:.4f}; span medians (ms) "
          + ", ".join(f"{k} {v:.3f}"
                      for k, v in obs_out["span_medians_ms"].items())
          + "; fused/scanned (scan phase): " + ", ".join(
              f"{k} {v:.4f}" for k, v in scan_out["steady_host_s"].items())
          + "; hetero-a grouped / loop (grouped phase): " + ", ".join(
              f"{v:.4f}" for v in grouped_out["a"]["steady_host_s"].values())
          + f"; straggler demo sync (sim phase): "
          f"{sim_out['a']['steady_host_s']:.4f}; 100k population by "
          f"cohorts of 256 (quickstart CLI): " + ", ".join(
              f"{h:.3f}" for h in cli_out["b"]["host_s_per_round"])
          + "; sharded fleet (sharded "
          "phase) rounds/s: " + ", ".join(
              f"{k} {v:.3f}" for k, v in shard_out["b"][
                  "rounds_per_s"].items())
          + f"; LM mesh {MESH_SHAPE} prefill "
          f"{mesh_out['gemma']['prefill_s']:.3f} s (unmeshed "
          f"{mesh_out['gemma']['prefill_plain_s']:.3f}), "
          f"decode {mesh_out['gemma']['decode_ms']:.2f} ms/token (unmeshed "
          f"{mesh_out['gemma']['decode_plain_ms']:.2f})"
          + f"; LM train {train_out['s_per_step']:.4f} s/step, on the "
          f"{MESH_SHAPE} mesh {mesh_train_out['s_per_step']:.4f} (unmeshed "
          f"at its split {mesh_train_out['plain_s_per_step']:.4f}), pods "
          f"{statistics.median(fed_out['s_per_round']):.4f} s/round, MoE "
          f"prefill {moe_out['prefill_s']:.4f} s, decode "
          f"{moe_out['ms_per_token']:.2f} ms/token, train "
          f"{moe_out['train_s']:.4f} s/step; families prefill s / decode "
          "ms/token: " + ", ".join(
              f"{k} {fam_out[k]['prefill_s']:.4f} / "
              f"{fam_out[k]['decode']['ms_per_token']:.2f}"
              for k in ("jamba", "xlstm", "pixtral", "whisper"))
          + f"; on the {MESH_SHAPE} mesh prefill s / decode ms/token / s "
          "per train step (unmeshed): " + ", ".join(
              f"{k} {mesh_fam_out[k]['prefill_s']:.4f} / "
              f"{mesh_fam_out[k]['decode_ms']:.2f} / "
              f"{mesh_fam_out[k]['train']['step_s']:.4f} ("
              f"{mesh_fam_out[k]['prefill_plain_s']:.4f} / "
              f"{mesh_fam_out[k]['decode_plain_ms']:.2f} / "
              f"{mesh_fam_out[k]['train']['plain_step_s']:.4f})"
              for k in ("jamba", "xlstm", "pixtral", "whisper"))
          + f"; launch phase {launch_out['phase_wall_s']:.2f} s (dry-run "
          f"sweep {launch_out['sweep_s']:.2f} s)",
          flush=True)
    print(json.dumps({"kernels": line_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
