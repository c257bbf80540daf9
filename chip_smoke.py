"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py      (the script also finds src/ itself)

Phases, one line each: the card's name and power limit; the kernels' build
(nvcc, one process per source, all started together, into build/kernels/);
the data (the paper's large-scale setting: N = 10^7 points of a 10-cluster
Gaussian mixture in R^10, m = 1000 frequencies); each kernel held against its
plain PyTorch version at the main path's shapes and at ragged ones (the
quantized and structured kernels also for bitwise repeatability over two
launches and, for integer sums, exact split invariance), and the structured
kernels again at the wide shape n = d = 2048, m = 20,000; the decoder
kernels (sketch_shift's score step at the decoder's swarm, a ragged and the
wide shape, with the plain version's time beside the wide one, and at
n = 3, 40, 64 and 100; amp_denoise at the decoder's shape, a wide one, the
deep tail and open boxes); the sweep of the sketch kernels' widths at
N = 20,001 (kernels 1-3 at n = 3 to 100, kernel 1 also at phases of
10^3-10^4 radians, kernels 4-5 at d = 64 to 1024); kernels 1 and 2 at the
CKM-compressed KV cache's shapes (8129 keys at head_dim 256; K = 64 and 16,
m = 81,920); kernels 1 and 4 at the training loop's launches (4 rows: the
balancer at n = 16, m = 640, the monitor at d = 2048, m = 32,768 and at
the smoke config's n = 64, m = 512), and kernels 3-5 at
phases of 10^3-10^5 radians on 1,000,003 rows; kernel 3's 1- and 4-bit
times at the fit shape beside kernel 1's (a timed call over 50 ms, such as
a plain version at N >= 10^6, is timed 3 times, not 10); flash
attention (kernel 8) at its edge cases and at the llama3.2-1B, gemma3-1B
local-layer and 32k-prefill shapes, beside SDPA's time; ckm.fit,
ckm.fit_streaming and lloyd.kmeans, then the slice-2 fits (dense 1-bit QCKM,
streaming structured, structured 1-bit QCKM) and the slice-3 fits (fit with
decoder="sketch_shift", fit_streaming with decoder="amp"), each with the
launch counts it caused; the SSE of each CKM fit against k-means with 5
replicates, beside the values before kernels 3 and 6 were redesigned
(the fits off those kernels are compared to the digit); each decoder's
decode again with its loops eager, against a graphed decode of the same
depth (sketch_shift and CL-AMP the fits' own; CLOMPR's two at a fifth of
the default steps): bits, launch counts, seconds; where fit's time
goes (the sketch pass alone, and short decodes, eager then graphed, each
timed alone and under torch.profiler: CLOMPR dense and structured,
sketch_shift, amp, with kernels 6 and 7's device time per launch inside the
graphs, beside an empty kernel's in a graph); the attention
entry point (ops.flash_attention) at the three model shapes, with its launch
counts; the streaming layer (``streaming_phases``): N points made on the host
as numpy and streamed by fit_streaming in 10 and 100 batches, sync and async
(pinned buffers and a side stream), float and 1-bit, with the bits compared,
the walls, the ingest stats and the peak device memory; decayed states and a
SketchWindow over 100 ticks; telemetry on and off; the decoders' convergence
traces, graphed and eager (CLOMPR's at a fifth of the default steps); async ingest of the batches already on the card
(``stream_device_phase``: no pinned slot, the sync bits); the fleet
(``fleet_phases``: 1024 tenants at m = 1000, float, 1-bit and decayed,
routed requests, a fleet window, four decoded tenants, a structured fleet),
with the tenant-axis entries of kernels 1 and 3 held bitwise to T single
launches and to their plain versions; the fleet's service (``serve_phases``:
FleetService over the same 1024 tenants, 4096 host requests flushed sync and
async with the bits compared, decodes on demand against a hand-simulated
LRU, 64 tenants evicted and restored bitwise, drift maintenance on a decayed
service, a 1-bit, a windowed and a structured service); ckm.diagnose on the
default fit (with the sigma sweep on 10^5 rows) and on sketch_shift fits at
sigma^2 x 10^4 and x 10^-4 (``diagnose_phases``); the sharded backend
(``sharded_phases``): at p = 1, an NCCL group of one rank, where float, 1-bit
and decayed sharded engines under every topology, a structured one and
ckm.fit with sketch_backend="sharded" give the "kernel" backend's and [fit]'s
bits, with one update timed against the kernel backend's; at p = 4, four
gloo rank processes on the one card (``_sharded_rank``), each sketching its
block of the N points over a (4,) "data" and a (2, 2) ("pod", "data") mesh,
held to the single card's sketch (float within the sketch bar, 1-bit
bitwise, every rank bitwise rank 0), their launches counted in; the tenant
mesh (``fleet_mesh_phases``: FleetEngine(sharding="mesh") at the fleet's
width, 4 blocks on the one card and the default one-card mesh, float, 1-bit
and decayed, every row bitwise the unsharded fleet's, kernel 1's (3's) fleet
entry launched once a block, no peer copy and no torch.distributed call, a
structured mesh fleet) and its service (``serve_mesh_phases``: 4096 host
requests shard-routed sync and async, decodes, evict/restore, bitwise the
unsharded service); the three examples of ``repro_torch.examples`` at their
default sizes (``examples_phase``); the LM serving path of every family
(``lm_serve_phase``: llama3.2-1B, gemma3-1B, granite-moe, xlstm, whisper and
internvl2 at their published widths and depths, jamba at 16 of 32 layers and
kimi-k2 at 1 of 61, bf16 weights drawn on the card, a float32 prefill ->
decode check against forward at the depth that fits 40 GB (kimi-k2's at its
smoke config), a timed prefill (4 x 4096, 1 x 8192, 4 x (1500 frames + 448
tokens), 1 x (256 patches + 3840 tokens), 1 x 32768) and 32 greedy decode
steps through the serve layer's steps, the peak memory, each recurrent
mixer's one-layer time) and the CKM-compressed KV cache on gemma3-1B's
global layers (``kv_ckm_phase``: Lloyd and CKM compression through kernels
1 and 2, decodes through the compressed layers, the clustered regime at
head_dim 256, Lloyd there over 20 seeds through kernel 2 and its plain
version) and on jamba's attention layers (``long_context_phase``: Lloyd at
K = 4096 through kernel 2, 32 tokens decoded beside the Mamba states, held
to the full cache; kernel 2 also checked at that shape, N = 31,745, n =
128, among the kernel checks); the
LM's training path (``lm_train_phase``: train_loop.run at llama3.2-1B's
width and depth, B = 4 x S = 4096, AdamW, bf16 compute, remat "full", the
activation monitor and the compressive balancer on through kernels 4 and 1,
three steps timed by CUDA events beside the loop's wall time, with tokens/s,
loss, gradient norm, peak memory, the balancer's decode seconds and the
model- and hardware-FLOP shares, the first loss against float32 compute, the
final checkpoint restored bitwise, the monitor's decode and the balancer's
weights) and the restart invariant at its smoke config
(``lm_restart_phase``: six steps straight against three, a restart and
three); one JSON line of per-kernel numbers,
the total wall time and, last, the device line.  Any failed check raises and the script exits non-zero
before the last line.  Without a CUDA card it exits non-zero and prints no
result."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Data and run sizes: the paper's Fig. 4 / §4 large-scale setting.
N, K, DIM, M = 10_000_000, 10, 10, 1000
STREAM_CHUNKS = 10
KMEANS_REPLICATES = 5
RAGGED_N = 1_000_003
DATA_SEED, FIT_SEED, KMEANS_SEED = 0, 1, 2
TIMED_LAUNCHES = 10
# A timed call whose warm-up takes over SLOW_CALL_MS (the plain versions at
# N = 10^7 and 10^6, the loops of T single launches) is timed
# SLOW_TIMED_LAUNCHES times: their medians are reported beside kernel times
# 8x-100x shorter, and ten runs of each cost ~50 s of the smoke's time.
SLOW_CALL_MS, SLOW_TIMED_LAUNCHES = 50.0, 3
# The structured kernels' generic d > 32 path, at the width of the
# reference's frequency-operator benchmark (n = 2048), with a ragged last
# frequency block and a ragged N.
WIDE_N, WIDE_DIM, WIDE_M = 100_003, 2048, 20_000
# The sketch_shift decoder's swarm: CKMConfig.shift_candidates (8) per
# cluster; a ragged swarm and sketch for the masked edges.
SHIFT_P = 8 * K
RAGGED_P, RAGGED_M = 83, 1003

# The sweep of the sketch kernels' template instances and generic paths, at
# small N: kernels 1-3 at every NP (4 to 64) and beyond (generic), kernels
# 4-5 at d = 32 with n = 5 and 20 (the first stage's instances NX = 16 and
# 32) and at d = 64, 128, 256, 512, 1024 (every case of the structured
# switch; the main path reaches d = 32 with NX = 16, the wide shape 2048).
SWEEP_N, SWEEP_M = 20_001, 300
SWEEP_DENSE_NS = (3, 6, 16, 24, 48, 100)
# Kernel 1 at large phases: x (n = 10) scaled so |x w| reaches 10^3-10^4,
# where its reduction to [-pi, pi] before the SFU's __sincosf is exercised.
LARGE_PHASE_N, LARGE_PHASE_SCALE = 10, 300.0
SWEEP_STRUCTURED_NS = (5, 20, 40, 100, 200, 500, 1000)
# Kernels 4-5 at large phases: the ragged rows of the data scaled so that the
# fit's structured phases reach 10^3-10^5, where their reduction to
# [-pi, pi] (and the 1-bit codes read off the reduced phase) is exercised.
# At such phases the kernel's and the plain version's float32 phases round
# apart by about an ulp of the phase (1.2e-4 rad at 2,000), so codes flip at
# about that rate a (row, frequency): at N = 20,001 a single flip is already
# 1e-4 of N, so the case runs at the ragged N of 1,000,003, where CODE_TOL
# reads as a flip rate.
LARGE_PHASE_STRUCTURED_SCALE = 100.0
# Kernel 6 at the rest of its template paths: the narrow (cluster) kernel at
# n = 3, 40 and 64 (a tiny swarm and sketch, a ragged one, the widest), and
# the two-phase wide kernel at a ragged n > 64; (P, n, m).
SHIFT_SWEEP = ((1, 3, 5), (17, 40, 300), (80, 64, 1000), (33, 100, 777))
# CLOMPR's eager re-decodes (fit, fit-structured) and [trace clompr]'s eager
# decode run at a fifth of the default Adam steps (300 / 200 / 1000), beside
# a graphed decode of the same depth: every one of the 2K rounds, NNLS and
# merge still runs.
RE_DECODE_STEPS = {"atom_steps": 60, "joint_steps": 40, "final_steps": 200}
# CLOMPR's short decodes under the profiler (section 9): 410 Adam steps (the
# profiler's host processing of their device operations, not the decodes,
# takes most of the section's time), each loop a multiple of the Adam
# graphs' unroll of 10, so they replay the graphs the re-decodes captured.
SHORT_CLOMPR_STEPS = {"atom_steps": 10, "joint_steps": 10, "final_steps": 10}
# The fits' relative SSEs as this script printed them on commit 227003f
# (NVIDIA H100 80GB HBM3, 700 W), before the streaming layer: with
# telemetry off, every fit should give them to the digit.
EARLIER_RELATIVE_SSE = {
    "fit": 1.3570, "fit_streaming": 1.2213, "fit-1bit": 1.2861, "fit-structured": 1.2468,
    "fit-structured-1bit": 1.2854, "fit-sketch_shift": 1.3237, "fit-amp": 1.3440,
}
# Flash attention at the reference's model widths (src/repro/configs/):
# llama3.2-1B (H = 32, KV = 8, hd = 64) at S = 4096 and at the 32k-token
# prefill that models/layers.py names, and a gemma3-1B local layer (H = 4,
# KV = 1, hd = 256, window 512); (B, S, H, KV, hd, window, dtype).
ATTENTION_SHAPES = {
    "llama3.2-1b bf16": (1, 4096, 32, 8, 64, 0, torch.bfloat16),
    "llama3.2-1b f32": (1, 4096, 32, 8, 64, 0, torch.float32),
    "gemma3-1b local bf16": (1, 4096, 4, 1, 256, 512, torch.bfloat16),
    "llama3.2-1b prefill-32k bf16": (1, 32768, 32, 8, 64, 0, torch.bfloat16),
}
# The plain version's q chunk at long S (its (BH, chunk, S) float32 scores).
PLAIN_Q_CHUNK = 512
# Edge cases: (BH, BKV, S_q, S_kv, hd, causal, window, dtype).
FLASH_EDGES = (
    *((4, 2, 100, 100, hd, True, 0, torch.float32) for hd in (8, 16, 32, 64, 128, 256)),
    *((4, 2, 100, 100, hd, True, 0, torch.bfloat16) for hd in (8, 64, 256)),
    (4, 2, 130, 70, 64, True, 0, torch.float32),     # S_q > S_kv
    (4, 2, 70, 130, 64, False, 0, torch.float32),    # S_q < S_kv, non-causal
    (4, 1, 300, 300, 64, True, 50, torch.float32),   # sliding window
    (4, 1, 300, 100, 32, True, 40, torch.float32),   # rows with no key
    (4, 1, 300, 100, 32, False, 40, torch.float32),  # rows with no key, window only
    (8, 8, 1000, 1000, 128, True, 0, torch.bfloat16),  # ragged causal S
    (4, 4, 257, 257, 72, True, 0, torch.float32),    # hd not a power of two
)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

# Tolerances against the plain versions on the card, with their reasons.
# fourier_sketch, on sums / N: the repo's 1e-4 bar across engine backends.
SKETCH_TOL = 1e-4
# assign_argmin distances: ||x||^2 - 2 x.c + ||c||^2 in float32, in two
# expression orders, differs by a few ulps of its largest terms: the bar is
# 32 ulps (4e-6) of max ||x_i||^2 + max ||c_k||^2.
DIST_RTOL = 4e-6
# Integer code sums (quantized kernels) against their plain versions: equal
# except where a code's argument sits on a rounding boundary, where the
# kernel's and PyTorch's phases or trig round apart; the flips are held to
# max |dq| / N <= 1e-4.
CODE_TOL = 1e-4
# sketch_shift score and gradient after the division by m: the engine's
# 1e-4 bar (the kernel's FMA chain and cuBLAS round the phase apart).
SHIFT_TOL = 1e-4
# amp_denoise, in the natural units of each moment (mean / max(1, sqrt q),
# variance / max(1, q)): the reference's 1e-5 bar.  Kernel and plain version
# call the same erfcf, expf and sqrtf on the card and round each operation
# alike.
DENOISE_TOL = 1e-5
# |z_stream - z|: the same points summed over other batch boundaries.
STREAM_TOL = 1e-5
# CKM's SSE over k-means x5 SSE: CKM's decode varies with the seed, and this
# bar catches a broken port, not that variation.
MAX_RELATIVE_SSE = 1.5
# Flash attention against its plain version: float32 outputs to 2e-5; bf16
# outputs to 2^-7 |o| + 1e-4 (both sides round float32 sums to bf16, one ulp
# apart at most); the LSE (float32 in both) to 1e-5.
FLASH_F32_TOL = 2e-5
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0**-7, 1e-4
FLASH_LSE_TOL = 1e-5
# Graphed decodes against eager ones (profiled short decodes): at most this
# share of the eager wall time, with the device busy for at least this share.
GRAPHED_WALL_SHARE = 0.5
GRAPHED_MIN_BUSY = 0.4

# The streaming layer.  Host-fed streams: the N points made on the host as a
# numpy array, streamed in 10 batches of 10^6 rows and 100 of 10^5, sync
# then async with INGEST_PREFETCH batches staged.  Decayed states and the
# window: 100 ticks of 10^5 rows; the window's mixture moves halfway.
HOST_BATCH_ROWS = (1_000_000, 100_000)
INGEST_PREFETCH = 2
TICKS, TICK_ROWS, DECAY, WINDOW_BUCKETS = 100, 100_000, 0.99, 24
HOST_DATA_SEED, DRIFT_SEED = 3, 4
# The fleet (core/fleet.py) at the paper's width: FLEET_T tenants, each with
# its own 10-cluster mixture in R^10 and m = 1000 frequencies (the reference
# benchmark's fleet of 1024 tenants, benchmarks/kernels.py run_fleet), aligned
# updates of FLEET_B rows a tenant, FLEET_REQUESTS interleaved requests of
# FLEET_REQUEST_ROWS rows, a W = FLEET_WINDOW window over FLEET_WINDOW_TICKS
# ticks, FLEET_DECAY_TICKS decayed ticks; FLEET_DECODES tenants decoded; a
# structured fleet of FLEET_STRUCTURED_T tenants (kernels 4-5 per tenant).
FLEET_T, FLEET_B, FLEET_UPDATES = 1024, 1000, 4
FLEET_REQUESTS, FLEET_REQUEST_ROWS = 4096, 256
FLEET_WINDOW, FLEET_WINDOW_TICKS, FLEET_DECAY_TICKS = 4, 8, 10
FLEET_DECODES, FLEET_STRUCTURED_T, FLEET_SEED = 4, 64, 5
# The fleet's service (serve/fleet_service.py) over that fleet: the
# FLEET_REQUESTS requests arrive as host numpy batches and are flushed sync
# and async; SERVE_HOT hot tenants get SERVE_HOT_REQUESTS more requests each
# and are decoded with sketch_shift through an LRU of SERVE_CACHE models;
# SERVE_EVICT tenants are evicted and restored; on a decayed service tenant 0
# shifts by SERVE_SHIFT in every coordinate.  ckm.diagnose's sigma sweep
# re-sketches the first DIAG_SAMPLE rows of the data.
SERVE_HOT, SERVE_HOT_REQUESTS, SERVE_CACHE, SERVE_EVICT, SERVE_SHIFT = 16, 16, 8, 64, 6.0
DIAG_SAMPLE = 100_000
# The sharded backend (core/engine.py "sharded", core/topology.py): at p = 1
# an NCCL group of one rank over the fit's device batches (SHARDED_TICKS
# decayed ticks), then SHARDED_RANKS gloo ranks on the one card, each
# sketching its block of the N points; each rank process and its
# collectives give up after SHARDED_TIMEOUT_S.
# The tenant mesh (core/fleet.py sharding="mesh"): MESH_SHARDS blocks of the
# [fleet] width's tenants, all on the one card (placement and routing, not
# concurrency), beside the default one-card mesh.
MESH_SHARDS = 4
SHARDED_TOPOLOGIES = ("allreduce", "tree", "ring")
SHARDED_RANKS, SHARDED_TICKS, SHARDED_DECAY, SHARDED_TIMEOUT_S = 4, 10, 0.99, 300
# The LM serving path (models/, launch/serve.py) at the published widths and
# depths of src/repro_torch/configs: (batch, prompt, float32-check prompt)
# per architecture: (batch, prompt, float32-check prompt, depth), prompts in
# positions (internvl2's count its 256 patches; whisper's are decoder tokens
# after the encoder's 1500 frames), depth None = the published n_layers.
# llama3.2-1B prefills 4 requests of 4096 tokens (kernel 8's shape);
# gemma3-1B one of 8192 (16 windows of 512), its float32 check past the
# window so that the rings wrap; granite-moe and xlstm 4 x 4096; whisper 4 x
# (1500 frames + 448 tokens); internvl2 1 x (256 patches + 3840 tokens);
# jamba 1 x 32768 (long_500k's 524,288 cut to one card's prefill) at 16 of
# its 32 layers (two periods of 8: 103 GB in bf16 at full depth); kimi-k2 1
# x 4096 at 1 of its 61 layers (2.08 TB in bf16; one layer's 384 experts are
# 33.8 GB).  LM_DECODE_STEPS greedy tokens after the prefill; the float32
# check (LM_CHECK_STEPS decode steps against forward to tests/test_archs.py's
# bar) runs at the largest depth whose float32 parameters take at most
# LM_CHECK_BYTES, or at the smoke config where one layer is over (kimi-k2); a
# warm-up prefill of LM_WARM_PROMPT tokens.
LM_SERVE = {
    "llama3.2-1b": (4, 4096, 128, None),
    "gemma3-1b": (1, 8192, 600, None),
    "granite-moe-1b-a400m": (4, 4096, 128, None),
    "xlstm-125m": (4, 4096, 128, None),
    "whisper-small": (4, 448, 128, None),
    "internvl2-26b": (1, 4096, 384, None),
    "jamba-v0.1-52b": (1, 32768, 128, 16),
    "kimi-k2-1t-a32b": (1, 4096, 128, 1),
}
LM_SERVE_CUTS = {
    "jamba-v0.1-52b": "cut: 103 GB in bf16 at full depth; prompt cut from long_500k's 524,288",
    "kimi-k2-1t-a32b": "cut: 2.08 TB in bf16 at full depth",
}
LM_DECODE_STEPS, LM_CHECK_STEPS, LM_WARM_PROMPT, LM_SEED = 32, 8, 256, 6
LM_CHECK_BYTES = 40e9
LM_ATOL, LM_RTOL = 2e-2, 1e-2
# jamba's long-context cache ([jamba long-context]): after its prefill, its
# attention layers compressed by build_compressed_cache (Lloyd, K =
# CKM_KV_CENTROIDS = 4096 centroids a head, a ring of CKM_KV_RECENT = 1024,
# models/transformer.py), LONG_DECODE_STEPS tokens decoded with the Mamba
# states carried; kernel 2 at that shape (N = 32768 - 1024 + 1 keys of
# head_dim 128, K = 4096) among the kernel checks.
LONG_CONTEXT_ARCH, LONG_DECODE_STEPS = "jamba-v0.1-52b", 32
# The CKM-compressed KV cache (serve/kv_clustering.py) on gemma3-1B's global
# layers, at examples/serve_kv_ckm.py's sizes (K = 64 centroids a head, a
# ring of 64); KV_DECODE_STEPS tokens decoded.  Section 4 holds kernels 1 and
# 2 against their plain versions at this phase's shapes: one head's S - ring
# + 1 keys of the gemma3-1B prompt at head_dim 256, kernel 2 at each K of
# KV_SHAPE_KS (both on its tile path, K = 64 as one centroid tile), kernel 1
# at CKM's m = 5 K head_dim (serve/kv_clustering.py compress_kv).  The
# clustered regime at head_dim 256 (planted centres x4, key noise 0.1):
# (keys, planted centres = centroids, ring) at the example's sizes and at
# tests/test_kv_clustering.py's.  At the test's both methods are held to its
# bar.  At the example's the reference's CKM recipe misses it (ROADMAP Queue
# 3), so CKM is printed without a bar, and Lloyd runs on KV_LLOYD_SEEDS data
# seeds twice, through kernel 2 and through its plain version (same draws):
# each seed's error must agree within KV_LLOYD_PLAIN_TOL, and the seeds under
# the bar are printed (a k-means++ draw that seeds two centroids in one
# cluster misses it when the query attends to that cluster, in both).
KV_CENTROIDS, KV_RING, KV_DECODE_STEPS, KV_SEED = 64, 64, 8, 7
# The LM's training path (launch/train.py, train/train_loop.py) at
# llama3.2-1B's published width and depth: AdamW over float32 parameters,
# bf16 compute, remat "full", the activation monitor (K = 4, structured at
# d_model 2048: kernel 4) and the compressive balancer (a decode every 2
# steps; kernel 1) on, over SyntheticLM(DataConfig(seed=0, n_domains=4)).
# (arch, batch, sequence): the reference's train_4k cell (S = 4096) with its
# global batch of 256 (512 chips' worth) cut to B = 4.  LM_TRAIN_STEPS steps;
# the first step's loss is held to the same batch's loss at float32 compute
# from the same parameters (relative LM_TRAIN_LOSS_RTOL: bf16 rounding of
# the activations; at initialisation ln V dominates the loss, so the bar
# sits near the ~1e-3 the rounding predicts, not at 2e-2); the final
# checkpoint (keep=1) goes under
# build/train_checkpoints/, is restored and compared bitwise, and needs
# twice the state's bytes free there.  Then the restart invariant of
# tests/test_substrate.py's loop (the smoke config, S = 32, B = 4, float32,
# a checkpoint every LM_RESTART_STEPS // 2 steps): LM_RESTART_STEPS steps
# straight against half, a restart and the rest, the final losses within
# LM_RESTART_RTOL.
LM_TRAIN = ("llama3.2-1b", 4, 4096)
LM_TRAIN_STEPS, LM_TRAIN_SEED, LM_TRAIN_LOSS_RTOL = 3, 8, 1e-3
LM_RESTART_STEPS, LM_RESTART_RTOL = 6, 1e-4
KV_SHAPE_KS = (64, 16)
KV_CLUSTERED_EXAMPLE, KV_CLUSTERED_TEST = (1024, 64, 64), (512, 16, 32)
KV_CLUSTERED_BAR = 0.15
KV_LLOYD_SEEDS, KV_LLOYD_PLAIN_TOL = 20, 1e-4
# Kernel 2's tile path (n > 64, or K past its switch at n <= 64): every
# (n, K, N) of these, with the ragged edges of its point tiles (N = 1, 63,
# 8129 = 127 x 64 + 1, 20,001), centroid tiles (K = 1, 47, 65, 300) and
# feature chunks (n = 65, 100, 257, 784) and the 4-byte staging of rows that
# are not 16-byte aligned (n odd); the prefixes of one draw a width, from a
# generator of their own (derive_seed(DATA_SEED, 300)); ties at n = 256 (the
# duplicated centroids of ASSIGN_TIES, each (kept, [duplicates])), a row
# wider than the redesign's predecessor took (ASSIGN_WIDE_N), and the
# (n, K, N) of ASSIGN_TIMED timed beside the plain version.
ASSIGN_SWEEP_NS = (65, 100, 128, 256, 257, 784, 2048)
ASSIGN_SWEEP_KS = (1, 7, 16, 47, 64, 65, 300)
ASSIGN_SWEEP_NPTS = (1, 63, 8129, 20_001)
ASSIGN_TIES = ((0, (3, 8, 16, 64)), (9, (20, 73)))
ASSIGN_WIDE_N = 12_289
ASSIGN_TIMED = ((784, 64, 20_001), (2048, 64, 20_001))
# A decoder's convergence series against its returned cost: the polish after
# the traced loop lowers the objective, so CLOMPR's and sketch_shift's cost
# is at most the last residual norm squared, and CL-AMP's cost per frequency
# at most its last unexplained energy, each with this slack.
TRACE_COST_SLACK = 1.05


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn) -> float:
    """One call of ``fn`` timed by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn) -> float:
    """Median of TIMED_LAUNCHES CUDA-event timings after one warm-up call
    (itself timed); of SLOW_TIMED_LAUNCHES when the warm-up took over
    SLOW_CALL_MS."""
    torch.cuda.synchronize()
    reps = SLOW_TIMED_LAUNCHES if event_ms(fn) > SLOW_CALL_MS else TIMED_LAUNCHES
    return statistics.median(event_ms(fn) for _ in range(reps))


def bound(n_bytes: float, n_ops: float, peak: float = PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their type's peak (FP32 by default), in
    ms."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sketch_bound(n_pts: int, n: int, m: int) -> tuple[float, str]:
    # Bytes: x, w, beta read once, the two (m,) sums written once.  Operations
    # per (point, frequency): n FMAs of the phase (2n), sin and cos counted as
    # one each (an understatement: sincosf takes tens of instructions), and
    # two weighted FMA accumulates (4).
    n_bytes = 4 * (n_pts * n + n * m + n_pts + 2 * m)
    return bound(n_bytes, n_pts * m * (2 * n + 6))


def qsketch_bound(n_pts: int, n: int, m: int) -> tuple[float, str]:
    # Bytes: x, w and the dither read once, the two (m,) int32 sums written
    # once.  Operations per (point, frequency): the phase (2n), the dither
    # add (1), sin and cos (one each), the two codes (2) and the two integer
    # accumulates (2).
    n_bytes = 4 * (n_pts * n + n * m + m) + 8 * m
    return bound(n_bytes, n_pts * m * (2 * n + 7))


def structured_bound(n_pts: int, n: int, d: int, nblocks: int, quantized: bool):
    # Per (point, frequency) of the (nblocks, d) output: three stages of a
    # sign multiply, the butterfly's log2(d) adds and a scale multiply, then
    # the radius multiply (1), sin and cos (2), and either two weighted FMA
    # accumulates (4) or the dither add, two codes and two integer adds (5).
    # Bytes: x (unpadded), the signs, radii (and dither) read once, beta read
    # once on the float path, the two outputs written once.
    width = nblocks * d
    per = 3 * (2 + d.bit_length() - 1) + (8 if quantized else 7)
    if quantized:
        n_bytes = 4 * (n_pts * n + 5 * width) + 8 * width
    else:
        n_bytes = 4 * (n_pts * n + 4 * width + n_pts) + 8 * width
    return bound(n_bytes, n_pts * width * per)


def assign_bound(n_pts: int, n: int, k: int) -> tuple[float, str]:
    # Bytes: x and c read once, labels and distances written once (8 B a
    # point).  Operations per (point, centroid): the dot product (2n), the
    # scale-and-subtract and the compare (3).
    n_bytes = 4 * (n_pts * n + k * n) + 8 * n_pts
    return bound(n_bytes, n_pts * k * (2 * n + 3))


def shift_bound(p_cand: int, n: int, m: int) -> tuple[float, str]:
    # Per (candidate, frequency): the phase (2n), sincosf (2, one each), the
    # density's two multiply-adds (4), t (4) and the gradient's n FMAs (2n).
    # Bytes: c, w, z1, z2 read once, f and g written once.
    n_bytes = 4 * (2 * p_cand * n + n * m + 2 * m + p_cand)
    return bound(n_bytes, p_cand * m * (4 * n + 10))


def denoise_bound(k_est: int, n: int) -> tuple[float, str]:
    # About 30 operations an entry (two divisions, two exps, two erfcs, the
    # moments and the clips, each counted as one); r read and the two
    # moments written once, lo, hi and q once per coordinate.
    return bound(4 * (3 * k_est * n + 3 * n), 30 * k_est * n)


def flash_bound(bh, bkv, s_q, s_kv, hd, causal, window, dtype) -> tuple[float, str]:
    # Bytes: q, k, v read once, o and the float32 LSE written once.
    # Operations: 4 hd per unmasked (q, k) pair (the score's and the
    # output's multiply-adds), counted for this call's masks, at the bf16
    # tensor-core peak for bf16 inputs and the FP32 peak for float32.
    i = torch.arange(s_q, dtype=torch.int64)
    hi = torch.clamp(i, max=s_kv - 1) if causal else torch.full_like(i, s_kv - 1)
    lo = torch.clamp(i - window + 1, min=0) if window > 0 else torch.zeros_like(i)
    pairs = int(torch.clamp(hi - lo + 1, min=0).sum())
    esize = 2 if dtype == torch.bfloat16 else 4
    n_bytes = esize * (2 * bh * s_q * hd + 2 * bkv * s_kv * hd) + 4 * bh * s_q
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_FP32_FLOP_PER_S
    return bound(n_bytes, 4 * bh * hd * pairs, peak)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    lines = log.splitlines()
    regs = [ln.split("Used ")[1].split(" registers")[0] for ln in lines if "Used " in ln]
    spills = [int(ln.split(" bytes spill stores")[0].split(",")[-1]) for ln in lines
              if "bytes spill stores" in ln]
    spilled = [b for b in spills if b]
    return (f"registers per kernel {regs}, spill stores "
            + (f"{spilled} bytes in {len(spilled)} of {len(spills)} kernels" if spilled else "none"))


_MODES = {"0": "float", "1": "codes", "2": "1bit"}


def ptxas_instances(log: str) -> list[str]:
    """``d/mode/NX: registers, spill stores`` of each instance of the
    structured kernel in a ptxas report."""
    out = []
    for chunk in log.split("Compiling entry function")[1:]:
        name = chunk.split("'")[1]
        if "structuredILi" not in name:
            continue
        d, mode, nx = name.split("structuredILi")[1].split("EE")[0].split("ELi")
        regs = chunk.split("Used ")[1].split(" registers")[0]
        spill = chunk.split(" bytes spill stores")[0].split(",")[-1].strip()
        out.append(f"d={d}/{_MODES[mode]}/NX={nx}: {regs} registers, {spill} B spilled")
    return out


def _timed(out, kernel, plain, bound_fn, line):
    """Add kernel, plain and bound ms to ``out`` and print ``line`` with them."""
    out["ms"] = median_ms(kernel)
    out["plain_ms"] = median_ms(plain)
    out["bound_ms"], out["bound_by"] = bound_fn()
    print(
        f"{line}  kernel {out['ms']:.3f} ms  plain {out['plain_ms']:.3f} ms  "
        f"bound {out['bound_ms']:.3f} ms ({out['bound_by']})",
        flush=True,
    )
    return out


def check_sketch(fs, x, w, beta, label):
    """fourier_sketch kernel vs its plain version on the card."""
    n_pts = x.shape[0]
    c1, s1 = fs.fourier_sketch_sums(x, w, beta)
    c2, s2 = fs.fourier_sketch_sums(x, w, beta)
    torch.cuda.synchronize()
    repeatable = torch.equal(c1, c2) and torch.equal(s1, s2)
    pc, ps = fs.fourier_sketch_sums_plain(x, w, beta)
    err = max(
        float(torch.amax(torch.abs(c1 - pc))), float(torch.amax(torch.abs(s1 - ps)))
    ) / n_pts
    check(err <= SKETCH_TOL, f"fourier_sketch {label}: max|d(sums/N)| {err:.3e} > {SKETCH_TOL}")
    check(repeatable, f"fourier_sketch {label}: two launches differ bitwise")
    line = (
        f"[fourier_sketch {label}] N={n_pts} n={x.shape[1]} m={w.shape[1]} "
        f"max|d(sums/N)|={err:.3e} (tol {SKETCH_TOL}) bitwise-repeatable"
    )
    return _timed(
        {"max_abs_err": err},
        lambda: fs.fourier_sketch_sums(x, w, beta),
        lambda: fs.fourier_sketch_sums_plain(x, w, beta),
        lambda: sketch_bound(n_pts, x.shape[1], w.shape[1]),
        line,
    )


def max_phase(x, w, chunk: int = 1 << 18) -> float:
    """max |x w| over all rows, ``chunk`` rows at a time."""
    return max(float(torch.amax(torch.abs(x[i:i + chunk] @ w)))
               for i in range(0, x.shape[0], chunk))


def max_structured_phase(x, op, chunk: int = 1 << 18) -> float:
    """max |phase| of the structured operator's (N, m) phases, ``chunk`` rows
    at a time."""
    return max(float(torch.amax(torch.abs(op.apply(x[i:i + chunk]))))
               for i in range(0, x.shape[0], chunk))


def check_codes(name, label, kernel, plain, n_pts, split_at, bound_fn, flips=None):
    """An integer-sum kernel against its plain version on the card.

    ``kernel(lo, hi)`` and ``plain(lo, hi)`` return the (qcos, qsin) sums of
    rows [lo, hi).  Checks: two launches bitwise equal; kernel(rows [0, a)) +
    kernel(rows [a, N)) == kernel(all rows) exactly; entries differing from
    the plain version counted, with max |dq| / N <= CODE_TOL; and, given
    ``flips(got, ref)`` (a ``boundary_flips`` call), every differing entry
    held to the boundary rule besides."""
    q1, q2 = kernel(0, n_pts), kernel(0, n_pts)
    parts = [kernel(0, split_at), kernel(split_at, n_pts)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(q1, q2)), f"{name} {label}: two launches differ")
    check(
        all(torch.equal(a + b, c) for a, b, c in zip(parts[0], parts[1], q1)),
        f"{name} {label}: split at {split_at} is not exact",
    )
    ref = plain(0, n_pts)
    diff = [torch.abs(a.long() - b.long()) for a, b in zip(q1, ref)]
    n_diff = sum(int((d > 0).sum()) for d in diff)
    err = max(float(d.max()) for d in diff) / n_pts
    check(err <= CODE_TOL, f"{name} {label}: max|dq|/N {err:.3e} > {CODE_TOL}")
    line = (
        f"[{name} {label}] N={n_pts} differing entries={n_diff} of {2 * q1[0].numel()} "
        f"max|dq|/N={err:.3e} (tol {CODE_TOL}) bitwise-repeatable split-exact"
    )
    if flips is not None:
        _, n_near, _ = flips(q1, ref)
        line += f"; every flip on a code boundary ({n_near} boundary rows)"
    return _timed({"max_abs_err": err}, lambda: kernel(0, n_pts), lambda: plain(0, n_pts),
                  bound_fn, line)


def check_structured(ft, x, op, beta, label):
    """structured_sketch kernel vs its plain version on the card."""
    n_pts = x.shape[0]
    args = (op.diags, op.radii, beta)
    c1, s1 = ft.structured_sketch_sums(x, *args)
    c2, s2 = ft.structured_sketch_sums(x, *args)
    torch.cuda.synchronize()
    pc, ps = ft.structured_sketch_sums_plain(x, *args)
    err = max(
        float(torch.amax(torch.abs(c1 - pc))), float(torch.amax(torch.abs(s1 - ps)))
    ) / n_pts
    check(err <= SKETCH_TOL, f"structured_sketch {label}: max|d(sums/N)| {err:.3e} > {SKETCH_TOL}")
    check(torch.equal(c1, c2) and torch.equal(s1, s2),
          f"structured_sketch {label}: two launches differ bitwise")
    line = (
        f"[structured_sketch {label}] N={n_pts} n={x.shape[1]} d={op.d} m={op.m} "
        f"max|d(sums/N)|={err:.3e} (tol {SKETCH_TOL}) bitwise-repeatable"
    )
    return _timed(
        {"max_abs_err": err},
        lambda: ft.structured_sketch_sums(x, *args),
        lambda: ft.structured_sketch_sums_plain(x, *args),
        lambda: structured_bound(n_pts, x.shape[1], op.d, op.nblocks, False),
        line,
    )


def check_slice2_kernels(fs, ft, x, w, op, dither, label, split_at, results=None):
    """Kernels 3-5 at one shape: kernel 3 at 1 and 4 bits (skipped when
    ``w`` is None), kernel 4, and kernel 5 at 1 and 4 bits.  The 1-bit
    numbers go to ``results`` when given."""
    n_pts, n = x.shape
    out = {}
    if w is not None:
        for bits in (1, 4):
            out[("quantized_fourier_sketch", bits)] = check_codes(
                "quantized_fourier_sketch", f"{label} {bits}bit",
                lambda lo, hi, b=bits: fs.quantized_fourier_sketch_sums(x[lo:hi], w, dither, b),
                lambda lo, hi, b=bits: fs.quantized_fourier_sketch_sums_plain(
                    x[lo:hi], w, dither, b),
                n_pts, split_at, lambda: qsketch_bound(n_pts, n, w.shape[1]),
            )
    out[("structured_sketch", 1)] = check_structured(
        ft, x, op, torch.ones((n_pts,), dtype=torch.float32, device=x.device), label
    )
    padded = torch.nn.functional.pad(dither, (0, op.nblocks * op.d - op.m))
    padded = padded.reshape(op.nblocks, op.d).contiguous()
    for bits in (1, 4):
        out[("quantized_structured_sketch", bits)] = check_codes(
            "quantized_structured_sketch", f"{label} d={op.d} {bits}bit",
            lambda lo, hi, b=bits: ft.quantized_structured_sketch_sums(
                x[lo:hi], op.diags, op.radii, padded, b),
            lambda lo, hi, b=bits: ft.quantized_structured_sketch_sums_plain(
                x[lo:hi], op.diags, op.radii, padded, b),
            n_pts, split_at, lambda: structured_bound(n_pts, n, op.d, op.nblocks, True),
            flips=(lambda got, ref: structured_flips(
                f"quantized_structured_sketch {label} d={op.d} 1bit", x, op, padded, got, ref))
            if bits == 1 else None,
        )
    if results is not None:
        for (name, bits), r in out.items():
            if bits == 1:
                results[name] = r
    return out


def check_shift(ks, c, w, z, label):
    """sketch_shift kernel vs its plain version on the card, after the
    division by m; bitwise repeatable over two launches."""
    m = w.shape[1]
    z1, z2 = z[:m], z[m:]
    f1, g1 = ks.sketch_shift_sums(c, w, z1, z2)
    f2, g2 = ks.sketch_shift_sums(c, w, z1, z2)
    torch.cuda.synchronize()
    pf, pg = ks.sketch_shift_sums_plain(c, w, z1, z2)
    err_f = float(torch.amax(torch.abs(f1 - pf))) / m
    err_g = float(torch.amax(torch.abs(g1 - pg))) / m
    err = max(err_f, err_g)
    check(err <= SHIFT_TOL, f"sketch_shift {label}: max|d(f, g)/m| {err:.3e} > {SHIFT_TOL}")
    check(torch.equal(f1, f2) and torch.equal(g1, g2),
          f"sketch_shift {label}: two launches differ bitwise")
    line = (
        f"[sketch_shift {label}] P={c.shape[0]} n={c.shape[1]} m={m} max|df/m|={err_f:.3e} "
        f"max|dg/m|={err_g:.3e} (tol {SHIFT_TOL}) bitwise-repeatable"
    )
    return _timed(
        {"max_abs_err": err},
        lambda: ks.sketch_shift_sums(c, w, z1, z2),
        lambda: ks.sketch_shift_sums_plain(c, w, z1, z2),
        lambda: shift_bound(c.shape[0], c.shape[1], m),
        line,
    )


def check_denoise(kd, r, q, lo, hi, label):
    """amp_denoise kernel vs its plain version on the card, in the natural
    units of each moment; finite moments inside their bounds."""
    qt = torch.tensor(q, dtype=torch.float32, device=r.device)
    mean, var = kd.amp_denoise(r, qt, lo, hi)
    torch.cuda.synchronize()
    pm, pv = kd.amp_denoise_plain(r, qt, lo, hi)
    err = max(
        float(torch.amax(torch.abs(mean - pm))) / max(1.0, q ** 0.5),
        float(torch.amax(torch.abs(var - pv))) / max(1.0, q),
    )
    check(err <= DENOISE_TOL, f"amp_denoise {label}: max error {err:.3e} > {DENOISE_TOL}")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
          f"amp_denoise {label}: non-finite moments")
    check(bool(((mean >= lo) & (mean <= hi)).all() and (var > 0).all() and (var <= qt).all()),
          f"amp_denoise {label}: moments outside their bounds")
    line = (
        f"[amp_denoise {label}] K={r.shape[0]} n={r.shape[1]} q={q} max err (natural units)="
        f"{err:.3e} (tol {DENOISE_TOL})"
    )
    return _timed(
        {"max_abs_err": err},
        lambda: kd.amp_denoise(r, qt, lo, hi),
        lambda: kd.amp_denoise_plain(r, qt, lo, hi),
        lambda: denoise_bound(r.shape[0], r.shape[1]),
        line,
    )


def check_assign(aa, x, c, label, dup_of=None, time_it=True):
    """assign_argmin kernel vs its plain version on the card.  Labels may
    differ only at near-ties, where the distances to both labels agree within
    the distance tolerance.  With ``dup_of = (i, j)``, centroid j (or each of
    a tuple of them) repeats centroid i < j and must never win (ties go to
    the lowest index).  Timed beside the plain version unless ``time_it`` is
    False."""
    lab, dist = aa.assign_argmin(x, c)
    lab2, dist2 = aa.assign_argmin(x, c)
    torch.cuda.synchronize()
    check(torch.equal(lab, lab2) and torch.equal(dist, dist2),
          f"assign_argmin {label}: two launches differ bitwise")
    plab, pdist = aa.assign_argmin_plain(x, c)
    scale = float(torch.amax(torch.sum(x * x, dim=1)) + torch.amax(torch.sum(c * c, dim=1)))
    tol = DIST_RTOL * scale
    err = float(torch.amax(torch.abs(dist - pdist)))
    check(err <= tol, f"assign_argmin {label}: max|d dist| {err:.3e} > {tol:.3e}")
    diff = torch.nonzero(lab != plab).reshape(-1)
    if diff.numel():
        d_all = torch.sum((x[diff][:, None, :] - c[None]) ** 2, dim=-1)
        gap = torch.abs(
            d_all.gather(1, lab[diff].long()[:, None]) - d_all.gather(1, plab[diff].long()[:, None])
        )
        check(float(gap.max()) <= tol, f"assign_argmin {label}: label mismatch off a tie")
    line = (
        f"[assign_argmin {label}] N={x.shape[0]} n={x.shape[1]} K={c.shape[0]} "
        f"max|d dist|={err:.3e} (tol {tol:.2e}) near-tie label flips={diff.numel()} "
        "bitwise-repeatable"
    )
    if dup_of is not None:
        dups = torch.tensor(dup_of[1], device=lab.device).reshape(-1)
        check(not bool(torch.isin(lab, dups).any()) and bool((lab == dup_of[0]).any()),
              f"assign_argmin {label}: tie not to lowest index")
        line += " ties-to-lowest"
    if not time_it:
        print(line, flush=True)
        return {"max_abs_err": err}
    return _timed(
        {"max_abs_err": err},
        lambda: aa.assign_argmin(x, c),
        lambda: aa.assign_argmin_plain(x, c),
        lambda: assign_bound(x.shape[0], x.shape[1], c.shape[0]),
        line,
    )


def assign_sweep(aa, dev):
    """Kernel 2's tile path over ASSIGN_SWEEP_NS x ASSIGN_SWEEP_KS x
    ASSIGN_SWEEP_NPTS, the ties of ASSIGN_TIES, a row of ASSIGN_WIDE_N
    features, with check_assign's bars; the shapes of ASSIGN_TIMED timed."""
    from repro_torch import device as device_mod

    t0 = time.perf_counter()
    g = device_mod.generator(device_mod.derive_seed(DATA_SEED, 300), dev)
    n_max, k_max = max(ASSIGN_SWEEP_NPTS), max(ASSIGN_SWEEP_KS)
    timed = {}
    for n_s in ASSIGN_SWEEP_NS:
        xs = torch.randn((n_max, n_s), generator=g, device=dev) * 3
        cs = torch.randn((k_max, n_s), generator=g, device=dev) * 3
        for k_s in ASSIGN_SWEEP_KS:
            for n_pts in ASSIGN_SWEEP_NPTS:
                time_it = (n_s, k_s, n_pts) in ASSIGN_TIMED
                r = check_assign(aa, xs[:n_pts], cs[:k_s].contiguous(),
                                 f"tile sweep n={n_s} K={k_s}", time_it=time_it)
                if time_it:
                    timed[(n_s, k_s, n_pts)] = r
        if n_s == 256:
            for kept, dups in ASSIGN_TIES:
                k_t = max(dups) + 7
                tied = cs[:k_t].clone()
                tied[list(dups)] = tied[kept].clone()
                check_assign(aa, xs, tied, f"tile sweep n={n_s} K={k_t} ties {kept}={dups}",
                             dup_of=(kept, dups), time_it=False)
    xs = torch.randn((63, ASSIGN_WIDE_N), generator=g, device=dev) * 3
    cs = torch.randn((7, ASSIGN_WIDE_N), generator=g, device=dev) * 3
    check_assign(aa, xs, cs, f"wide n={ASSIGN_WIDE_N}", time_it=False)
    for (n_s, k_s, n_pts), r in timed.items():
        print(f"[assign_argmin tile timed] n={n_s} K={k_s} N={n_pts}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound", flush=True)
    shapes = len(ASSIGN_SWEEP_NS) * len(ASSIGN_SWEEP_KS) * len(ASSIGN_SWEEP_NPTS)
    print(f"[assign_argmin tile sweep] {shapes} shapes, "
          f"{sum(len(d) for _, d in ASSIGN_TIES)} ties, n={ASSIGN_WIDE_N}: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def check_flash(fa, label, q, k, v, rep, causal, window, time_it=False, q_chunk=None):
    """flash_attention kernel vs its plain version on the card: output and
    LSE within their bars, bitwise repeatable over two launches, rows with
    no key at LSE -1e30.  Returns the numbers and the kernel's output."""
    o1, l1 = fa.flash_attention_kernel(q, k, v, rep, causal, window)
    o2, l2 = fa.flash_attention_kernel(q, k, v, rep, causal, window)
    torch.cuda.synchronize()
    check(torch.equal(o1, o2) and torch.equal(l1, l2),
          f"flash_attention {label}: two launches differ bitwise")
    po, pl = fa.flash_attention_plain(q, k, v, rep, causal, window, q_chunk)
    do = torch.abs(o1.float() - po.float())
    err_o, err_l = float(do.max()), float(torch.amax(torch.abs(l1 - pl)))
    del o2, l2
    if q.dtype == torch.bfloat16:
        used = float(torch.amax(do / (FLASH_BF16_RTOL * torch.abs(po.float()) + FLASH_BF16_ATOL)))
        bar = f"|do| <= 2^-7 |o| + {FLASH_BF16_ATOL}: {used:.3f} of it"
        check(used <= 1.0, f"flash_attention {label}: |do| over its bar ({used:.3f})")
    else:
        bar = f"tol {FLASH_F32_TOL}"
        check(err_o <= FLASH_F32_TOL, f"flash_attention {label}: max|do| {err_o:.3e}")
    check(err_l <= FLASH_LSE_TOL, f"flash_attention {label}: max|dlse| {err_l:.3e}")
    bh, s_q, hd = q.shape
    s_kv = k.shape[1]
    keyless = max(0, s_q - (s_kv + window - 1)) if window > 0 else 0
    if keyless:
        check(bool((l1[:, s_q - keyless:] == -1e30).all()),
              f"flash_attention {label}: a row with no key has an LSE other than -1e30")
    line = (
        f"[flash_attention {label}] BH={bh} BKV={k.shape[0]} S_q={s_q} S_kv={s_kv} hd={hd} "
        f"causal={causal} window={window} {str(q.dtype).split('.')[-1]} rows-without-key="
        f"{keyless} max|do|={err_o:.3e} ({bar}) max|dlse|={err_l:.3e} (tol {FLASH_LSE_TOL}) "
        "bitwise-repeatable"
    )
    out = {"max_abs_err": err_o, "o": o1}
    if not time_it:
        print(line, flush=True)
        return out
    return _timed(
        out,
        lambda: fa.flash_attention_kernel(q, k, v, rep, causal, window),
        lambda: fa.flash_attention_plain(q, k, v, rep, causal, window, q_chunk),
        lambda: flash_bound(bh, k.shape[0], s_q, s_kv, hd, causal, window, q.dtype),
        line,
    )


def sdpa_ms(q, k, v, b, h, kvh, causal, window) -> tuple[float, str]:
    """The time of one torch.nn.functional.scaled_dot_product_attention call
    on the same (flattened-head) inputs, viewed as (B, H, S, hd), with the
    backend PyTorch picks, and the name of its longest device kernel.  Timed
    only: the port never calls it."""
    s_q, s_kv = q.shape[1], k.shape[1]
    q4, k4, v4 = q.view(b, h, s_q, -1), k.view(b, kvh, s_kv, -1), v.view(b, kvh, s_kv, -1)
    mask = None
    if window > 0:
        i = torch.arange(s_q, device=q.device)[:, None]
        j = torch.arange(s_kv, device=q.device)[None, :]
        mask = (i - j < window) & ((i >= j) | (not causal))

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=h != kvh)

    ms = median_ms(call)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    top = (max(kernels, key=lambda e: e.self_device_time_total).key if kernels
           else "its kernels not seen by the profiler")
    return ms, top[:90]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _peak_since(dev, base: int) -> int:
    """Device bytes allocated at the peak since the last reset, over ``base``."""
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def _reset_peak(dev) -> int:
    """Start a peak-memory window on an emptied cache: a cached block is
    handed out unsplit when it is at most 1 MB larger than asked, and would
    count in full; returns the bytes allocated at the start."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def launch_floor(dev, launches: int = 100) -> tuple[float, float]:
    """An empty kernel's cost inside a CUDA graph: ``launches`` zero-cycle
    spin kernels (``torch.cuda._sleep(0)``) captured in one graph, replayed;
    returns (device µs per launch from the profiler, graph µs per launch from
    CUDA events, gaps between the kernels included)."""
    stream = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    torch.cuda._sleep(0)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph.capture_begin()
        for _ in range(launches):
            torch.cuda._sleep(0)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    per_replay_ms = median_ms(graph.replay)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize(dev)
    device = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    count = sum(e.count for e in device)
    device_us = sum(e.self_device_time_total for e in device) / count if count else float("nan")
    return device_us, per_replay_ms * 1e3 / launches


def trace_consistent(decoder: str, series: dict, cost: float, m: int) -> tuple[bool, str]:
    """Whether a decoder's last traced point is consistent with its cost
    (``TRACE_COST_SLACK``), and the numbers that say so."""
    if decoder == "amp":
        last = series["decoder.amp.unexplained_energy"][-1]
        return cost / m <= TRACE_COST_SLACK * last, f"cost/m {cost / m:.6g}, last energy {last:.6g}"
    last = series[f"decoder.{decoder}.residual_norm"][-1]
    return cost <= TRACE_COST_SLACK * last * last, f"cost {cost:.6g}, last |r|^2 {last * last:.6g}"


def streaming_phases(dev, run, cfg, path_cfg, x, batches, fits, n_host=N,
                     batch_rows=HOST_BATCH_ROWS, ticks=TICKS, tick_rows=TICK_ROWS):
    """The streaming layer on the card, through the entry points a user calls.

    ``run(label, fn, kernel)`` drives a counted main-path phase; ``fits``
    holds the earlier fits by label, ``path_cfg`` their configs, ``x`` and
    ``batches`` their device data.  Phases: [stream-host sync/async] (and
    1-bit), [decay], [window], [obs], [trace]; every failed check raises.
    """
    from repro_torch import device as device_mod
    from repro_torch import obs
    from repro_torch.core import SketchEngine, SketchWindow, ckm, ingest_stream, lloyd
    from repro_torch.core.engine import (
        DecayedQuantizedSketchEngineState,
        DecayedSketchEngineState,
    )
    from repro_torch.data import synthetic
    from repro_torch.kernels import fourier_sketch as fs

    seed0, seed1 = device_mod.derive_seed(FIT_SEED, 0), device_mod.derive_seed(FIT_SEED, 1)
    km_cfg = lloyd.LloydConfig(k=K, replicates=KMEANS_REPLICATES)

    # The host data: numpy, made on the host; k-means x5 on a device copy of
    # it (for the quality bar only).
    t0 = time.perf_counter()
    xh = synthetic.gaussian_mixture(HOST_DATA_SEED, n_host, K, DIM, device="cpu").numpy()
    make_s = time.perf_counter() - t0
    x_eval = torch.from_numpy(xh).to(dev)
    km = run("kmeans-host", lambda: lloyd.kmeans(KMEANS_SEED, x_eval, km_cfg, device=dev),
             "assign_argmin")
    sse_km = float(km.sse) / n_host
    print(f"[stream-host data] N={n_host} n={DIM} float32 numpy on the host "
          f"({xh.nbytes / 1e6:.0f} MB) made in {make_s:.2f}s; kmeans x{KMEANS_REPLICATES} "
          f"SSE/N {sse_km:.4f}", flush=True)

    def rel_sse(pts, c, ref):
        return float(ckm.sse(pts, c, device=dev)) / pts.shape[0] / ref

    # 1. Host-fed streams, sync then async: the pass alone (sync, async, and
    # ingest_stream with its stats and peak memory), then the async fit.
    host_fits = {}
    for quant, kernel in (("none", "fourier_sketch"), ("1bit", "quantized_fourier_sketch")):
        tag = "stream-host" if quant == "none" else "stream-host-1bit"
        cfg_s = dataclasses.replace(cfg, sketch_quantization=quant)
        cfg_a = dataclasses.replace(cfg_s, ingest="async", ingest_prefetch=INGEST_PREFETCH)
        for rows in batch_rows:
            host_batches = [xh[i:i + rows] for i in range(0, n_host, rows)]
            # The pass in turns, sync, async, async, sync: the first async
            # pass at a batch size also pins its ring of host buffers.
            walls, sketches = {"sync": [], "async": []}, {"sync": [], "async": []}
            for mode in ("sync", "async", "async", "sync"):
                t0 = time.perf_counter()
                z, op, _, _, first = ckm.compute_sketch_streaming(
                    seed0, iter(host_batches), cfg_a if mode == "async" else cfg_s, device=dev)
                torch.cuda.synchronize(dev)
                walls[mode].append(time.perf_counter() - t0)
                sketches[mode].append(z)
            z_s = sketches["sync"][0]
            eng = ckm.make_engine(op, cfg_a, dev, ckm.make_quantizer(seed0, cfg_a, op.m, dev))
            state0 = eng.update(eng.init_state(), first)
            base = _reset_peak(dev)
            eng.update(state0, first)  # one fold alone: the kernel's own scratch
            scratch = _peak_since(dev, base)
            base = _reset_peak(dev)
            state, stats = ingest_stream(eng, iter(host_batches[1:]), state=state0,
                                         prefetch=INGEST_PREFETCH)
            peak = _peak_since(dev, base)
            batch_bytes = rows * DIM * 4
            bound_b = (INGEST_PREFETCH + 2) * batch_bytes + _nbytes(state0) + _nbytes([op.w])
            # The caching allocator hands a block out unsplit when at most
            # 1 MiB would remain (a 20 MiB segment holds five 4 MB batches,
            # the fifth with the remainder): up to 1 MiB more a batch.
            slack = (INGEST_PREFETCH + 2) * (1 << 20)
            z_i = eng.finalize(state)[0]
            t0 = time.perf_counter()
            r = run(f"{tag} async fit B={rows}",
                    lambda: ckm.fit_streaming(FIT_SEED, iter(host_batches), cfg_a, device=dev),
                    kernel)
            fit_s = time.perf_counter() - t0
            host_fits[(quant, rows)] = (r, fit_s, host_batches, cfg_a)
            rel = rel_sse(x_eval, r.centroids, sse_km)
            same = {"sync pass": torch.equal(sketches["sync"][1], z_s),
                    "async passes": all(torch.equal(z, z_s) for z in sketches["async"]),
                    "ingest_stream": torch.equal(z_i, z_s), "async fit": torch.equal(r.sketch, z_s)}
            wall_s, wall_a = min(walls["sync"]), min(walls["async"])
            print(f"[{tag} sync] B={rows} ({len(host_batches)} batches): pass "
                  f"{walls['sync'][0]:.4f}s, {walls['sync'][1]:.4f}s", flush=True)
            print(
                f"[{tag} async] B={rows} ({len(host_batches)} batches), prefetch "
                f"{INGEST_PREFETCH}: pass {walls['async'][0]:.4f}s (first), "
                f"{walls['async'][1]:.4f}s; best {wall_s / wall_a:.2f}x the best sync; "
                f"ingest_stream {dataclasses.asdict(stats)}, overlap_efficiency "
                f"{stats.overlap_efficiency:.3f}; peak device memory {peak / 1e6:.1f} MB against "
                f"(prefetch + 2) x batch + state + operator {bound_b / 1e6:.1f} MB + the fold's "
                f"scratch {scratch / 1e6:.1f} MB + the allocator's split allowance "
                f"{slack / 1e6:.1f} MB (margin {(bound_b + scratch + slack - peak) / 1e6:.1f} MB, "
                f"{(bound_b + scratch - peak) / 1e6:.1f} MB without the allowance); the sync "
                f"sketch's bits: {same}; fit {fit_s:.2f}s, relative SSE {rel:.4f} "
                f"(limit {MAX_RELATIVE_SSE})",
                flush=True,
            )
            check(all(same.values()), f"{tag} B={rows}: async differs from sync: {same}")
            check(peak <= bound_b + scratch + slack,
                  f"{tag} B={rows}: peak {peak} B over the bound {bound_b} + scratch {scratch} "
                  f"+ allowance {slack}")
            check(rel <= MAX_RELATIVE_SSE, f"{tag} B={rows}: relative SSE {rel:.4f}")
    del x_eval

    # 2. Decayed states over `ticks` ticks of the device data: the kernel's
    # state against the plain versions' through the same algebra, decay = 1
    # against the lifetime engine, decay_to against the closed form.
    op = fits["fit"].freq_op
    q1 = ckm.make_quantizer(seed0, dataclasses.replace(cfg, sketch_quantization="1bit"), op.m, dev)
    chunks = torch.split(x[: ticks * tick_rows], tick_rows)
    ones = torch.ones((tick_rows,), dtype=torch.float32, device=dev)
    eng_f = SketchEngine(op, device=dev, decay=DECAY)
    eng_q = SketchEngine(op, device=dev, quantizer=q1, decay=DECAY)

    def fold(eng, tick=None):
        s = eng.init_state()
        for t, c in enumerate(chunks):
            s = eng.update(s, c, **({} if eng.decay is None else
                                    {"t": float(t if tick is None else tick)}))
        return s

    s_f = run("decay", lambda: fold(eng_f), "fourier_sketch")
    s_q = run("decay-1bit", lambda: fold(eng_q), "quantized_fourier_sketch")
    p_f, p_q = eng_f.init_state(), eng_q.init_state()
    kernel_parts = []
    for t, c in enumerate(chunks):
        stamp = torch.full((), float(t), device=dev)
        gamma = torch.full((), DECAY, device=dev)
        n_c = torch.full((), float(tick_rows), device=dev)
        lo_c, hi_c = torch.amin(c, 0), torch.amax(c, 0)
        cs, ss = fs.fourier_sketch_sums_plain(c, op.w, ones)
        p_f = eng_f.merge(p_f, DecayedSketchEngineState(
            cs, ss, torch.sum(ones), lo_c, hi_c, n_c, stamp, gamma))
        qc, qs = fs.quantized_fourier_sketch_sums_plain(c, op.w, q1.dither, 1)
        p_q = eng_q.merge(p_q, DecayedQuantizedSketchEngineState(
            qc, qs, torch.zeros_like(cs), torch.zeros_like(ss), n_c, lo_c, hi_c, n_c, stamp,
            gamma))
        kernel_parts.append(fs.fourier_sketch_sums(c, op.w, ones))
    err_f = float(torch.amax(torch.abs(eng_f.finalize(s_f)[0] - eng_f.finalize(p_f)[0])))
    wsum = float(s_f.weight_sum)
    err_q = max(float(torch.amax(torch.abs(a.long() - b.long()))) / tick_rows
                for a, b in ((s_q.qcos_acc, p_q.qcos_acc), (s_q.qsin_acc, p_q.qsin_acc)))
    err_d = max(float(torch.amax(torch.abs(a - b))) / wsum
                for a, b in ((s_q.dcos_acc, p_q.dcos_acc), (s_q.dsin_acc, p_q.dsin_acc)))
    qc_last, qs_last = fs.quantized_fourier_sketch_sums(chunks[-1], op.w, q1.dither, 1)
    ints_exact = torch.equal(s_q.qcos_acc, qc_last) and torch.equal(s_q.qsin_acc, qs_last)
    same_rest = all(torch.equal(getattr(s_f, f), getattr(p_f, f))
                    for f in ("weight_sum", "lower", "upper", "count", "stamp"))
    check(err_f <= SKETCH_TOL, f"decay: kernel against plain |dz| {err_f:.3e}")
    check(err_q <= CODE_TOL and err_d <= CODE_TOL,
          f"decay-1bit: kernel against plain |dq|/N {err_q:.3e}, |d side|/mass {err_d:.3e}")
    check(ints_exact and same_rest, "decay: the int32 segment or the exact fields differ")
    transparent = []
    for quantizer in (None, q1):
        life = SketchEngine(op, device=dev, quantizer=quantizer)
        one = SketchEngine(op, device=dev, quantizer=quantizer, decay=1.0)
        a, b = life.finalize(fold(life)), one.finalize(fold(one, tick=7))
        transparent.append(all(torch.equal(u, v) for u, v in zip(a, b)))
    check(all(transparent), f"decay=1.0 at a constant tick is not the lifetime state: {transparent}")
    t_end = ticks - 1 + 5
    z_end = eng_f.finalize(eng_f.decay_to(s_f, float(t_end)))[0]
    f64 = [DECAY ** (t_end - t) for t in range(ticks)]
    cos_ref = sum(f * c.double() for f, (c, _) in zip(f64, kernel_parts))
    sin_ref = sum(f * s_.double() for f, (_, s_) in zip(f64, kernel_parts))
    z_ref = torch.cat([cos_ref, -sin_ref]) / (sum(f64) * tick_rows)
    err_c = float(torch.amax(torch.abs(z_end.double() - z_ref)))
    check(err_c <= SKETCH_TOL, f"decay_to against the closed form: |dz| {err_c:.3e}")
    print(f"[decay] gamma={DECAY}, {ticks} ticks of {tick_rows} rows, m={op.m}: kernel against "
          f"plain max|dz| {err_f:.3e} (tol {SKETCH_TOL}); 1-bit max|dq|/N {err_q:.3e}, side "
          f"channel max|d|/mass {err_d:.3e} (tol {CODE_TOL}), newest int32 segment the last "
          f"tick's codes exactly: {ints_exact}; decay=1.0 at one tick bitwise the lifetime "
          f"state (float, 1-bit): {transparent}; decay_to({t_end}) against the closed form "
          f"max|dz| {err_c:.3e}; decayed mass {wsum:.6g} of {ticks * tick_rows} points",
          flush=True)

    # 3. The window: the mixture moves halfway through the ticks.
    half = ticks // 2
    drift = torch.cat([
        synthetic.gaussian_mixture(DRIFT_SEED, half * tick_rows, K, DIM, device=dev),
        synthetic.gaussian_mixture(DRIFT_SEED + 1, (ticks - half) * tick_rows, K, DIM, device=dev),
    ])
    d_chunks = torch.split(drift, tick_rows)
    eng = SketchEngine(op, device=dev)
    sw = SketchWindow(eng, WINDOW_BUCKETS)

    def drive():
        ws, life = sw.init_state(), eng.init_state()
        for t, c in enumerate(d_chunks):
            ws = sw.update(ws, c, t=float(t))
            life = eng.update(life, c)
        return ws, life

    t0 = time.perf_counter()
    ws, life = run("window", drive, "fourier_sketch")
    drive_s = time.perf_counter() - t0
    read = sw.read(ws)
    ref = eng.init_state()
    for c in d_chunks[ticks - WINDOW_BUCKETS:]:
        ref = eng.merge(ref, eng.update(eng.init_state(), c))
    read_bitwise = all(torch.equal(a, b) for a, b in zip(read, ref))
    check(read_bitwise, "window: the read differs from the merge of the last W ticks' states")
    pts = drift[(ticks - WINDOW_BUCKETS) * tick_rows:]
    km_w = run("kmeans-window", lambda: lloyd.kmeans(KMEANS_SEED, pts, km_cfg, device=dev),
               "assign_argmin")
    sse_w = float(km_w.sse) / pts.shape[0]
    rels = {}
    for name, st in (("window", read), ("lifetime", life)):
        z, lo, hi = eng.finalize(st)
        cents = ckm.decode_sketch(seed1, z, op, lo, hi, cfg, device=dev)[0]
        rels[name] = rel_sse(pts, cents, sse_w)
    print(f"[window] W={WINDOW_BUCKETS} buckets over {ticks} ticks of {tick_rows} rows (mixture "
          f"moved at tick {half}), {drive_s:.2f}s; the read bitwise the merge of the last "
          f"{WINDOW_BUCKETS} ticks' states: {read_bitwise}; ring {sw.state_bytes(ws)} B; relative "
          f"SSE on the window's {pts.shape[0]} points: window {rels['window']:.4f} (limit "
          f"{MAX_RELATIVE_SSE}), lifetime sketch {rels['lifetime']:.4f}", flush=True)
    check(rels["window"] <= MAX_RELATIVE_SSE, f"window: relative SSE {rels['window']:.4f}")
    del drift, d_chunks, pts

    # 4. Telemetry on and off over the host-fed async fit (the off run is
    # the [stream-host async] fit at the first batch size).
    r_off, wall_off, host_batches, cfg_a = host_fits[("none", batch_rows[0])]
    obs.reset()
    obs.enable()
    t0 = time.perf_counter()
    r_on = run("obs", lambda: ckm.fit_streaming(FIT_SEED, iter(host_batches), cfg_a, device=dev),
               "fourier_sketch")
    wall_on = time.perf_counter() - t0
    path = obs.export_jsonl(Path(__file__).resolve().parent / "build" / "obs" / "stream-host.jsonl")
    obs.disable()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    obs.reset()
    spans = [e["name"] for e in lines if e["kind"] == "span"]
    metrics = {e["name"]: e["value"] for e in lines if e["kind"] == "metric"}
    series = {e["name"]: e["values"] for e in lines if e["kind"] == "series"}
    ingest_keys = sorted(k for k in metrics if k.startswith("ingest."))
    want = ["ingest.batches", "ingest.compute_s", "ingest.consumer_wait_s", "ingest.overlap_efficiency",
            "ingest.points", "ingest.produce_s", "ingest.producer_wait_s", "ingest.resident_batches",
            "ingest.wall_s"]
    same_c = all(torch.equal(getattr(r_on, f), getattr(r_off, f))
                 for f in ("centroids", "weights", "cost", "sketch"))
    print(f"[obs] host-fed async fit_streaming, telemetry off {wall_off:.3f}s, on {wall_on:.3f}s; "
          f"the same bits: {same_c}; {len(lines)} JSONL lines ({path.stat().st_size} B): "
          f"{spans.count('engine.update')} engine.update spans for {len(host_batches)} batches, "
          f"ingest instruments {ingest_keys}, overlap_efficiency "
          f"{metrics.get('ingest.overlap_efficiency', float('nan')):.3f}, series "
          f"{ {k: len(v) for k, v in series.items()} }", flush=True)
    check(same_c, "obs: telemetry changed the fit's bits")
    check(spans.count("engine.update") == len(host_batches),
          f"obs: {spans.count('engine.update')} engine.update spans for {len(host_batches)} batches")
    check(ingest_keys == want, f"obs: ingest instruments {ingest_keys}")
    check(len(series.get("decoder.clompr.residual_norm", ())) == 2 * K, "obs: no CLOMPR series")

    # 5. Convergence traces, graphed (the fit) and eager (decode_sketch).
    obs.enable()
    for label, decoder, kernel, streaming in (
        ("fit", "clompr", "fourier_sketch", False),
        ("fit-sketch_shift", "sketch_shift", "sketch_shift", False),
        ("fit-amp", "amp", "amp_denoise", True),
    ):
        r0 = fits[label]
        tcfg = dataclasses.replace(path_cfg[label], trace_convergence=True)
        obs.TRACER.reset()
        if streaming:
            r_t = run(f"trace {decoder}", lambda c=tcfg: ckm.fit_streaming(
                FIT_SEED, iter(batches), c, device=dev), kernel)
        else:
            r_t = run(f"trace {decoder}", lambda c=tcfg: ckm.fit(FIT_SEED, x, c, device=dev),
                      kernel)
        def traced():
            out = {e["name"]: e["values"] for e in obs.TRACER.events if e["kind"] == "series"}
            obs.TRACER.reset()
            return out

        graphed = traced()
        # The eager decode against a graphed one of the same depth: the fit's
        # own for sketch_shift and CL-AMP; CLOMPR's at RE_DECODE_STEPS.
        dcfg, out_g, series_g, depth = tcfg, (r_t.centroids, r_t.weights, r_t.cost), graphed, ""
        if decoder == "clompr":
            dcfg = dataclasses.replace(tcfg, **RE_DECODE_STEPS)
            out_g = ckm.decode_sketch(seed1, r_t.sketch, r_t.freq_op, *r_t.bounds, dcfg,
                                      device=dev)
            series_g = traced()
            depth = " at {atom_steps}/{joint_steps}/{final_steps} steps".format(**RE_DECODE_STEPS)
        t0 = time.perf_counter()
        out_e = ckm.decode_sketch(seed1, r_t.sketch, r_t.freq_op, *r_t.bounds, dcfg, device=dev,
                                  eager=True)
        torch.cuda.synchronize(dev)
        eager_s = time.perf_counter() - t0
        eager = traced()
        same_c = all(torch.equal(getattr(r_t, f), getattr(r0, f))
                     for f in ("centroids", "weights", "cost"))
        same_e = all(torch.equal(a, b) for a, b in zip(out_e, out_g))
        ok, numbers = trace_consistent(decoder, graphed, float(r_t.cost), op.m)
        print(f"[trace {decoder}] series { {k: len(v) for k, v in graphed.items()} }; centroids "
              f"bitwise the untraced fit's: {same_c}; graphed series bitwise the eager "
              f"decode's{depth} ({eager_s:.2f}s): {series_g == eager} (eager centroids the same: "
              f"{same_e}); first/last {[(v[0], v[-1]) for v in graphed.values()]}; {numbers}",
              flush=True)
        check(same_c, f"trace {decoder}: tracing changed the fit's bits")
        check(bool(series_g) and series_g == eager,
              f"trace {decoder}: graphed and eager series differ")
        check(ok, f"trace {decoder}: the last traced point is inconsistent with the cost ({numbers})")
    obs.disable()
    obs.reset()


def stream_device_phase(dev, run, cfg, batches, sync=None):
    """[stream-device sync/async]: fit_streaming over batches already on the
    card, sync and async, float and 1-bit.  The async passes give the sync
    sketch's bits, and the async ingest's stager hands every batch through
    without a pinned slot."""
    from repro_torch import device as device_mod
    from repro_torch.core import ckm
    from repro_torch.core import ingest as ingest_mod

    sync = sync or torch.cuda.synchronize
    seed0 = device_mod.derive_seed(FIT_SEED, 0)
    stagers = []
    made = ingest_mod._PinnedStager

    def recorded(*args):
        stagers.append(made(*args))
        return stagers[-1]

    ingest_mod._PinnedStager = recorded
    try:
        for quant, kernel in (("none", "fourier_sketch"), ("1bit", "quantized_fourier_sketch")):
            tag = "stream-device" if quant == "none" else "stream-device-1bit"
            cfg_s = dataclasses.replace(cfg, sketch_quantization=quant)
            cfg_a = dataclasses.replace(cfg_s, ingest="async", ingest_prefetch=INGEST_PREFETCH)
            walls, sketches = {"sync": [], "async": []}, {"sync": [], "async": []}
            base = _reset_peak(dev)
            for mode in ("sync", "async", "async", "sync"):
                t0 = time.perf_counter()
                z = ckm.compute_sketch_streaming(
                    seed0, iter(batches), cfg_a if mode == "async" else cfg_s, device=dev)[0]
                sync(dev)
                walls[mode].append(time.perf_counter() - t0)
                sketches[mode].append(z)
            peak = _peak_since(dev, base)
            r = run(f"{tag} async fit",
                    lambda c=cfg_a: ckm.fit_streaming(FIT_SEED, iter(batches), c, device=dev),
                    kernel)
            z_s = sketches["sync"][0]
            same = {"sync pass": torch.equal(sketches["sync"][1], z_s),
                    "async passes": all(torch.equal(z, z_s) for z in sketches["async"]),
                    "async fit": torch.equal(r.sketch, z_s)}
            pinned = sum(b is not None for st in stagers for b in st.buffers)
            print(f"[{tag} sync/async] {len(batches)} device batches of {batches[0].shape[0]} "
                  f"rows: sync pass {walls['sync'][0]:.4f}s, {walls['sync'][1]:.4f}s; async pass "
                  f"{walls['async'][0]:.4f}s, {walls['async'][1]:.4f}s; best async/sync "
                  f"{min(walls['async']) / min(walls['sync']):.3f}; the sync sketch's bits: "
                  f"{same}; pinned slots allocated by {len(stagers)} stagers: {pinned}; peak "
                  f"device memory over the passes {peak / 1e6:.1f} MB (the batches were "
                  f"resident before)", flush=True)
            check(all(same.values()), f"{tag}: async differs from sync: {same}")
            check(stagers and pinned == 0,
                  f"{tag}: {len(stagers)} stagers, {pinned} pinned slots for device batches")
            stagers.clear()
    finally:
        ingest_mod._PinnedStager = made


def _stack_states(states):
    """Per-tenant states -> one stacked state of their type."""
    return type(states[0])(*(torch.stack(f) for f in zip(*states)))


def _same_state(a, b) -> bool:
    return type(a) is type(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def boundary_flips(name, x, w, dither, got, ref, rows=1 << 14):
    """1-bit code sums ``got`` against ``ref`` ((T, m) int32 pairs) of rows
    ``x (T, B, n)`` under frequencies ``w (T, n, m)`` and ``dither (T, m)``.

    Each entry may differ only by flips of points on a code boundary: by at
    most twice the count of its rows whose float64 phase has |cos| (or |sin|)
    within float32's rounding of that phase, 1e-6 (1 + sum |x_i w_i| + |d|).
    Fails otherwise.  Returns (differing entries, boundary points among
    them, max |dq|)."""
    diff = torch.stack([torch.abs(a.long() - b.long()) for a, b in zip(got, ref)])
    idx = torch.nonzero(diff)  # (k, 3): (cos/sin, tenant, frequency)
    n_near = 0
    for t in torch.unique(idx[:, 1]).tolist():
        which, _, j = idx[idx[:, 1] == t].unbind(1)
        ws, ds = w[t][:, j].double(), dither[t, j].double()  # (n, k), (k,)
        near = torch.zeros_like(j)
        for lo in range(0, x.shape[1], rows):
            xs = x[t, lo:lo + rows].double()
            theta = xs @ ws + ds
            mag = xs.abs() @ ws.abs() + ds.abs()
            trig = torch.where(which == 0, torch.cos(theta), torch.sin(theta))
            near += (trig.abs() < 1e-6 * (1 + mag)).sum(0)
        bad = diff[which, t, j] > 2 * near
        check(not bool(bad.any()),
              f"{name}: {int(bad.sum())} entries differ from the plain version by more than "
              "their boundary points allow")
        n_near += int(near.sum())
    return idx.shape[0], n_near, float(diff.max())


def structured_w64(op) -> torch.Tensor:
    """The structured operator's (n, nblocks d) frequencies in float64, from
    its signs and radii (every block column, the ragged tail included)."""
    from repro_torch.kernels import freq_transform as ft

    eye = torch.eye(op.n, op.d, dtype=torch.float64, device=op.diags.device)
    cols = ft.hd_chain(eye[:, None, :], op.diags.double()) * op.radii.double()
    return cols.reshape(op.n, op.nblocks * op.d)


def structured_flips(name, x, op, dither, got, ref):
    """``boundary_flips`` of kernel 5's 1-bit sums (``(nblocks, d)`` pairs)
    on rows ``x`` under ``op`` and its padded ``(nblocks, d)`` dither."""
    return boundary_flips(name, x[None], structured_w64(op)[None], dither.reshape(1, -1),
                          [q.reshape(1, -1) for q in got], [q.reshape(1, -1) for q in ref])


def fleet_phases(dev, run, cfg, sigma2, results, sync=None, tenants=FLEET_T, rows=FLEET_B,
                 requests=FLEET_REQUESTS, request_rows=FLEET_REQUEST_ROWS,
                 structured_tenants=FLEET_STRUCTURED_T, m=M, k=K, dim=DIM):
    """[fleet]: the multi-tenant fleet on one card, through the entry points a
    user calls (fleet_specs, FleetEngine update / merge / finalize /
    finalize_tenant / ingest / decay_to, a fleet SketchWindow, decode of a
    tenant's sketch).  Every tenant's rows are held bitwise to its isolated
    engine's; the tenant-axis entries of kernels 1 and 3 bitwise to T single
    launches and to their plain versions within the bars; their numbers go
    to ``results``."""
    from repro_torch import device as device_mod
    from repro_torch.core import FleetEngine, SketchWindow, ckm, fleet_quantizers, fleet_specs
    from repro_torch.core import lloyd
    from repro_torch.data import synthetic
    from repro_torch.kernels import fourier_sketch as fs
    from repro_torch.kernels import freq_transform as ft

    sync = sync or torch.cuda.synchronize
    t_phase = time.perf_counter()
    base_mem = _reset_peak(dev)
    upd_rows = FLEET_UPDATES * rows
    req_per = requests // tenants
    per_tenant = upd_rows + req_per * request_rows
    t0 = time.perf_counter()
    data = torch.stack([
        synthetic.gaussian_mixture(device_mod.derive_seed(FLEET_SEED, t), per_tenant, k, dim,
                                   device=dev)
        for t in range(tenants)
    ])  # (T, rows a tenant, n)
    blocks = [data[:, i * rows:(i + 1) * rows].contiguous() for i in range(FLEET_UPDATES)]
    sync(dev)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    specs = fleet_specs(FLEET_SEED, tenants, "dense", m, dim, sigma2)
    engines = {
        "float": FleetEngine(specs, device=dev),
        "1bit": FleetEngine(specs, quantizers=fleet_quantizers(FLEET_SEED, tenants, m, "1bit",
                                                               device=dev), device=dev),
    }
    sync(dev)
    build_s = time.perf_counter() - t0
    print(f"[fleet data] T={tenants} tenants, each its own {k}-cluster mixture in R^{dim} "
          f"({per_tenant} rows a tenant, {data.numel() * 4 / 1e6:.0f} MB) made on the card in "
          f"{make_s:.2f}s; specs and two fleets (float, 1-bit) built in {build_s:.2f}s; "
          f"m={m}, sigma2={float(sigma2):.4f}", flush=True)

    def timed(fn, reps=5):
        """Median host seconds of ``fn`` over ``reps`` synchronised calls, and
        its last result."""
        times = []
        for _ in range(reps):
            sync(dev)
            t1 = time.perf_counter()
            out = fn()
            sync(dev)
            times.append(time.perf_counter() - t1)
        return statistics.median(times), out

    # 1. The tenant-axis entries against T single launches and their plain
    # versions, at an update block's shapes.
    eng = engines["float"]
    w_all = eng._stacked_op.leaves[0]
    ones = torch.ones((tenants, rows), dtype=torch.float32, device=dev)
    blk = blocks[0]
    c, s_ = fs.fourier_sketch_sums_fleet(blk, w_all, ones)
    singles = [fs.fourier_sketch_sums(blk[t], w_all[t], ones[t]) for t in range(tenants)]
    bitwise = (torch.equal(c, torch.stack([a for a, _ in singles]))
               and torch.equal(s_, torch.stack([b for _, b in singles])))
    pc, ps = fs.fourier_sketch_sums_fleet_plain(blk, w_all, ones)
    # Each (t, j) entry sums the B rows of one tenant: the error is per B.
    err = max(float(torch.amax(torch.abs(c - pc))), float(torch.amax(torch.abs(s_ - ps))))
    err /= rows
    check(bitwise, "fourier_sketch_fleet: differs from T single launches")
    check(err <= SKETCH_TOL, f"fourier_sketch_fleet: max|d(sums/B)| {err:.3e}")
    loop_ms = median_ms(lambda: [fs.fourier_sketch_sums(blk[t], w_all[t], ones[t])
                                 for t in range(tenants)])
    results["fourier_sketch_fleet"] = _timed(
        {"max_abs_err": err, "loop_ms": loop_ms, "library_ms": None},
        lambda: fs.fourier_sketch_sums_fleet(blk, w_all, ones),
        lambda: fs.fourier_sketch_sums_fleet_plain(blk, w_all, ones),
        lambda: sketch_bound(tenants * rows, dim, m),
        f"[fourier_sketch_fleet] T={tenants} B={rows} n={dim} m={m}: bitwise T single "
        f"launches {bitwise}; max|d(sums/B)|={err:.3e} (tol {SKETCH_TOL}); T single "
        f"launches {loop_ms:.3f} ms",
    )
    qeng = engines["1bit"]
    dith = qeng.dither
    q = fs.quantized_fourier_sketch_sums_fleet(blk, w_all, dith, 1)
    qs = [fs.quantized_fourier_sketch_sums(blk[t], w_all[t], dith[t], 1) for t in range(tenants)]
    qbit = all(torch.equal(q[i], torch.stack([p[i] for p in qs])) for i in (0, 1))
    qp = fs.quantized_fourier_sketch_sums_fleet_plain(blk, w_all, dith, 1)
    # One boundary flip moves an entry's sum by 2 of B = 1000 rows, so the
    # bar is the boundary rule itself, per entry (boundary_flips).
    n_diff, n_near, qerr = boundary_flips("quantized_fourier_sketch_fleet", blk, w_all, dith,
                                          q, qp)
    qerr /= rows
    check(qbit, "quantized_fourier_sketch_fleet: differs from T single launches")
    qloop_ms = median_ms(lambda: [fs.quantized_fourier_sketch_sums(blk[t], w_all[t], dith[t], 1)
                                  for t in range(tenants)])
    results["quantized_fourier_sketch_fleet"] = _timed(
        {"max_abs_err": qerr, "loop_ms": qloop_ms, "library_ms": None},
        lambda: fs.quantized_fourier_sketch_sums_fleet(blk, w_all, dith, 1),
        lambda: fs.quantized_fourier_sketch_sums_fleet_plain(blk, w_all, dith, 1),
        lambda: qsketch_bound(tenants * rows, dim, m),
        f"[quantized_fourier_sketch_fleet] T={tenants} B={rows} 1bit: bitwise T single "
        f"launches {qbit}; differing entries against the plain version {n_diff} of "
        f"{2 * q[0].numel()}, each within twice its boundary points ({n_near} in all), "
        f"max|dq|/B={qerr:.3e}; T single launches "
        f"{qloop_ms:.3f} ms",
    )
    del c, s_, singles, pc, ps, q, qs, qp

    # 2. Updates, merge, finalize, finalize_tenant: float and 1-bit, each
    # tenant's rows bitwise its isolated engine's (the reference's run_fleet
    # comparison: the Python loop of tenant_engine(t).update).
    for label, fe in engines.items():
        kernel = "fourier_sketch_fleet" if label == "float" else "quantized_fourier_sketch_fleet"

        def fold(fe=fe, which=range(FLEET_UPDATES)):
            st = fe.init_state()
            for i in which:
                st = fe.update(st, blocks[i])
            return st

        half = FLEET_UPDATES // 2
        sa = run(f"fleet {label} update", lambda: fold(which=range(half)), kernel)
        sb = fold(which=range(half, FLEET_UPDATES))
        merged = fe.merge(sa, sb)
        z, lo, hi = fe.finalize(merged)
        upd_s, _ = timed(lambda: fe.update(sa, blocks[0]))
        refs = [fe.tenant_engine(t) for t in range(tenants)]
        ref_a = [r.init_state() for r in refs]
        ref_b = [r.init_state() for r in refs]
        for i in range(FLEET_UPDATES):
            tgt = ref_a if i < half else ref_b
            for t, r in enumerate(refs):
                tgt[t] = r.update(tgt[t], blocks[i][t])
        loop_s, _ = timed(lambda: [r.update(st, blocks[0][t])
                                   for t, (r, st) in enumerate(zip(refs, ref_a))], reps=3)
        ref_m = [r.merge(a, b) for r, a, b in zip(refs, ref_a, ref_b)]
        fins = [r.finalize(st) for r, st in zip(refs, ref_m)]
        tenant_fins = [fe.finalize_tenant(merged, t) for t in range(tenants)]
        ok = {
            "update": _same_state(sa, _stack_states(ref_a)),
            "merge": _same_state(merged, _stack_states(ref_m)),
            "finalize": all(torch.equal(u, torch.stack(v)) for u, v in zip((z, lo, hi),
                                                                           zip(*fins))),
            "finalize_tenant": all(torch.equal(u, v) for tf, f in zip(tenant_fins, fins)
                                   for u, v in zip(tf, f)),
        }
        print(f"[fleet {label}] {FLEET_UPDATES} updates of ({tenants}, {rows}, {dim}) "
              f"({tenants * rows} points each): stacked update {upd_s * 1e3:.3f} ms against the "
              f"Python loop of tenant_engine(t).update {loop_s * 1e3:.3f} ms "
              f"({loop_s / upd_s:.1f}x); each tenant's rows bitwise its isolated engine's: {ok}; "
              f"state_bytes {fe.state_bytes()} B", flush=True)
        check(all(ok.values()), f"fleet {label}: differs from the isolated engines: {ok}")
        del refs, ref_a, ref_b, ref_m, fins, tenant_fins
    del sb

    # 3. Routed requests: unique ids in chunks of T, then all of them at
    # once in a shuffled order (each tenant appears requests / T times).
    gen = torch.Generator(device="cpu").manual_seed(FLEET_SEED)
    perms = [torch.randperm(tenants, generator=gen) for _ in range(req_per)]
    req = torch.cat([data[p.to(dev), upd_rows + c * request_rows:upd_rows + (c + 1) * request_rows]
                     for c, p in enumerate(perms)])  # (R, rows, n)
    ids = torch.cat(perms).numpy()
    state0 = run("fleet float update before ingest",
                 lambda: eng.update(eng.init_state(), blocks[0]), "fourier_sketch_fleet")
    refs = [eng.tenant_engine(t) for t in range(tenants)]
    ref0 = [r.update(r.init_state(), blocks[0][t]) for t, r in enumerate(refs)]

    def by_chunks():
        st = state0
        for c in range(req_per):
            st = eng.ingest(st, ids[c * tenants:(c + 1) * tenants],
                            req[c * tenants:(c + 1) * tenants])
        return st

    order = torch.randperm(requests, generator=gen).numpy()
    shuffled_ids, shuffled = ids[order], req[torch.from_numpy(order).to(dev)]
    st_u = run("fleet ingest unique", by_chunks, "fourier_sketch_fleet")
    st_d = run("fleet ingest duplicates", lambda: eng.ingest(state0, shuffled_ids, shuffled),
               "fourier_sketch_fleet")
    uniq_s, _ = timed(by_chunks, reps=3)
    dup_s, _ = timed(lambda: eng.ingest(state0, shuffled_ids, shuffled), reps=3)
    want_u, want_d = list(ref0), list(ref0)
    for r_i, t in enumerate(ids.tolist()):
        want_u[t] = refs[t].update(want_u[t], req[r_i])
    for r_i, t in enumerate(shuffled_ids.tolist()):
        want_d[t] = refs[t].update(want_d[t], shuffled[r_i])
    ok_u, ok_d = _same_state(st_u, _stack_states(want_u)), _same_state(st_d, _stack_states(want_d))
    print(f"[fleet ingest] {requests} requests of {request_rows} rows: unique ids in "
          f"{req_per} calls of {tenants} {uniq_s * 1e3:.2f} ms, duplicates ({req_per} a tenant) "
          f"in one shuffled call {dup_s * 1e3:.2f} ms; each tenant bitwise its isolated engine "
          f"folding its requests in arrival order: unique {ok_u}, duplicates {ok_d}", flush=True)
    check(ok_u and ok_d, f"fleet ingest: unique {ok_u}, duplicates {ok_d}")
    lifetime = st_u
    del req, shuffled, want_u, want_d, st_d

    # 4. A decayed float fleet over FLEET_DECAY_TICKS ticks, then decay_to.
    deng = FleetEngine(specs, decay=DECAY, device=dev)

    def decayed():
        st = deng.init_state()
        for tick in range(FLEET_DECAY_TICKS):
            st = deng.update(st, blocks[tick % FLEET_UPDATES], t=float(tick))
        return deng.decay_to(st, float(FLEET_DECAY_TICKS + 2))

    dstate = run("fleet decay", decayed, "fourier_sketch_fleet")
    drefs = [deng.tenant_engine(t) for t in range(tenants)]
    dwant = [r.init_state() for r in drefs]
    for tick in range(FLEET_DECAY_TICKS):
        dwant = [r.update(st, blocks[tick % FLEET_UPDATES][t], t=float(tick))
                 for t, (r, st) in enumerate(zip(drefs, dwant))]
    dwant = [r.decay_to(st, float(FLEET_DECAY_TICKS + 2)) for r, st in zip(drefs, dwant)]
    dz = deng.finalize(dstate)[0]
    ok_dec = (_same_state(dstate, _stack_states(dwant))
              and torch.equal(dz, torch.stack([r.finalize(st)[0] for r, st in zip(drefs, dwant)])))
    print(f"[fleet decay] gamma={DECAY}, {FLEET_DECAY_TICKS} ticks then decay_to: each tenant "
          f"bitwise its isolated decayed engine (state and z): {ok_dec}", flush=True)
    check(ok_dec, "fleet decay: differs from the isolated decayed engines")
    del drefs, dwant, dstate

    # 5. A fleet window: W buckets over the ticks; read at the newest tick
    # is bitwise the merge of the live buckets' states.
    fw = SketchWindow(eng, FLEET_WINDOW)

    def windowed():
        ws = fw.init_state()
        for tick in range(FLEET_WINDOW_TICKS):
            ws = fw.update(ws, blocks[tick % FLEET_UPDATES], t=float(tick))
        return ws

    ws = run("fleet window", windowed, "fourier_sketch_fleet")
    read = fw.read(ws)
    want = eng.init_state()
    for tick in range(FLEET_WINDOW_TICKS - FLEET_WINDOW, FLEET_WINDOW_TICKS):
        want = eng.merge(want, eng.update(eng.init_state(), blocks[tick % FLEET_UPDATES]))
    ok_w = _same_state(read, want)
    print(f"[fleet window] W={FLEET_WINDOW} over {FLEET_WINDOW_TICKS} ticks: the read bitwise "
          f"the merge of the live buckets' states: {ok_w}; ring {fw.state_bytes(ws)} B",
          flush=True)
    check(ok_w, "fleet window: the read differs from the merge of the live buckets")
    del ws, read, want

    # 6. Decode a few tenants' lifetime sketches (updates and requests).
    seed1 = device_mod.derive_seed(FIT_SEED, 1)
    km_cfg = lloyd.LloydConfig(k=k, replicates=KMEANS_REPLICATES)
    rels = []
    for t in range(FLEET_DECODES):
        z_t, lo_t, hi_t = eng.finalize_tenant(lifetime, t)
        pts = data[t]
        cents = ckm.decode_sketch(seed1, z_t, eng.operator(t), lo_t, hi_t, cfg, device=dev)[0]
        km = lloyd.kmeans(KMEANS_SEED, pts, km_cfg, device=dev)
        rels.append(float(ckm.sse(pts, cents, device=dev)) / float(km.sse))
    print(f"[fleet decode] {FLEET_DECODES} tenants' sketches ({per_tenant} points each) decoded "
          f"with {cfg.decoder}: relative SSE against kmeans x{KMEANS_REPLICATES} on each "
          f"tenant's points {[round(r, 4) for r in rels]} (limit {MAX_RELATIVE_SSE})", flush=True)
    check(all(r <= MAX_RELATIVE_SSE for r in rels), f"fleet decode: relative SSE {rels}")
    del lifetime

    # 7. A structured fleet: kernels 4-5 once per tenant.
    s_t = structured_tenants
    sspecs = fleet_specs(FLEET_SEED, s_t, "structured", m, dim, sigma2)
    sblocks = [b[:s_t].contiguous() for b in blocks[:2]]
    for label, quant, kernel in (("float", None, "structured_sketch"),
                                 ("1bit", "1bit", "quantized_structured_sketch")):
        se = FleetEngine(sspecs, quantizers=None if quant is None else fleet_quantizers(
            FLEET_SEED, s_t, m, quant, device=dev), device=dev)
        sst = run(f"fleet structured {label}", lambda se=se: se.update(
            se.update(se.init_state(), sblocks[0]), sblocks[1]), kernel)
        srefs = [se.tenant_engine(t) for t in range(s_t)]
        swant = [r.update(r.update(r.init_state(), sblocks[0][t]), sblocks[1][t])
                 for t, r in enumerate(srefs)]
        ok_s = (_same_state(sst, _stack_states(swant))
                and torch.equal(se.finalize(sst)[0],
                                torch.stack([r.finalize(st)[0] for r, st in zip(srefs, swant)])))
        upd_s, _ = timed(lambda se=se, sst=sst: se.update(sst, sblocks[0]))
        print(f"[fleet structured {label}] T={s_t}, d={se.operator(0).d}: one update "
              f"({s_t} launches of {kernel}) {upd_s * 1e3:.3f} ms; each tenant bitwise its "
              f"isolated engine: {ok_s}", flush=True)
        check(ok_s, f"fleet structured {label}: differs from the isolated engines")
    peak = _peak_since(dev, base_mem)
    base = _reset_peak(dev)
    fs.fourier_sketch_sums_fleet(blocks[0], w_all, ones)
    scratch = _peak_since(dev, base)
    print(f"[fleet] {time.perf_counter() - t_phase:.1f}s; peak device memory {peak / 1e6:.1f} MB "
          f"over the phase's start (data {data.numel() * 4 / 1e6:.1f} MB, {FLEET_UPDATES} "
          f"update blocks {FLEET_UPDATES * blocks[0].numel() * 4 / 1e6:.1f} MB, one stacked "
          f"float state {eng.state_bytes() / 1e6:.1f} MB, each fleet's stacked operators "
          f"{w_all.numel() * 4 / 1e6:.1f} MB; one fleet launch of kernel 1 at an update "
          f"block's shape takes {scratch / 1e6:.1f} MB of scratch and outputs, its double "
          f"partials 2 x T x groups x m x 8 B)", flush=True)


def _lru_expect(script, versions, capacity):
    """Hand-simulated decode LRU over ``script`` (tenant ids, versions
    fixed): per-decode hit flags, and (hits, misses, evictions)."""
    from collections import OrderedDict

    sim, flags, evictions = OrderedDict(), [], 0
    for t in script:
        key = (t, versions[t])
        flags.append(key in sim)
        sim[key] = True
        sim.move_to_end(key)
        while len(sim) > capacity:
            sim.popitem(last=False)
            evictions += 1
    return flags, (sum(flags), len(flags) - sum(flags), evictions)


def serve_phases(dev, run, cfg, sigma2, sync=None, tenants=FLEET_T, requests=FLEET_REQUESTS,
                 request_rows=FLEET_REQUEST_ROWS, hot=SERVE_HOT, hot_requests=SERVE_HOT_REQUESTS,
                 evict=SERVE_EVICT, structured_tenants=FLEET_STRUCTURED_T, m=M, k=K, dim=DIM,
                 root=None):
    """[serve]: FleetService over the fleet, through the calls a user makes
    (submit, flush sync and async, decode, evict, restore, drift and its
    maintenance), float, 1-bit, windowed and structured.  Requests arrive as
    host numpy batches.  Sync and async flushes give the same bits and every
    row is its isolated engine's; the decode LRU matches a hand simulation;
    evict/restore is bitwise; a drifting tenant is re-decoded and no
    stationary one is."""
    import shutil

    from repro_torch import device as device_mod
    from repro_torch import obs
    from repro_torch.core import FleetEngine, SketchWindow, fleet_quantizers, fleet_specs
    from repro_torch.core import ckm, graphs, lloyd
    from repro_torch.data import synthetic
    from repro_torch.obs.diagnose import sketch_drift
    from repro_torch.serve import FleetService

    sync = sync or torch.cuda.synchronize
    t_phase = time.perf_counter()
    base_mem = _reset_peak(dev)
    root = Path(root or Path(__file__).resolve().parent / "build" / "serve_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    req_per = requests // tenants
    shift_cfg = dataclasses.replace(cfg, decoder="sketch_shift")

    # Each tenant's points on the host (a hot tenant also has hot_requests
    # more requests' worth), drawn from its own mixture on the card.
    t0 = time.perf_counter()
    pts = [synthetic.gaussian_mixture(
        device_mod.derive_seed(FLEET_SEED, t),
        (req_per + (hot_requests if t < hot else 0)) * request_rows, k, dim, device=dev)
        for t in range(tenants)]
    host = [p.cpu().numpy() for p in pts]
    make_s = time.perf_counter() - t0

    def chunk(t, c):
        return host[t][c * request_rows:(c + 1) * request_rows]

    gen = torch.Generator(device="cpu").manual_seed(FLEET_SEED + 1)
    reqs = [(int(t), c) for c in range(req_per) for t in torch.randperm(tenants, generator=gen)]
    reqs = [reqs[i] for i in torch.randperm(len(reqs), generator=gen).tolist()]
    hot_reqs = [(t, req_per + c) for c in range(hot_requests) for t in range(hot)]
    hot_reqs = [hot_reqs[i] for i in torch.randperm(len(hot_reqs), generator=gen).tolist()]
    specs = fleet_specs(FLEET_SEED, tenants, "dense", m, dim, sigma2)
    eng = FleetEngine(specs, device=dev)
    print(f"[serve data] T={tenants} tenants, each its own {k}-cluster mixture in R^{dim}; "
          f"{len(reqs)} host requests of {request_rows} rows ({req_per} a tenant, shuffled), "
          f"then {len(hot_reqs)} more for {hot} hot tenants; made in {make_s:.2f}s", flush=True)

    def service(engine=eng, **kw):
        return FleetService(engine, shift_cfg, checkpoint_dir=root / f"svc{len(made)}", **kw)

    made = []

    def flushed(svc, script, async_ingest):
        for t, c in script:
            svc.submit(t, chunk(t, c))
        sync(dev)
        t1 = time.perf_counter()
        svc.flush(async_ingest=async_ingest)
        sync(dev)
        made.append(svc)
        return svc, time.perf_counter() - t1

    # 1. Flushes: sync then async into fresh services, then once more each.
    walls = {"sync": [], "async": []}
    states = {}
    for mode in ("sync", "async", "async", "sync"):
        a = mode == "async"
        if not states.get(mode):
            svc, wall = run(f"serve flush {mode}",
                            lambda a=a: flushed(service(decode_cache_entries=SERVE_CACHE), reqs, a),
                            "fourier_sketch_fleet")
            states[mode] = svc
        else:
            svc, wall = flushed(service(), reqs, a)
        walls[mode].append(wall)
        check(svc.stats.flushes == 1 and svc.stats.requests == len(reqs),
              f"serve flush {mode}: {svc.stats}")
    svc = states["sync"]
    same = all(_same_state(s.state, svc.state) for s in made[1:4])
    refs = [eng.tenant_engine(t) for t in range(tenants)]
    want = [r.init_state() for r in refs]
    for t, c in reqs:
        want[t] = refs[t].update(want[t], torch.as_tensor(chunk(t, c)).to(dev))
    isolated = _same_state(svc.state, _stack_states(want))
    n_pts = len(reqs) * request_rows
    best = {mode: min(w) for mode, w in walls.items()}
    print(f"[serve flush] {len(reqs)} requests of {request_rows} rows, one dispatch: sync "
          f"{walls['sync'][0] * 1e3:.2f} / {walls['sync'][1] * 1e3:.2f} ms, async "
          f"{walls['async'][0] * 1e3:.2f} / {walls['async'][1] * 1e3:.2f} ms; best "
          f"{best['sync'] * 1e6 / len(reqs):.2f} / {best['async'] * 1e6 / len(reqs):.2f} us a "
          f"request, {n_pts / best['sync']:.3e} / {n_pts / best['async']:.3e} points/s "
          f"(sync / async); async the sync bits: {same}; each tenant bitwise its isolated "
          f"engine over its requests in arrival order: {isolated}", flush=True)
    check(same, "serve flush: async differs from sync")
    check(isolated, "serve flush: a tenant differs from its isolated engine")
    del made[1:], want

    # 2. Hot traffic, then decodes on demand against a hand-simulated LRU.
    flushed(svc, hot_reqs, False)
    hot_ids = list(range(hot))
    script = hot_ids + hot_ids[hot // 2:] + hot_ids[:hot // 4]
    flags, (e_hits, e_misses, e_evict) = _lru_expect(
        script, {t: svc.version(t) for t in hot_ids}, SERVE_CACHE)
    before = dataclasses.replace(svc.stats)
    hit_s, miss_s = [], []

    def decodes():
        out = []
        for t in script:
            sync(dev)
            t1 = time.perf_counter()
            out.append(svc.decode(t))
            sync(dev)
            (hit_s if out[-1].cached else miss_s).append(time.perf_counter() - t1)
        return out

    got = run("serve decode", decodes, "sketch_shift")
    counts = (svc.stats.decode_hits - before.decode_hits,
              svc.stats.decode_misses - before.decode_misses,
              svc.stats.decode_cache_evictions - before.decode_cache_evictions)
    lru_ok = [r.cached for r in got] == flags and counts == (e_hits, e_misses, e_evict)
    # The same tenant twice without the cache: graph captures and wall each,
    # and the bits of an eager decode.
    fresh = []
    for _ in range(2):
        graphs.CAPTURES = graphs.REPLAYS = 0
        sync(dev)
        t1 = time.perf_counter()
        r = svc.decode(0, use_cache=False)
        sync(dev)
        fresh.append((time.perf_counter() - t1, graphs.CAPTURES, graphs.REPLAYS, r))
    # The same decode twice on one held operator object: the second call
    # captures nothing, so the difference is what a fresh operator's
    # captures cost a decode on demand.
    z0, lo0, hi0 = eng.finalize_tenant(svc.state, 0)
    op0, held = eng.operator(0), []
    for _ in range(2):
        graphs.CAPTURES = 0
        sync(dev)
        t1 = time.perf_counter()
        ckm.decode_sketch(device_mod.derive_seed(0, 0), z0, op0, lo0, hi0, shift_cfg, device=dev)
        sync(dev)
        held.append((time.perf_counter() - t1, graphs.CAPTURES))
    eager = ckm.decode_sketch(device_mod.derive_seed(0, 0), z0, op0, lo0, hi0,
                              shift_cfg, device=dev, eager=True)
    eager_same = all(torch.equal(a, b) for r in fresh for a, b in zip(eager, r[3][:3]))
    km_cfg = lloyd.LloydConfig(k=k, replicates=KMEANS_REPLICATES)
    rels = []
    for t, r in zip(hot_ids, got):  # each hot tenant's first decode
        c = r.centroids
        rels.append(float(ckm.sse(pts[t], c, device=dev))
                    / float(lloyd.kmeans(KMEANS_SEED, pts[t], km_cfg, device=dev).sse))
    print(f"[serve decode] {len(script)} decodes of {hot} hot tenants ({pts[0].shape[0]} points "
          f"each) with cache {SERVE_CACHE}: hits/misses/evictions {counts}, hand-simulated "
          f"LRU {(e_hits, e_misses, e_evict)}, flags match: {lru_ok}; a miss "
          f"{statistics.median(miss_s) * 1e3:.2f} ms (median of {len(miss_s)}, first "
          f"{miss_s[0] * 1e3:.2f}), a hit {statistics.median(hit_s) * 1e6:.1f} us; use_cache="
          f"False twice: {fresh[0][0] * 1e3:.2f} ms ({fresh[0][1]} captures, {fresh[0][2]} "
          f"replays) then {fresh[1][0] * 1e3:.2f} ms ({fresh[1][1]} captures, {fresh[1][2]} "
          f"replays); one held operator twice: {held[0][0] * 1e3:.2f} ms ({held[0][1]} "
          f"captures) then {held[1][0] * 1e3:.2f} ms ({held[1][1]} captures); the eager "
          f"decode's bits: {eager_same}; relative SSE against kmeans "
          f"x{KMEANS_REPLICATES} {[round(r, 4) for r in rels]} (limit {MAX_RELATIVE_SSE})",
          flush=True)
    check(lru_ok, f"serve decode: LRU {counts} against the simulation "
                  f"{(e_hits, e_misses, e_evict)}")
    check(eager_same, "serve decode: graphed decodes differ from the eager decode")
    check(all(r <= MAX_RELATIVE_SSE for r in rels), f"serve decode: relative SSE {rels}")

    # 3. Evict and restore: rows bitwise, versions rewound, cached decodes
    # valid again.
    evicted = list(range(hot // 2, hot // 2 + evict))
    rows = {t: svc.engine.tenant_state(svc.state, t) for t in evicted}
    versions = {t: svc.version(t) for t in evicted}
    served = {t: svc.served_model(t) for t in evicted}
    ev_s, rs_s = [], []
    for t in evicted:
        t1 = time.perf_counter()
        svc.evict(t)
        sync(dev)
        ev_s.append(time.perf_counter() - t1)
    holes = all(float(svc.engine.tenant_state(svc.state, t).weight_sum) == 0.0 for t in evicted)
    for t in evicted:
        t1 = time.perf_counter()
        svc.restore(t)
        sync(dev)
        rs_s.append(time.perf_counter() - t1)
    bitwise = all(_same_state(svc.engine.tenant_state(svc.state, t), rows[t]) for t in evicted)
    rewound = all(svc.version(t) == versions[t] for t in evicted)
    hits = [svc.decode(t).cached for t in evicted if served[t] is not None
            and served[t].version == versions[t]]
    print(f"[serve evict] {evict} tenants: evict {statistics.median(ev_s) * 1e3:.3f} ms a tenant "
          f"(max {max(ev_s) * 1e3:.3f}), restore {statistics.median(rs_s) * 1e3:.3f} ms (max "
          f"{max(rs_s) * 1e3:.3f}); rows reset: {holes}; restored bitwise: {bitwise}; versions "
          f"rewound: {rewound}; {len(hits)} cached decodes served again as hits: {all(hits)}",
          flush=True)
    check(holes and bitwise and rewound and all(hits), "serve evict/restore")

    # 4. Drift maintenance on a decayed service: calibrate the bound between
    # the stationary drift and a shifted tenant's, then shift tenant 0.
    deng = FleetEngine(specs, decay=0.5, device=dev)
    dsvc = FleetService(deng, shift_cfg)
    drifting = list(range(min(4, hot)))
    per_tick = req_per

    def tick_reqs(tick, shift=0.0):
        out = []
        for t in drifting:
            for c in range(tick * per_tick, (tick + 1) * per_tick):
                out.append((t, chunk(t, c) + (shift if t == 0 else 0.0)))
        return out

    for t, b in tick_reqs(0):
        dsvc.submit(t, b, t=0.0)
    dsvc.flush()
    for t in drifting:
        dsvc.decode(t)
    for t, b in tick_reqs(1):
        dsvc.submit(t, b, t=1.0)
    dsvc.flush()
    stationary = [dsvc.drift(t) for t in drifting]
    shifted_reqs = tick_reqs(2, SERVE_SHIFT)
    probe = deng.ingest(dsvc.state, [0] * per_tick,
                        torch.stack([torch.as_tensor(b).to(dev) for t, b in shifted_reqs
                                     if t == 0]), t=2.0)
    shifted = sketch_drift(deng.finalize_tenant(probe, 0)[0], dsvc.served_model(0).centroids,
                           dsvc.served_model(0).weights, deng.operator(0))
    check(2.0 * max(stationary) < shifted,
          f"serve drift: stationary {stationary} not clear of shifted {shifted}")
    dsvc.drift_threshold = math.sqrt(max(stationary) * shifted)
    served_before = {t: dsvc.served_model(t).version for t in drifting}
    for t, b in shifted_reqs:
        dsvc.submit(t, b, t=2.0)
    obs.reset()
    obs.enable()
    try:
        run("serve drift", dsvc.flush, "sketch_shift")
    finally:
        obs.disable()
    snap = obs.snapshot()
    obs.reset()
    served_after = {t: dsvc.served_model(t).version for t in drifting}
    redecoded = [t for t in drifting if served_after[t] != served_before[t]]
    decodes = dsvc.stats.decodes
    fresh_drift = dsvc.drift(tenants - 1)
    print(f"[serve drift] decayed service (gamma 0.5), {len(drifting)} tenants decoded at tick 0: "
          f"stationary drift at tick 1 {[round(s, 4) for s in stationary]}, tenant 0 shifted by "
          f"{SERVE_SHIFT} {shifted:.4f}; bound {dsvc.drift_threshold:.4f}; the shifted flush "
          f"re-decoded {redecoded} (stats {dsvc.stats.drift_redecodes}, counter "
          f"{snap.get('fleet.redecode.drift', 0)}); a fresh tenant's drift {fresh_drift} "
          f"({dsvc.stats.decodes - decodes} decodes)", flush=True)
    check(redecoded == [0] and dsvc.stats.drift_redecodes == 1
          and snap.get("fleet.redecode.drift") == 1,
          f"serve drift: re-decoded {redecoded}, stats {dsvc.stats.drift_redecodes}, counter "
          f"{snap.get('fleet.redecode.drift')}")
    check(fresh_drift == 0.0 and dsvc.stats.decodes == decodes, "serve drift: a fresh tenant")
    del dsvc, probe

    # 5. A 1-bit service (kernel 3f): sync and async, the engine's bits,
    # evict/restore, a decode.
    qeng = FleetEngine(specs, quantizers=fleet_quantizers(FLEET_SEED, tenants, m, "1bit",
                                                          device=dev), device=dev)
    qsvc, q_wall = run("serve 1bit flush", lambda: flushed(service(qeng), reqs, False),
                       "quantized_fourier_sketch_fleet")
    qsvc_a, qa_wall = flushed(service(qeng), reqs, True)
    q_want = qeng.ingest(qeng.init_state(), [t for t, _ in reqs],
                         torch.stack([torch.as_tensor(chunk(t, c)).to(dev) for t, c in reqs]))
    q_row = qeng.tenant_state(qsvc.state, 3)
    qsvc.evict(3)
    qsvc.restore(3)
    q_ok = {"engine": _same_state(qsvc.state, q_want), "async": _same_state(qsvc_a.state, q_want),
            "evict/restore": _same_state(qeng.tenant_state(qsvc.state, 3), q_row)}
    q_dec = run("serve 1bit decode", lambda: qsvc.decode(3), "sketch_shift")
    print(f"[serve 1bit] flush sync {q_wall * 1e3:.2f} ms, async {qa_wall * 1e3:.2f} ms; the "
          f"engine's bits {q_ok}; a decode finite: {bool(torch.isfinite(q_dec.centroids).all())}",
          flush=True)
    check(all(q_ok.values()), f"serve 1bit: {q_ok}")
    check(bool(torch.isfinite(q_dec.centroids).all()), "serve 1bit: decode not finite")
    del qsvc, qsvc_a, q_want

    # 6. A windowed service: W buckets over the ticks, tenant e_t evicted
    # across them; its lifetime row and window read (and a neighbour's) are
    # their isolated engine's and window's.
    e_t, o_t = hot // 2 - 3, hot // 2 - 2
    wsvc = service(window_buckets=FLEET_WINDOW)
    out_from, back_at = FLEET_WINDOW_TICKS // 2 - 1, FLEET_WINDOW_TICKS // 2 + 1
    schedule = [[t for t in range(tenants) if not (t == e_t and out_from < tick < back_at)]
                for tick in range(FLEET_WINDOW_TICKS)]

    def windowed():
        w_s = []
        for tick, ids in enumerate(schedule):
            if tick == back_at:
                wsvc.restore(e_t)
            for t in ids:
                wsvc.submit(t, chunk(t, tick % req_per), t=float(tick))
            sync(dev)
            t1 = time.perf_counter()
            wsvc.flush()
            sync(dev)
            w_s.append(time.perf_counter() - t1)
            if tick == out_from:
                wsvc.evict(e_t)
        return w_s

    w_s = run("serve window", windowed, "fourier_sketch_fleet")
    last = float(FLEET_WINDOW_TICKS - 1)
    read = wsvc.window.read(wsvc.window_state, last)
    w_ok = {}
    for t in (e_t, o_t):
        ref = eng.tenant_engine(t)
        win = SketchWindow(ref, FLEET_WINDOW)
        st, ws = ref.init_state(), win.init_state()
        for tick, ids in enumerate(schedule):
            if t in ids:
                xb = torch.as_tensor(chunk(t, tick % req_per)).to(dev)
                st, ws = ref.update(st, xb), win.update(ws, xb, t=float(tick))
        w_ok[t] = (_same_state(eng.tenant_state(wsvc.state, t), st),
                   _same_state(eng.tenant_state(read, t), win.read(ws, last)))
    print(f"[serve window] W={FLEET_WINDOW} over {FLEET_WINDOW_TICKS} ticks of {tenants} "
          f"requests, tenant {e_t} evicted after tick {out_from} and restored at tick {back_at}: "
          f"flush {statistics.median(w_s) * 1e3:.2f} ms a tick (median); lifetime row and window "
          f"read bitwise the isolated engine's and window's: {w_ok}", flush=True)
    check(all(a and b for a, b in w_ok.values()), f"serve window: {w_ok}")
    del wsvc, read

    # 7. A structured service (kernel 4 per tenant).
    s_t = structured_tenants
    seng = FleetEngine(fleet_specs(FLEET_SEED, s_t, "structured", m, dim, sigma2), device=dev)
    s_reqs = [(t, c) for t, c in reqs if t < s_t]
    ssvc, s_wall = run("serve structured flush", lambda: flushed(service(seng), s_reqs, False),
                       "structured_sketch")
    s_want = seng.ingest(seng.init_state(), [t for t, _ in s_reqs],
                         torch.stack([torch.as_tensor(chunk(t, c)).to(dev) for t, c in s_reqs]))
    s_row = seng.tenant_state(ssvc.state, 1)
    ssvc.evict(1)
    ssvc.restore(1)
    s_ok = {"engine": _same_state(ssvc.state, s_want),
            "evict/restore": _same_state(seng.tenant_state(ssvc.state, 1), s_row)}
    s_dec = run("serve structured decode", lambda: ssvc.decode(1), "sketch_shift")
    print(f"[serve structured] T={s_t}, {len(s_reqs)} requests: flush {s_wall * 1e3:.2f} ms; the "
          f"engine's bits {s_ok}; a decode finite: {bool(torch.isfinite(s_dec.centroids).all())}",
          flush=True)
    check(all(s_ok.values()) and bool(torch.isfinite(s_dec.centroids).all()),
          f"serve structured: {s_ok}")
    peak = _peak_since(dev, base_mem)
    shutil.rmtree(root, ignore_errors=True)
    print(f"[serve] {time.perf_counter() - t_phase:.1f}s; peak device memory {peak / 1e6:.1f} MB "
          f"over the phase's start (one stacked float state {eng.state_bytes() / 1e6:.1f} MB, "
          f"the stacked requests {len(reqs) * request_rows * dim * 4 / 1e6:.1f} MB)", flush=True)


def diagnose_phases(dev, run, cfg, x, res, sample_rows=DIAG_SAMPLE):
    """[diagnose]: ckm.diagnose on fits at N = 10^7: the default fit (with a
    sample, so sigma_sweep re-sketches through kernel 1), and sketch_shift
    fits at sigma^2 x 10^4 and x 10^-4, whose verdict must be
    frequency_scale (decrease, increase)."""
    from repro_torch.core import ckm

    t_phase = time.perf_counter()
    sample = x[:sample_rows]

    def diag(label, r, **kw):
        t1 = time.perf_counter()
        d = run(f"diagnose {label}", lambda: ckm.diagnose(r, **kw),
                ("sketch_shift", "fourier_sketch") if "sample" in kw else "sketch_shift")
        wall = time.perf_counter() - t1
        scores = {key: round(v, 4) for key, v in d.scores.items()}
        print(f"[diagnose {label}] verdict {d.verdict}: {d.recommendation}; scores {scores}; "
              f"half-sketch residuals {[round(h['rel_residual'], 4) for h in d.details['m_sweep']]}"
              f"; {wall:.2f}s", flush=True)
        return d

    d = diag("fit", res, sample=sample)
    rows = d.details["sigma_sweep"]
    mods = [r["mean_modulus"] for r in rows]
    print(f"[diagnose sigma_sweep] {sample_rows} rows at factors "
          f"{[r['factor'] for r in rows]}: mean moduli {[round(v, 4) for v in mods]}, healthy "
          f"{[r['healthy'] for r in rows]}", flush=True)
    check(rows[1]["factor"] == 1.0 and rows[1]["healthy"], f"diagnose: sweep at 1 {rows[1]}")
    check(mods[0] < mods[1] < mods[2], f"diagnose: moduli {mods} do not rise with the factor")
    for label, scale, direction, word in (("sigma2 x 1e4", 1e4, "sigma2_too_large", "decrease"),
                                          ("sigma2 x 1e-4", 1e-4, "sigma2_too_small", "increase")):
        c = dataclasses.replace(cfg, decoder="sketch_shift", sigma2=float(res.sigma2) * scale)
        r = run(f"fit-sketch_shift {label}", lambda c=c: ckm.fit(FIT_SEED, x, c, device=dev),
                "sketch_shift")
        d = diag(label, r)
        check(d.verdict == "frequency_scale" and d.details["sigma_profile"]["direction"] == direction
              and word in d.recommendation, f"diagnose {label}: {d.verdict}, {d.recommendation}")
    print(f"[diagnose] {time.perf_counter() - t_phase:.1f}s", flush=True)


def _same(a, b) -> bool:
    """Two states (or tuples of tensors) bitwise equal, field by field."""
    return type(a) is type(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def sharded_phases(dev, run, launches, cfg, x, batches, fit_res, sync=None, p1_backend="nccl"):
    """[sharded p=1] and [sharded p=4]: the "sharded" SketchEngine and a
    sharded fit.  p = 1: an NCCL group of one rank on a (1,) "data" mesh;
    float (kernel 1), 1-bit (kernel 3) and decayed engines over the fit's
    device batches under every topology, and a structured one (kernel 4),
    each bitwise the "kernel" backend's (every collective is the identity);
    one update timed against the kernel backend's; ckm.fit through the
    sharded backend, bitwise [fit]'s centroids.  p = 4: SHARDED_RANKS gloo
    processes on the one card (``_sharded_rank``), each sketching its block
    of the N points; the states they save are checked here against the
    single-card kernel backend, and their launch counts join ``launches``.
    ``p1_backend="gloo"`` and ``sync`` let a CPU box rehearse the phases.
    Neither is an interconnect measurement: one card, NCCL at one rank,
    gloo through host memory."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import device as device_mod
    from repro_torch.core import ckm
    from repro_torch.core.engine import SketchEngine

    sync = sync or torch.cuda.synchronize
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "sharded"
    root.mkdir(parents=True, exist_ok=True)
    for f in root.glob("*"):
        f.unlink()
    op, op_s = fit_res["fit"].freq_op, fit_res["fit-structured"].freq_op
    quantizer = ckm.make_quantizer(device_mod.derive_seed(FIT_SEED, 0),
                                   dataclasses.replace(cfg, sketch_quantization="1bit"), op.m, dev)

    def fold(eng, ticks=False):
        state = eng.init_state()
        for t, b in enumerate(batches[:SHARDED_TICKS] if ticks else batches):
            state = eng.update(state, b, **({"t": t} if ticks else {}))
        return state

    dist.init_process_group(p1_backend, init_method=f"file://{root}/init1", rank=0, world_size=1)
    try:
        mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
        variants = {"float": {}, "1bit": {"quantizer": quantizer},
                    "decayed": {"decay": SHARDED_DECAY}}
        for name in SHARDED_TOPOLOGIES:
            pairs = {label: (SketchEngine(op, device=dev, **kw),
                             SketchEngine(op, "sharded", device=dev, mesh=mesh,
                                          reduce_topology=name, **kw))
                     for label, kw in variants.items()}
            want = {label: fold(k, label == "decayed") for label, (k, _) in pairs.items()}
            got = run(f"sharded p=1 {name}",
                      lambda: {label: fold(sh, label == "decayed") for label, (_, sh) in pairs.items()},
                      ("fourier_sketch", "quantized_fourier_sketch"))
            for label in variants:
                check(_same(got[label], want[label]),
                      f"sharded p=1 {name} {label}: not bitwise the kernel backend's state")
            k_eng, sh_eng = pairs["float"]
            s0 = k_eng.init_state()
            k_ms = median_ms(lambda: k_eng.update(s0, batches[0]))
            sh_ms = median_ms(lambda: sh_eng.update(s0, batches[0]))
            print(f"[sharded p=1 {name}] float, 1-bit and decayed ({SHARDED_TICKS} ticks) states "
                  f"over {len(batches)} batches of {batches[0].shape[0]} rows bitwise the kernel "
                  f"backend's; one update {sh_ms:.3f} ms against {k_ms:.3f} ms "
                  f"(collectives at p=1: {sh_ms - k_ms:+.3f} ms; {p1_backend}, one rank)",
                  flush=True)
        k_s = SketchEngine(op_s, device=dev)
        sh_s = SketchEngine(op_s, "sharded", device=dev, mesh=mesh, reduce_topology="tree")
        want = fold(k_s)
        got = run("sharded p=1 structured", lambda: fold(sh_s), "structured_sketch")
        check(_same(got, want), "sharded p=1 structured: not bitwise the kernel backend's state")
        cfg_sh = dataclasses.replace(cfg, sketch_backend="sharded", reduce_topology="ring")
        t0 = time.perf_counter()
        r = run("sharded p=1 fit",
                lambda: ckm.fit(FIT_SEED, x, cfg_sh, device=dev, mesh=mesh), "fourier_sketch")
        wall = time.perf_counter() - t0
        ref = fit_res["fit"]
        for f in ("centroids", "weights", "cost", "sigma2", "sketch"):
            check(torch.equal(getattr(r, f), getattr(ref, f)),
                  f"sharded p=1 fit: {f} not bitwise [fit]'s")
        print(f"[sharded p=1 fit] ckm.fit with sketch_backend='sharded' (ring) at N={x.shape[0]}: "
              f"{wall:.2f}s; centroids, weights, cost, sigma2 and sketch bitwise [fit]'s",
              flush=True)
    finally:
        dist.destroy_process_group()

    # p = 4: the rank processes build their own data from DATA_SEED and
    # load the kernels built above (no nvcc runs in them).
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ranks = SHARDED_RANKS
    args = (str(root), dev.type, x.shape[0], op.w.cpu(), quantizer.dither.cpu())
    ctx = mp.start_processes(_sharded_rank, args=args, nprocs=ranks, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, f"sharded p={ranks}: ranks still running after "
                                               f"{SHARDED_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    spawn_s = time.perf_counter() - t0
    saved = [torch.load(root / f"rank{r}.pt") for r in range(ranks)]
    k_f = SketchEngine(op, device=dev)
    k_q = SketchEngine(op, device=dev, quantizer=quantizer)
    want_f = k_f.update(k_f.init_state(), x)
    want_q = k_q.update(k_q.init_state(), x)
    z_want, lo_want, hi_want = (t.cpu() for t in k_f.finalize(want_f))
    sync(dev)
    local = [s["ms"]["local"] for s in saved]
    print(f"[sharded p={ranks} local] the kernel backend on each rank's block, every rank at once "
          f"(no collective; the {ranks} processes' kernels share the card), host wall median of "
          f"{TIMED_LAUNCHES}: rank 0 {local[0][0]:.3f} / {local[0][1]:.3f} ms, slowest rank "
          f"{max(m[0] for m in local):.3f} / {max(m[1] for m in local):.3f} ms", flush=True)
    for label, states in saved[0]["states"].items():
        for r, other in enumerate(saved[1:], 1):
            check(all(_same(a, b) for a, b in zip(states, other["states"][label])),
                  f"sharded p={ranks} {label}: rank {r}'s states are not rank 0's")
        f_state, q_state = states
        z, lo, hi = k_f.finalize(type(want_f)(*(t.to(dev) for t in f_state)))
        dz = float(torch.amax(torch.abs(z.cpu() - z_want)))
        check(dz <= SKETCH_TOL, f"sharded p={ranks} {label}: |z - z_single| {dz:.2e} > {SKETCH_TOL}")
        check(torch.equal(lo.cpu(), lo_want) and torch.equal(hi.cpu(), hi_want),
              f"sharded p={ranks} {label}: bounds differ from the single card's")
        check(all(torch.equal(a, b.cpu()) for a, b in zip(q_state, want_q)),
              f"sharded p={ranks} {label}: 1-bit state not bitwise the single card's kernel 3 sums")
        ms = [s["ms"][label] for s in saved]
        print(f"[sharded p={ranks} {label}] {saved[0]['rows']} rows a rank: float |z - z_single| "
              f"{dz:.2e} (tol {SKETCH_TOL}), bounds equal, 1-bit sums bitwise the single card's, "
              f"every rank bitwise rank 0; one update (float / 1-bit), gloo through the host on "
              f"one card, host wall median of {TIMED_LAUNCHES}: rank 0 {ms[0][0]:.3f} / "
              f"{ms[0][1]:.3f} ms, slowest rank {max(m[0] for m in ms):.3f} / "
              f"{max(m[1] for m in ms):.3f} ms", flush=True)
    counts = {name: sum(s["launches"][name] for s in saved) for name in saved[0]["launches"]}
    for name, n_launch in counts.items():
        check(all(s["launches"][name] >= 1 for s in saved),
              f"sharded p={ranks}: a rank did not launch the {name} kernel")
        launches[name] += n_launch
    print(f"[sharded p={ranks}] {ranks} gloo ranks on one {dev.type} device, spawned and joined in "
          f"{spawn_s:.1f}s; their launches {counts}; gloo stages all_reduce and broadcast "
          f"through the host itself, and the tree's and ring's sends and receives go through "
          f"host copies (core/topology.py _exchange)", flush=True)
    for f in root.glob("*"):
        f.unlink()
    print(f"[sharded] {time.perf_counter() - t_phase:.1f}s", flush=True)


def _sharded_rank(rank, root, dev_type, n_rows, w, dither) -> None:
    """One rank of [sharded p=4]: a gloo process on the card that builds the
    smoke's data from DATA_SEED, takes its block through ``shard_points``,
    folds it through a float and a 1-bit sharded engine under every
    topology over a (4,) "data" mesh and once over a (2, 2) ("pod", "data")
    mesh, and saves the states (on the host), its launch counts of kernels 1
    and 3, and one update's host wall time for each engine and for the
    kernel backend on the same block."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import device as device_mod
    from repro_torch.core import quantize
    from repro_torch.core.engine import SketchEngine
    from repro_torch.data import synthetic
    from repro_torch.kernels import fourier_sketch as fs

    dev = device_mod.resolve(dev_type)
    ranks = SHARDED_RANKS
    dist.init_process_group("gloo", init_method=f"file://{root}/init{ranks}", rank=rank,
                            world_size=ranks,
                            timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    try:
        x = synthetic.gaussian_mixture(DATA_SEED, n_rows, K, DIM, device=dev)
        w, q = w.to(dev), quantize.SketchQuantizer(1, dither.to(dev))
        flat = init_device_mesh(dev.type, (ranks,), mesh_dim_names=("data",))
        pod = init_device_mesh(dev.type, (2, ranks // 2), mesh_dim_names=("pod", "data"))
        runs = [(name, flat, ("data",), name) for name in SHARDED_TOPOLOGIES]
        runs.append(("(2,2) pod,data allreduce", pod, ("pod", "data"), "allreduce"))
        fs.LAUNCHES = fs.QUANTIZED_LAUNCHES = 0
        states, engs = {}, {}
        for label, mesh, axes, name in runs:
            pair = tuple(SketchEngine(w, "sharded", device=dev, mesh=mesh, data_axes=axes,
                                      quantizer=quant, reduce_topology=name)
                         for quant in (None, q))
            xs = pair[0].shard_points(x)
            states[label] = tuple(tuple(t.cpu() for t in e.update(e.init_state(), xs))
                                  for e in pair)
            engs[label] = (pair, xs)
        launches = {"fourier_sketch": fs.LAUNCHES, "quantized_fourier_sketch": fs.QUANTIZED_LAUNCHES}

        def update_ms(e, xs):
            """Host wall median of one update, every rank timing at once."""
            s0 = e.init_state()
            dist.barrier()
            times = []
            for _ in range(TIMED_LAUNCHES + 1):
                t0 = time.perf_counter()
                e.update(s0, xs)
                device_mod.sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times[1:])

        ms = {label: [update_ms(e, xs) for e in pair] for label, (pair, xs) in engs.items()}
        # The kernel backend on the same block: the sketch alone, no
        # collective, with the other ranks' kernels sharing the card.
        xs = engs[SHARDED_TOPOLOGIES[0]][1]
        ms["local"] = [update_ms(SketchEngine(w, device=dev, quantizer=quant), xs)
                       for quant in (None, q)]
        torch.save({"states": states, "launches": launches, "ms": ms, "rows": xs.shape[0]},
                   f"{root}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _refusing_collectives():
    """``torch.distributed``'s collectives and group calls replaced by ones
    that raise; returns a function that puts them back."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise RuntimeError("check failed: the tenant mesh's hot path called torch.distributed")

    saved = {}
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                 "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
                 "all_to_all", "all_to_all_single", "send", "recv", "isend", "irecv", "barrier",
                 "init_process_group", "new_group"):
        if hasattr(dist, name):
            saved[name] = getattr(dist, name)
            setattr(dist, name, refuse)
    return lambda: [setattr(dist, name, fn) for name, fn in saved.items()]


def _copy_events(prof) -> dict:
    """Device copy and collective events of a profile, by name."""
    out = {}
    for e in prof.key_averages():
        if "Memcpy" in e.key or "nccl" in e.key.lower():
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def fleet_mesh_phases(dev, run, cfg, sigma2, sync=None, tenants=FLEET_T, rows=FLEET_B,
                      requests=FLEET_REQUESTS, request_rows=FLEET_REQUEST_ROWS,
                      structured_tenants=FLEET_STRUCTURED_T, shards=MESH_SHARDS, m=M, k=K,
                      dim=DIM, default_mesh=True):
    """[fleet-mesh]: FleetEngine(sharding="mesh") at [fleet]'s width: float,
    1-bit and decayed fleets at p = ``shards`` (blocks on ``[dev] * p``,
    explicitly) and at p = 1 (``tenant_mesh(1)``, the default path); update,
    merge, finalize and the routed ingest of ``requests`` shuffled requests,
    every row bitwise the ``sharding="none"`` fleet's; the fleet entry of
    kernel 1 (3) launched exactly p times an update and once a block an
    ingest, with no peer copy and no ``torch.distributed`` call (its
    collectives raise, and a profiler window counts copies and NCCL kernels);
    a structured mesh fleet; the update timed against the unsharded one's.
    Returns what [serve-mesh] reuses.  ``default_mesh=False`` (a CPU
    rehearsal) gives p = 1 an explicit one-device mesh."""
    import numpy as np

    from repro_torch import device as device_mod
    from repro_torch.core import FleetEngine, fleet_quantizers, fleet_specs
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.data import synthetic
    from repro_torch.kernels import fourier_sketch as fs
    from repro_torch.kernels import freq_transform as ft
    from repro_torch.parallel import tenant_mesh

    sync = sync or torch.cuda.synchronize
    t_phase = time.perf_counter()
    req_per = requests // tenants
    per_tenant = 2 * rows + req_per * request_rows
    data = torch.stack([
        synthetic.gaussian_mixture(device_mod.derive_seed(FLEET_SEED, t), per_tenant, k, dim,
                                   device=dev)
        for t in range(tenants)
    ])
    blocks = [data[:, i * rows:(i + 1) * rows].contiguous() for i in range(2)]
    gen = torch.Generator(device="cpu").manual_seed(FLEET_SEED + 2)
    reqs = [(int(t), c) for c in range(req_per) for t in torch.randperm(tenants, generator=gen)]
    reqs = [reqs[i] for i in torch.randperm(len(reqs), generator=gen).tolist()]
    ids = np.asarray([t for t, _ in reqs])
    req = torch.stack([data[t, 2 * rows + c * request_rows:2 * rows + (c + 1) * request_rows]
                       for t, c in reqs])
    specs = fleet_specs(FLEET_SEED, tenants, "dense", m, dim, sigma2)
    meshes = {shards: tenant_mesh(shards, devices=[dev] * shards),
              1: None if default_mesh else tenant_mesh(1, devices=[dev])}
    quants = fleet_quantizers(FLEET_SEED, tenants, m, "1bit", device=dev)
    variants = {
        "float": ({}, "fourier_sketch_fleet", "FLEET_LAUNCHES", {}),
        "1bit": ({"quantizers": quants}, "quantized_fourier_sketch_fleet",
                 "QUANTIZED_FLEET_LAUNCHES", {}),
        "decay": ({"decay": DECAY}, "fourier_sketch_fleet", "FLEET_LAUNCHES", {"t": 1.0}),
    }
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    times, kept = {}, {}
    for label, (kw, kernel, counter, tick) in variants.items():
        plain = FleetEngine(specs, device=dev, **kw)
        p_a = plain.update(plain.init_state(), blocks[0], **tick)
        p_m = plain.merge(p_a, plain.update(plain.init_state(), blocks[1]))
        p_fin = plain.finalize(p_m)
        p_in = plain.ingest(p_m, ids, req, **tick)
        timed = {"none": lambda: plain.update(p_a, blocks[0], **tick)}
        timed_in = {"none": lambda: plain.ingest(p_m, ids, req, **tick)}
        for p, mesh in meshes.items():
            eng = FleetEngine(specs, sharding="mesh", mesh=mesh, tenant_shards=p, **kw)
            check(eng.devices == tuple(device_mod.resolve(dev) for _ in range(p)),
                  f"fleet-mesh: blocks on {eng.devices}")
            counts = {}

            def counted(what, fn, expect):
                out = run(f"fleet-mesh {label} p={p} {what}", fn, kernel)
                counts[what] = getattr(fs, counter)
                check(counts[what] == expect,
                      f"fleet-mesh {label} p={p} {what}: {counts[what]} launches of {kernel}, "
                      f"not {expect}")
                return out

            restore = _refusing_collectives()
            try:
                with torch.profiler.profile(activities=activities) as prof:
                    s_a = counted("update", lambda: eng.update(eng.init_state(), blocks[0],
                                                               **tick), p)
                    s_b = eng.update(eng.init_state(), blocks[1])
                    s_m = eng.merge(s_a, s_b)
                    fin = eng.finalize(s_m)
                    s_in = counted("ingest", lambda: eng.ingest(s_m, ids, req, **tick), p)
                    sync(dev)
            finally:
                restore()
            copies = _copy_events(prof)
            bad = {key: n for key, n in copies.items() if "PtoP" in key or "nccl" in key.lower()}
            placed = all(v.device == d for st in (s_a, s_m, s_in)
                         for blk, d in zip(st.blocks, eng.devices) for v in blk)
            ok = {
                "update": _same_state(fleet_mod.gather_rows(s_a, dev), p_a),
                "merge": _same_state(fleet_mod.gather_rows(s_m, dev), p_m),
                "finalize": all(torch.equal(u, v) for u, v in
                                zip(fleet_mod.gather_rows(fin, dev), p_fin)),
                "ingest": _same_state(fleet_mod.gather_rows(s_in, dev), p_in),
                "blocks on their devices": placed,
            }
            timed[p] = lambda eng=eng, s_a=s_a: eng.update(s_a, blocks[0], **tick)
            timed_in[p] = lambda eng=eng, s_m=s_m: eng.ingest(s_m, ids, req, **tick)
            print(f"[fleet-mesh {label} p={p}] T={tenants} B={rows} m={m}: {p} blocks of "
                  f"{eng.shard_rows} rows on {[str(d) for d in eng.devices]}; update, merge, "
                  f"finalize and ingest of {requests} shuffled requests bitwise the unsharded "
                  f"fleet: {ok}; {kernel} launches: {counts} (p an update, one a block an "
                  f"ingest); copies and collectives in the window: {copies} (peer or NCCL: "
                  f"{bad or 'none'}); no torch.distributed call", flush=True)
            check(all(ok.values()), f"fleet-mesh {label} p={p}: {ok}")
            check(not bad, f"fleet-mesh {label} p={p}: peer copies or collectives {bad}")
            if label == "float" and p == shards:
                kept = {"engine": eng, "plain": plain}
            del s_b, fin, s_in
        # One update and one ingest, CUDA-event median of 10 a turn, in the
        # order unsharded, p, 1, 1, p, unsharded.
        for key in ("none", shards, 1, 1, shards, "none"):
            times.setdefault((label, key), []).append(median_ms(timed[key]))
            times.setdefault((label, key, "ingest"), []).append(median_ms(timed_in[key]))
        del timed, timed_in, p_a, p_m, p_fin, p_in

    # A structured mesh fleet: kernel 4 once per tenant, in its block.
    s_t = structured_tenants
    sspecs = fleet_specs(FLEET_SEED, s_t, "structured", m, dim, sigma2)
    splain = FleetEngine(sspecs, device=dev)
    seng = FleetEngine(sspecs, sharding="mesh", mesh=tenant_mesh(shards, devices=[dev] * shards))
    sblocks = [b[:s_t].contiguous() for b in blocks]
    sst = run(f"fleet-mesh structured p={shards}", lambda: seng.update(
        seng.update(seng.init_state(), sblocks[0]), sblocks[1]), "structured_sketch")
    launches = ft.STRUCTURED_LAUNCHES
    want = splain.update(splain.update(splain.init_state(), sblocks[0]), sblocks[1])
    s_ok = (_same_state(fleet_mod.gather_rows(sst, dev), want)
            and torch.equal(fleet_mod.gather_rows(seng.finalize(sst)[0], dev),
                            splain.finalize(want)[0]))
    s_ms = [median_ms(lambda: (splain.update(want, sblocks[0]) if turn in (0, 3)
                               else seng.update(sst, sblocks[0]))) for turn in range(4)]
    print(f"[fleet-mesh structured p={shards}] T={s_t}: two updates, {launches} launches of "
          f"structured_sketch (one a tenant an update); bitwise the unsharded fleet (state and "
          f"z): {s_ok}; one update (unsharded, mesh, mesh, unsharded) "
          f"{[round(t, 3) for t in s_ms]} ms", flush=True)
    check(s_ok and launches == 2 * s_t, f"fleet-mesh structured: bits {s_ok}, launches {launches}")
    print(f"[fleet-mesh] {time.perf_counter() - t_phase:.1f}s; one update (ms, CUDA-event median "
          f"of {TIMED_LAUNCHES}, two turns each, in the order unsharded, p={shards}, p=1, p=1, "
          f"p={shards}, unsharded): " + "; ".join(
              f"{label} unsharded {times[(label, 'none')][0]:.3f} / "
              f"{times[(label, 'none')][1]:.3f}, p={shards} {times[(label, shards)][0]:.3f} / "
              f"{times[(label, shards)][1]:.3f}, p=1 {times[(label, 1)][0]:.3f} / "
              f"{times[(label, 1)][1]:.3f}" for label in variants)
          + f"; one ingest of {requests} shuffled requests, the same turns: " + "; ".join(
              f"{label} " + ", ".join(
                  f"{key if key == 'none' else f'p={key}'} "
                  f"{times[(label, key, 'ingest')][0]:.3f} / {times[(label, key, 'ingest')][1]:.3f}"
                  for key in ("none", shards, 1)) for label in variants), flush=True)
    del data, blocks, req
    return kept


def serve_mesh_phases(dev, run, cfg, sigma2, kept, sync=None, tenants=FLEET_T,
                      requests=FLEET_REQUESTS, request_rows=FLEET_REQUEST_ROWS, k=K, dim=DIM,
                      root=None):
    """[serve-mesh]: FleetService over the p-block float fleet of
    [fleet-mesh]: ``requests`` shuffled host requests flushed sync and async,
    the state bitwise the unsharded service's, one dispatch a block, the
    per-shard request counter adding up; decodes of tenants in different
    blocks bitwise the unsharded service's, on the owner's device; one
    tenant a block evicted and restored bitwise."""
    import shutil

    from repro_torch import device as device_mod
    from repro_torch import obs
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.data import synthetic
    from repro_torch.serve import FleetService

    sync = sync or torch.cuda.synchronize
    t_phase = time.perf_counter()
    root = Path(root or Path(__file__).resolve().parent / "build" / "serve_mesh_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    eng, plain = kept["engine"], kept["plain"]
    p, rows = eng.tenant_shards, eng.shard_rows
    shift_cfg = dataclasses.replace(cfg, decoder="sketch_shift")
    req_per = requests // tenants
    host = [synthetic.gaussian_mixture(device_mod.derive_seed(FLEET_SEED, t), req_per * request_rows,
                                       k, dim, device=dev).cpu().numpy() for t in range(tenants)]
    gen = torch.Generator(device="cpu").manual_seed(FLEET_SEED + 3)
    reqs = [(int(t), c) for c in range(req_per) for t in torch.randperm(tenants, generator=gen)]
    reqs = [reqs[i] for i in torch.randperm(len(reqs), generator=gen).tolist()]

    def flushed(engine, async_ingest, name):
        svc = FleetService(engine, shift_cfg, checkpoint_dir=root / name)
        for t, c in reqs:
            svc.submit(t, host[t][c * request_rows:(c + 1) * request_rows])
        sync(dev)
        t1 = time.perf_counter()
        svc.flush(async_ingest=async_ingest)
        sync(dev)
        return svc, time.perf_counter() - t1

    svc, sync_s = run(f"serve-mesh flush sync p={p}", lambda: flushed(eng, False, "sync"),
                      "fourier_sketch_fleet")
    from repro_torch.kernels import fourier_sketch as fs

    flush_launches = fs.FLEET_LAUNCHES
    asvc, async_s = flushed(eng, True, "async")
    ref, ref_s = flushed(plain, False, "plain")
    obs.reset()
    obs.enable()
    try:
        osvc, _ = flushed(eng, False, "obs")
    finally:
        obs.disable()
    snap = obs.snapshot()
    obs.reset()
    per_shard = [snap.get(f"fleet.flush.shard_requests{{shard={s}}}", 0) for s in range(p)]
    want_shard = [sum(1 for t, _ in reqs if t // rows == s) for s in range(p)]
    ok = {
        "sync": _same_state(fleet_mod.gather_rows(svc.state, dev), ref.state),
        "async": _same_state(fleet_mod.gather_rows(asvc.state, dev), ref.state),
        "one dispatch a block": svc.stats.flushes == asvc.stats.flushes == p
        and flush_launches == p,
        "per-shard counts": per_shard == want_shard and sum(per_shard) == len(reqs),
    }
    print(f"[serve-mesh flush] {len(reqs)} host requests of {request_rows} rows over {p} blocks: "
          f"sync {sync_s * 1e3:.2f} ms, async {async_s * 1e3:.2f} ms, the unsharded service "
          f"sync {ref_s * 1e3:.2f} ms ({sync_s * 1e6 / len(reqs):.2f} / "
          f"{async_s * 1e6 / len(reqs):.2f} / {ref_s * 1e6 / len(reqs):.2f} us a request); "
          f"{svc.stats.flushes} dispatches, {flush_launches} launches of fourier_sketch_fleet; "
          f"fleet.flush.shard_requests {per_shard}; checks {ok}", flush=True)
    check(all(ok.values()), f"serve-mesh flush: {ok}")
    del asvc, osvc

    # Decode one tenant in each block, then evict and restore it.
    picks = [s * rows + s for s in range(p)]
    got = run("serve-mesh decode", lambda: [svc.decode(t) for t in picks], "sketch_shift")
    want = [ref.decode(t) for t in picks]
    dec_ok = all(torch.equal(a.centroids, b.centroids) and torch.equal(a.weights, b.weights)
                 and a.centroids.device == eng.device_of(t)
                 for a, b, t in zip(got, want, picks))
    before = {t: eng.tenant_state(svc.state, t) for t in picks}
    ev_s = []
    for t in picks:
        t1 = time.perf_counter()
        svc.evict(t)
        svc.restore(t)
        sync(dev)
        ev_s.append(time.perf_counter() - t1)
    back = all(_same_state(eng.tenant_state(svc.state, t), before[t]) for t in picks)
    hits = all(svc.decode(t).cached for t in picks)
    print(f"[serve-mesh decode] tenants {picks} (one a block): decodes bitwise the unsharded "
          f"service's, on the owner's device: {dec_ok}; evict + restore "
          f"{statistics.median(ev_s) * 1e3:.3f} ms a tenant, rows bitwise: {back}, cached "
          f"decodes served again: {hits}", flush=True)
    check(dec_ok and back and hits, f"serve-mesh decode/evict: {dec_ok}, {back}, {hits}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[serve-mesh] {time.perf_counter() - t_phase:.1f}s", flush=True)


def examples_phase(dev, run, argv=None):
    """[examples]: the port's three sketch examples on the card at their
    default sizes (``full_pipeline`` with its default sharded backend: a
    one-rank NCCL group it makes and destroys), and ``serve_fleet`` again
    over a 4-block tenant mesh on one card; each one's relative SSE or
    bitwise line is asserted."""
    import contextlib
    import io
    import re

    from repro_torch.examples import full_pipeline, quickstart, serve_fleet

    t_phase = time.perf_counter()
    argv = argv or {}
    cases = [
        ("quickstart", quickstart, [], ("fourier_sketch", "assign_argmin")),
        ("full_pipeline", full_pipeline, [], ("fourier_sketch", "assign_argmin")),
        ("serve_fleet", serve_fleet, [], ("fourier_sketch_fleet", "sketch_shift")),
        ("serve_fleet --shards 4 --devices 1", serve_fleet, ["--shards", "4", "--devices", "1"],
         ("fourier_sketch_fleet", "sketch_shift")),
    ]

    def captured(module, args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            module.main(args)
        return buf.getvalue()

    for name, module, args, needs in cases:
        args = [*args, *argv.get(module.__name__.rsplit(".", 1)[-1], []), "--device", str(dev)]
        text = run(f"examples {name}", lambda: captured(module, args), needs)
        for line in text.splitlines():
            print(f"[examples {name}] {line}", flush=True)
        if module is quickstart:
            ckm_sse = float(re.search(r"CKM +SSE/N = ([\d.]+)", text).group(1))
            lloyd_sse = float(re.search(r"Lloyd5 SSE/N = ([\d.]+)", text).group(1))
            rel = ckm_sse / lloyd_sse
        elif module is full_pipeline:
            check("[0] launched alone: made a one-rank" in text, "full_pipeline: no group line")
            rel = float(re.search(r"\[4\] relative SSE ([\d.]+);", text).group(1))
        else:
            rel = None
            check("restored bitwise=True" in text, f"examples {name}: no bitwise restore")
            if "--shards" in args:
                check(text.startswith("placement: shard 0 -> ") and "shards=4x" in text,
                      f"examples {name}: no mesh placement")
        if rel is not None:
            print(f"[examples {name}] relative SSE {rel:.4f} (limit {MAX_RELATIVE_SSE})",
                  flush=True)
            check(rel <= MAX_RELATIVE_SSE, f"examples {name}: relative SSE {rel}")
    print(f"[examples] {time.perf_counter() - t_phase:.1f}s", flush=True)


def _clone(tree):
    return tree_map(torch.Tensor.clone, tree)


def _check_config(cfg):
    """The float32 check's config: the largest depth whose float32
    parameters take at most LM_CHECK_BYTES, or None when one layer is over."""
    depth = cfg.n_layers
    while depth and dataclasses.replace(cfg, n_layers=depth).param_count() * 4 > LM_CHECK_BYTES:
        depth -= 1
    return dataclasses.replace(cfg, n_layers=depth) if depth else None


def _frontend_inputs(cfg, batch, gen, dev, dtype=torch.float32):
    """The stub frontend's inputs of a batch: patches or frames, (B, F, d)."""
    name = {"vision": "patches", "audio": "frames"}.get(cfg.frontend)
    if name is None:
        return {}
    return {name: torch.randn((batch, cfg.frontend_len, cfg.d_model), generator=gen,
                              device=dev).to(dtype)}


def _recurrent_ms(cfg, params, dev, batch, seq, sync) -> dict:
    """Each recurrent mixer of ``cfg``: one layer's full-sequence apply on
    (batch, seq) bf16 activations, host-clock ms (synchronised), once warm."""
    from repro_torch.models import transformer as tfm

    out = {}
    for li, where, g, key in tfm._walk(cfg):
        mixer = tfm._kind(cfg, li)[0]
        if mixer in out or mixer not in tfm._APPLY:
            continue
        apply, dims_of = tfm._APPLY[mixer]
        p = tfm._at(params, where, g, key)["mixer"]
        x = torch.randn((batch, seq, cfg.d_model), device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            apply(p, dims_of(cfg), x[:, :16])
            sync(dev)
            t0 = time.perf_counter()
            apply(p, dims_of(cfg), x)
            sync(dev)
        out[mixer] = (time.perf_counter() - t0) * 1e3
    return out


def lm_serve_phase(dev, run, phase_counts, arch, batch, prompt, check_prompt, depth=None,
                   sync=None, steps=LM_DECODE_STEPS, check_steps=LM_CHECK_STEPS, keep=False):
    """[lm-serve <arch>]: the published config at full width, at ``depth``
    layers (None: all), built by ``init_lm`` on the card.  In float32:
    prefill -> decode against ``forward`` at ``check_prompt`` positions, to
    ``tests/test_archs.py``'s bar, at the largest depth whose float32
    parameters take at most LM_CHECK_BYTES (the smoke config where one layer
    is over) and, for a MoE, at a capacity factor that drops no token,
    freed before the serving model is built.  Then the serving
    (bf16) model, built in bf16: ``batch`` prompts of ``prompt`` positions
    (with the frontend's stub inputs: internvl2's patches lead the prompt,
    whisper's frames feed its encoder) through the serve layer's prefill
    step and ``steps`` greedy tokens through its serve step, timed, the
    logits finite, the peak memory against the bf16 parameters plus the
    cache (KV, recurrent states, cross keys and values); each recurrent
    mixer's one-layer apply timed at the prompt's shape.  No kernel launches
    (the model's attention is plain PyTorch).  With ``keep``, returns what a
    compressed-cache phase needs: the serving model, the cache of one more
    (untimed) prefill, the prompt's length and the first request's first
    decoded token."""
    from repro_torch import device as device_mod
    from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import specs as lspecs
    from repro_torch.models import transformer as tfm

    sync = sync or torch.cuda.synchronize
    t_phase = time.perf_counter()
    tag = f"lm-serve {arch}"
    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
    prefix = cfg.frontend_len if cfg.frontend == "vision" else 0

    def gen(i):
        return device_mod.generator(device_mod.derive_seed(LM_SEED, i), dev)

    # 1. Float32: prefill -> decode against forward.
    check_cfg = _check_config(full)
    where = (f"{check_cfg.n_layers} of {full.n_layers} layers" if check_cfg is not None
             else "the smoke config (one layer's float32 parameters exceed "
                  f"{LM_CHECK_BYTES / 1e9:.0f} GB)")
    check_cfg = check_cfg or get_smoke_config(arch)
    if check_cfg.moe_experts:
        # A capacity of every token: the prefill's dispatch drops none, as
        # the decode's dense path drops none (at the published 1.25 the two
        # differ by design once an expert overflows).
        no_drop = max(check_cfg.moe_capacity_factor, check_cfg.moe_experts / check_cfg.moe_top_k)
        check_cfg = dataclasses.replace(check_cfg, moe_capacity_factor=no_drop)
        where += f", MoE capacity factor {no_drop:g} (no token dropped)"
    params = tfm.init_lm(LM_SEED, check_cfg, device=dev)
    f32 = torch.float32
    n_check = check_prompt - prefix
    check_in = {"tokens": torch.randint(0, check_cfg.vocab_size, (2, n_check + check_steps),
                                        generator=gen(1), device=dev),
                **_frontend_inputs(check_cfg, 2, gen(3), dev)}

    def consistency():
        worst = -float("inf")
        with torch.inference_mode():
            x, _ = tfm.forward(params, check_cfg, check_in, dtype=f32)
            ref = tfm.logits_fn(params, check_cfg, x[:, check_prompt - 1:])
            del x
            logits, cache, index = tfm.prefill(
                params, check_cfg, {**check_in, "tokens": check_in["tokens"][:, :n_check]},
                check_prompt + check_steps, dtype=f32)
            for t in range(check_steps + 1):
                if t:
                    logits, cache = tfm.decode_step(
                        params, check_cfg, check_in["tokens"][:, n_check + t - 1:][:, :1],
                        cache, index + t - 1, dtype=f32)
                want = ref[:, t]
                excess = torch.abs(logits[:, 0] - want) - (LM_ATOL + LM_RTOL * torch.abs(want))
                worst = max(worst, float(torch.amax(excess)))
        return worst, float(torch.amax(torch.abs(ref)))

    worst, ref_max = run(f"{tag} f32 check", consistency, ())
    print(f"[{tag} f32 check] {where}: prefill of {check_prompt} positions then {check_steps} "
          f"decode steps against forward (B=2): max(|d| - (atol + rtol |ref|)) = {worst:.3e} "
          f"(atol {LM_ATOL}, rtol {LM_RTOL}; max |logit| {ref_max:.3f})", flush=True)
    check(worst <= 0.0, f"{tag}: prefill -> decode differs from forward by {worst:.3e} over "
                        "the bar")
    del params, check_in
    sync(dev)
    torch.cuda.empty_cache()

    # 2. The serving model, drawn in bf16 (the bits of casting the float32
    # model of the same seed).
    params = tfm.init_lm(LM_SEED, cfg, device=dev, dtype=torch.bfloat16)
    sync(dev)
    base = _reset_peak(dev)
    param_bytes = _nbytes(tree_leaves(params))
    # The cache holds the prompt and the decode steps after it.
    shape = ShapeConfig(tag, prompt + steps, batch, "prefill")
    prefill, _ = lserve.make_prefill(cfg, shape)
    serve_step, _ = lserve.make_serve_step(cfg, shape)
    inputs = lspecs.make_batch(cfg, shape, gen(2))
    inputs.pop("labels")
    inputs["tokens"] = inputs["tokens"][:, :prompt - prefix].contiguous()
    warm_prefill, _ = lserve.make_prefill(
        cfg, ShapeConfig(tag, prefix + LM_WARM_PROMPT + 1, batch, "prefill"))
    logits, cache, index = warm_prefill(
        params, {**inputs, "tokens": inputs["tokens"][:, :LM_WARM_PROMPT]})
    serve_step(params, torch.argmax(logits[:, -1], -1, keepdim=True), cache, index)
    del logits, cache

    def serve():
        sync(dev)
        t0 = time.perf_counter()
        logits, cache, index = prefill(params, inputs)
        sync(dev)
        t1 = time.perf_counter()
        finite = torch.isfinite(logits).all()
        for t in range(steps):
            nxt = torch.argmax(logits[:, -1], -1, keepdim=True)
            logits, cache = serve_step(params, nxt, cache, index + t)
            finite &= torch.isfinite(logits).all()
        sync(dev)
        return t1 - t0, time.perf_counter() - t1, bool(finite), cache

    prefill_s, decode_s, finite, cache = run(tag, serve, ())
    cache_bytes = _nbytes(tree_leaves(cache))
    del cache
    peak = _peak_since(dev, base) + param_bytes
    check(finite, f"{tag}: non-finite logits")
    check(phase_counts[tag]["flash_attention"] == 0, f"{tag}: the model launched kernel 8")
    budget = cfg.param_count() * 2 + cache_bytes
    layers = (f"{cfg.n_layers} layers" if depth is None else
              f"{cfg.n_layers} of {full.n_layers} layers ({LM_SERVE_CUTS[arch]})")
    if cfg.encoder_layers:
        layers += f" + an encoder of {cfg.encoder_layers} on {cfg.frontend_len} frames"
    if cfg.moe_experts:
        layers += f", MoE {cfg.moe_experts} experts top-{cfg.moe_top_k}"
    mixers = "/".join(dict.fromkeys(cfg.mixer_pattern))
    recurrent = _recurrent_ms(cfg, params, dev, batch, prompt, sync)
    print(f"[{tag}] {layers}, mixers {mixers}, d={cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, head_dim {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, bf16: prefill of B={batch} x S={prompt} "
          f"{'(' + str(prefix) + ' patches + ' + str(prompt - prefix) + ' tokens) ' if prefix else ''}"
          f"{prefill_s * 1e3:.1f} ms ({batch * prompt / prefill_s:.0f} positions/s); {steps} "
          f"greedy decode steps {decode_s / steps * 1e3:.2f} ms a token ({batch * steps / decode_s:.1f} "
          f"tokens/s over the batch); logits finite; peak device memory {peak / 1e9:.3f} GB "
          f"against params {cfg.param_count() * 2 / 1e9:.3f} GB (param_count x 2 B) + cache "
          f"{cache_bytes / 1e9:.3f} GB = {budget / 1e9:.3f} GB ({peak / budget:.3f}x); phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    if recurrent:
        print(f"[{tag} mixers] one layer's full-sequence apply at B={batch} x S={prompt}, bf16, "
              "host clock: " + ", ".join(f"{m} {ms:.1f} ms ({ms * 1e3 / prompt:.1f} us a "
                                         "position)" for m, ms in recurrent.items()),
              flush=True)
    if not keep:
        return None
    # The cache right after the prefill, and the first token (the timed run's
    # decode wrote its cache in place).
    logits, cache, index = prefill(params, inputs)
    return {"cfg": cfg, "params": params, "cache": cache, "index": index,
            "first": torch.argmax(logits[:1, -1], -1, keepdim=True)}


def _compressed_decode(served, layers, compressed, steps, tokens=None, sync=None):
    """``steps`` tokens decoded from ``served``'s prefill cache (cloned)
    with each layer of ``compressed`` (layer index -> a ``"ck"`` cache) in
    place of its full cache: greedy from the first token, or fed
    ``tokens``.  Returns ([(token, float logits)], seconds a step)."""
    from repro_torch.models import transformer as tfm

    cfg, params, index = served["cfg"], served["params"], served["index"]
    cache = _clone(served["cache"])
    for li, where, g, key in layers:
        if li in compressed:
            tfm._put(cache, where, g, key, _clone(compressed[li]))
    out, nxt = [], served["first"]
    (sync or torch.cuda.synchronize)()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(steps):
            tok = nxt if tokens is None else tokens[t]
            logits, cache = tfm.decode_step(params, cfg, tok, cache, index + t)
            out.append((tok, logits[:, 0].float()))
            nxt = torch.argmax(logits[:, -1], -1, keepdim=True)
    (sync or torch.cuda.synchronize)()
    return out, (time.perf_counter() - t0) / steps


def _relative_errors(got, full) -> list[float]:
    return [float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
            for (_, a), (_, b) in zip(got, full)]


def long_context_phase(dev, run, phase_counts, served, steps=LONG_DECODE_STEPS, centroids=None,
                       ring=None):
    """[jamba long-context]: jamba's attention layers (``long_context="ckm"``)
    compressed from its prefill's KV by ``build_compressed_cache``: Lloyd
    through kernel 2 (counted), K = CKM_KV_CENTROIDS centroids a head, a ring
    of CKM_KV_RECENT; k-means++'s host loop timed apart.  Then ``steps``
    tokens decoded with those layers in the ``"ck"`` form beside the carried
    Mamba states, against the full cache: the logits' relative error
    (random weights: no bar), ms a token."""
    from repro_torch import device as device_mod
    from repro_torch.core import lloyd as lloyd_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kv_clustering as kvc

    t_phase = time.perf_counter()
    centroids = centroids or tfm.CKM_KV_CENTROIDS
    ring = ring or tfm.CKM_KV_RECENT
    cfg, cache0, index = served["cfg"], served["cache"], served["index"]
    tag = f"{cfg.name.split('-')[0]} long-context"
    layers = [(li, where, g, key) for li, where, g, key in tfm._walk(cfg)
              if tfm._kind(cfg, li)[0] == "attn"]
    check(bool(layers), f"{tag}: no attention layer")
    kpp_s = [0.0]
    init = lloyd_mod._init_centroids

    def timed_init(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = init(*args, **kwargs)
        torch.cuda.synchronize()
        kpp_s[0] += time.perf_counter() - t0
        return out

    def compress():
        out = {}
        for li, where, g, key in layers:
            c = tfm._at(cache0, where, g, key)
            out[li] = kvc.build_compressed_cache(device_mod.derive_seed(KV_SEED, 300, li),
                                                 c["k"][:, :index], c["v"][:, :index],
                                                 centroids, ring, "lloyd")
        return out

    lloyd_mod._init_centroids = timed_init
    try:
        t0 = time.perf_counter()
        comp = run(f"{tag} compress", compress, "assign_argmin")
        compress_s = time.perf_counter() - t0
    finally:
        lloyd_mod._init_centroids = init
    k = tfm._at(cache0, *layers[0][1:])["k"]
    heads = len(layers) * k.shape[0] * k.shape[2]  # batch x kv heads a layer
    full, full_ms = _compressed_decode(served, layers, {}, steps)
    got, ck_s = _compressed_decode(served, layers, comp, steps, [tok for tok, _ in full])
    rel = _relative_errors(got, full)
    live = sum(int((c["clogw"] > -1e29).sum()) for c in comp.values())
    print(f"[{tag}] {len(layers)} attention layers of {cfg.n_layers} (layers "
          f"{[li for li, *_ in layers]}), {heads} heads compressed from S={index} to K="
          f"{centroids} + ring {ring} ({index / (centroids + ring):.1f}x smaller; {live} of "
          f"{heads * centroids} centroids live) by Lloyd in {compress_s:.2f} s ({kpp_s[0]:.2f} s "
          f"of it k-means++'s {centroids - 1} host steps a head, {kpp_s[0] / heads * 1e3:.1f} ms "
          f"a head), launches {phase_counts[f'{tag} compress']['assign_argmin']} of kernel 2; "
          f"{steps} tokens decoded with the Mamba states carried: "
          f"{ck_s * 1e3:.2f} ms a token compressed, {full_ms * 1e3:.2f} with the full cache; "
          f"relative error of the logits against the full cache max {max(rel):.4f} mean "
          f"{statistics.mean(rel):.4f} (random weights: the worst case, no bar); phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    check(all(math.isfinite(r) for r in rel), f"{tag}: non-finite logits")


def kv_ckm_phase(dev, run, served, centroids=KV_CENTROIDS, ring=KV_RING,
                 steps=KV_DECODE_STEPS):
    """[kv-ckm]: gemma3-1B's global layers (``long_context="ckm"``)
    compressed from the prefill's KV with ``build_compressed_cache``: Lloyd
    on every global layer, CKM on the first (kernels 1 and 2, counted); then
    ``steps`` tokens decoded through ``decode_step`` with those layers in
    the ``"ck"`` form, the logits' relative error against the full cache
    printed (random weights: the worst case, no bar).  Then the example's
    clustered-KV regime at head_dim 256 (centres x4, noise 0.1): both
    methods held to ``tests/test_kv_clustering.py``'s bar at its size
    (KV_CLUSTERED_TEST); at the example's (KV_CLUSTERED_EXAMPLE) CKM
    printed, and Lloyd over KV_LLOYD_SEEDS seeds through kernel 2 held to
    the same run through its plain version."""
    from repro_torch import device as device_mod
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kv_clustering as kvc

    t_phase = time.perf_counter()
    cfg, params, cache0, index = (served[k] for k in ("cfg", "params", "cache", "index"))
    layers = [(li, where, g, key) for li, where, g, key in tfm._walk(cfg)
              if tfm._kind(cfg, li)[0] == "attn"]
    check(bool(layers), "kv-ckm: no global layer")

    def compress(method, which):
        out = {}
        for li, where, g, key in which:
            c = tfm._at(cache0, where, g, key)
            out[li] = kvc.build_compressed_cache(device_mod.derive_seed(KV_SEED, li),
                                                 c["k"][:, :index], c["v"][:, :index],
                                                 centroids, ring, method)
        return out

    lloyd_c = run("kv-ckm lloyd", lambda: compress("lloyd", layers), "assign_argmin")
    ckm_c = run("kv-ckm ckm", lambda: compress("ckm", layers[:1]),
                ("fourier_sketch", "assign_argmin"))

    full, _ = _compressed_decode(served, layers, {}, steps)
    tokens = [tok for tok, _ in full]
    rel = {}
    for method, comp in (("lloyd", lloyd_c), ("ckm", {**lloyd_c, **ckm_c})):
        got, _ = _compressed_decode(served, layers, comp, steps, tokens)
        rel[method] = _relative_errors(got, full)
    print(f"[kv-ckm decode] {len(layers)} global layers of {cfg.n_layers} (layers "
          f"{[li for li, *_ in layers]}) compressed from S={index} to K={centroids} + ring "
          f"{ring} ({index / (centroids + ring):.1f}x smaller); {steps} tokens decoded: "
          f"relative error of the logits against the full cache, Lloyd on every global layer "
          f"max {max(rel['lloyd']):.4f} mean {statistics.mean(rel['lloyd']):.4f}; CKM on "
          f"layer {layers[0][0]} (Lloyd on the rest) max {max(rel['ckm']):.4f} mean "
          f"{statistics.mean(rel['ckm']):.4f} (random weights: the worst case, no bar)",
          flush=True)
    check(all(math.isfinite(r) for v in rel.values() for r in v), "kv-ckm: non-finite logits")

    # The clustered-KV regime at the model's head_dim.
    li, where, g, key = layers[0]
    mixer = {k: v.float() for k, v in tfm._at(params, where, g, key)["mixer"].items()}
    dims = tfm.attn_dims(cfg, "attn")
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    pad = (0, 0, 0, 0, 0, 1)

    def clustered(n_keys, n_cent, *tag):
        """Planted keys and values, a query, and the full-cache output."""
        gens = [device_mod.generator(device_mod.derive_seed(KV_SEED, 100, n_cent, *tag, i), dev)
                for i in range(4)]
        centers = torch.randn((n_cent, kvh, hd), generator=gens[0], device=dev) * 4
        assign = torch.randint(0, n_cent, (n_keys,), generator=gens[1], device=dev)
        kcl = centers[assign][None] + 0.1 * torch.randn((1, n_keys, kvh, hd),
                                                        generator=gens[2], device=dev)
        vcl = centers[assign][None] * 0.5
        x = torch.randn((1, 1, cfg.d_model), generator=gens[3], device=dev)
        out_full, _, _ = L.attention_decode(mixer, dims, x, torch.nn.functional.pad(kcl, pad),
                                            torch.nn.functional.pad(vcl, pad), n_keys)
        return {"k": kcl, "v": vcl, "x": x, "full": out_full, "centers": centers}

    def rel_err(case, cache):
        out_c, _ = kvc.attention_decode_compressed(mixer, dims, case["x"], cache,
                                                   case["k"].shape[1])
        return float(torch.linalg.norm(out_c - case["full"]) / torch.linalg.norm(case["full"]))

    def matched(case, cache):
        """Planted centres that are some live centroid's nearest (all of
        them unless two centroids share a cluster)."""
        live = cache["clogw"][0, :, 0] > -1e29
        ck = cache["ck"][0][live].float().reshape(int(live.sum()), -1)
        d2 = torch.cdist(ck, case["centers"].reshape(case["centers"].shape[0], -1))
        return int(torch.unique(torch.argmin(d2, 1)).numel())

    def build(case, seed, n_cent, n_ring, method):
        return kvc.build_compressed_cache(seed, case["k"], case["v"], n_cent, n_ring, method)

    # The test's size: both methods held to the bar.
    n_keys, n_cent, n_ring = KV_CLUSTERED_TEST
    case = clustered(n_keys, n_cent)
    errs = {}
    for method, needs in (("lloyd", "assign_argmin"),
                          ("ckm", ("fourier_sketch", "assign_argmin"))):
        cache = run(f"kv-ckm clustered K={n_cent} {method}",
                    lambda m=method: build(case, device_mod.derive_seed(KV_SEED, 101), n_cent,
                                           n_ring, m), needs)
        errs[method] = rel_err(case, cache)
    print(f"[kv-ckm clustered K={n_cent}] head_dim {hd}, S={n_keys}, {n_cent} planted centres "
          f"x4, noise 0.1, ring {n_ring}: attention-output relative error Lloyd "
          f"{errs['lloyd']:.4f}, CKM {errs['ckm']:.4f} (bar {KV_CLUSTERED_BAR})", flush=True)
    for method, err in errs.items():
        check(err < KV_CLUSTERED_BAR, f"kv-ckm clustered K={n_cent} {method}: relative error "
                                      f"{err:.4f}")

    # The example's size: CKM printed without a bar; Lloyd over
    # KV_LLOYD_SEEDS data seeds through kernel 2 and through its plain version.
    n_keys, n_cent, n_ring = KV_CLUSTERED_EXAMPLE
    case = clustered(n_keys, n_cent)
    cache = run(f"kv-ckm clustered K={n_cent} ckm",
                lambda: build(case, device_mod.derive_seed(KV_SEED, 101), n_cent, n_ring, "ckm"),
                ("fourier_sketch", "assign_argmin"))
    ckm_err, ckm_found = rel_err(case, cache), matched(case, cache)
    cases = [clustered(n_keys, n_cent, s) for s in range(KV_LLOYD_SEEDS)]

    def lloyd_sweep():
        return [build(c, device_mod.derive_seed(KV_SEED, 101, s), n_cent, n_ring, "lloyd")
                for s, c in enumerate(cases)]

    kernel_caches = run(f"kv-ckm clustered K={n_cent} lloyd x{KV_LLOYD_SEEDS}", lloyd_sweep,
                        "assign_argmin")
    with plain_assign():
        plain_caches = lloyd_sweep()
    errs = [(rel_err(c, a), rel_err(c, b), matched(c, a), matched(c, b))
            for c, a, b in zip(cases, kernel_caches, plain_caches)]
    gap = max(abs(e_k - e_p) for e_k, e_p, _, _ in errs)
    under = [sum(e[j] < KV_CLUSTERED_BAR for e in errs) for j in (0, 1)]
    merged = [s for s, e in enumerate(errs) if e[2] < n_cent]
    missed = {s: round(e[0], 4) for s, e in enumerate(errs) if e[0] >= KV_CLUSTERED_BAR}
    print(f"[kv-ckm clustered K={n_cent}] head_dim {hd}, S={n_keys}, {n_cent} planted centres "
          f"x4, noise 0.1, ring {n_ring}: CKM {ckm_err:.4f} ({ckm_found} of {n_cent} centres "
          f"matched; no bar: the reference's recipe misses it here); Lloyd over "
          f"{KV_LLOYD_SEEDS} seeds: under the bar {KV_CLUSTERED_BAR} on {under[0]} (kernel 2) "
          f"and {under[1]} (plain), errors {min(e[0] for e in errs):.4f}-"
          f"{max(e[0] for e in errs):.4f}, max |kernel - plain| {gap:.2e} (tol "
          f"{KV_LLOYD_PLAIN_TOL}), seeds with two centroids in one cluster {merged}, over the "
          f"bar {missed}", flush=True)
    check(gap <= KV_LLOYD_PLAIN_TOL,
          f"kv-ckm clustered K={n_cent} lloyd: kernel 2 and its plain version differ by {gap:.2e}")
    check(all(e[2] == e[3] for e in errs),
          f"kv-ckm clustered K={n_cent} lloyd: kernel 2 and its plain version match different "
          "centres")
    print(f"[kv-ckm] {time.perf_counter() - t_phase:.1f}s", flush=True)


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step, counted from the code: the forward's
    products (the attention projections, the SwiGLU MLP, the tied
    unembedding; causal attention's QK^T and PV over the half of the scores
    a causal mask needs), three times that for the forward and backward.
    Remat "full" runs one forward more (x 4/3 for the hardware's FLOPs)."""
    d, hd = cfg.d_model, cfg.head_dim_
    per_token = 2 * (cfg.n_layers * (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                                     + 3 * d * cfg.d_ff) + d * cfg.vocab_size)
    attention = cfg.n_layers * 2 * batch * cfg.n_heads * hd * seq * seq
    return 3.0 * (per_token * batch * seq + attention)


def lm_train_shapes(dev) -> dict:
    """Kernel 1's and kernel 4's inputs at the training path's shapes: the
    balancer's and the monitors' operators as ``train_loop.run`` makes them
    (see LM_TRAIN), B = LM_TRAIN[1] rows each.  The balancer's rows are the
    first batch's document embeddings, which also set its sigma^2; the
    monitors' pooled rows are standard normal from a generator of their own.
    -> {"dense": [(label, x, w)], "structured": [(label, x, op)]}."""
    from repro_torch import device as device_mod
    from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
    from repro_torch.data.clustering import CompressiveBalancer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.monitor import ActivationMonitor

    arch, batch, seq = LM_TRAIN
    cfg, smoke = get_config(arch), get_smoke_config(arch)
    data = DataConfig(seed=0, n_domains=4)
    embeds = SyntheticLM(cfg, ShapeConfig("train_4k", seq, batch, "train"), data,
                         dev).batch_numpy(0)["_doc_embeds"]
    bal = CompressiveBalancer(k=data.n_domains, dim=data.embed_dim, seed=LM_TRAIN_SEED + 3,
                              device=dev)
    bal.update(embeds)
    g = device_mod.generator(device_mod.derive_seed(LM_TRAIN_SEED, 300), dev)
    wide = ActivationMonitor(dim=cfg.d_model, k=4, device=dev).freqs
    narrow = ActivationMonitor(dim=smoke.d_model, k=2, device=dev).freqs
    x_bal = torch.from_numpy(embeds).to(dev)
    return {
        "dense": [
            (f"lm-train balancer N={batch}", x_bal, bal.freqs.w.contiguous()),
            (f"lm-train restart monitor N={batch}",
             torch.randn((batch, smoke.d_model), generator=g, device=dev),
             narrow.w.contiguous()),
        ],
        "structured": [(f"lm-train monitor N={batch}",
                        torch.randn((batch, cfg.d_model), generator=g, device=dev), wide)],
    }


def lm_train_phase(dev, run):
    """[lm-train <arch>]: ``train_loop.run`` at the published config's width
    and depth (see LM_TRAIN): the first batch's loss at float32 compute,
    then LM_TRAIN_STEPS bf16 steps with the monitor and the balancer on
    (kernels 4 and 1, counted), each step's time by CUDA events beside the
    loop's wall time, tokens/s, loss, gradient norm and peak memory, the
    balancer's decode seconds, the model- and hardware-FLOP shares of the
    bf16 peak, the final checkpoint's bytes, save and restore seconds
    (restored bitwise), the monitor's decode and the balancer's weights."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    arch, batch, seq = LM_TRAIN
    steps = LM_TRAIN_STEPS
    tag = f"lm-train {arch}"
    cfg = get_config(arch)
    shape = ShapeConfig("train_4k", seq, batch, "train")
    data = DataConfig(seed=0, n_domains=4)
    root = Path(__file__).resolve().parent / "build" / "train_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    # The checkpoint: float32 parameters and AdamW's m and v (12 bytes a
    # parameter), the step and the monitor's sketch.
    state_bytes = 12 * cfg.param_count()
    free = shutil.disk_usage(root).free
    print(f"[{tag} disk] {free / 1e9:.1f} GB free under {root}; the state ~{state_bytes / 1e9:.1f} "
          "GB", flush=True)
    check(free >= 2 * state_bytes, f"{tag}: {free / 1e9:.1f} GB free under {root}, under twice "
                                   f"the state's {state_bytes / 1e9:.1f} GB")

    def f32_loss():
        params = tfm.init_lm(LM_TRAIN_SEED, cfg, device=dev)
        with torch.no_grad():
            return float(tfm.lm_loss(params, cfg, SyntheticLM(cfg, shape, data, dev).batch(0),
                                     dtype=torch.float32))

    loss32 = run(f"{tag} f32 loss", f32_loss, ())
    loop = train_loop.LoopConfig(steps=steps, ckpt_dir=str(root), ckpt_every=steps + 1, keep=1,
                                 monitor_k=4, balance_every=2, log_every=1,
                                 dtype=torch.bfloat16, remat="full")
    base = _reset_peak(dev)
    out = run(tag, lambda: train_loop.run(cfg, shape, None, loop, data, seed=LM_TRAIN_SEED,
                                          device=dev), ("fourier_sketch", "structured_sketch"))
    hist = out["history"]
    check(len(hist) == steps, f"{tag}: {len(hist)} logged steps, not {steps}")
    tokens = batch * seq
    for h in hist:
        check(math.isfinite(h["loss"]) and math.isfinite(h["gnorm"]),
              f"{tag}: step {h['step']} loss {h['loss']} gnorm {h['gnorm']}")
        print(f"[{tag} step {h['step']}] step function {h['step_ms']:.1f} ms (CUDA events), "
              f"{tokens / h['step_ms'] * 1e3:.0f} tokens/s; the loop's wall {h['wall_ms']:.1f} ms "
              f"(batch, upload, step, balancer), {tokens / h['wall_ms'] * 1e3:.0f} tokens/s; loss "
              f"{h['loss']:.4f}, gnorm {h['gnorm']:.4f}, lr {h['lr']:.3e}, peak device memory "
              f"{h['peak_bytes'] / 1e9:.2f} GB ({(h['peak_bytes'] - base) / 1e9:.2f} GB over the "
              "phase's start)", flush=True)
    wall_s = sum(h["wall_ms"] for h in hist) * 1e-3
    print(f"[{tag} loop] {steps} steps in {wall_s:.2f} s of the loop's wall time: "
          f"{steps * tokens / wall_s:.0f} tokens/s; the balancer's decodes "
          f"{[round(t, 3) for t in out['balance_s']]} s (every 2 steps, inside the wall time)",
          flush=True)
    flops = lm_train_flops(cfg, batch, seq)
    step_ms = statistics.median(h["step_ms"] for h in hist)
    rate = flops / (step_ms * 1e-3)
    print(f"[{tag} model flops] {flops / 1e12:.1f} TFLOP a step (6 x params x tokens and causal "
          f"attention, counted from the code); median step function {step_ms:.1f} ms: "
          f"{rate / 1e12:.1f} TFLOP/s, model-FLOP share {100 * rate / PEAK_BF16_FLOP_PER_S:.2f}% "
          f"of {PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16; hardware-FLOP share (x 4/3, "
          f"remat's recompute included) {100 * 4 / 3 * rate / PEAK_BF16_FLOP_PER_S:.2f}%",
          flush=True)
    rel = abs(hist[0]["loss"] - loss32) / abs(loss32)
    print(f"[{tag} loss] step 1 at bf16 compute {hist[0]['loss']:.6f} against float32 "
          f"{loss32:.6f}: relative {rel:.2e} (bar {LM_TRAIN_LOSS_RTOL})", flush=True)
    check(math.isfinite(loss32) and rel <= LM_TRAIN_LOSS_RTOL,
          f"{tag}: the bf16 loss {hist[0]['loss']} is {rel:.2e} from the float32 {loss32}")

    # The final checkpoint: bytes, save seconds, restored bitwise.
    ck = Checkpointer(root, keep=1)
    check(ck.all_steps() == [steps], f"{tag}: checkpoints {ck.all_steps()}, not [{steps}]")
    nbytes = sum(f.stat().st_size for f in (root / f"step_{steps:010d}").iterdir())
    state = out["state"]
    t0 = time.perf_counter()
    restored = ck.restore(state)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    leaves, want = tree_leaves(restored), tree_leaves(state)
    same = len(leaves) == len(want) and all(torch.equal(a, b) for a, b in zip(leaves, want))
    print(f"[{tag} checkpoint] step {steps}: {nbytes / 1e9:.3f} GB in {len(leaves)} leaves, saved "
          f"in {out['save_s']:.1f}s (snapshot to the host and write), restored in "
          f"{restore_s:.1f}s (a warm read), bitwise equal to the live state: {same}", flush=True)
    check(same, f"{tag}: the restored checkpoint differs from the live state")
    del restored, leaves, want

    res = out["monitor_result"]
    weights = out["balance_weights"]
    check(tuple(res.centroids.shape) == (4, cfg.d_model)
          and bool(torch.isfinite(res.centroids).all()), f"{tag}: monitor centroids")
    check(weights is not None and len(weights) == data.n_domains
          and bool(np.all(np.isfinite(weights))) and abs(float(weights.sum()) - 1.0) < 1e-9,
          f"{tag}: balancer weights {weights}")
    print(f"[{tag}] {cfg.n_layers} layers, d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, B={batch} x S={seq} (train_4k's global "
          f"batch of 256 cut to {batch}), AdamW, float32 parameters, bf16 compute, remat full; "
          f"monitor weights {[round(float(w), 3) for w in res.weights]}; balancer weights "
          f"{[round(float(w), 3) for w in weights]}; phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    del out, state, res
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def lm_restart_phase(dev, run):
    """[lm-train restart]: LM_RESTART_STEPS steps straight against half, a
    restart from the checkpoint and the rest, at LM_TRAIN's smoke config on
    the card (the reference loop test's configuration): the same final
    loss."""
    import shutil

    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    tag = "lm-train restart"
    steps = LM_RESTART_STEPS
    cfg = get_smoke_config(LM_TRAIN[0])
    root = Path(__file__).resolve().parent / "build" / "train_restart"
    shutil.rmtree(root, ignore_errors=True)

    def loop(name, n):
        cfg_loop = train_loop.LoopConfig(steps=n, ckpt_dir=str(root / name), ckpt_every=steps // 2,
                                         monitor_k=2, log_every=2, dtype=torch.float32)
        return train_loop.run(cfg, ShapeConfig("t", 32, 4, "train"), None, cfg_loop,
                              DataConfig(seed=0), device=dev)

    straight = run(f"{tag} straight", lambda: loop("a", steps), "fourier_sketch")
    run(f"{tag} first half", lambda: loop("b", steps // 2), "fourier_sketch")
    resumed = run(f"{tag} resumed", lambda: loop("b", steps), "fourier_sketch")
    a, b = straight["history"][-1]["loss"], resumed["history"][-1]["loss"]
    finite = all(bool(torch.isfinite(o["monitor_result"].centroids).all())
                 for o in (straight, resumed))
    print(f"[{tag}] {cfg.name}: {steps} steps straight, final loss {a:.6f}; {steps // 2} + "
          f"restart + {steps - steps // 2}, final loss {b:.6f} (relative {abs(a - b) / abs(a):.2e}, "
          f"bar {LM_RESTART_RTOL}); the resumed run logged steps "
          f"{[h['step'] for h in resumed['history']]}; monitor centroids finite: {finite}; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    check(resumed["history"][0]["step"] > steps // 2, f"{tag}: the second run did not resume")
    check(abs(a - b) <= LM_RESTART_RTOL * abs(a), f"{tag}: final losses {a} and {b} differ")
    check(finite, f"{tag}: monitor centroids not finite")
    shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def plain_assign():
    """Kernel 2's wrapper replaced by its plain version: the same draws and
    the same arithmetic around it, so only the kernel differs."""
    from repro_torch.kernels import assign_argmin as aa

    kernel = aa.assign_argmin
    aa.assign_argmin = aa.assign_argmin_plain
    try:
        yield
    finally:
        aa.assign_argmin = kernel


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)

    from repro_torch import device as device_mod
    from repro_torch.configs import get_config
    from repro_torch.core import ckm, freq_ops, frequencies, lloyd, quantize
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import amp_denoise as kd
    from repro_torch.core import graphs
    from repro_torch.kernels import assign_argmin as aa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fourier_sketch as fs
    from repro_torch.kernels import freq_transform as ft
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch_shift as ks
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kv_clustering as kvc

    smoke_t0 = time.perf_counter()

    # Full-precision FP32 for every product the plain versions take.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    print(card_line(), flush=True)
    print(f"[torch] {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    # 2. The build.
    t0 = time.perf_counter()
    libs = _build.build()
    print(
        f"[build] {time.perf_counter() - t0:.1f}s: " + ", ".join(p.name for p in libs),
        flush=True,
    )
    for name, log in sorted(_build.PTXAS.items()):
        print(f"[ptxas {name}] {ptxas_summary(log)}", flush=True)
    instances = ptxas_instances(_build.PTXAS.get("structured_sketch", ""))
    check(len(instances) == 24, f"ptxas reported {len(instances)} structured instances, not 24")
    print("[ptxas structured_sketch] " + "; ".join(instances), flush=True)

    # 3. The data.
    t0 = time.perf_counter()
    x = synthetic.gaussian_mixture(DATA_SEED, N, K, DIM, device=dev)
    torch.cuda.synchronize()
    print(f"[data] N={N} K={K} n={DIM} m={M} in {time.perf_counter() - t0:.2f}s", flush=True)

    # Each section's seconds (the phases print their own).
    t_section = [time.perf_counter()]

    def section(label):
        now = time.perf_counter()
        print(f"[{label}] {now - t_section[0]:.1f}s", flush=True)
        t_section[0] = now

    # 4. Each kernel against its plain version, at the main path's shapes.
    cfg = ckm.CKMConfig(k=K, m=M)
    g_sig, g_freq, _ = ckm.stream_keys(FIT_SEED, dev)
    sigma2 = frequencies.estimate_sigma2(g_sig, x[: cfg.sigma2_sample], device=dev)
    w = frequencies.draw_frequencies(g_freq, M, DIM, sigma2, device=dev)
    ones = torch.ones((N,), dtype=torch.float32, device=dev)
    results = {"fourier_sketch": check_sketch(fs, x, w, ones, "fit shape")}
    print(f"[fourier_sketch phases] fit shape: max|x w| = {max_phase(x, w):.3f} rad", flush=True)
    chunk = N // STREAM_CHUNKS
    check_sketch(fs, x[:chunk], w, ones[:chunk], "stream-batch shape")
    check_sketch(fs, x[:RAGGED_N], w, ones[:RAGGED_N], "ragged")
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    beta = torch.rand((20_001,), generator=gen, device=dev)
    for n_small in (3, 70):
        xs = torch.randn((20_001, n_small), generator=gen, device=dev) * 2
        ws = torch.randn((n_small, 300), generator=gen, device=dev)
        check_sketch(fs, xs, ws, beta, f"n={n_small}")

    cents = x[torch.randperm(N, generator=gen, device=dev)[:K]].contiguous()
    results["assign_argmin"] = check_assign(aa, x, cents, "kmeans shape")
    dup = cents.clone()
    dup[3] = dup[0]
    check_assign(aa, x[:RAGGED_N], dup, "ragged", dup_of=(0, 3))
    for n_small in (3, 70):
        xs = torch.randn((20_001, n_small), generator=gen, device=dev) * 3
        cs = torch.randn((7, n_small), generator=gen, device=dev) * 3
        check_assign(aa, xs, cs, f"n={n_small}")

    # Kernels 1 and 2 at [kv-ckm]'s shapes: clustered keys of one gemma3-1B
    # global head, CKM's sigma^2 (boosted) and m.  Drawn from a generator of
    # their own, so that the checks after them keep their inputs.
    g_kv = device_mod.generator(device_mod.derive_seed(KV_SEED, 200), dev)
    hd = get_config("gemma3-1b").head_dim_
    n_keys = LM_SERVE["gemma3-1b"][1] - KV_RING + 1
    planted = torch.randn((KV_CENTROIDS, hd), generator=g_kv, device=dev) * 4
    keys = (planted[torch.randint(0, KV_CENTROIDS, (n_keys,), generator=g_kv, device=dev)]
            + 0.1 * torch.randn((n_keys, hd), generator=g_kv, device=dev))
    for k_s in KV_SHAPE_KS:
        check_assign(aa, keys, keys[torch.randperm(n_keys, generator=g_kv, device=dev)[:k_s]],
                     f"kv-ckm shape K={k_s}")
    s2_kv = float(frequencies.estimate_sigma2(g_kv, keys[:kvc.SIGMA2_SAMPLE], device=dev))
    w_kv = frequencies.draw_frequencies(g_kv, 5 * KV_CENTROIDS * hd, hd,
                                        s2_kv * kvc.SIGMA2_BOOST, device=dev)
    check_sketch(fs, keys, w_kv, ones[:n_keys], "kv-ckm shape")
    print(f"[fourier_sketch phases] kv-ckm shape: max|x w| = {max_phase(keys, w_kv):.3f} rad",
          flush=True)
    del keys, w_kv

    # Kernel 2 at [jamba long-context]'s shape: one head's S - ring + 1 keys
    # of the 32k prompt at head_dim 128 against CKM_KV_CENTROIDS centroids
    # (more than shared memory holds: the tile path streams them), planted
    # clusters as above, the centroids a sample of the keys (Lloyd's start).
    jamba = get_config(LONG_CONTEXT_ARCH)
    n_keys = LM_SERVE[LONG_CONTEXT_ARCH][1] - tfm.CKM_KV_RECENT + 1
    planted = torch.randn((tfm.CKM_KV_CENTROIDS, jamba.head_dim_), generator=g_kv,
                          device=dev) * 4
    keys = (planted[torch.randint(0, tfm.CKM_KV_CENTROIDS, (n_keys,), generator=g_kv,
                                  device=dev)]
            + 0.1 * torch.randn((n_keys, jamba.head_dim_), generator=g_kv, device=dev))
    sample = torch.randperm(n_keys, generator=g_kv, device=dev)[:tfm.CKM_KV_CENTROIDS]
    check_assign(aa, keys, keys[sample].contiguous(),
                 f"long-context shape K={tfm.CKM_KV_CENTROIDS}")
    del keys, planted

    # Kernels 1 and 4 at [lm-train]'s shapes, B = 4 rows a step: the
    # balancer's operator (n = 16, m = 640) after its first batch of
    # document embeddings, the monitor's at d_model 2048 (m = 32,768, 16
    # whole blocks) and at the restart phase's smoke width (dense, n = 64,
    # m = 512), on pooled rows from a generator of their own.
    lm_shapes = lm_train_shapes(dev)
    for label, x_t, w_t in lm_shapes["dense"]:
        check_sketch(fs, x_t, w_t, ones[:x_t.shape[0]], label)
    for label, x_t, op_t in lm_shapes["structured"]:
        check_structured(ft, x_t, op_t, ones[:x_t.shape[0]], label)
    del lm_shapes
    section("kernel checks 1-2")
    assign_sweep(aa, dev)
    section("assign_argmin tile sweep")

    # 4b. The slice-2 kernels (quantized dense, structured float and
    # quantized) at the main path's shapes: the fit's operator and dither.
    g_dither = ckm.stream_keys(FIT_SEED, dev)[2]
    dither = quantize.draw_dither(g_dither, M)
    op = freq_ops.make_operator("structured", g_freq, M, DIM, sigma2, device=dev)
    fit_codes = check_slice2_kernels(fs, ft, x, w, op, dither, "fit shape", N // 3, results)
    print(f"[quantized_fourier_sketch fit shape] 1bit "
          f"{fit_codes[('quantized_fourier_sketch', 1)]['ms']:.3f} ms, 4bit "
          f"{fit_codes[('quantized_fourier_sketch', 4)]['ms']:.3f} ms; fourier_sketch (float) "
          f"{results['fourier_sketch']['ms']:.3f} ms", flush=True)
    check_slice2_kernels(fs, ft, x[:chunk], w, op, dither, "stream-batch shape", chunk // 3)
    check_slice2_kernels(fs, ft, x[:RAGGED_N], w, op, dither, "ragged", 333_333)
    x_big = x[:RAGGED_N] * LARGE_PHASE_STRUCTURED_SCALE
    big = max_structured_phase(x_big, op)
    big_dense = max_phase(x_big, w)
    check(1e3 <= big <= 1e5, f"structured large-phase case: max|phase| {big:.1f} outside [1e3, 1e5]")
    check(1e3 <= big_dense <= 1e5,
          f"dense large-phase case: max|x w| {big_dense:.1f} outside [1e3, 1e5]")
    check_slice2_kernels(fs, ft, x_big, w, op, dither,
                         f"large phases max|phase|={big:.1f} (dense {big_dense:.1f})", 333_333)
    print(f"[structured phases] fit shape: max|phase| = {max_structured_phase(x, op):.3f} rad; "
          f"large-phase case {big:.1f} rad (dense {big_dense:.1f} rad)", flush=True)
    del x_big

    # 4c. The structured kernels' generic path (d > 32) at the wide shape.
    xw = synthetic.gaussian_mixture(DATA_SEED, WIDE_N, K, WIDE_DIM, device=dev)
    sigma2_w = frequencies.estimate_sigma2(g_sig, xw[: cfg.sigma2_sample], device=dev)
    op_w = freq_ops.make_operator("structured", g_freq, WIDE_M, WIDE_DIM, sigma2_w, device=dev)
    check_slice2_kernels(fs, ft, xw, None, op_w, quantize.draw_dither(g_dither, WIDE_M),
                         "wide", WIDE_N // 3)
    section("kernel checks 3-5")

    # 4d. The decoder kernels.  sketch_shift at the decoder's swarm on the
    # fit's operator and sketch, at a ragged swarm and sketch, and on the
    # materialised wide structured operator (what the decoder scores a
    # structured fit through).
    lo_x, hi_x = torch.amin(x, 0), torch.amax(x, 0)

    def swarm(p_cand, lo, hi):
        return (lo + torch.rand((p_cand, lo.shape[0]), generator=gen, device=dev)
                * (hi - lo)).contiguous()

    def dense_sketch(xs, ws):
        c_s, s_s = fs.fourier_sketch_sums(xs, ws, ones[: xs.shape[0]])
        return torch.cat([c_s, -s_s]) / xs.shape[0]

    z_fit, op_fit, _, _ = ckm.compute_sketch(device_mod.derive_seed(FIT_SEED, 0), x, cfg,
                                             device=dev)
    results["sketch_shift"] = check_shift(ks, swarm(SHIFT_P, lo_x, hi_x), op_fit.w, z_fit,
                                          "decoder shape")
    w_r = frequencies.draw_frequencies(g_freq, RAGGED_M, DIM, sigma2, device=dev)
    check_shift(ks, swarm(RAGGED_P, lo_x, hi_x), w_r, dense_sketch(x[:RAGGED_N], w_r), "ragged")
    c_w, s_w = ft.structured_sketch_sums(xw, op_w.diags, op_w.radii, ones[:WIDE_N])
    z_w = torch.cat([c_w.reshape(-1)[:WIDE_M], -s_w.reshape(-1)[:WIDE_M]]) / WIDE_N
    wide = check_shift(ks, swarm(SHIFT_P, torch.amin(xw, 0), torch.amax(xw, 0)),
                       op_w.materialize().contiguous(), z_w, "wide structured")
    print(f"[sketch_shift wide structured] kernel {wide['ms']:.3f} ms against the plain "
          f"version's {wide['plain_ms']:.3f} ms ({wide['ms'] / wide['plain_ms']:.2f}x), bound "
          f"{wide['bound_ms']:.3f} ms", flush=True)
    del xw, c_w, s_w, z_w
    for p_s, n_s, m_s in SHIFT_SWEEP:
        xs = torch.randn((20_001, n_s), generator=gen, device=dev) * 2
        ws = torch.randn((n_s, m_s), generator=gen, device=dev) * 0.5
        check_shift(ks, swarm(p_s, torch.amin(xs, 0), torch.amax(xs, 0)), ws,
                    dense_sketch(xs, ws), f"sweep P={p_s} n={n_s}")
    del xs

    # amp_denoise at the decoder's shape (K estimates in the data's box), a
    # wide one across three variances, the deep tail and open boxes.
    r_k = (lo_x + (torch.rand((K, DIM), generator=gen, device=dev) * 1.4 - 0.2)
           * (hi_x - lo_x)).contiguous()
    results["amp_denoise"] = check_denoise(kd, r_k, 0.5, lo_x, hi_x, "decoder shape")
    r_w = torch.randn((256, 130), generator=gen, device=dev) * 4
    lo_w = -torch.abs(torch.randn((130,), generator=gen, device=dev)) - 0.1
    hi_w = torch.abs(torch.randn((130,), generator=gen, device=dev)) + 0.1
    for q in (1e-4, 0.5, 25.0):
        check_denoise(kd, r_w, q, lo_w, hi_w, "wide")
    tail = torch.tensor([[1e6] * 8, [-1e6] * 8, [50.0] * 8], device=dev)
    check_denoise(kd, tail, 1.0, -torch.ones(8, device=dev), torch.ones(8, device=dev),
                  "deep tail")
    inf = float("inf")
    check_denoise(kd, torch.tensor([[0.3, -2.0, 5.0, -5.0]], device=dev), 2.0,
                  torch.tensor([-inf, -1.0, -inf, -1.0], device=dev),
                  torch.tensor([inf, inf, 1.0, 1.0], device=dev), "open boxes")
    section("kernel checks 6-7")

    # 4e. The sweep of the sketch kernels' widths at small N: every template
    # instance and generic path of kernels 1-3, every case of the structured
    # switch of kernels 4-5; the bars of the main path's shapes.
    sweep_beta = torch.rand((SWEEP_N,), generator=gen, device=dev)
    sweep_dither = quantize.draw_dither(g_dither, SWEEP_M)
    for n_s in SWEEP_DENSE_NS:
        xs = torch.randn((SWEEP_N, n_s), generator=gen, device=dev) * 2
        ws = torch.randn((n_s, SWEEP_M), generator=gen, device=dev)
        check_sketch(fs, xs, ws, sweep_beta, f"sweep n={n_s}")
        cs = torch.randn((7, n_s), generator=gen, device=dev) * 2
        check_assign(aa, xs, cs, f"sweep n={n_s}")
        for bits in (1, 4):
            check_codes(
                "quantized_fourier_sketch", f"sweep n={n_s} {bits}bit",
                lambda lo, hi, b=bits: fs.quantized_fourier_sketch_sums(
                    xs[lo:hi], ws, sweep_dither, b),
                lambda lo, hi, b=bits: fs.quantized_fourier_sketch_sums_plain(
                    xs[lo:hi], ws, sweep_dither, b),
                SWEEP_N, SWEEP_N // 3, lambda: qsketch_bound(SWEEP_N, n_s, SWEEP_M),
            )
    xs = torch.randn((SWEEP_N, LARGE_PHASE_N), generator=gen, device=dev) * LARGE_PHASE_SCALE
    ws = torch.randn((LARGE_PHASE_N, SWEEP_M), generator=gen, device=dev)
    big = max_phase(xs, ws)
    check(1e3 <= big <= 1e5, f"large-phase case: max|x w| {big:.1f} outside [1e3, 1e5]")
    check_sketch(fs, xs, ws, sweep_beta, f"sweep large phases max|x w|={big:.1f}")
    for n_s in SWEEP_STRUCTURED_NS:
        xs = torch.randn((SWEEP_N, n_s), generator=gen, device=dev)
        d_s = max(32, 1 << (n_s - 1).bit_length())
        m_s = 3 * d_s - 5  # three blocks, the last one ragged
        op_s = freq_ops.make_operator("structured", g_freq, m_s, n_s, 1.0, device=dev)
        check(op_s.d == d_s, f"sweep n={n_s}: block width {op_s.d}, expected {d_s}")
        check_slice2_kernels(fs, ft, xs, None, op_s, quantize.draw_dither(g_dither, m_s),
                             f"sweep n={n_s}", SWEEP_N // 3)
    del xs
    section("sketch kernel sweeps")

    # 4f. Flash attention against its plain version: the edge cases, then
    # the model shapes (timed beside SDPA, which the port never calls).
    for bh, bkv, s_q, s_kv, hd, causal, window, dtype in FLASH_EDGES:
        q, k, v = (torch.randn((n_h, s, hd), generator=gen, device=dev).to(dtype)
                   for n_h, s in ((bh, s_q), (bkv, s_kv), (bkv, s_kv)))
        check_flash(fa, "edge", q, k, v, bh // bkv, causal, window)
    attention = {}
    for label, (b, s_a, h, kvh, hd, window, dtype) in ATTENTION_SHAPES.items():
        q4, k4, v4 = (torch.randn((b, s_a, n_h, hd), generator=gen, device=dev).to(dtype)
                      for n_h in (h, kvh, kvh))
        qf, kf, vf = (t.transpose(1, 2).reshape(-1, s_a, hd).contiguous() for t in (q4, k4, v4))
        r = check_flash(fa, label, qf, kf, vf, h // kvh, True, window, time_it=True,
                        q_chunk=PLAIN_Q_CHUNK)
        r["library_ms"], backend = sdpa_ms(qf, kf, vf, b, h, kvh, True, window)
        print(f"[flash_attention {label}] SDPA {r['library_ms']:.3f} ms ({backend}); kernel "
              f"{r['ms'] / r['library_ms']:.1f}x SDPA", flush=True)
        attention[label] = (q4, k4, v4, window, r.pop("o"))
        if label == "llama3.2-1b bf16":
            results["flash_attention"] = r
        del qf, kf, vf
    section("kernel checks 8")

    # 5-7. The main path, each phase with the launch counts it caused.
    counters = {
        "fourier_sketch": (fs, "LAUNCHES"),
        "assign_argmin": (aa, "LAUNCHES"),
        "quantized_fourier_sketch": (fs, "QUANTIZED_LAUNCHES"),
        "structured_sketch": (ft, "STRUCTURED_LAUNCHES"),
        "quantized_structured_sketch": (ft, "QUANTIZED_STRUCTURED_LAUNCHES"),
        "sketch_shift": (ks, "LAUNCHES"),
        "amp_denoise": (kd, "LAUNCHES"),
        "flash_attention": (fa, "LAUNCHES"),
        "fourier_sketch_fleet": (fs, "FLEET_LAUNCHES"),
        "quantized_fourier_sketch_fleet": (fs, "QUANTIZED_FLEET_LAUNCHES"),
    }
    launches = dict.fromkeys(counters, 0)
    phase_s, phase_counts = {}, {}

    def run(label, fn, needs):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = phase_s[label] = time.perf_counter() - t0
        counts = phase_counts[label] = {
            name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        for name, n_launch in counts.items():
            launches[name] += n_launch
        for need in (needs,) if isinstance(needs, str) else needs:
            check(counts[need] >= 1, f"{label} did not launch the {need} kernel")
        print(f"[{label}] {secs:.2f}s  launches {counts}", flush=True)
        return out

    res = run("fit", lambda: ckm.fit(FIT_SEED, x, cfg, device=dev), "fourier_sketch")
    check(tuple(res.centroids.shape) == (K, DIM), "fit centroids shape")
    check(bool(torch.isfinite(res.centroids).all()), "fit centroids finite")
    check(abs(float(res.weights.sum()) - 1.0) < 1e-4, "fit weights sum to 1")

    batches = torch.split(x, chunk)
    res_s = run(
        "fit_streaming",
        lambda: ckm.fit_streaming(FIT_SEED, iter(batches), cfg, device=dev),
        "fourier_sketch",
    )
    dz = float(torch.amax(torch.abs(res_s.sketch - res.sketch)))
    check(dz <= STREAM_TOL, f"|z_stream - z| {dz:.3e} > {STREAM_TOL}")
    check(bool(torch.isfinite(res_s.centroids).all()), "fit_streaming centroids finite")

    km = run(
        "kmeans",
        lambda: lloyd.kmeans(
            KMEANS_SEED, x, lloyd.LloydConfig(k=K, replicates=KMEANS_REPLICATES), device=dev
        ),
        "assign_argmin",
    )

    # 8. Quality.
    # The float32 SSEs themselves (9 significant digits name each exactly),
    # so that two runs show which side of a ratio moved.
    sse_ckm_raw, sse_km_raw = float(ckm.sse(x, res.centroids, device=dev)), float(km.sse)
    sse_ckm = sse_ckm_raw / N
    sse_stream = float(ckm.sse(x, res_s.centroids, device=dev)) / N
    sse_km = sse_km_raw / N
    rel = sse_ckm / sse_km
    print(
        f"[quality] SSE/N ckm {sse_ckm:.4f}  ckm-stream {sse_stream:.4f}  "
        f"kmeans x{KMEANS_REPLICATES} {sse_km:.4f} (iters {km.iters})  "
        f"relative SSE {rel:.4f} (stream {sse_stream / sse_km:.4f}, limit "
        f"{MAX_RELATIVE_SSE})  |z_stream - z|={dz:.2e} (tol {STREAM_TOL})  "
        f"sigma2={float(res.sigma2):.4f}  SSE ckm {sse_ckm_raw:.9g} kmeans "
        f"{sse_km_raw:.9g} ratio {rel:.9g}; before: {EARLIER_RELATIVE_SSE['fit']:.4f} "
        f"(stream {EARLIER_RELATIVE_SSE['fit_streaming']:.4f})",
        flush=True,
    )
    check(rel <= MAX_RELATIVE_SSE, f"relative SSE {rel:.4f} > {MAX_RELATIVE_SSE}")

    # 8b. The slice-2 paths (sketch kernels) and the slice-3 paths (decoder
    # kernels): each fit through its kernel, its sketch pass timed alone,
    # its SSE against k-means x5.
    slice2 = [
        ("fit-1bit", "quantized_fourier_sketch", False,
         dataclasses.replace(cfg, sketch_quantization="1bit")),
        ("fit-structured", "structured_sketch", True,
         dataclasses.replace(cfg, freq_op="structured")),
        ("fit-structured-1bit", "quantized_structured_sketch", False,
         dataclasses.replace(cfg, freq_op="structured", sketch_quantization="1bit")),
        ("fit-sketch_shift", "sketch_shift", False,
         dataclasses.replace(cfg, decoder="sketch_shift")),
        ("fit-amp", "amp_denoise", True, dataclasses.replace(cfg, decoder="amp")),
    ]
    slice2_res, path_cfg, pass_of, rel_of = {}, {"fit": cfg}, {}, {"fit": rel}
    for label, kernel, streaming, cfg2 in slice2:
        if streaming:
            r2 = run(label, lambda c=cfg2: ckm.fit_streaming(FIT_SEED, iter(batches), c,
                                                              device=dev), kernel)
            t0 = time.perf_counter()
            ckm.compute_sketch_streaming(FIT_SEED, iter(batches), cfg2, device=dev)
        else:
            r2 = run(label, lambda c=cfg2: ckm.fit(FIT_SEED, x, c, device=dev), kernel)
            t0 = time.perf_counter()
            ckm.compute_sketch(FIT_SEED, x, cfg2, device=dev)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        check(tuple(r2.centroids.shape) == (K, DIM), f"{label} centroids shape")
        check(bool(torch.isfinite(r2.centroids).all()), f"{label} centroids finite")
        check(abs(float(r2.weights.sum()) - 1.0) < 1e-4, f"{label} weights sum to 1")
        slice2_res[label], path_cfg[label], pass_of[label] = r2, cfg2, pass_s
        sse2_raw = float(ckm.sse(x, r2.centroids, device=dev))
        rel2 = rel_of[label] = sse2_raw / N / sse_km
        print(
            f"[{label} quality] sketch pass {pass_s:.3f}s, decode "
            f"{phase_s[label] - pass_s:.2f}s; SSE/N {rel2 * sse_km:.4f}, relative SSE "
            f"{rel2:.4f} (limit {MAX_RELATIVE_SSE}; before {EARLIER_RELATIVE_SSE[label]:.4f}); "
            f"SSE ckm {sse2_raw:.9g} kmeans {sse_km_raw:.9g} ratio {rel2:.9g}",
            flush=True,
        )
        check(rel2 <= MAX_RELATIVE_SSE, f"{label}: relative SSE {rel2:.4f} > {MAX_RELATIVE_SSE}")

    # Every fit, telemetry off, against its relative SSE on 227003f.
    rel_now = {**rel_of, "fit_streaming": sse_stream / sse_km}
    kept = {label: f"{rel_now[label]:.4f}" == f"{EARLIER_RELATIVE_SSE[label]:.4f}"
            for label in EARLIER_RELATIVE_SSE}
    print(f"[quality as on 227003f] the same 4 digits as before: {kept}", flush=True)
    section("fits")

    # 8c. Each decoder's decode with its loops eager, against a graphed
    # decode of the same sketch and depth (sketch_shift and CL-AMP at full
    # depth, against the fit's own decode; CLOMPR at RE_DECODE_STEPS): the
    # same bits (or, where they differ, the same relative SSE to 4 digits),
    # the same launches of the decoder kernels, and both decode times.
    t0 = time.perf_counter()
    ckm.compute_sketch(FIT_SEED, x, cfg, device=dev)
    torch.cuda.synchronize()
    pass_of["fit"] = time.perf_counter() - t0
    fit_res = {"fit": res, **slice2_res}
    print(
        f"[fit vs kmeans] fit {phase_s['fit']:.2f}s (sketch pass {pass_of['fit']:.3f}s, graphed "
        f"decode {phase_s['fit'] - pass_of['fit']:.2f}s) against kmeans x{KMEANS_REPLICATES} "
        f"{phase_s['kmeans']:.2f}s: fit is {phase_s['kmeans'] / phase_s['fit']:.2f}x faster",
        flush=True,
    )
    def counted_decode(r, dcfg, eager):
        """A decode of ``r``'s sketch: (out, seconds, launch counts)."""
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        out = ckm.decode_sketch(device_mod.derive_seed(FIT_SEED, 1), r.sketch, r.freq_op,
                                *r.bounds, dcfg, device=dev, eager=eager)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return out, secs, {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

    for label in ("fit", "fit-structured", "fit-sketch_shift", "fit-amp"):
        r, dcfg = fit_res[label], path_cfg[label]
        if dcfg.decoder == "clompr":
            # CLOMPR's eager decode is the slow one (tens of seconds at full
            # depth): both sides run at RE_DECODE_STEPS, every round of the
            # decode kept.
            dcfg = dataclasses.replace(dcfg, **RE_DECODE_STEPS)
            graphed, g_secs, g_counts = counted_decode(r, dcfg, False)
            rel_g = float(ckm.sse(x, graphed[0], device=dev)) / N / sse_km
            depth = "at {atom_steps}/{joint_steps}/{final_steps} steps, ".format(**RE_DECODE_STEPS)
        else:
            graphed, g_counts = (r.centroids, r.weights, r.cost), phase_counts[label]
            g_secs, rel_g, depth = phase_s[label] - pass_of[label], rel_of[label], "full depth, "
        out, secs, counts = counted_decode(r, dcfg, True)
        same = all(torch.equal(a, b) for a, b in zip(out, graphed))
        rel_e = float(ckm.sse(x, out[0], device=dev)) / N / sse_km
        print(
            f"[{label} eager decode] {depth}{secs:.2f}s against the graphed {g_secs:.2f}s "
            f"({g_secs / secs:.3f} of it); bitwise equal to the graphed decode: {same}; "
            f"relative SSE eager {rel_e:.4f}, graphed {rel_g:.4f}; decoder-kernel launches "
            f"eager {counts['sketch_shift']}/{counts['amp_denoise']}, graphed "
            f"{g_counts['sketch_shift']}/{g_counts['amp_denoise']} (sketch_shift/amp_denoise)",
            flush=True,
        )
        check(same or f"{rel_e:.4f}" == f"{rel_g:.4f}",
              f"{label}: the eager decode's relative SSE {rel_e:.4f} differs from the graphed "
              f"{rel_g:.4f}")
        for name in ("sketch_shift", "amp_denoise"):
            check(counts[name] == g_counts[name],
                  f"{label}: {name} launched {counts[name]} times eager, {g_counts[name]} graphed")

    # 9. Where a decode's time goes: short decodes, eager then graphed, each
    # timed alone and then once more under the profiler for its device time
    # and operations (the profiler's own host cost inflates a profiled wall
    # time, so the busy share is the device time over the unprofiled wall).
    # CLOMPR's are SHORT_CLOMPR_STEPS deep: the profiler's processing of
    # their ~10^5 device operations a run costs the host far more than the
    # decodes themselves.
    section("eager decodes")
    short = dataclasses.replace(cfg, **SHORT_CLOMPR_STEPS)
    adam_steps = 2 * K * (short.atom_steps + short.joint_steps) + short.final_steps
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def decode_once(r, short_cfg, eager):
        graphs.CAPTURES = graphs.REPLAYS = 0
        t0 = time.perf_counter()
        out = ckm.decode_sketch(FIT_SEED, r.sketch, r.freq_op, *r.bounds, short_cfg,
                                device=dev, eager=eager)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (graphs.CAPTURES, graphs.REPLAYS)

    def short_decode(label, r, short_cfg, n_units, unit):
        """A short decode of ``r``'s sketch, eager then graphed: wall
        seconds, device-busy seconds and device operations per ``unit``
        (``n_units`` of them in the decode); the two must give the same
        bits (or the same relative SSE to 4 digits).  Returns the graphed
        run's device operations by name: (launches, device microseconds)."""
        runs, parts = {}, []
        for eager in (True, False):
            out, wall, (caps, reps) = decode_once(r, short_cfg, eager)
            t_prof = time.perf_counter()
            with torch.profiler.profile(activities=activities) as prof:
                out_p, wall_p, _ = decode_once(r, short_cfg, eager)
            check(all(torch.equal(a, b) for a, b in zip(out, out_p)),
                  f"{label}: a repeated short decode differs")
            device_ops = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
            t_prof = time.perf_counter() - t_prof - wall_p
            busy = sum(e.self_device_time_total for e in device_ops) / 1e6
            n_ops = sum(e.count for e in device_ops)
            runs[eager] = (out, wall, busy)
            by_name = {e.key: (e.count, e.self_device_time_total) for e in device_ops}
            parts.append(
                f"{'eager' if eager else 'graphed'} wall {wall:.3f}s (profiled {wall_p:.3f}s, "
                f"then {t_prof:.1f}s of the profiler's processing), "
                f"device busy {busy:.3f}s ({100 * busy / wall:.1f}%), {n_ops} device "
                f"operations, {n_ops / n_units:.1f} per {unit}"
                + ("" if eager else f", {caps} captures, {reps} replays")
                + ("" if busy else " (the profiler saw no device time: busy share not measured)")
            )
        (out_e, wall_e, _), (out_g, wall_g, busy_g) = runs[True], runs[False]
        same = all(torch.equal(a, b) for a, b in zip(out_e, out_g))
        rel_e, rel_g = (float(ckm.sse(x, o[0], device=dev)) / N / sse_km for o in (out_e, out_g))
        print(
            f"[{label} time] short decode ({n_units} {unit}s): {'; '.join(parts)}; graphed/eager "
            f"wall {wall_g / wall_e:.3f}; bitwise equal: {same} (relative SSE {rel_e:.4f} / "
            f"{rel_g:.4f})",
            flush=True,
        )
        check(same or f"{rel_e:.4f}" == f"{rel_g:.4f}",
              f"{label}: short decodes differ (relative SSE {rel_e:.4f} / {rel_g:.4f})")
        check(wall_g <= GRAPHED_WALL_SHARE * wall_e,
              f"{label}: graphed short decode {wall_g:.3f}s, over {GRAPHED_WALL_SHARE} of the "
              f"eager {wall_e:.3f}s")
        check(busy_g >= GRAPHED_MIN_BUSY * wall_g,
              f"{label}: device busy {busy_g:.3f}s of a graphed {wall_g:.3f}s")
        return by_name

    def in_graph(name, by_name, symbols):
        """Kernel ``name``'s device time per launch inside the graphed short
        decode, its kernels matched by symbol (the first one counts the
        launches and must be there; a second pass kernel may not run),
        beside its wrapper-timed ms from step 4."""
        found = [[(c, us) for key, (c, us) in by_name.items() if sym in key] for sym in symbols]
        check(bool(found[0]), f"{name}: the profiler saw no {symbols[0]} in the graphs")
        launches_g = sum(c for c, _ in found[0])
        total_us = sum(us for hits in found for _, us in hits)
        parts = ", ".join(f"{sym} {sum(us for _, us in hits) / launches_g:.2f}" if hits
                          else f"{sym} not launched" for sym, hits in zip(symbols, found))
        print(f"[{name} in graph] {launches_g} launches, {total_us / launches_g:.2f} us of device "
              f"time per launch ({parts}); wrapper-timed {results[name]['ms'] * 1e3:.2f} us "
              "(step 4, host included)", flush=True)

    short_decode("fit", res, short, adam_steps, "Adam step")
    short_decode("fit-structured", slice2_res["fit-structured"], short, adam_steps, "Adam step")
    # The decoders' loops alone (no polish): K rounds of mean-shift steps
    # (plus one harvest score a round, NNLS and deflation), and GAMP
    # iterations (each with its inner NNLS weight refresh).
    short_ss = dataclasses.replace(cfg, decoder="sketch_shift", shift_steps=30,
                                   shift_polish_steps=0)
    by_name = short_decode("fit-sketch_shift", slice2_res["fit-sketch_shift"], short_ss, K * 30,
                           "mean-shift step")
    in_graph("sketch_shift", by_name, ("shift_cluster",))
    short_amp = dataclasses.replace(cfg, decoder="amp", amp_iters=30, amp_polish_steps=0)
    by_name = short_decode("fit-amp", slice2_res["fit-amp"], short_amp, 30, "GAMP iteration")
    in_graph("amp_denoise", by_name, ("amp_denoise_kernel",))
    floor_us, floor_graph_us = launch_floor(dev)
    print(f"[launch floor] an empty kernel (torch.cuda._sleep(0)) in a CUDA graph: "
          f"{floor_us:.2f} us of device time per launch, {floor_graph_us:.2f} us per launch "
          "with the gaps (CUDA events over the replay); beside amp_denoise's in-graph time "
          "above", flush=True)
    section("short decodes")

    # 9b. The attention entry point (ops.flash_attention, the reference's
    # (B, S, H, hd) layout) at the model shapes: the same bits as the kernel
    # checked above on the same inputs.
    outs = run(
        "attention",
        lambda: {label: ops.flash_attention(q4, k4, v4, causal=True, window=window)
                 for label, (q4, k4, v4, window, _) in attention.items()},
        "flash_attention",
    )
    for label, (q4, _, _, _, o_kernel) in attention.items():
        b, s_a, h, hd = q4.shape
        want = o_kernel.reshape(b, h, s_a, hd).transpose(1, 2).reshape(b, s_a, h * hd)
        check(outs[label].dtype == q4.dtype and torch.equal(outs[label], want),
              f"attention {label}: the entry point differs from the checked kernel")
    print(f"[attention] {len(outs)} shapes through ops.flash_attention: the checked kernel's "
          "bits", flush=True)
    del outs, attention

    # 9c. The streaming layer: host-fed streams, decayed states, the window,
    # telemetry and the decoders' convergence traces.
    t0 = time.perf_counter()
    streaming_phases(dev, run, cfg, path_cfg, x, batches, fit_res)
    print(f"[streaming] {time.perf_counter() - t0:.1f}s", flush=True)

    # 9d. Async ingest of batches already on the card, and the fleet.
    t0 = time.perf_counter()
    stream_device_phase(dev, run, cfg, batches)
    print(f"[stream-device] {time.perf_counter() - t0:.1f}s", flush=True)
    fleet_phases(dev, run, cfg, res.sigma2, results)
    mesh_fleet = fleet_mesh_phases(dev, run, cfg, res.sigma2)

    # 9e. The fleet's service (also over the tenant mesh), and ckm.diagnose
    # at N = 10^7.
    serve_phases(dev, run, cfg, res.sigma2)
    serve_mesh_phases(dev, run, cfg, res.sigma2, mesh_fleet)
    del mesh_fleet
    diagnose_phases(dev, run, cfg, x, res)

    # 9f. The sharded backend: NCCL at one rank, then gloo ranks on the card.
    sharded_phases(dev, run, launches, cfg, x, batches, fit_res)

    # 9g. The port's three sketch examples at their default sizes.
    examples_phase(dev, run)

    # 9h. The LM serving path of every family at its published width, the
    # CKM-compressed KV cache on gemma3-1B's global layers, and jamba's
    # compressed long-context cache.
    for arch, (lm_batch, prompt, check_prompt, depth) in LM_SERVE.items():
        served = lm_serve_phase(dev, run, phase_counts, arch, lm_batch, prompt, check_prompt,
                                depth, keep=arch in ("gemma3-1b", LONG_CONTEXT_ARCH))
        if arch == "gemma3-1b":
            kv_ckm_phase(dev, run, served)
        elif arch == LONG_CONTEXT_ARCH:
            long_context_phase(dev, run, phase_counts, served)
        del served
        torch.cuda.empty_cache()

    # 9i. The LM's training path at llama3.2-1B width, and the restart
    # invariant at its smoke config.
    lm_train_phase(dev, run)
    lm_restart_phase(dev, run)

    # 10. Per-kernel numbers.
    meta = {
        "fourier_sketch": ("src/repro_torch/kernels/csrc/fourier_sketch.cu",
                           "src/repro/kernels/fourier_sketch.py:131"),
        "assign_argmin": ("src/repro_torch/kernels/csrc/assign_argmin.cu",
                          "src/repro/kernels/assign_argmin.py:35"),
        "quantized_fourier_sketch": ("src/repro_torch/kernels/csrc/quantized_fourier_sketch.cu",
                                     "src/repro/kernels/fourier_sketch.py:88"),
        "structured_sketch": ("src/repro_torch/kernels/csrc/structured_sketch.cu",
                              "src/repro/kernels/freq_transform.py:181"),
        "quantized_structured_sketch": ("src/repro_torch/kernels/csrc/structured_sketch.cu",
                                        "src/repro/kernels/freq_transform.py:217"),
        "sketch_shift": ("src/repro_torch/kernels/csrc/sketch_shift.cu",
                         "src/repro/kernels/sketch_shift.py:67"),
        "amp_denoise": ("src/repro_torch/kernels/csrc/amp_denoise.cu",
                        "src/repro/kernels/amp_denoise.py:79"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:83"),
        "fourier_sketch_fleet": ("src/repro_torch/kernels/csrc/fourier_sketch.cu",
                                 "src/repro/core/fleet.py:450"),
        "quantized_fourier_sketch_fleet": (
            "src/repro_torch/kernels/csrc/quantized_fourier_sketch.cu",
            "src/repro/core/fleet.py:481"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        })
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"[smoke] total wall time {time.perf_counter() - smoke_t0:.1f}s", flush=True)

    # 11. The device line.
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
