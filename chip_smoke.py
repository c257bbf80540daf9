"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py      (the script also finds src/ itself)

Phases, one line each: the card's name and power limit; the kernels' build
(nvcc, one process per source, all started together, into build/kernels/);
the data (the paper's large-scale setting: N = 10^7 points of a 10-cluster
Gaussian mixture in R^10, m = 1000 frequencies); each kernel held against its
plain PyTorch version at the main path's shapes and at ragged ones (the
quantized and structured kernels also for bitwise repeatability over two
launches and, for integer sums, exact split invariance), and the structured
kernels again at the wide shape n = d = 2048, m = 20,000 and at the
monitor's wide blocks (``wide_block_checks``: kernel 4 at d = 4096 and
16384 on 20,001 rows, kernels 4-5 at 8192 on 200,003 rows, 4f-5f at 8192);
the decoder kernels (sketch_shift's score step at the decoder's swarm, a
ragged and the wide shape, with the plain version's time beside the wide
one, and at n = 3, 40, 64 and 100; amp_denoise at the decoder's shape, a
wide one, the deep tail, open boxes, the collapse at Z <= 1e-12 and NaN
pseudo-data); the sweep of the sketch kernels' widths at
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
graphs and the graphed GAMP iteration's, beside an empty kernel's in a
graph); the attention
entry point (ops.flash_attention) at the three model shapes, with its launch
counts; the streaming layer (``streaming_phases``): N points made on the host
as numpy and streamed by fit_streaming in 10 and 100 batches, sync and async
(pinned buffers and a side stream), float and 1-bit, with the bits compared,
the walls, the ingest stats and the peak device memory; decayed states and a
SketchWindow over 100 ticks; telemetry on and off; the decoders' convergence
traces, graphed and eager (CLOMPR's at a fifth of the default steps); async ingest of the batches already on the card
(``stream_device_phase``: no pinned slot, the sync bits); the fleet
(``fleet_phases``: 1024 tenants at m = 1000, float, 1-bit and decayed,
routed requests, a fleet window, four decoded tenants, a structured fleet of
the same 1024 tenants, one launch an update), with the tenant-axis entries
of kernels 1, 3, 4 and 5 held bitwise to T single launches and to their
plain versions (kernels 4-5 also at d = 32 past the first-stage skip, d =
64 and d = 2048, few tenants, ragged B, 1 and 4 bits); the fleet's service
(``serve_phases``:
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
weights), the same loop for five more families at published width with
each published config's default optimizer (granite-moe at 4 x 4096,
whisper-small at 4 x 448 beside 1500 frames, xlstm-125m at 4 x 512,
jamba at its first 4 layers, 1 x 512, Adafactor, and internvl2 at 4 of 48
layers, 256 patches + 3840 tokens; two steps each, the checkpoint deleted),
the activation monitor at d_model 4096, 6144 and 12288
(``monitor_wide_phase``: updates through kernel 4's wide blocks against
the plain version, and kernel 4 at the monitor's default K = 8 at 12288,
24 blocks, on an operator drawn on the card) and the restart invariant at
its smoke config
(``lm_restart_phase``: six steps straight against three, a restart and
three); the LM on a mesh (``lm_mesh_phases``: an NCCL group of one rank on
a (1, 1) mesh, llama3.2-1B's train steps, prefill and decode bitwise the
mesh=None run at full width and depth and the train loop bitwise the
one-card loop; four gloo rank processes on the card (``_lm_mesh_rank``,
every collective through the host), a (2, 2) data x model mesh, llama3.2-1B
and granite-moe at full width cut to 2 layers, a train step (its loss,
the gradients the optimizer took and the parameters after it) and a
prefill with 8 decode tokens each against the one-card run, the compressed
train step over (2, 2) pod x data against the plain one (the exchanged
gradient in int16 steps, the pods' parameters equal), and GPipe over 4 stages
of one full-width layer against the stages in turn); one JSON line of
per-kernel numbers,
the total wall time and, last, the device line.  Any failed check raises and the script exits non-zero
before the last line.  Without a CUDA card it exits non-zero and prints no
result."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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
# Kernels 4-5 at the activation monitor's wide blocks (d_model > 2048): (n,
# m) of d = 4096 (jamba's d_model, two blocks), 8192 (internvl2's, two
# blocks: kernel 5 at 1 and 4 bits, and the fleet entries 4f-5f at
# WIDE_BLOCK_FLEET tenants of a ragged B) and 16384 (mistral-large's, one
# block), the last block ragged, on WIDE_BLOCK_N standard normal rows (the
# sweep's N); kernels 4-5 at d = 8192 on WIDE_CODES_N rows: at this width
# the kernel's and the plain version's float32 phases round apart by more
# (3 x 13 levels of values of size ||x|| ~ 78), so an entry may take a few
# boundary flips, and at 20,001 rows two of them (4 / N) pass CODE_TOL.
WIDE_BLOCKS = ((4096, 2 * 4096 - 5), (6144, 2 * 8192 - 5), (12288, 16384 - 5))
WIDE_BLOCK_N, WIDE_CODES_N = 20_001, 200_003
WIDE_BLOCK_FLEET = (3, 333)
WIDE_BLOCK_SEED = 31
# [monitor wide]: ActivationMonitor.update at these (d_model, m) (kernel 4
# at d = 4096, 8192 and 16384), K = MONITOR_WIDE_K, MONITOR_WIDE_UPDATES
# updates of LM_TRAIN's B pooled rows.  m = None is the monitor's 4 K
# d_model; at 12288 that is 12 blocks, whose draw (on the host, a CPU
# generator, summed in chunks: under 5 GB of peak RSS) takes ~27 s on the
# chip machine's host (monitor_draw), so 12288 takes 3 blocks for the
# smoke's clock.
MONITOR_WIDE = ((4096, None), (6144, None), (12288, 3 * 16384))
MONITOR_WIDE_K, MONITOR_WIDE_UPDATES = 4, 3
# Kernel 4 at the monitor's default shape at the widest d_model: K = 8 (m =
# 4 K d_model = 393,216, 24 blocks of 16384), LM_TRAIN's B rows, on an
# operator drawn on the card.
MONITOR_DEFAULT = (12288, 8)
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

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit), kept in
# one place: the dry run's roofline.
from repro_torch.utils.roofline import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.utils.roofline import PEAK_FLOPS as PEAK_BF16_FLOP_PER_S  # noqa: E402
from repro_torch.utils.roofline import PEAK_FP32_FLOPS as PEAK_FP32_FLOP_PER_S  # noqa: E402

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
# The structured chain's float32 phase: a rounding of PHASE_ULP of a value of
# size radius ||x||_2 at each of its 3 log2(d) butterfly levels and two
# scalings.  A column whose phases that leaves uncertain beyond
# UNDETERMINED_RAD at some row (a tiny restricted norm, so a huge radius:
# a few of the fleet's 1024 operators have one) has no float32 value to
# hold two evaluations to; there the fleet checks count each row's
# uncertainty, elsewhere they keep the bars above.
PHASE_ULP = 2.0 ** -24
UNDETERMINED_RAD = 1e-3
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
# structured fleet of the same FLEET_T tenants (the tenant-axis entries of
# kernels 4-5), and those entries also at the other instances of kernels
# 4-5, (n, m, T, B) with a ragged B: d = 32 past the first-stage skip
# (NX = 32), d = 64, and d = 2048 (two-warp rows).
FLEET_T, FLEET_B, FLEET_UPDATES = 1024, 1000, 4
FLEET_REQUESTS, FLEET_REQUEST_ROWS = 4096, 256
FLEET_WINDOW, FLEET_WINDOW_TICKS, FLEET_DECAY_TICKS = 4, 8, 10
FLEET_DECODES, FLEET_SEED = 4, 5
FLEET_STRUCTURED_SHAPES = ((20, 1000, 8, 1001), (40, 1000, 8, 777), (2048, 20_000, 3, 333))
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
# The other families' training ([lm-train <arch>]): LM_TRAIN's loop (bf16
# compute, remat "full", the monitor at K = 4 through kernel 4 at the
# family's d_model, the balancer every 2 steps through kernel 1) at the
# published width for LM_TRAIN_FAMILY_STEPS steps, with the published
# config's default optimizer and parameter dtype (Adafactor for jamba, AdamW
# elsewhere; float32 parameters: only kimi-k2's default is bf16), the first
# loss held to float32 at LM_TRAIN_LOSS_RTOL.  (batch, sequence, depth;
# None = every layer): whisper's 448 tokens beside its 1500 frames (as
# [lm-serve]), internvl2's 4096 positions 256 patches and 3840 tokens.  The
# cuts, in LM_TRAIN_CUTS, are forced by memory or the clock: jamba's 4
# layers are all past its last whole period of 8, so they run without remat
# (as the reference's), and at S = 1024 its three Mamba layers' scan
# products (~15 GB each) beside 27.5 GB of float32 parameters and the MoE's
# bf16 weight copies ran the card out of memory.  kimi-k2 stays
# off the card: one of its 61 layers is ~19.4 B parameters, whose bf16
# parameters and gradients alone take 77.6 GB of the 80.  gemma3-1b,
# smollm-360m and mistral-large are the dense family [lm-train llama3.2-1b]
# runs.  The restored checkpoint is compared bitwise for llama3.2-1b only;
# these phases delete theirs.
LM_TRAIN_FAMILIES = {
    "granite-moe-1b-a400m": (4, 4096, None),
    "whisper-small": (4, 448, None),
    "xlstm-125m": (4, 512, None),
    "jamba-v0.1-52b": (1, 512, 4),
    "internvl2-26b": (1, 4096, 4),
}
LM_TRAIN_CUTS = {
    "xlstm-125m": "S cut from 4096 to 512 for the clock: sLSTM's time loop runs on the host, "
                  "~12 s a remat step at 512, ~8x that at 4096",
    "jamba-v0.1-52b": "cut to layers 0-3 (three Mamba layers and the attention at 3; dense, MoE, "
                      "dense, MoE MLPs) for memory: a period of 8 is ~13 B parameters, ~107 GB of "
                      "float32 parameters and gradients; S cut from 1024 to 512, where the step "
                      "ran out of memory: layers past the last whole period run without remat, "
                      "and each Mamba layer keeps ~14.6 MB of float32 scan products a position",
    "internvl2-26b": "cut to 4 of 48 layers for memory: 26 B parameters x 16 B of AdamW state",
}
LM_TRAIN_FAMILY_STEPS = 2
LM_RESTART_STEPS, LM_RESTART_RTOL = 6, 1e-4
# [dryrun] (in [lm-train llama3.2-1b], after its checkpoint): the train step
# at LM_TRAIN's shape costed by utils.hlo on fake CUDA and fake CPU tensors
# and on the card, then timed DRYRUN_TIMED_STEPS times by CUDA events; and
# the dry run's CLI on DRYRUN_ARCH at DRYRUN_CELLS on the 16 x 16 mesh (a
# process each, started first, on the host), held to tests/test_dryrun.py's
# invariants with the card's DRYRUN_CARD_BYTES in place of the v5e's 16 GB;
# prefill_32k's attention split over query heads (useful_ratio above
# DRYRUN_PREFILL_USEFUL) and decode_32k's vocab-parallel serve (collective
# bytes a device at most DRYRUN_DECODE_COLL_BYTES).
DRYRUN_ARCH, DRYRUN_CELLS = "llama3.2-1b", ("train_4k", "decode_32k", "prefill_32k")
DRYRUN_PREFILL_USEFUL, DRYRUN_DECODE_COLL_BYTES = 0.3, 3.5e7
DRYRUN_TIMED_STEPS, DRYRUN_CARD_BYTES, DRYRUN_TIMEOUT_S = 2, 80 * 2**30, 150

# The LM on a mesh (parallel/sharding.py, models/ with mesh=, launch/train.py
# and launch/serve.py over a DeviceMesh, optim/grad_compression.py,
# parallel/pipeline.py, train/train_loop.py with mesh=).  [lm-mesh p=1]: an
# NCCL group of one rank, a (1, 1) ("data", "model") mesh; LM_TRAIN's
# llama3.2-1B at full width and depth (B = 4, S = 4096, bf16, AdamW, remat
# "full"): one train step on the mesh against the mesh=None step (loss and
# parameters bitwise), a prefill of the same prompt and LM_MESH_DECODE
# tokens (logits bitwise), and the train loop on the mesh against one card
# at the smoke config (monitor and balancer on: kernel 1).  [lm-mesh p=4]:
# LM_MESH_RANKS gloo processes on the one card (every collective through the
# host), a (2, 2) ("data", "model") mesh: llama3.2-1B, granite-moe and
# internvl2-26B (d_model 6144: its residual stream sequence-parallel, each
# rank's half of the sequence, which remat saves) at full width cut to
# LM_MESH_LAYERS layers (granite at the no-drop capacity E / k) at B = 4,
# S = LM_MESH_SEQ (internvl2's 256 patches included), float32: one train
# step and a prefill plus LM_MESH_DECODE tokens (internvl2:
# LM_MESH_WIDE_DECODE) each against the one-card run on the same rows, and
# gemma3-1B (its one KV head: the prefill's attention split over query
# heads, the cache made by one all-to-all a layer) at full width cut to
# LM_MESH_GROUPED_LAYERS layers, the prefill and decode alone (rank 0 runs
# the one-card runs): loss within LM_MESH_LOSS_RTOL relative, the gradients
# the optimizer took (after the step's collectives, gathered) and the
# parameters after the step within LM_MESH_LEAF_TOL of each leaf's max-abs,
# logits within LM_ATOL / LM_RTOL.  Granite's aux term on the mesh is each
# data shard's own, as on the reference's devices: the one-card objective
# is the cross-entropy over all rows plus the mean of the shards' aux terms
# (its gradient), and the loss compared takes shard 0's (rank 0's value).
# build_compressed_train_step on a (2, 2) ("pod", "data") mesh against the
# plain step on the same mesh (LM_MESH_COMPRESSED at full width, cut to
# LM_MESH_LAYERS layers, S = LM_MESH_PIPE_SEQ: a dense model whose 0.19 GB
# embedding keeps gloo's host round trips short): the exchanged mean
# gradient within one int16 step of the plain step's (a leaf's step: the
# larger pod gradient's max-abs, from one card, over 2^13), the pods'
# parameters after the step equal; pipeline_apply over 4
# stages of one full-width llama3.2-1B layer each against the stages in
# turn.  Each rank process and its collectives give up after
# LM_MESH_TIMEOUT_S.
LM_MESH_RANKS, LM_MESH_LAYERS, LM_MESH_SEQ, LM_MESH_DECODE = 4, 2, 1024, 8
LM_MESH_WIDE_DECODE, LM_MESH_GROUPED_LAYERS = 2, 6
# (arch, whether a train step runs, decode tokens' size key, optimizer) of
# [lm-mesh p=4]: internvl2's step takes SGD, since AdamW's two float32
# moments of its 1.9 B parameters (6.1 GB a rank) do not fit four ranks on
# one card beside its gathered 92,553-row table and head and their
# gradients (the first try ran out of the card's memory).
LM_MESH_CASES = (("llama3.2-1b", True, "decode", "adamw"),
                 ("granite-moe-1b-a400m", True, "decode", "adamw"),
                 ("internvl2-26b", True, "wide_decode", "sgd"),
                 ("gemma3-1b", False, "decode", "adamw"))
LM_MESH_PIPE_SEQ, LM_MESH_MICRO, LM_MESH_TIMEOUT_S = 256, 8, 600
LM_MESH_LOSS_RTOL, LM_MESH_LEAF_TOL = 1e-5, 1e-4
LM_MESH_COMPRESSED = "smollm-360m"
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


def structured_bound(n_pts: int, n: int, d: int, nblocks: int, quantized: bool,
                     tenants: int = 1):
    # Per (point, frequency) of the (nblocks, d) output: three stages of a
    # sign multiply, the butterfly's log2(d) adds and a scale multiply, then
    # the radius multiply (1), sin and cos (2), and either two weighted FMA
    # accumulates (4) or the dither add, two codes and two integer adds (5).
    # Bytes: x (unpadded), the signs, radii (and dither) read once, beta read
    # once on the float path, the two outputs written once.  A fleet entry
    # does that for each of ``tenants`` operators, n_pts rows each.
    width = nblocks * d
    per = 3 * (2 + d.bit_length() - 1) + (8 if quantized else 7)
    if quantized:
        n_bytes = 4 * (n_pts * n + 5 * width) + 8 * width
    else:
        n_bytes = 4 * (n_pts * n + 4 * width + n_pts) + 8 * width
    return bound(tenants * n_bytes, tenants * n_pts * width * per)


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
    """``d/mode/NX[/fleet]: registers, spill stores`` of each instance of
    the structured kernels in a ptxas report (``NX=wide``: the wide kernel)."""
    out = []
    for chunk in log.split("Compiling entry function")[1:]:
        name = chunk.split("'")[1]
        kind = next((k for k in ("structuredILi", "structured_wideILi") if k in name), None)
        if kind is None:
            continue
        args = name.split(kind)[1].split("EE")[0]
        args, fleet = args.split("ELb")
        d, mode, nx = args.split("ELi") if kind == "structuredILi" else (*args.split("ELi"), "wide")
        regs = chunk.split("Used ")[1].split(" registers")[0]
        spill = chunk.split(" bytes spill stores")[0].split(",")[-1].strip()
        out.append(f"d={d}/{_MODES[mode]}/NX={nx}{'/fleet' if fleet == '1' else ''}: "
                   f"{regs} registers, {spill} B spilled")
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


def check_structured(ft, x, op, beta, label, chain=False):
    """structured_sketch kernel vs its plain version on the card; with
    ``chain``, each undetermined column (``chain_uncertainty``) within its
    rows' uncertainty besides (``chain_slack``)."""
    n_pts = x.shape[0]
    args = (op.diags, op.radii, beta)
    c1, s1 = ft.structured_sketch_sums(x, *args)
    c2, s2 = ft.structured_sketch_sums(x, *args)
    torch.cuda.synchronize()
    pc, ps = ft.structured_sketch_sums_plain(x, *args)
    diff = torch.maximum((c1 - pc).abs(), (s1 - ps).abs()).reshape(1, -1).double()
    und, slack = (chain_slack(x[None], op.radii[None], beta[None]) if chain
                  else (torch.zeros_like(diff, dtype=torch.bool), torch.zeros_like(diff)))
    err = float(diff[~und].max()) / n_pts
    und_err = float(diff[und].max()) / n_pts if bool(und.any()) else 0.0
    check(bool((diff <= SKETCH_TOL * n_pts + slack).all()),
          f"structured_sketch {label}: max|d(sums/N)| {err:.3e} > {SKETCH_TOL}, at "
          f"undetermined columns {und_err:.3e}")
    check(torch.equal(c1, c2) and torch.equal(s1, s2),
          f"structured_sketch {label}: two launches differ bitwise")
    line = (
        f"[structured_sketch {label}] N={n_pts} n={x.shape[1]} d={op.d} m={op.m} "
        f"max|d(sums/N)|={err:.3e} (tol {SKETCH_TOL}) bitwise-repeatable"
        + (f"; {int(und.sum())} undetermined columns within their rows' uncertainty, "
           f"max|d(sums/N)| there {und_err:.3e}" if chain else "")
    )
    return _timed(
        {"max_abs_err": err},
        lambda: ft.structured_sketch_sums(x, *args),
        lambda: ft.structured_sketch_sums_plain(x, *args),
        lambda: structured_bound(n_pts, x.shape[1], op.d, op.nblocks, False),
        line,
    )


def check_slice2_kernels(fs, ft, x, w, op, dither, label, split_at, results=None, chain=False):
    """Kernels 3-5 at one shape: kernel 3 at 1 and 4 bits (skipped when
    ``w`` is None), kernel 4, and kernel 5 at 1 and 4 bits.  The 1-bit
    numbers go to ``results`` when given.  ``chain``: the structured checks
    count the operator's undetermined columns (``chain_uncertainty``)."""
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
        ft, x, op, torch.ones((n_pts,), dtype=torch.float32, device=x.device), label, chain
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
                f"quantized_structured_sketch {label} d={op.d} 1bit", x, op, padded, got, ref,
                chain))
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
    units of each moment; finite moments inside their bounds, except the
    mean of a NaN pseudo-datum, which is NaN as the plain version's is."""
    qt = torch.tensor(q, dtype=torch.float32, device=r.device)
    mean, var = kd.amp_denoise(r, qt, lo, hi)
    torch.cuda.synchronize()
    pm, pv = kd.amp_denoise_plain(r, qt, lo, hi)
    ok = ~torch.isnan(r)
    err = max(
        float(torch.amax(torch.abs(mean - pm)[ok])) / max(1.0, q ** 0.5),
        float(torch.amax(torch.abs(var - pv))) / max(1.0, q),
    )
    check(err <= DENOISE_TOL, f"amp_denoise {label}: max error {err:.3e} > {DENOISE_TOL}")
    check(torch.equal(torch.isnan(mean), ~ok) and torch.equal(torch.isnan(pm), ~ok),
          f"amp_denoise {label}: a NaN mean where r is not NaN, or none where it is")
    mean, lo_b, hi_b = mean[ok], lo.expand_as(r)[ok], hi.expand_as(r)[ok]
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
          f"amp_denoise {label}: non-finite moments")
    check(bool(((mean >= lo_b) & (mean <= hi_b)).all() and (var > 0).all() and (var <= qt).all()),
          f"amp_denoise {label}: moments outside their bounds")
    line = (
        f"[amp_denoise {label}] K={r.shape[0]} n={r.shape[1]} q={q} max err (natural units)="
        f"{err:.3e} (tol {DENOISE_TOL}); collapsed entries (Z <= 1e-12) "
        f"{int((pv == qt * 1e-6).sum())}, NaN pseudo-data {int((~ok).sum())}"
    )
    return _timed(
        {"max_abs_err": err, "collapsed": int((pv == qt * 1e-6).sum())},
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


def boundary_flips(name, x, w, dither, got, ref, rows=1 << 14, bits=1, chain=None):
    """Code sums ``got`` against ``ref`` ((T, m) int32 pairs) of rows
    ``x (T, B, n)`` under frequencies ``w (T, n, m)`` and ``dither (T, m)``.

    Each entry may differ only by flips of points on a code boundary: by at
    most twice the count of its rows whose float64 phase has |cos| (or |sin|)
    within float32's rounding of that phase, 1e-6 (1 + sum |x_i w_i| + |d|)
    at 1 bit; at b bits, whose S cos (S sin) lies within S times that of a
    rounding boundary k + 1/2 (S = quantize.quantization_scale(bits)).
    ``chain`` ((T, m), from ``chain_uncertainty``) widens that window of a
    structured operator's undetermined columns by ||x_i||_2 chain[t, j].
    Fails otherwise.  Returns (differing entries, boundary points among
    them, max |dq|)."""
    from repro_torch.core import quantize

    scale = quantize.quantization_scale(bits)
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
            tol = 1e-6 * (1 + mag)
            if chain is not None:
                tol = tol + xs.norm(dim=1)[:, None] * chain[t, j].double()[None, :]
            if bits == 1:
                near += (trig.abs() < tol).sum(0)
            else:
                frac = scale * trig - torch.floor(scale * trig)
                near += ((frac - 0.5).abs() < scale * tol).sum(0)
        bad = diff[which, t, j] > 2 * near
        check(not bool(bad.any()),
              f"{name}: {int(bad.sum())} entries differ from the plain version by more than "
              "their boundary points allow")
        n_near += int(near.sum())
    return idx.shape[0], n_near, float(diff.max())


def structured_w64(op) -> torch.Tensor:
    """The structured operator's (n, nblocks d) frequencies in float64, from
    its signs and radii (every block column, the ragged tail included)."""
    return stacked_w64(op.diags[None], op.radii[None], op.n)[0]


def stacked_w64(diags, radii, n: int) -> torch.Tensor:
    """(T, n, nblocks d) float64 frequencies of T structured operators'
    signs ``diags (T, nblocks, 3, d)`` and ``radii (T, nblocks, d)``."""
    from repro_torch.kernels import freq_transform as ft

    tenants, nblocks, _, d = diags.shape
    eye = torch.eye(n, d, dtype=torch.float64, device=diags.device)
    cols = ft.hd_chain(eye[None, :, None, :], diags[:, None].double())
    return (cols * radii[:, None].double()).reshape(tenants, n, nblocks * d)


def structured_flips(name, x, op, dither, got, ref, chain=False):
    """``boundary_flips`` of kernel 5's 1-bit sums (``(nblocks, d)`` pairs)
    on rows ``x`` under ``op`` and its padded ``(nblocks, d)`` dither (with
    ``chain``, widened at the undetermined columns)."""
    return boundary_flips(name, x[None], structured_w64(op)[None], dither.reshape(1, -1),
                          [q.reshape(1, -1) for q in got], [q.reshape(1, -1) for q in ref],
                          chain=chain_uncertainty(x[None], op.radii[None]) if chain else None)


def chain_uncertainty(x, radii) -> torch.Tensor:
    """(T, nblocks d) float64: for each column of T structured operators
    whose float32 phases some row of ``x (T, B, n)`` leaves uncertain beyond
    UNDETERMINED_RAD, that uncertainty per unit of ||x_i||_2 (PHASE_ULP at
    each of the chain's 3 log2(d) butterfly levels and two scalings, on
    values of size radius ||x_i||_2); 0 at every other column."""
    tenants, _, d = radii.shape
    coef = PHASE_ULP * (3 * (d.bit_length() - 1) + 2) * radii.reshape(tenants, -1).double()
    worst = coef * x.double().norm(dim=2).amax(dim=1)[:, None]
    return torch.where(worst > UNDETERMINED_RAD, coef, torch.zeros_like(coef))


def chain_slack(x, radii, beta):
    """For ``x (T, B, n)``, ``radii (T, nblocks, d)`` and ``beta (T, B)``:
    ((T, nblocks d) mask of the undetermined columns, (T, nblocks d) float64
    slack on their sums: each row's |beta| min(2, 2 uncertainty))."""
    coef = chain_uncertainty(x, radii)
    und = coef > 0
    slack = torch.zeros_like(coef)
    ti, ji = torch.nonzero(und).unbind(1)
    if ti.numel():
        delta = coef[ti, ji][:, None] * x.double().norm(dim=2)[ti]  # (columns, B)
        slack[ti, ji] = (beta[ti].double().abs() * torch.clamp(2 * delta, max=2.0)).sum(1)
    return und, slack


def check_structured_fleet(ft, x, diags, radii, beta, label, time_it=True):
    """Kernel 4's tenant-axis entry on ``x (T, B, n)``: bitwise two of its
    launches and the loop of T single launches, within SKETCH_TOL of its
    plain version on sums / B (at undetermined columns, ``chain_uncertainty``,
    plus each row's |beta| min(2, 2 uncertainty)); timed beside that loop
    when ``time_it``."""
    tenants, rows, n = x.shape
    _, nblocks, _, d = diags.shape
    args = (x, diags, radii, beta)

    def loop():
        return [ft.structured_sketch_sums(x[t], diags[t], radii[t], beta[t])
                for t in range(tenants)]

    c, s_ = ft.structured_sketch_sums_fleet(*args)
    c2, s2 = ft.structured_sketch_sums_fleet(*args)
    singles = loop()
    torch.cuda.synchronize()
    bitwise = (torch.equal(c, torch.stack([a for a, _ in singles]))
               and torch.equal(s_, torch.stack([b for _, b in singles])))
    pc, ps = ft.structured_sketch_sums_fleet_plain(*args)
    # Each (t, j) entry sums the B rows of one tenant: the error is per B.
    diff = torch.maximum((c - pc).abs(), (s_ - ps).abs()).reshape(tenants, -1).double()
    und, slack = chain_slack(x, radii, beta)
    n_und = int(und.sum())
    err = float(diff[~und].max()) / rows
    und_err = float(diff[und].max()) / rows if n_und else 0.0
    check(bitwise, f"structured_sketch_fleet {label}: differs from T single launches")
    check(torch.equal(c, c2) and torch.equal(s_, s2),
          f"structured_sketch_fleet {label}: two launches differ bitwise")
    check(bool((diff <= SKETCH_TOL * rows + slack).all()),
          f"structured_sketch_fleet {label}: max|d(sums/B)| {err:.3e}, at undetermined "
          f"columns {und_err:.3e}")
    line = (f"[structured_sketch_fleet {label}] T={tenants} B={rows} n={n} d={d} "
            f"nblocks={nblocks}: bitwise T single launches and repeatable {bitwise}; "
            f"max|d(sums/B)|={err:.3e} (tol {SKETCH_TOL}); {n_und} undetermined columns "
            f"(float32 phases uncertain beyond {UNDETERMINED_RAD} rad) within their rows' "
            f"uncertainty, max|d(sums/B)| there {und_err:.3e}")
    if not time_it:
        print(line, flush=True)
        return {"max_abs_err": err}
    loop_ms = median_ms(loop)
    return _timed(
        {"max_abs_err": err, "loop_ms": loop_ms, "library_ms": None},
        lambda: ft.structured_sketch_sums_fleet(*args),
        lambda: ft.structured_sketch_sums_fleet_plain(*args),
        lambda: structured_bound(rows, n, d, nblocks, False, tenants),
        f"{line}; T single launches {loop_ms:.3f} ms",
    )


def check_structured_codes_fleet(ft, x, diags, radii, dither, bits, label, time_it=True):
    """Kernel 5's tenant-axis entry on ``x (T, B, n)`` at ``bits``: equal to
    two of its launches and to the loop of T single launches, every entry
    within ``boundary_flips``' rule of its plain version; timed beside that
    loop when ``time_it``."""
    tenants, rows, n = x.shape
    _, nblocks, _, d = diags.shape
    args = (x, diags, radii, dither, bits)

    def loop():
        return [ft.quantized_structured_sketch_sums(x[t], diags[t], radii[t], dither[t], bits)
                for t in range(tenants)]

    q = ft.quantized_structured_sketch_sums_fleet(*args)
    q2 = ft.quantized_structured_sketch_sums_fleet(*args)
    singles = loop()
    torch.cuda.synchronize()
    equal = all(torch.equal(q[i], torch.stack([p[i] for p in singles])) for i in (0, 1))
    qp = ft.quantized_structured_sketch_sums_fleet_plain(*args)
    flat = [[a.reshape(tenants, -1) for a in pair] for pair in (q, qp)]
    # One flip moves an entry's sum by 2 (1 bit) or 1 (b bits) of B rows,
    # so the bar is the boundary rule itself, per entry (boundary_flips).
    chain = chain_uncertainty(x, radii)
    n_diff, n_near, _ = boundary_flips(
        f"quantized_structured_sketch_fleet {label}", x, stacked_w64(diags, radii, n),
        dither.reshape(tenants, -1), *flat, bits=bits, chain=chain)
    und = chain > 0
    dq = torch.maximum(*((a.long() - b.long()).abs() for a, b in zip(*flat)))
    qerr = float(dq[~und].max()) / rows
    und_err = float(dq[und].max()) / rows if bool(und.any()) else 0.0
    check(equal, f"quantized_structured_sketch_fleet {label}: differs from T single launches")
    check(all(torch.equal(a, b) for a, b in zip(q, q2)),
          f"quantized_structured_sketch_fleet {label}: two launches differ")
    line = (f"[quantized_structured_sketch_fleet {label}] T={tenants} B={rows} n={n} d={d} "
            f"{bits}bit: equal to T single launches and repeatable {equal}; differing entries "
            f"against the plain version {n_diff} of {2 * q[0].numel()}, each within twice "
            f"its boundary points ({n_near} in all), max|dq|/B={qerr:.3e}; "
            f"{int(und.sum())} undetermined columns, max|dq|/B there {und_err:.3e}")
    if not time_it:
        print(line, flush=True)
        return {"max_abs_err": qerr}
    loop_ms = median_ms(loop)
    return _timed(
        {"max_abs_err": qerr, "loop_ms": loop_ms, "library_ms": None},
        lambda: ft.quantized_structured_sketch_sums_fleet(*args),
        lambda: ft.quantized_structured_sketch_sums_fleet_plain(*args),
        lambda: structured_bound(rows, n, d, nblocks, True, tenants),
        f"{line}; T single launches {loop_ms:.3f} ms",
    )


def structured_fleet_instances(ft, dev, gen, shapes=FLEET_STRUCTURED_SHAPES, time_it=False):
    """Kernels 4-5's fleet entries at the other instances, few tenants and
    a ragged B (``shapes`` of (n, m, T, B)): float, 1 bit and 4 bits each,
    timed beside the loop of single launches when ``time_it``."""
    from repro_torch.core import FleetEngine, fleet_specs
    from repro_torch.core import quantize

    for n, m, tenants, rows in shapes:
        op = FleetEngine(fleet_specs(FLEET_SEED, tenants, "structured", m, n, 1.0),
                         device=dev)._stacked_op
        diags, radii = op.leaves[:2]
        _, nblocks, _, d = diags.shape
        x = torch.randn((tenants, rows, n), generator=gen, device=dev)
        beta = torch.rand((tenants, rows), generator=gen, device=dev)
        dither = torch.stack([quantize.draw_dither(gen, nblocks * d) for _ in range(tenants)])
        label = f"instance d={d} n={n}"
        check_structured_fleet(ft, x, diags, radii, beta, label, time_it=time_it)
        for bits in (1, 4):
            check_structured_codes_fleet(ft, x, diags, radii, dither.reshape(tenants, nblocks, d),
                                         bits, label, time_it=time_it)


def wide_block_checks(fs, ft, dev, blocks=WIDE_BLOCKS, n_pts=WIDE_BLOCK_N,
                      codes_n=WIDE_CODES_N, fleet=WIDE_BLOCK_FLEET, seed=WIDE_BLOCK_SEED):
    """Kernels 4-5 at the monitor's wide blocks (the wide kernel,
    ``structured_wide``): kernel 4 at each (n, m) of ``blocks`` on ``n_pts``
    standard normal rows, kernels 4 and 5 (1 and 4 bits) on ``codes_n``
    rows and the fleet entries 4f-5f (``fleet`` = (T, B)) at d = 8192,
    timed; the sketch and code bars, the undetermined columns counted
    (``chain_uncertainty``).  Operators, rows and dither from a generator
    of their own."""
    from repro_torch.core import freq_ops, quantize

    gen = torch.Generator(device=dev).manual_seed(seed)
    for n, m in blocks:
        op = freq_ops.make_operator("structured", gen, m, n, 1.0, device=dev)
        rows = codes_n if op.d == 8192 else n_pts
        x = torch.randn((rows, n), generator=gen, device=dev)
        label = f"wide block d={op.d} n={n}"
        if op.d == 8192:
            check_slice2_kernels(fs, ft, x, None, op, quantize.draw_dither(gen, m), label,
                                 rows // 3, chain=True)
        else:
            check_structured(ft, x, op, torch.ones((rows,), device=dev), label, chain=True)
        del op, x
    structured_fleet_instances(ft, dev, gen, ((blocks[1][0], blocks[1][1], *fleet),), time_it=True)


def monitor_wide_phase(dev, run, dims=MONITOR_WIDE, k=MONITOR_WIDE_K,
                       updates=MONITOR_WIDE_UPDATES, rows=None):
    """[monitor wide]: ActivationMonitor(dim=D).update at each D of ``dims``
    on the card (the structured operator, d = 4096 .. 16384 blocks through
    kernel 4), ``updates`` updates of ``rows`` standard normal pooled rows:
    kernel 4 launched once an update (asserted) and never its plain version,
    the state's sums within SKETCH_TOL of the plain version on sums / N (the
    undetermined columns within their rows' uncertainty), count and bounds
    exact.  Prints the operator draw's seconds and the process's peak host
    memory after it (the draw runs on a CPU generator, then moves)."""
    from repro_torch.kernels import freq_transform as ft
    from repro_torch.train.monitor import ActivationMonitor

    import resource

    rows = rows or LM_TRAIN[1]
    for dim, m in dims:
        t0 = time.perf_counter()
        mon = ActivationMonitor(dim=dim, k=k, m=m, device=dev)
        draw_s = time.perf_counter() - t0
        draw_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        op = mon.freqs
        gen = torch.Generator(device=dev).manual_seed(dim)
        pooled = [torch.randn((rows, dim), generator=gen, device=dev) for _ in range(updates)]

        def fold():
            state = mon.init_state()
            for batch in pooled:
                state = mon.update(state, batch)
            return state

        tag = f"monitor wide d_model={dim}"
        state = run(tag, fold, "structured_sketch")
        launched = ft.STRUCTURED_LAUNCHES
        xs = torch.cat(pooled)
        ones = torch.ones((xs.shape[0],), device=dev)
        pc, ps = ft.structured_sketch_sums_plain(xs, op.diags, op.radii, ones)
        want = torch.cat([pc.reshape(-1)[:op.m], -ps.reshape(-1)[:op.m]]).double()
        und, slack = chain_slack(xs[None], op.radii[None], ones[None])
        und = und[0, :op.m].repeat(2)
        slack = slack[0, :op.m].repeat(2)
        diff = (state.sums.double() - want).abs()
        n_pts = xs.shape[0]
        err = float(diff[~und].max()) / n_pts
        print(f"[{tag}] d={op.d} nblocks={op.nblocks} m={op.m}: operator draw {draw_s:.2f}s, "
              f"host peak RSS {draw_gb:.2f} GB; {updates} updates of {rows} rows, {launched} kernel 4 "
              f"launches; max|d(sums/N)| against the plain version {err:.3e} (tol {SKETCH_TOL}), "
              f"{int(und.sum()) // 2} undetermined columns within their rows' uncertainty",
              flush=True)
        check(launched == updates, f"{tag}: {launched} kernel 4 launches, not {updates}")
        check(bool((diff <= SKETCH_TOL * n_pts + slack).all()),
              f"{tag}: max|d(sums/N)| {err:.3e} > {SKETCH_TOL}")
        check(float(state.count) == n_pts and torch.equal(state.lo, xs.amin(0))
              and torch.equal(state.hi, xs.amax(0)), f"{tag}: count or bounds")
        ms = median_ms(lambda: ft.structured_sketch_sums(pooled[0], op.diags, op.radii,
                                                         ones[:rows]))
        bound_ms, bound_by = structured_bound(rows, dim, op.d, op.nblocks, False)
        print(f"[{tag}] kernel 4 at one update's shape (N={rows}): {ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by})", flush=True)
        del mon, op, state, pooled, xs
        torch.cuda.empty_cache()
    monitor_default_shape(dev, rows)


def monitor_default_shape(dev, rows, shape=MONITOR_DEFAULT):
    """Kernel 4 against its plain version and timed at the monitor's
    default (d_model, K) = ``shape``: m = 4 K d_model on ``rows`` standard
    normal rows, the operator drawn on the card (freq_ops.make_operator),
    the undetermined columns within their rows' uncertainty."""
    from repro_torch.core import freq_ops
    from repro_torch.kernels import freq_transform as ft

    dim, k = shape
    gen = torch.Generator(device=dev).manual_seed(dim + k)
    t0 = time.perf_counter()
    op = freq_ops.make_operator("structured", gen, 4 * k * dim, dim, 1.0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    x = torch.randn((rows, dim), generator=gen, device=dev)
    out = check_structured(ft, x, op, torch.ones((rows,), device=dev),
                           f"monitor default d_model={dim} K={k} nblocks={op.nblocks}", chain=True)
    print(f"[monitor default d_model={dim} K={k}] operator drawn on the card in {draw_s:.2f}s; "
          f"kernel 4 {out['ms']:.4f} ms against the bound {out['bound_ms']:.5f} ms "
          f"({out['bound_by']})", flush=True)


def fleet_phases(dev, run, cfg, sigma2, results, sync=None, tenants=FLEET_T, rows=FLEET_B,
                 requests=FLEET_REQUESTS, request_rows=FLEET_REQUEST_ROWS, m=M, k=K, dim=DIM,
                 shapes=FLEET_STRUCTURED_SHAPES):
    """[fleet]: the multi-tenant fleet on one card, through the entry points a
    user calls (fleet_specs, FleetEngine update / merge / finalize /
    finalize_tenant / ingest / decay_to, a fleet SketchWindow, decode of a
    tenant's sketch), dense and structured.  Every tenant's rows are held
    bitwise to its isolated engine's; the tenant-axis entries of kernels 1,
    3, 4 and 5 bitwise to T single launches and to their plain versions
    within the bars (kernels 4-5 also at ``shapes``); their numbers go to
    ``results``."""
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
    sspecs = fleet_specs(FLEET_SEED, tenants, "structured", m, dim, sigma2)
    quants = fleet_quantizers(FLEET_SEED, tenants, m, "1bit", device=dev)
    engines = {"float": FleetEngine(specs, device=dev),
               "1bit": FleetEngine(specs, quantizers=quants, device=dev)}
    sengines = {"float": FleetEngine(sspecs, device=dev),
                "1bit": FleetEngine(sspecs, quantizers=quants, device=dev)}
    sync(dev)
    build_s = time.perf_counter() - t0
    print(f"[fleet data] T={tenants} tenants, each its own {k}-cluster mixture in R^{dim} "
          f"({per_tenant} rows a tenant, {data.numel() * 4 / 1e6:.0f} MB) made on the card in "
          f"{make_s:.2f}s; specs and four fleets (dense and structured, float and 1-bit) "
          f"built in {build_s:.2f}s; m={m}, sigma2={float(sigma2):.4f}", flush=True)

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

    # 1b. The tenant-axis entries of kernels 4 and 5 the same way, on the
    # structured fleet's stacked operators (d = 32, 32 blocks), then at the
    # other instances with few tenants.
    diags, radii = sengines["float"]._stacked_op.leaves[:2]
    _, nblocks, _, d = diags.shape
    sdith = torch.nn.functional.pad(sengines["1bit"].dither, (0, nblocks * d - m))
    results["structured_sketch_fleet"] = check_structured_fleet(
        ft, blk, diags, radii, ones, "fleet shape")
    results["quantized_structured_sketch_fleet"] = check_structured_codes_fleet(
        ft, blk, diags, radii, sdith.reshape(tenants, nblocks, d).contiguous(), 1, "fleet shape")
    structured_fleet_instances(ft, dev, torch.Generator(device=dev).manual_seed(FLEET_SEED),
                               shapes)

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

    # 7. The structured fleet: one launch of kernel 4's (5's) tenant-axis
    # entry an update, each tenant bitwise its isolated engine.
    for label, kernel, counter in (
            ("float", "structured_sketch_fleet", "STRUCTURED_FLEET_LAUNCHES"),
            ("1bit", "quantized_structured_sketch_fleet", "QUANTIZED_STRUCTURED_FLEET_LAUNCHES")):
        se = sengines[label]
        sst = run(f"fleet structured {label}", lambda se=se: se.update(
            se.update(se.init_state(), blocks[0]), blocks[1]), kernel)
        n_fleet = getattr(ft, counter)
        n_single = ft.STRUCTURED_LAUNCHES + ft.QUANTIZED_STRUCTURED_LAUNCHES
        srefs = [se.tenant_engine(t) for t in range(tenants)]
        swant = [r.update(r.update(r.init_state(), blocks[0][t]), blocks[1][t])
                 for t, r in enumerate(srefs)]
        ok_s = (_same_state(sst, _stack_states(swant))
                and torch.equal(se.finalize(sst)[0],
                                torch.stack([r.finalize(st)[0] for r, st in zip(srefs, swant)])))
        upd_s, _ = timed(lambda se=se, sst=sst: se.update(sst, blocks[0]))
        loop_s, _ = timed(lambda: [r.update(st, blocks[0][t])
                                   for t, (r, st) in enumerate(zip(srefs, swant))], reps=3)
        print(f"[fleet structured {label}] T={tenants}, d={se.operator(0).d}: two updates, "
              f"{n_fleet} launches of {kernel} and {n_single} single launches; one update "
              f"{upd_s * 1e3:.3f} ms against the Python loop of tenant_engine(t).update "
              f"{loop_s * 1e3:.3f} ms ({loop_s / upd_s:.1f}x); each tenant bitwise its isolated "
              f"engine: {ok_s}", flush=True)
        check(ok_s, f"fleet structured {label}: differs from the isolated engines")
        check(n_fleet == 2 and n_single == 0,
              f"fleet structured {label}: {n_fleet} fleet and {n_single} single launches for "
              "two updates, not 2 and 0")
        del srefs, swant
    peak = _peak_since(dev, base_mem)
    base = _reset_peak(dev)
    fs.fourier_sketch_sums_fleet(blocks[0], w_all, ones)
    scratch = _peak_since(dev, base)
    base = _reset_peak(dev)
    ft.structured_sketch_sums_fleet(blocks[0], diags, radii, ones)
    sscratch = _peak_since(dev, base)
    print(f"[fleet] {time.perf_counter() - t_phase:.1f}s; peak device memory {peak / 1e6:.1f} MB "
          f"over the phase's start (data {data.numel() * 4 / 1e6:.1f} MB, {FLEET_UPDATES} "
          f"update blocks {FLEET_UPDATES * blocks[0].numel() * 4 / 1e6:.1f} MB, one stacked "
          f"float state {eng.state_bytes() / 1e6:.1f} MB, each fleet's stacked operators "
          f"{w_all.numel() * 4 / 1e6:.1f} MB; one fleet launch of kernel 1 at an update "
          f"block's shape takes {scratch / 1e6:.1f} MB of scratch and outputs, its double "
          f"partials 2 x T x groups x m x 8 B; one of kernel 4 {sscratch / 1e6:.1f} MB, "
          f"2 x T x groups x nblocks d x 8 B)", flush=True)


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
                 evict=SERVE_EVICT, m=M, k=K, dim=DIM, root=None):
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

    # 7. A structured service over the same tenants: one launch of kernel
    # 4's tenant-axis entry a flush.
    from repro_torch.kernels import freq_transform as ft

    seng = FleetEngine(fleet_specs(FLEET_SEED, tenants, "structured", m, dim, sigma2), device=dev)
    ssvc, s_wall = run("serve structured flush", lambda: flushed(service(seng), reqs, False),
                       "structured_sketch_fleet")
    s_launches = (ft.STRUCTURED_FLEET_LAUNCHES, ft.STRUCTURED_LAUNCHES)
    s_want = seng.ingest(seng.init_state(), [t for t, _ in reqs],
                         torch.stack([torch.as_tensor(chunk(t, c)).to(dev) for t, c in reqs]))
    s_row = seng.tenant_state(ssvc.state, 1)
    ssvc.evict(1)
    ssvc.restore(1)
    s_ok = {"engine": _same_state(ssvc.state, s_want),
            "evict/restore": _same_state(seng.tenant_state(ssvc.state, 1), s_row)}
    s_dec = run("serve structured decode", lambda: ssvc.decode(1), "sketch_shift")
    print(f"[serve structured] T={tenants}, {len(reqs)} requests of {request_rows} rows: flush "
          f"{s_wall * 1e3:.2f} ms ({ssvc.stats.flushes} dispatch; launches of the fleet entry and "
          f"of the single kernel 4: {s_launches}); the engine's bits {s_ok}; a decode finite: "
          f"{bool(torch.isfinite(s_dec.centroids).all())}", flush=True)
    check(all(s_ok.values()) and bool(torch.isfinite(s_dec.centroids).all()),
          f"serve structured: {s_ok}")
    check(s_launches == (ssvc.stats.flushes, 0) and ssvc.stats.flushes == 1,
          f"serve structured: {s_launches} launches (fleet entry, single) for "
          f"{ssvc.stats.flushes} dispatches, not (1, 0)")
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
                      shards=MESH_SHARDS, m=M, k=K, dim=DIM, default_mesh=True):
    """[fleet-mesh]: FleetEngine(sharding="mesh") at [fleet]'s width: float,
    1-bit and decayed fleets at p = ``shards`` (blocks on ``[dev] * p``,
    explicitly) and at p = 1 (``tenant_mesh(1)``, the default path); update,
    merge, finalize and the routed ingest of ``requests`` shuffled requests,
    every row bitwise the ``sharding="none"`` fleet's; the fleet entry of
    kernel 1 (3) launched exactly p times an update and once a block an
    ingest, with no peer copy and no ``torch.distributed`` call (its
    collectives raise, and a profiler window counts copies and NCCL kernels);
    a structured mesh fleet at the same width, kernel 4's fleet entry once a
    block an update; the update timed against the unsharded one's.
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

    # A structured mesh fleet: kernel 4's tenant-axis entry once a block.
    sspecs = fleet_specs(FLEET_SEED, tenants, "structured", m, dim, sigma2)
    splain = FleetEngine(sspecs, device=dev)
    seng = FleetEngine(sspecs, sharding="mesh", mesh=tenant_mesh(shards, devices=[dev] * shards))
    sst = run(f"fleet-mesh structured p={shards}", lambda: seng.update(
        seng.update(seng.init_state(), blocks[0]), blocks[1]), "structured_sketch_fleet")
    launches = (ft.STRUCTURED_FLEET_LAUNCHES, ft.STRUCTURED_LAUNCHES)
    want = splain.update(splain.update(splain.init_state(), blocks[0]), blocks[1])
    s_ok = (_same_state(fleet_mod.gather_rows(sst, dev), want)
            and torch.equal(fleet_mod.gather_rows(seng.finalize(sst)[0], dev),
                            splain.finalize(want)[0]))
    s_ms = [median_ms(lambda: (splain.update(want, blocks[0]) if turn in (0, 3)
                               else seng.update(sst, blocks[0]))) for turn in range(4)]
    print(f"[fleet-mesh structured p={shards}] T={tenants}: two updates, {launches} launches "
          f"of the fleet entry and of the single kernel 4 (one a block an update, none); "
          f"bitwise the unsharded fleet (state and z): {s_ok}; one update (unsharded, mesh, "
          f"mesh, unsharded) "
          f"{[round(t, 3) for t in s_ms]} ms", flush=True)
    check(s_ok and launches == (2 * shards, 0),
          f"fleet-mesh structured: bits {s_ok}, launches {launches}, not {(2 * shards, 0)}")
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


def lm_train_flops(cfg, batch: int, seq: int) -> float | None:
    """Model FLOPs of one train step, counted from the code, or None where a
    layer is recurrent (Mamba, mLSTM, sLSTM: their scans are not counted).
    The forward's products, three times over for the forward and backward:
    each layer's attention projections and its MLP (SwiGLU; a MoE's router
    and its top-k experts, not the capacity's padded slots), causal
    attention's QK^T and PV over the half of the scores a causal mask needs,
    and the unembedding, all over ``seq`` positions (internvl2's patch prefix
    included: its layers and its logits run there too); whisper's encoder
    (projections, MLP and non-causal attention over its frames) and each
    decoder layer's cross-attention (q and o over the tokens, k and v over
    the frames, the full scores).  Remat "full" runs one forward more (x 4/3
    for the hardware's FLOPs)."""
    kinds = cfg.layer_kinds()
    if any(mixer not in ("attn", "local") for mixer, _ in kinds):
        return None
    d, hd, h, kvh = cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * hd * (2 * h + 2 * kvh)
    mlp = {"dense": 6 * d * cfg.d_ff, "none": 0,
           "moe": 2 * d * cfg.moe_experts + cfg.moe_top_k * 6 * d * cfg.d_ff}
    per_token = sum(proj + mlp[kind] for _, kind in kinds) + 2 * d * cfg.vocab_size
    total = per_token * batch * seq + len(kinds) * 2 * batch * h * hd * seq * seq
    if cfg.encoder_layers:
        frames = cfg.frontend_len
        total += cfg.encoder_layers * ((proj + mlp["dense"]) * batch * frames
                                       + 4 * batch * h * hd * frames * frames)
        total += len(kinds) * (2 * d * hd * 2 * h * batch * seq
                               + 2 * d * hd * 2 * kvh * batch * frames
                               + 4 * batch * h * hd * seq * frames)
    return 3.0 * total


def lm_train_shapes(dev) -> dict:
    """Kernel 1's and kernel 4's inputs at the training path's shapes: the
    balancer's and the monitors' operators as ``train_loop.run`` makes them
    (see LM_TRAIN), B = LM_TRAIN[1] rows each, and the monitor's shape in
    each of LM_TRAIN_FAMILIES (d_model, its batch's rows).  The balancer's
    rows are the first batch's document embeddings, which also set its
    sigma^2; the monitors' pooled rows are standard normal from a generator
    of their own.  -> {"dense": [(label, x, w)], "structured": [(label, x,
    op, wide)]}, ``wide`` for blocks past 2048 (their undetermined columns
    are held within their chain's slack)."""
    from repro_torch import device as device_mod
    from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
    from repro_torch.core import freq_ops
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
    structured = [(f"lm-train monitor N={batch}",
                   torch.randn((batch, cfg.d_model), generator=g, device=dev), wide, False)]
    # The other families' monitors (K = 4: m = 16 d_model), on operators
    # drawn on the card at the same shapes (the monitor draws on the host,
    # seconds at d_model 4096 and 6144).
    for fam, (rows, _, _) in LM_TRAIN_FAMILIES.items():
        dim = get_config(fam).d_model
        op = freq_ops.make_operator("structured", g, 16 * dim, dim, 1.0, device=dev)
        structured.append((f"lm-train {fam} monitor d_model={dim} N={rows}",
                           torch.randn((rows, dim), generator=g, device=dev), op, dim > 2048))
    return {
        "dense": [
            (f"lm-train balancer N={batch}", x_bal, bal.freqs.w.contiguous()),
            (f"lm-train restart monitor N={batch}",
             torch.randn((batch, smoke.d_model), generator=g, device=dev),
             narrow.w.contiguous()),
        ],
        "structured": structured,
    }


def _fake_copy(tree, device):
    """Empty tensors of ``tree``'s shapes and dtypes on ``device``, a leaf
    that requires grad as one (call it under ``FakeTensorMode``)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
                    .requires_grad_(t.requires_grad), tree)


def _same_costs(a, b) -> bool:
    return (a.flops == b.flops and a.bytes == b.bytes
            and dict(a.coll_by_op) == dict(b.coll_by_op)
            and dict(a.coll_count) == dict(b.coll_count))


def dryrun_cells():
    """Start the dry run's CLI on DRYRUN_ARCH at each of DRYRUN_CELLS (the
    16 x 16 mesh), a process each: -> {cell: (process, its JSON's path)}."""
    root = Path(__file__).resolve().parent
    out_dir = root / "experiments" / "dryrun_torch"
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    procs = {}
    for cell in DRYRUN_CELLS:
        path = out_dir / f"{DRYRUN_ARCH}__{cell}__16x16.json"
        path.unlink(missing_ok=True)
        procs[cell] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
             "--shape", cell], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True), path)
    return procs


def dryrun_cells_finish(procs) -> None:
    """Wait for ``dryrun_cells``' processes (killed past DRYRUN_TIMEOUT_S)
    and hold each cell to tests/test_dryrun.py's invariants."""
    for cell, (proc, path) in procs.items():
        try:
            log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        check(proc.returncode == 0, f"dryrun {cell}: exit {proc.returncode}: {log[-2000:]}")
        r = json.loads(path.read_text())
        mem = r["memory_analysis"]
        print(f"[dryrun {DRYRUN_ARCH} x {cell} x 16x16] fake {r['fake_device']} tensors, "
              f"{r['chips']} ranks: per device {r['flops_per_device']:.4e} flops, "
              f"{r['hbm_bytes_per_device']:.4e} HBM bytes, "
              f"{r['collective_bytes_per_device']:.4e} collective bytes "
              f"{ {k: v['count'] for k, v in r['collectives'].items()} }; compute "
              f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms: {r['dominant']}-bound; useful_ratio "
              f"{r['useful_ratio']}, roofline_fraction {r['roofline_fraction']}; arguments "
              f"{mem['argument_size'] / 1e9:.3f} GB + temporaries {mem['temp_size'] / 1e9:.3f} GB "
              f"(build {r['lower_s']} s, trace {r['compile_s']} s)", flush=True)
        check(r["status"] == "ok" and r["chips"] == 256, f"dryrun {cell}: {r}")
        check(r["fake_device"] == "cuda", f"dryrun {cell}: fake {r['fake_device']} tensors")
        if cell == "train_4k":
            check(r["dominant"] in ("compute", "memory", "collective"), f"dryrun {cell}: {r}")
            check(0.3 < r["useful_ratio"] < 1.2, f"dryrun {cell}: useful_ratio "
                                                 f"{r['useful_ratio']}")
            check(r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0,
                  f"dryrun {cell}: roofline terms {r}")
            check(mem["argument_size"] + mem["temp_size"] < 2 * DRYRUN_CARD_BYTES,
                  f"dryrun {cell}: {mem}")
        elif cell == "prefill_32k":
            check(r["useful_ratio"] > DRYRUN_PREFILL_USEFUL,
                  f"dryrun {cell}: useful_ratio {r['useful_ratio']} (bar "
                  f"{DRYRUN_PREFILL_USEFUL}: the attention split over query heads)")
        elif cell == "decode_32k":
            check(r["collective_bytes_per_device"] <= DRYRUN_DECODE_COLL_BYTES,
                  f"dryrun {cell}: {r['collective_bytes_per_device']:.4e} collective bytes "
                  f"a device (bar {DRYRUN_DECODE_COLL_BYTES:.1e}: the vocab-parallel serve)")


def dryrun_phase(dev, cfg, shape, opt_cfg, state, data, lm_flops):
    """[dryrun]: llama3.2-1B's train step at LM_TRAIN's shape (AdamW, remat
    "full", bf16 compute) costed by ``utils.hlo`` three ways: traced on fake
    CUDA tensors, on fake CPU tensors (the branches on ``is_cuda`` change no
    count) and run on the card; the three costs equal, the argument bytes
    the state's and the batch's on the card, the step (CUDA events, without
    the cost mode) no faster than its roofline bound; the counted peak
    beside the allocator's, the counted flops beside ``lm_train_flops`` x
    4/3, the roofline fraction beside the measured model-FLOP share.  Then
    the dry run's two 16 x 16 cells (``dryrun_cells``, started first).
    ``state``: the train state on the card (updated by the steps)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as ltrain
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils import hlo
    from repro_torch.utils import roofline as rl

    t_phase = time.perf_counter()
    procs = dryrun_cells()
    try:
        host = SyntheticLM(cfg, shape, data, dev).batch_numpy(0)
        batch = {k: torch.from_numpy(a.copy()).to(dev) for k, a in host.items()
                 if not k.startswith("_")}
        step = ltrain.build_train_step(cfg, make_optimizer(opt_cfg), remat="full",
                                       dtype=torch.bfloat16)
        on_card = sum(t.numel() * t.element_size() for t in tree_leaves((state, batch)))
        costs, secs = {}, {}
        for where in ("fake cuda", "fake cpu"):
            t0 = time.perf_counter()
            with FakeTensorMode():
                fake = _fake_copy((state, batch), dev if where == "fake cuda" else "cpu")
                costs[where] = hlo.analyze(step, *fake)
            secs[where] = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        costs["card"] = real = hlo.analyze(step, state, batch)
        torch.cuda.synchronize(dev)
        secs["card"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        times = [event_ms(lambda: step(state, batch)) for _ in range(DRYRUN_TIMED_STEPS)]
        step_s = min(times) * 1e-3
        tokens = shape.global_batch * shape.seq_len
        roof = rl.analyze(real, 1, rl.train_model_flops(cfg.active_param_count(), tokens))
        for where, c in costs.items():
            print(f"[dryrun {where}] {c.flops:.6e} flops, {c.bytes:.6e} bytes, collectives "
                  f"{dict(c.coll_count)}; arguments {c.argument_bytes} B, peak "
                  f"{c.peak_bytes} B, output {c.output_bytes} B; {secs[where]:.1f} s under "
                  "the cost mode", flush=True)
        print(f"[dryrun step] {cfg.name} B={shape.global_batch} x S={shape.seq_len}, one card: "
              f"counted {real.flops / 1e12:.3f} TFLOP beside lm_train_flops x 4/3 "
              f"{lm_flops * 4 / 3 / 1e12:.3f} (ratio {real.flops / (lm_flops * 4 / 3):.4f}); bound "
              f"{roof.bound_step_time() * 1e3:.1f} ms ({roof.dominant}: compute "
              f"{roof.compute_s * 1e3:.1f}, memory {roof.memory_s * 1e3:.1f} ms) against the "
              f"step's {[round(t, 1) for t in times]} ms (CUDA events; "
              f"{step_s / roof.bound_step_time():.3f} x the bound); roofline_fraction "
              f"{roof.roofline_fraction():.4f} beside the measured "
              f"model-FLOP share {roof.model_flops / step_s / rl.PEAK_FLOPS:.4f} (6 N D = "
              f"{roof.model_flops / 1e12:.3f} TFLOP); counted peak {real.peak_bytes / 1e9:.3f} GB "
              f"(temporaries {real.temp_bytes / 1e9:.3f}) beside the allocator's "
              f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} over the step's start): ratio "
              f"{real.peak_bytes / peak:.4f}, temporaries "
              f"{real.temp_bytes / max(peak - base, 1):.4f}",
              flush=True)
        for where in ("fake cuda", "fake cpu"):
            check(_same_costs(costs[where], real),
                  f"dryrun: the {where} trace's costs differ from the card's step's")
        check(real.argument_bytes == costs["fake cuda"].argument_bytes == on_card,
              f"dryrun: argument bytes {real.argument_bytes}, "
              f"{costs['fake cuda'].argument_bytes} (fake), the state and batch {on_card}")
        check(step_s >= roof.bound_step_time(), f"dryrun: a step of {step_s * 1e3:.1f} ms beats "
                                                f"its bound {roof.bound_step_time() * 1e3:.1f} ms")
        dryrun_cells_finish(procs)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[dryrun] {time.perf_counter() - t_phase:.1f}s", flush=True)


def lm_train_phase(dev, run, arch=LM_TRAIN[0], batch=LM_TRAIN[1], seq=LM_TRAIN[2], depth=None,
                   steps=LM_TRAIN_STEPS, restore=True, dryrun=False):
    """[lm-train <arch>]: ``train_loop.run`` at the published config's width,
    at ``depth`` layers (None: all; see LM_TRAIN and LM_TRAIN_FAMILIES),
    with the published config's default optimizer and parameter dtype: the
    first batch's loss at float32 compute, then ``steps`` bf16 steps with
    the monitor and the balancer on (kernels 4 and 1, counted), each step's
    time by CUDA events beside the loop's wall time, tokens/s, loss,
    gradient norm and peak memory, the balancer's decode seconds, the model-
    and hardware-FLOP shares of the bf16 peak (where ``lm_train_flops``
    counts the model), the final checkpoint's bytes and save seconds (with
    ``restore``, its restore seconds, restored bitwise; else the checkpoint
    is deleted), the monitor's decode and the balancer's weights."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as ltrain
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    tag = f"lm-train {arch}"
    published = get_config(arch)
    cfg = published if depth is None else dataclasses.replace(published, n_layers=depth)
    opt_cfg = ltrain.default_opt_config(published)
    param_dtype = ltrain.default_param_dtype(published)
    # train_loop.run stores the parameters in the run config's default dtype.
    check(ltrain.default_param_dtype(cfg) == param_dtype,
          f"{tag}: the cut config's parameter dtype is not the published config's {param_dtype}")
    shape = ShapeConfig("train_4k", seq, batch, "train")
    data = DataConfig(seed=0, n_domains=4)
    root = Path(__file__).resolve().parent / "build" / "train_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    # The checkpoint: the parameters and the optimizer's state (AdamW's m
    # and v; Adafactor's row and column statistics), the step and the
    # monitor's sketch.
    shapes = ltrain.state_shapes(cfg, make_optimizer(opt_cfg))
    state_bytes = sum(math.prod(t.shape) * t.dtype.itemsize for t in tree_leaves(
        {k: shapes[k] for k in ("params", "opt")}, is_leaf=lambda t: hasattr(t, "dtype")))
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
    torch.cuda.empty_cache()
    loop = train_loop.LoopConfig(steps=steps, ckpt_dir=str(root), ckpt_every=steps + 1, keep=1,
                                 monitor_k=4, balance_every=2, log_every=1,
                                 dtype=torch.bfloat16, remat="full")
    base = _reset_peak(dev)
    out = run(tag, lambda: train_loop.run(cfg, shape, None, loop, data, opt_cfg=opt_cfg,
                                          seed=LM_TRAIN_SEED, device=dev),
              ("fourier_sketch", "structured_sketch"))
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
    if flops is None:
        print(f"[{tag} model flops] not counted: the recurrent mixers' scans are not counted, "
              f"so no model-FLOP share is given; median step function {step_ms:.1f} ms",
              flush=True)
    else:
        rate = flops / (step_ms * 1e-3)
        print(f"[{tag} model flops] {flops / 1e12:.1f} TFLOP a step (the forward's products x 3, "
              f"counted from the code: lm_train_flops); median step function {step_ms:.1f} ms: "
              f"{rate / 1e12:.1f} TFLOP/s, model-FLOP share "
              f"{100 * rate / PEAK_BF16_FLOP_PER_S:.2f}% of {PEAK_BF16_FLOP_PER_S / 1e12:.0f} "
              f"TFLOP/s bf16; hardware-FLOP share (x 4/3, remat's recompute included) "
              f"{100 * 4 / 3 * rate / PEAK_BF16_FLOP_PER_S:.2f}%", flush=True)
    rel = abs(hist[0]["loss"] - loss32) / abs(loss32)
    print(f"[{tag} loss] step 1 at bf16 compute {hist[0]['loss']:.6f} against float32 "
          f"{loss32:.6f}: relative {rel:.2e} (bar {LM_TRAIN_LOSS_RTOL})", flush=True)
    check(math.isfinite(loss32) and rel <= LM_TRAIN_LOSS_RTOL,
          f"{tag}: the bf16 loss {hist[0]['loss']} is {rel:.2e} from the float32 {loss32}")

    # The final checkpoint: bytes, save seconds; with ``restore``, restored
    # bitwise.
    ck = Checkpointer(root, keep=1)
    check(ck.all_steps() == [steps], f"{tag}: checkpoints {ck.all_steps()}, not [{steps}]")
    nbytes = sum(f.stat().st_size for f in (root / f"step_{steps:010d}").iterdir())
    state = out["state"]
    kept = f"saved in {out['save_s']:.1f}s (snapshot to the host and write)"
    if restore:
        t0 = time.perf_counter()
        restored = ck.restore(state)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        leaves, want = tree_leaves(restored), tree_leaves(state)
        same = len(leaves) == len(want) and all(torch.equal(a, b) for a, b in zip(leaves, want))
        kept += (f", restored in {restore_s:.1f}s (a warm read), bitwise equal to the live "
                 f"state: {same}")
        check(same, f"{tag}: the restored checkpoint differs from the live state")
        del restored, leaves, want
    print(f"[{tag} checkpoint] step {steps}: {nbytes / 1e9:.3f} GB in "
          f"{len(tree_leaves(state))} leaves, {kept}", flush=True)
    if dryrun:
        dryrun_phase(dev, cfg, shape, opt_cfg, {k: state[k] for k in ("params", "opt", "step")},
                     data, flops)

    res = out["monitor_result"]
    weights = out["balance_weights"]
    check(tuple(res.centroids.shape) == (4, cfg.d_model)
          and bool(torch.isfinite(res.centroids).all()), f"{tag}: monitor centroids")
    # The weights are float32 on the host: their sum is 1 to a few ulps.
    check(weights is not None and len(weights) == data.n_domains
          and bool(np.all(np.isfinite(weights)))
          and abs(float(weights.sum()) - 1.0) <= 4 * float(np.finfo(weights.dtype).eps),
          f"{tag}: balancer weights {weights}")
    layers = (f"{cfg.n_layers} layers" if depth is None
              else f"{cfg.n_layers} of {published.n_layers} layers")
    mixers = "/".join(dict.fromkeys(cfg.mixer_pattern))
    extra = (f", MoE {cfg.moe_experts} experts top-{cfg.moe_top_k}" if cfg.moe_experts else "") + (
        f", an encoder of {cfg.encoder_layers} on {cfg.frontend_len} frames"
        if cfg.encoder_layers else "") + (
        f" ({cfg.frontend_len} patches + {seq - cfg.frontend_len} tokens)"
        if cfg.frontend == "vision" else "")
    cut = LM_TRAIN_CUTS.get(arch, f"train_4k's global batch of 256 cut to {batch}")
    print(f"[{tag}] {layers}, mixers {mixers}, d={cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}{extra}, "
          f"B={batch} x S={seq} ({cut}), {opt_cfg.name}, "
          f"{str(param_dtype).replace('torch.', '')} parameters, bf16 compute, remat full; "
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


def _leaf_errors(got, want) -> float:
    """The largest |got - want| over each leaf's max-abs, over a tree."""
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        scale = max(float(b.detach().abs().max()), 1e-30)
        worst = max(worst, float((a.detach().float() - b.detach().float()).abs().max()) / scale)
    return worst


def _bitwise(got, want) -> bool:
    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def lm_mesh_phases(dev, run, launches, p1_backend="nccl", sizes=None):
    """[lm-mesh p=1] and [lm-mesh p=4]: the LM on a mesh (see LM_MESH_RANKS).
    Neither is an interconnect measurement: NCCL at one rank, gloo through
    host memory on one card.  ``p1_backend="gloo"``, ``dev=cpu`` and small
    ``sizes`` (with ``configs.get_config`` replaced by the smoke configs)
    let a CPU box rehearse the phases: the ranks take their configs and
    sizes from here."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import device as device_mod
    from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.optim.optimizers import OptConfig, make_optimizer
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "lm_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    arch, batch, seq = LM_TRAIN
    cfg = get_config(arch)
    shape = ShapeConfig("train_4k", seq, batch, "train")
    data = SyntheticLM(cfg, shape, DataConfig(seed=0), dev).batch(0)
    data = {k: v for k, v in data.items() if not k.startswith("_")}
    opt = make_optimizer(OptConfig(name="adamw"))
    tag = "lm-mesh p=1"

    dist.init_process_group(p1_backend, init_method=f"file://{root}/init1", rank=0, world_size=1)
    try:
        mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))

        def train_pair():
            """Two steps each way: the first compared, the second (warm)
            timed and compared again."""
            one = ltrain.init_state(cfg, opt, seed=LM_TRAIN_SEED, device=dev)
            sharded = ltrain.init_sharded_state(cfg, opt, mesh, seed=LM_TRAIN_SEED)
            same_init = _bitwise(one, sharded)
            ms, out = {}, {}
            for name, state, m in (("mesh=None", one, None), ("mesh (1, 1)", sharded, mesh)):
                step = ltrain.build_train_step(cfg, opt, mesh=m, remat="full",
                                               dtype=torch.bfloat16)
                out[name] = [step(state, data)[1]]
                holder = {}
                ms[name] = event_ms(lambda: holder.update(m=step(state, data)[1]))
                out[name].append(holder["m"])
            return one, sharded, same_init, ms, out

        one, sharded, same_init, ms, out = run(f"{tag} train", train_pair, ())
        loss_same = all(torch.equal(a["loss"], b["loss"])
                        for a, b in zip(out["mesh=None"], out["mesh (1, 1)"]))
        params_same = _bitwise(one["params"], sharded["params"])
        print(f"[{tag} train] {arch} ({cfg.n_layers} layers, d={cfg.d_model}) B={batch} x "
              f"S={seq}, bf16 compute, AdamW, remat full: the second step on the mesh "
              f"{ms['mesh (1, 1)']:.1f} ms, mesh=None {ms['mesh=None']:.1f} ms (CUDA events; "
              f"NCCL at one rank: no collective runs); initial state bitwise {same_init}, losses "
              f"{[round(float(m['loss']), 6) for m in out['mesh=None']]} bitwise {loss_same}, "
              f"parameters after two steps bitwise {params_same}", flush=True)
        check(same_init and loss_same and params_same,
              f"{tag}: the mesh's train steps are not the mesh=None steps' bits")
        params = lserve.serving_params(one["params"])
        del one, sharded, out
        torch.cuda.empty_cache()

        serve_shape = ShapeConfig("decode", seq + LM_MESH_DECODE, batch, "decode")
        prompt = {"tokens": data["tokens"]}

        def serve_pair():
            res = {}
            for name, m in (("mesh=None", None), ("mesh (1, 1)", mesh)):
                prefill, _ = lserve.make_prefill(cfg, serve_shape, mesh=m)
                step, _ = lserve.make_serve_step(cfg, serve_shape, mesh=m)
                t0 = time.perf_counter()
                logits, cache, index = prefill(params, prompt)
                rows = [logits]
                for t in range(LM_MESH_DECODE):
                    logits, cache = step(params, data["labels"][:, t:t + 1], cache, index + t)
                    rows.append(logits)
                device_mod.sync(dev)
                res[name] = (rows, time.perf_counter() - t0)
                del cache
            return res

        res = run(f"{tag} serve", serve_pair, ())
        logits_same = _bitwise(res["mesh=None"][0], res["mesh (1, 1)"][0])
        print(f"[{tag} serve] prefill of {batch} x {seq} and {LM_MESH_DECODE} decode tokens, bf16: "
              f"mesh {res['mesh (1, 1)'][1]:.2f}s, mesh=None {res['mesh=None'][1]:.2f}s (host "
              f"wall); logits bitwise {logits_same}", flush=True)
        check(logits_same, f"{tag}: the mesh's serve logits are not the mesh=None bits")
        del params, res
        torch.cuda.empty_cache()

        # The train loop on the mesh against one card, at the smoke config.
        smoke = get_smoke_config(arch)

        def loops():
            out = {}
            for name, m in (("one card", None), ("mesh", mesh)):
                loop = train_loop.LoopConfig(steps=2, ckpt_dir=str(root / name.replace(" ", "_")),
                                             ckpt_every=2, keep=1, monitor_k=2,
                                             balance_every=2, log_every=1,
                                             dtype=torch.float32)
                out[name] = train_loop.run(smoke, ShapeConfig("t", 32, 4, "train"), m, loop,
                                           DataConfig(seed=0), device=dev)
            return out

        res = run(f"{tag} loop", loops, "fourier_sketch")
        a, b = res["one card"], res["mesh"]
        same = (_bitwise(a["state"], b["state"])
                and [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]])
        print(f"[{tag} loop] train_loop.run on the (1, 1) mesh, {smoke.name} smoke config, 2 "
              f"steps with the monitor and the balancer: state, monitor sketch and losses "
              f"bitwise the one-card loop's: {same}", flush=True)
        check(same, f"{tag} loop: the mesh loop differs from the one-card loop")
        del res, a, b
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # p = 4: gloo ranks on the card.
    import torch.multiprocessing as mp

    tag = f"lm-mesh p={LM_MESH_RANKS}"
    t0 = time.perf_counter()
    sizes = sizes or {"seq": LM_MESH_SEQ, "pipe_seq": LM_MESH_PIPE_SEQ, "micro": LM_MESH_MICRO,
                      "decode": LM_MESH_DECODE, "wide_decode": LM_MESH_WIDE_DECODE}
    cfgs = {a: dataclasses.replace(get_config(a), n_layers=LM_MESH_LAYERS if train
                                   else LM_MESH_GROUPED_LAYERS)
            for a, train, _, _ in LM_MESH_CASES}
    cfgs["pipe"] = get_config("llama3.2-1b")
    cfgs["compressed"] = dataclasses.replace(get_config(LM_MESH_COMPRESSED), n_layers=LM_MESH_LAYERS)
    if dev.type == "cuda":
        print(f"[{tag}] the parent process holds {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
              f"allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved as its ranks "
              "start", flush=True)
    ctx = mp.start_processes(_lm_mesh_rank, args=(str(root), dev.type, cfgs, sizes),
                             nprocs=LM_MESH_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + LM_MESH_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, f"{tag}: ranks still running after "
                                               f"{LM_MESH_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    spawn_s = time.perf_counter() - t0
    result = json.loads((root / "result.json").read_text())
    note = "gloo through the host, not an interconnect measurement"
    for line in result["lines"]:
        print(f"[{tag} {line['label']}] {line['text']} ({note})", flush=True)
    for line in result["lines"]:
        check(line["ok"], f"{tag} {line['label']}: {line['text']}")
    print(f"[{tag}] {LM_MESH_RANKS} gloo ranks on one {dev.type} device, spawned and joined in "
          f"{spawn_s:.1f}s", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f"[lm-mesh] {time.perf_counter() - t_phase:.1f}s", flush=True)


def _saved_rows(fn):
    """``fn()`` and the sequence rows of each group input that
    ``transformer._rematerialised`` was given (what remat "full" saves)."""
    from repro_torch.models import transformer as tfm

    rows, inner = [], tfm._rematerialised

    def spy(f, remat, *args):
        if getattr(f, "func", None) is not None and f.func.__name__ == "group":
            rows.append(args[0].shape[1])
        return inner(f, remat, *args)

    tfm._rematerialised = spy
    try:
        return fn(), rows
    finally:
        tfm._rematerialised = inner


def _gather_on_rank0(tree, specs, mesh, rank: int):
    """The whole tree on rank 0, empty leaves on the others (a collective,
    one leaf at a time: no other rank holds more than one whole leaf, so
    four ranks on one card never hold four whole models)."""
    from repro_torch.parallel import sharding as sh

    flat = dict(sh.walk(specs))

    def one(path, t):
        full = sh.gather_leaf(t, flat[path], mesh)
        return full if rank == 0 else full.new_empty(0)

    return sh.map_with_path(one, tree)


def _mesh_layout(cfg, sp, seq: int) -> str:
    """How the LM lays out ``cfg`` at S = ``seq`` on the mesh ``sp``."""
    from repro_torch.models import transformer as tfm

    attn = ("grouped over query heads" if tfm._attn_grouped(cfg, sp) else
            "over KV heads" if tfm._attn_tp(cfg, sp) else "replicated")
    return (f"sequence-parallel stream {tfm._seq_shard(cfg, sp, seq)}, attention {attn}, "
            f"vocab-parallel {tfm._vocab_tp(cfg, sp)}")


def _lm_mesh_rank(rank, root, dev_type, cfgs, sizes) -> None:
    """One rank of [lm-mesh p=4] (see LM_MESH_RANKS) on ``cfgs`` (the cut
    models of LM_MESH_CASES, the compressed step's and the pipeline's
    layer) at ``sizes``; rank 0 runs the
    one-card comparisons and writes ``result.json``."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import device as device_mod
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as ltrain
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.grad_compression import local_error_state
    from repro_torch.optim.optimizers import OptConfig, make_optimizer
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device_mod.resolve(dev_type)
    seq, pipe_seq, micro, n_decode = (sizes[k] for k in ("seq", "pipe_seq", "micro", "decode"))
    dist.init_process_group("gloo", init_method=f"file://{root}/init4", rank=rank,
                            world_size=LM_MESH_RANKS,
                            timeout=datetime.timedelta(seconds=LM_MESH_TIMEOUT_S))
    lines = []

    def line(label, ok, text):
        lines.append({"label": label, "ok": bool(ok), "text": text})

    def wall(fn, together=True):
        """``fn()`` and its host wall seconds; ``together``: every rank
        starts it at once (a barrier first)."""
        if together:
            dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        device_mod.sync(dev)
        return out, time.perf_counter() - t0

    try:
        mesh = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
        sp = C.Spmd(mesh)
        opt = make_optimizer(OptConfig(name="adamw"))
        shape = ShapeConfig("t", seq, 4, "train")
        for arch, train, decode_key, opt_name in LM_MESH_CASES:
            cfg = cfgs[arch]
            opt_cfg = OptConfig(name=opt_name)
            case_opt = make_optimizer(opt_cfg)
            n_tokens = sizes[decode_key]
            if cfg.moe_experts:
                cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
            batch = SyntheticLM(cfg, shape, DataConfig(seed=0), dev).batch(0)
            batch = {k: v for k, v in batch.items() if not k.startswith("_")}
            seq_live = tfm._seq_shard(cfg, sp, seq)
            layout = _mesh_layout(cfg, sp, seq)
            if train:
                step, _, specs, bspecs = ltrain.jit_train_step(
                    cfg, shape, mesh, opt_cfg, remat="full", dtype=torch.float32,
                    return_grads=True)
                rows = sh.shard_tree(batch, bspecs, mesh)
                state = ltrain.init_sharded_state(cfg, case_opt, mesh, seed=LM_TRAIN_SEED)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                ((_, metrics), saved), secs = wall(lambda: _saved_rows(lambda: step(state, rows)))
                peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
                params = _gather_on_rank0(state["params"], specs["params"], mesh, rank)
                grads = _gather_on_rank0(metrics.pop("grads"), specs["params"], mesh, rank)
                loss = float(metrics["loss"])
                del state
            else:
                rows = sh.shard_tree(batch, sh.batch_specs(cfg, shape, mesh), mesh)
            # Serving from the seed's parameters (drawn again, cut to this rank).
            serve_params = ltrain.init_sharded_state(cfg, case_opt, mesh,
                                                     seed=LM_TRAIN_SEED)["params"]
            serve_shape = ShapeConfig("d", seq + n_tokens, 4, "decode")

            def serve(p, m, toks):
                prompt = {k: v for k, v in toks.items() if k != "labels"}
                with torch.no_grad():
                    logits, cache, index = tfm.prefill(p, cfg, prompt, serve_shape.seq_len,
                                                       mesh=m, dtype=torch.float32)
                    out = [logits]
                    for t in range(n_tokens):
                        logits, cache = tfm.decode_step(p, cfg, toks["labels"][:, t:t + 1], cache,
                                                        index + t, mesh=m, dtype=torch.float32,
                                                        cache_len=serve_shape.seq_len)
                        out.append(logits)
                return out

            exchanges, inner = [], C.all_to_all
            C.all_to_all = lambda *a, **k: exchanges.append(1) or inner(*a, **k)
            try:
                got, serve_s = wall(lambda: serve(serve_params, mesh, rows))
            finally:
                C.all_to_all = inner
            tok = sh.token_spec(serve_shape, mesh)
            got = [sh.gather_leaf(r, tok, mesh) for r in got]
            del serve_params
            torch.cuda.empty_cache()
            if rank == 0:
                if train:
                    one = ltrain.init_state(cfg, case_opt, seed=LM_TRAIN_SEED, device=dev)
                    n_rows = batch["tokens"].shape[0] // mesh.size(0)
                    shards = [{k: v[i:i + n_rows] for k, v in batch.items()}
                              for i in range(0, batch["tokens"].shape[0], n_rows)]

                    def objective(p):
                        """The mesh step's objective on one card, and rank 0's loss."""
                        if not cfg.moe_experts:
                            ce = tfm.lm_loss(p, cfg, batch, dtype=torch.float32, remat="full")
                            return ce, ce
                        ce = tfm.lm_loss(p, cfg, batch, dtype=torch.float32, remat="full",
                                         aux_weight=0.0)
                        auxes = [tfm.forward(p, cfg, b, dtype=torch.float32)[1] for b in shards]
                        return ce + 0.01 * sum(auxes) / len(auxes), ce + 0.01 * auxes[0]

                    def one_step():
                        (_, value), g = ltrain.loss_and_grads(objective, one["params"])
                        kept = tree_map(torch.clone, g)
                        case_opt.update(g, one["opt"], one["params"], one["step"])
                        return float(value.detach()), kept

                    (want, want_grads), one_s = wall(one_step, together=False)
                    rel = abs(loss - want) / abs(want)
                    g_err = _leaf_errors(grads, want_grads)
                    err = _leaf_errors(params, one["params"])
                    blocks = seq // 2 if seq_live else seq
                    line(f"{arch} train", rel <= LM_MESH_LOSS_RTOL and g_err <= LM_MESH_LEAF_TOL
                         and err <= LM_MESH_LEAF_TOL and set(saved) == {blocks}
                         and seq_live == (cfg.d_model >= 4096),
                         f"{cfg.n_layers} layers at d={cfg.d_model}, B=4 x S={seq} float32, "
                         f"(2, 2) data x model ({layout}), {opt_name}: one train step "
                         f"{secs:.2f}s on the mesh (rank 0's peak {peak / 1e9:.2f} GB) against "
                         f"{one_s:.2f}s on one card (host wall); loss {loss:.6f} "
                         f"against {want:.6f} (relative {rel:.2e}, bar {LM_MESH_LOSS_RTOL}), "
                         f"gradients within {g_err:.2e} and parameters after the step within "
                         f"{err:.2e} of each leaf's max-abs (bar {LM_MESH_LEAF_TOL}); the rows "
                         f"of each group input remat saved {saved} (expected {blocks})")
                    del one, want_grads
                    torch.cuda.empty_cache()
                fresh = tfm.init_lm(LM_TRAIN_SEED, cfg, device=dev)
                want_rows, one_serve_s = wall(lambda: serve(fresh, None, batch), together=False)
                errs = [float((a - b).abs().max()) for a, b in zip(got, want_rows)]
                close = all(torch.allclose(a, b, atol=LM_ATOL, rtol=LM_RTOL)
                            for a, b in zip(got, want_rows))
                # One all-to-all a grouped layer whose cache has its
                # sequence over "model" (the others gather their heads).
                kinds = [tfm._kind(cfg, li)[0] for li in range(cfg.n_layers)]
                lengths = [min(cfg.window, serve_shape.seq_len) if k == "local"
                           else serve_shape.seq_len for k in kinds if k in ("attn", "local")]
                want_exchanges = (sum(sh.seq_sharded(n, sp.model, cfg) for n in lengths)
                                  if tfm._attn_grouped(cfg, sp) else 0)
                line(f"{arch} serve", close and len(exchanges) == want_exchanges,
                     f"prefill of 4 x {seq} and {n_tokens} decode tokens, float32 "
                     f"({layout}): {serve_s:.2f}s on the mesh against {one_serve_s:.2f}s on "
                     f"one card (host wall); logits max |diff| {max(errs):.2e} (atol {LM_ATOL}, "
                     f"rtol {LM_RTOL}); all-to-alls in the prefill {len(exchanges)} (expected "
                     f"{want_exchanges}: one a grouped attention layer, its cache's sequence over "
                     f"\"model\")")
                del fresh, want_rows
            if train:
                del params, grads
            del got
            torch.cuda.empty_cache()
            dist.barrier()

        # The compressed step over (2, 2) ("pod", "data"), against the plain
        # step on the same mesh.
        pod = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("pod", "data"))
        cfg = cfgs["compressed"]
        short = ShapeConfig("t", pipe_seq, 4, "train")
        batch = SyntheticLM(cfg, short, DataConfig(seed=1), dev).batch(0)
        batch = {k: v for k, v in batch.items() if not k.startswith("_")}
        rows = sh.shard_tree(batch, sh.batch_specs(cfg, short, pod), pod)
        specs = ltrain.state_specs(ltrain.state_shapes(cfg, opt), cfg, pod)["params"]
        comp = ltrain.init_sharded_state(cfg, opt, pod, seed=LM_TRAIN_SEED)
        comp["err"] = local_error_state(comp["params"])
        plain = ltrain.init_sharded_state(cfg, opt, pod, seed=LM_TRAIN_SEED)
        (_, mc), comp_s = wall(lambda: ltrain.build_compressed_train_step(
            cfg, opt, pod, remat="full", dtype=torch.float32, return_grads=True)(comp, rows))
        (_, mp_), plain_s = wall(lambda: ltrain.build_train_step(
            cfg, opt, mesh=pod, remat="full", dtype=torch.float32, return_grads=True)(plain, rows))
        comp_params = sh.gather_tree(comp["params"], specs, pod)
        err = _leaf_errors(comp_params, sh.gather_tree(plain["params"], specs, pod))
        g_comp = sh.gather_tree(mc["grads"], specs, pod)
        g_plain = sh.gather_tree(mp_["grads"], specs, pod)
        # The pods hold the same parameters after the step (bitwise).
        psp = C.Spmd(pod)
        pods_equal = all(torch.equal(*C.all_gather(t[None], psp, "pod", 0))
                         for t in tree_leaves(comp_params))
        pods_equal = float(C.all_reduce(torch.tensor(float(pods_equal), device=dev), psp,
                                        ("pod", "data"), "min")) == 1.0
        rel = abs(float(mc["loss"]) - float(mp_["loss"])) / abs(float(mp_["loss"]))
        resid = max(float(e.abs().max()) for e in tree_leaves(comp["err"]))
        del comp, plain, comp_params, mc, mp_
        torch.cuda.empty_cache()
        if rank == 0:
            # Each pod's gradient on one card (the pods hold rows 0-1 and
            # 2-3): a leaf's int16 step is the larger one's max-abs / 2^13.
            fresh = tree_map(lambda t: t.requires_grad_(True),
                             tfm.init_lm(LM_TRAIN_SEED, cfg, device=dev))
            pod_grads = [ltrain.loss_and_grads(lambda p, b=b: tfm.lm_loss(
                p, cfg, b, dtype=torch.float32, remat="full"), fresh)[1]
                for b in ({k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2))]
            steps = [max(float(a.abs().max()), float(b.abs().max())) / 2.0 ** 13
                     for a, b in zip(*(tree_leaves(g) for g in pod_grads), strict=True)]
            g_steps = [float((a - b).abs().max()) / q
                       for a, b, q in zip(tree_leaves(g_comp), tree_leaves(g_plain), steps,
                                          strict=True)]
            del fresh, pod_grads
            line("compressed", rel <= LM_MESH_LOSS_RTOL and max(g_steps) <= 1.0
                 and err <= LM_MESH_LEAF_TOL and pods_equal and math.isfinite(resid)
                 and resid > 0,
                 f"build_compressed_train_step, {cfg.name} at {cfg.n_layers} layers (d="
                 f"{cfg.d_model}), B=4 x "
                 f"S={pipe_seq}, (2, 2) pod x data, int16 payload of 13 bits: {comp_s:.2f}s "
                 f"against the plain step's {plain_s:.2f}s (host wall); loss relative "
                 f"{rel:.2e} (bar {LM_MESH_LOSS_RTOL}); the exchanged mean gradient within "
                 f"{max(g_steps):.3f} int16 steps of the plain step's (bar 1); parameters "
                 f"within {err:.2e} of each leaf's max-abs (bar {LM_MESH_LEAF_TOL}); the pods' "
                 f"parameters equal: {pods_equal}; largest residual {resid:.2e}")
        del g_comp, g_plain
        torch.cuda.empty_cache()

        # GPipe: 4 stages of one full-width layer each.
        pipe = init_device_mesh(dev.type, (LM_MESH_RANKS,), mesh_dim_names=("pipe",))
        full = cfgs["pipe"]

        def layer(li):
            gen = device_mod.generator(device_mod.derive_seed(LM_TRAIN_SEED, 1, li), dev)
            return tfm.init_layer(gen, full, "attn", "dense", False, dev)

        g = device_mod.generator(device_mod.derive_seed(LM_TRAIN_SEED, 400), dev)
        x = torch.randn((micro, 1, pipe_seq, full.d_model), generator=g, device=dev)
        pos = torch.arange(pipe_seq, device=dev)[None]

        def stage_fn(p, h):
            with torch.no_grad():
                return tfm.layer_forward(p, full, "attn", "dense", h, pos)[0]

        mine = tree_map(lambda t: t[None], layer(rank))
        out, pipe_s = wall(lambda: pipeline_apply(stage_fn, mine, x, pipe, axis="pipe"))
        if rank == 0:
            layers = [layer(li) for li in range(LM_MESH_RANKS)]
            seq_out = []
            for m in range(micro):
                h = x[m]
                for p in layers:
                    h = stage_fn(p, h)
                seq_out.append(h)
            want = torch.stack(seq_out)
            diff = float((out - want).abs().max())
            line("pipeline", diff <= 1e-5 * float(want.abs().max()),
                 f"pipeline_apply, {LM_MESH_RANKS} stages of one llama3.2-1B layer (d="
                 f"{full.d_model}), {micro} microbatches of 1 x {pipe_seq}, "
                 f"float32: {pipe_s:.2f}s (host wall; bubble "
                 f"{bubble_fraction(LM_MESH_RANKS, micro):.3f}); max |diff| against the "
                 f"stages in turn {diff:.2e}")
            (Path(root) / "result.json").write_text(json.dumps({"lines": lines}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


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
    check(len(instances) == 66, f"ptxas reported {len(instances)} structured instances, not 66")
    print("[ptxas structured_sketch] " + "; ".join(instances), flush=True)
    wide = [i for i in instances if "/NX=wide" in i]
    spilled = [i for i in wide if not i.endswith(" 0 B spilled")]
    check(len(wide) == 18 and not spilled,
          f"the wide structured instances: {len(wide)} of 18, spills in {spilled}")

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
    # m = 512), on pooled rows from a generator of their own; kernel 4 also
    # at the other families' monitors (d_model 768 - 6144, B = 4 or 1).
    lm_shapes = lm_train_shapes(dev)
    for label, x_t, w_t in lm_shapes["dense"]:
        check_sketch(fs, x_t, w_t, ones[:x_t.shape[0]], label)
    for label, x_t, op_t, wide_block in lm_shapes["structured"]:
        check_structured(ft, x_t, op_t, ones[:x_t.shape[0]], label, chain=wide_block)
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

    # 4c'. Kernels 4-5 at the monitor's wide blocks (d = 4096 .. 16384).
    wide_block_checks(fs, ft, dev)
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
    # The collapse (in-box mass Z <= 1e-12: r 8.4 to 1000 sigmas out of
    # [-1, 1]) beside entries just inside it (7.5 and 7.6 sigmas), and NaN
    # pseudo-data (the second erfc branch, then the collapse; the mean NaN).
    box = torch.ones(4, device=dev)
    collapse = check_denoise(kd, torch.tensor([[9.0, -9.0, 40.0, 8.4], [7.5, -7.6, 1e3, 0.0]],
                                              device=dev), 1.0, -box, box, "collapse")
    check(collapse["collapsed"] == 5, f"amp_denoise collapse: {collapse['collapsed']} "
          "entries collapsed, not 5")
    nan = float("nan")
    check_denoise(kd, torch.tensor([[nan, 0.2, -3.0, nan], [0.5, nan, nan, 2.0]], device=dev),
                  0.7, torch.tensor([-1.0, -inf, -1.0, -2.0], device=dev),
                  torch.tensor([1.0, 1.0, inf, 2.0], device=dev), "nan r")
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
        "structured_sketch_fleet": (ft, "STRUCTURED_FLEET_LAUNCHES"),
        "quantized_structured_sketch_fleet": (ft, "QUANTIZED_STRUCTURED_FLEET_LAUNCHES"),
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
    # timed alone; the graphed one then once more under the profiler for its
    # device time and operations (the profiler's own host cost inflates a
    # profiled wall time, so the busy share is the device time over the
    # unprofiled wall).  The eager runs are not profiled: the profiler's
    # processing of their ~10^5 device operations a run took ~136 s of the
    # smoke's clock, and no check reads their busy share.  CLOMPR's are
    # SHORT_CLOMPR_STEPS deep.
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

    graphed_walls = {}

    def short_decode(label, r, short_cfg, n_units, unit):
        """A short decode of ``r``'s sketch, eager then graphed: wall
        seconds, and for the graphed run device-busy seconds and device
        operations per ``unit`` (``n_units`` of them in the decode); the two
        must give the same bits (or the same relative SSE to 4 digits).
        Returns the graphed run's device operations by name: (launches,
        device microseconds)."""
        out_e, wall_e, _ = decode_once(r, short_cfg, True)
        out_g, wall_g, (caps, reps) = decode_once(r, short_cfg, False)
        t_prof = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            out_p, wall_p, _ = decode_once(r, short_cfg, False)
        check(all(torch.equal(a, b) for a, b in zip(out_g, out_p)),
              f"{label}: a repeated short decode differs")
        device_ops = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        t_prof = time.perf_counter() - t_prof - wall_p
        busy_g = sum(e.self_device_time_total for e in device_ops) / 1e6
        n_ops = sum(e.count for e in device_ops)
        by_name = {e.key: (e.count, e.self_device_time_total) for e in device_ops}
        parts = [
            f"eager wall {wall_e:.3f}s (not profiled: its device-busy share is not measured)",
            f"graphed wall {wall_g:.3f}s (profiled {wall_p:.3f}s, then {t_prof:.1f}s of the "
            f"profiler's processing), device busy {busy_g:.3f}s ({100 * busy_g / wall_g:.1f}%), "
            f"{n_ops} device operations, {n_ops / n_units:.1f} per {unit}, {caps} captures, "
            f"{reps} replays"
            + ("" if busy_g else " (the profiler saw no device time: busy share not measured)"),
        ]
        graphed_walls[label] = wall_g
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

    def in_graph(name, by_name, symbols, beside=""):
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
              f"(step 4, host included){beside}", flush=True)

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
    in_graph("amp_denoise", by_name, ("amp_denoise_kernel",),
             f"; the graphed GAMP iteration {graphed_walls['fit-amp'] * 1e6 / 30:.2f} us (the "
             "graphed short decode's wall over its 30 iterations)")
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

    # 9i. The LM's training path at llama3.2-1B width, then the other
    # families' (at published width, jamba and internvl2 cut in depth), the
    # activation monitor at the wide d_model (kernel 4's wide blocks), and the
    # restart invariant at its smoke config.
    lm_train_phase(dev, run, dryrun=True)
    t0 = time.perf_counter()
    for arch, (lm_batch, seq, depth) in LM_TRAIN_FAMILIES.items():
        lm_train_phase(dev, run, arch, lm_batch, seq, depth, steps=LM_TRAIN_FAMILY_STEPS,
                       restore=False)
    print(f"[lm-train families] {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    monitor_wide_phase(dev, run)
    print(f"[monitor wide] {time.perf_counter() - t0:.1f}s", flush=True)
    lm_restart_phase(dev, run)

    # 9j. The LM on a mesh: NCCL at one rank, then gloo ranks on the card.
    print(f"[smoke] {time.perf_counter() - smoke_t0:.1f}s before [lm-mesh]", flush=True)
    lm_mesh_phases(dev, run, launches)

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
        "structured_sketch_fleet": ("src/repro_torch/kernels/csrc/structured_sketch.cu",
                                    "src/repro/core/fleet.py:450"),
        "quantized_structured_sketch_fleet": ("src/repro_torch/kernels/csrc/structured_sketch.cu",
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
