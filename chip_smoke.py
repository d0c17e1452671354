#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits nonzero):
  1. device and build: the card's name and power limit (nvidia-smi), then
     the Hopper kernels compiled from src/repro_torch/kernels/csrc, with the
     tensor-core and tile kernels' registers and spills (nvcc -Xptxas -v)
     and their dynamic shared memory (the SSD tile kernel at state 16 and
     at state 128), the decode SIMT kernels' register
     range and spills, and machine-instruction counts (cuobjdump -sass) of
     the decode tc kernels and of both routes of the WKV6 and SSD kernels
     (FFMA against shared loads: what their designs rest on);
  2. kernel parity: each attention kernel against its plain PyTorch version
     at the qwen3-0.6b attention shapes (hd 128, 16 query / 8 kv heads), at
     the hymba-1.5b ones (hd 64, 25 query / 5 kv heads, G 5) and at the
     granite-moe-1b-a400m ones (hd 64, 16 query / 8 kv heads, G 2), bf16 and
     f32, and at the shapes of phase 11 (prefill B 4 x S 1100, decode over
     a [4, 1132] cache at lengths 1101..1132) — zero-length rows, per-row
     and ragged lengths, lengths at the decode kernels' tile and split
     edges, unmapped pages, an fp8 pool, a window; the chunked WKV6 kernel
     against the sequential recurrence at the rwkv6-3b shapes (40 heads of
     64, f32, y and the final state, S 128 / 100 / 17 / 1, lens-padded row
     tails) and the chunked SSD kernel against its sequential recurrence at
     the hymba-1.5b shapes (50 heads of 64, state 16, f32, y and the final
     state, S 128 / 100 / 1100 / 17 / 1, strided inputs, lens-padded row
     tails), each through its tile and its simt route; the grouped
     matmul against its plain version at granite-moe-1b-a400m's expert GEMMs
     (E 32, C 8 in decode and 320 in prefill, [d 1024 -> 1024] for w_in and
     [512 -> 1024] for w_out) and a ragged C 13 / d 72 / f 40, bf16 and
     f32 (grouped_matmul, flash_attention_fwd and both decode kernels in
     bf16 through both their tensor-core and their SIMT route); then the
     kernel, plain and library times (kernels and library calls as device
     time, a CUDA graph replayed over 24-150 layers' inputs, and eager; for
     WKV6 and SSD also the chunked torch scans that the plain serve path
     runs); WKV6 and SSD per route (tile against simt, in turns: tile,
     simt, simt, tile) at their serve shapes and SSD also at hymba's
     generate shape [4, 50, 1100, 64] and at granite4h-serve-chat's padded
     group [64, 128, 512, 64], state 128 (granite4h_cases holds every
     launch of that cell at its shapes on both routes); the kernels with
     routes per route
     (tc, simt_bf16, simt_f32):
     attention at qwen3's, granite's and hymba's heads and at hymba's S 1100
     prefill, paged decode at the same three head shapes, contiguous decode
     at qwen3's [8, 160] and hymba's [4, 1132] generate caches; and at
     gemma3-1b's heads (4 / 1 of 256, and 1 / 1 as on a tp shard; every
     bf16 launch asserted on the tensor-core route, held beside a forced
     simt_bf16 launch) prefill attention with window 0 and 512 and both
     decode kernels at its global layers' shapes (a bf16 and an fp8
     pool), held against their plain versions in bf16 and f32 and timed
     route by route in turns (tc, simt_bf16, simt_f32, then back) beside
     their bounds and SDPA;
  3. qwen3-0.6b at full width (28 layers, random weights from a seeded
     generator, bf16) served through the continuous-batching Scheduler over
     a 48-page pool, with the kernel launch counts of that run asserted
     (here and in every bf16 phase below: exact, and every launch on its
     kernel's fast route: tensor-core for attention, decode and the
     grouped matmul, tile for WKV6 and SSD), then
     a short profiled run for the device's busy and idle share;
  4. the same requests in f32 through the kernels and through the plain
     path: the first prefill's logits agree and the greedy streams match
     except at a step whose top-2 margin is under the tolerance;
  5. Engine.generate at full width over the contiguous cache (flash_decode),
     then a profiled short run;
  6. rwkv6-3b at full width (32 layers, d 2560, 40 WKV heads of 64, d_ff
     8960, vocab 65536, untied head; random weights, bf16) served through
     the Scheduler with no page pool, rwkv6_chunked launched by every layer
     of every prefill group, then a profiled short run;
  7. rwkv6-3b's requests in f32, kernel against the plain chunked scan, as
     in phase 4, every rwkv6_chunked launch on its tile route;
  8. rwkv6-3b through Engine.generate (batch 8 x prompt 128 + 32), then a
     profiled short run;
  9. hymba-1.5b at full width (32 layers, 29 of them windowed at 1024, d
     1600, 25/5 heads of 64 beside 50 SSD heads of 64 with state 16, d_ff
     5504, vocab 32001, untied head; random weights, bf16) served through
     the Scheduler over a 48-page pool for its 3 full layers: ssd_chunked
     launched by every layer and flash_attention_fwd by every full layer of
     every prefill group, flash_decode_paged by every full layer of every
     decode step; then a profiled short run;
 10. hymba-1.5b's requests in f32, kernels against the plain paths, every
     ssd_chunked launch on its tile route;
 11. hymba-1.5b through Engine.generate at batch 4 x prompt 1100 + 32: the
     1024-slot rings wrap in prefill and decode, the SSD kernel walks 17
     chunks and a tail; then a profiled short run;
 12. granite-moe-1b-a400m at full width (24 layers, d 1024, 16/8 heads of
     64, 32 experts top-8 with d_ff 512, vocab 49155, tied; random weights,
     bf16) served through the Scheduler over a 48-page pool: both expert
     GEMMs of every layer through grouped_matmul in every prefill group and
     decode step, flash_attention_fwd and flash_decode_paged by every
     layer, the launch counts asserted exactly; the router's logit spread,
     the first group's expert loads and each group's dropped choices (real
     and padding) printed; then a profiled short run;
 13. granite-moe-1b-a400m in f32, kernels against the plain path: first
     every layer alone on the same input (the plain path's hidden state
     into both), outputs within 1e-5 and the same routing except at router
     near-ties; then the requests of phase 12 with the routing of both
     sides recorded: streams may diverge only at a top-2 near-tie or after
     a flipped expert choice that reached the request (the random model
     amplifies the paths' 1e-6 differences layer over layer, and a flip
     moves the capacity drops of its whole group);
 14. granite-moe-1b-a400m through Engine.generate (batch 8 x prompt 128 +
     32, flash_decode and grouped_matmul), then a profiled short run;
 15. train-step: qwen3-0.6b at full width and depth (f32 params, adamw
     lr 1e-3) through Engine.step() for 6 waves of batch 16 x seq 512 (Nm
     16: 1-row microbatches) on the default device, the parameter server
     on the host: wave ms, tokens/s, peak device memory, the per-wave push
     (D2H + PS apply) and pull (PS snapshot + H2D) ms and the loss
     sequence; every loss finite, the last below the first, every tensor
     of the worker on the card, no kernel launched (training runs the
     plain path, as the JAX package's); then a profiled wave;
 16. train-parity: one wave of reduced qwen3-0.6b on the card against the
     same wave on the CPU in this process: loss, grads and adamw deltas;
 17. fleet: Engine.fit() at full width — single_node (2 VWs, WSP D 1) and
     bsp_baseline (2 VWs), 4 waves each of batch 16 x seq 256 in 4-row
     microbatches (Nm 4), and
     paper_hetero (4 VWs, D 2, async push, pull_every 2) at qwen3's widths
     on 4 layers: per-VW wave ms, gate waits, overlap seconds, peak
     memory; the staleness audit (max distance <= D) holds and every loss
     is finite;
 18. gemma3-1b at full width (26 layers, 4 of them global, window 512,
     4/1 heads of 256, vocab 262144, tied; random weights, bf16) served
     through the Scheduler over a 48-page pool: flash_attention_fwd and
     flash_decode_paged by every global layer, the counts exact and every
     launch on tc, as in every family; then the same requests in f32,
     kernel and plain streams identical;
 19. minitron-8b at full width (32 layers, d 4096, 32/8 heads of 128,
     relu^2 d_ff 16384, vocab 256000, untied; ~8.7 B params drawn in bf16,
     the init's peak memory printed): each layer alone on one input in f32
     against its plain path, then 8 requests served in bf16;
 20. musicgen-medium at full width (48 layers, d 1536, 24 heads of 64,
     vocab 2048) through Engine.generate and the stub frontend (prompts and
     each step's input are seeded embeddings); chameleon-34b (34 B params:
     no room beside its cache on one 80 GB card) is left to the CPU tests;
 21. chaos serving: qwen3-0.6b in bf16 through the kernels under two
     SlotFaults, recovered by requeue and by reprefill: streams equal the
     fault-free run's (a divergence only at a bf16 near-tie, printed), the
     fault counters equal the plan's;
 22. chaos training: qwen3-0.6b at full width, 2 VWs, WSP D 1, Nm 4, 6 waves
     of 16 x 256 under a WorkerCrash of vw1 at wave 2, message loss on
     vw0 -> ps, a PS stall at push 3 and a slowdown of vw0 from wave 1,
     FaultPolicy(evict_lag=1, rejoin_after_waves=1): the fault digest equals
     the same plan's on the CPU at reduced width, vw1 is evicted as dead
     and vw1r finishes waves, losses finite, repro_torch.obs.summary exits
     0 on the trace (staleness max <= 1); peak device memory before the
     crash and after the rejoin is printed, and the dead worker's state is
     released: once the run has ended, the device memory above what was
     held before it is the Engine's params and the live workers' state,
     within half of one worker's params;
 23. serve-cluster: qwen3-0.6b at full width (bf16) served by three
     replicas behind the Router (PartitionSpec(data=3), topology hetero:
     vw0 and vw1 share a pod, vw2 sits across 10 GbE; ReplicaSpec 8 / 48,
     4 / 24, 4 / 24 slots / pages; share_prefix and evict on), 24 seeded
     requests, 8 of them opening with one 64-token system prompt: building
     the Router takes one weight copy plus three pools of device memory
     (within 10%); the measured least_loaded run's launches equal 28 x the
     prefill groups and 28 x the decode steps summed over the replicas'
     sub-reports, all on tc, from the replica threads on one stream; the
     system prompt's pages lie on one replica (affinity hits >= 7, prefix
     hits > 0); per-replica requests, prefill groups, decode steps, decode
     step ms and peak pages, the merged tok/s, wall_s and
     modeled_fleet_wall_s, then a profiled short run; the same traffic in
     f32 through the Router and through a single-replica Scheduler (8
     slots, 48 pages, the same params): streams equal except after a step
     whose top-2 margin is under LOGIT_TOL (printed); under
     ReplicaDown(1, 4) in f32 one replica dies, its requests replay on the
     survivors in a second round, streams held to the fault-free run's the
     same way; the deadline policy's dispatch printed;
 24. spmd training: qwen3-0.6b at full width on the pipelined spmd
     backend, mesh (1, 4, 4) = 16 slots on the card (f32, TF32 off, batch
     16 x seq 512, Nm 16; depth cut to SPMD_LAYERS = 4, 1 a stage): one
     sgd-0.1 step of build_train_step against build_local_wave_step(cfg,
     16) on the same params and batch (params within 1e-4), the overlap
     schedule against the base (loss equal, params within 1e-6 of each
     leaf's max); Engine(plan).fit() with adamw for 4 waves: wave ms,
     tokens/s, peak device memory beside the card's name and power
     limit, losses finite and falling, the device
     memory the built Engine holds within 10% of params + moments (the
     shard views copy no weight) and, after fit(), the same before and
     after a cyclic gc (no reference cycle holds a wave's tensors); a
     profiled wave; then granite-moe-1b-a400m reduced on a (2, 2, 2) mesh
     of card slots against its local wave (the data axis and the MoE tp
     sum); no kernel launched in the phase;
 25. spmd serving: qwen3-0.6b at full width on the pipelined spmd
     backend, mesh (1, 4, 4) = 16 slots on the card (bf16, kernels
     "cuda"; depth cut to SPMD_SERVE_LAYERS = 4, 1 a stage):
     Engine.generate of 8 x 128 + 32 over the per-slot contiguous caches
     (flash_attention_fwd and flash_decode at one tp shard's 4 / 2 heads
     of 128 and one-row microbatches: layers x 4 x 8 launches a step,
     exact, all tc), then a profiled short run (device ops, idle share);
     the paged Scheduler over 48 pages of 16 for 8 requests of 16-128 +
     16 (flash_decode_paged over each (stage, tp) slot's own pool, exact):
     decode step ms, mean TTFT, tok/s, peak pages, the pool and one slot's
     pool bytes, peak device memory beside the card's name and power
     limit; each of the three kernels against its plain version at the
     shard shapes (the paged one over a slot's pool); the same requests
     in f32 through the kernels against the plain spmd path and the
     threads Engine (streams part only after a top-2 margin under
     LOGIT_TOL, printed); then granite-moe-1b-a400m (grouped_matmul over
     tp shards), rwkv6-3b (rwkv6_chunked) and hymba-1.5b (ssd_chunked
     beside the attention kernels) reduced on a (1, 2, 2) mesh, their
     launches exact and on their fast routes, and every launch held
     against its plain version on the inputs the pass handed it;
 26. the dry run (repro_torch.launch.dryrun's counter on meta tensors)
     against the card: phase 25's Plan (qwen3-0.6b's width, 4 layers,
     mesh 1 x 4 x 4, bf16, kernels "cuda") through Engine.prefill and one
     Engine.decode, on the card and on meta: kernel launches and routes
     exactly equal, aten ops equal (the same counter on the card's
     steps), the dry run's peak live bytes within 10% or 8 MiB of the
     growth of max_memory_allocated over each step, the counted dot FLOPs
     beside the two steps' profiled device busy ms; phase 24's train step
     at 1 layer dry-run, its argument bytes within 1% of the built
     Engine's params + moments; then moe_mlp_ep at granite-moe-1b-a400m's
     width (E 32 top-8, d 1024, ff 512, swiglu) over 4 slots, 4 shards x
     8 x 128 tokens: every grouped_matmul launch at [8, 4 cap, ...] held
     against its plain version, each shard's output against the plain
     moe_mlp on its tokens;
 27. one JSON line of per-kernel numbers.
The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside it, the script fails before printing any
result. It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# chunked WKV6 and SSD against their sequential recurrences (atol and
# rtol), as tests/test_kernels.py holds the Pallas kernels
RWKV_TOL = 5e-4
SSD_TOL = 1e-4
LOGIT_TOL = 1e-3                   # f32 full-width logits, kernel vs plain
N_LAYERS = 28
N_RWKV_LAYERS = 32
RWKV_MATS = ("wr", "wk", "wv", "wg", "wo", "cm_k", "cm_v", "cm_r")
HYMBA_MATS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo", "ssd_conv_w",
              "ssd_out_proj")
GRANITE_MATS = ("wq", "wk", "wv", "wo", "moe_w_in", "moe_w_out")
# each kernel's design, as the kernels line reports it
DESIGN = {
    "flash_decode_paged": "each row's positions split across blocks "
                          "(chunks of 16k positions from static shapes; "
                          "dead chunks load nothing), the splits merged by "
                          "logsumexp in the same launch (a ticket: the last "
                          "split merges); bf16 (route tc): per warp 16-"
                          "position K/V tiles through a 2-stage cp.async "
                          "ring, S^T = K q^T and O^T += V^T P^T on "
                          "mma.sync.m16n8k16 (positions / hd on M, the G "
                          "<= 8 query rows on N), P^T from S^T by "
                          "movmatrix, the block table read in the kernel, "
                          "fp8 widened in shared memory, 6 warps at hd "
                          "256; f32 or unaligned rows (simt): the same "
                          "splits with f32-FMA",
    "flash_attention_fwd": "bf16 (route tc): flash-attention-2 on "
                           "mma.sync.m16n8k16, Q fragments (re-read from "
                           "shared memory at hd 256) and P (bf16) in "
                           "registers, K/V double-buffered by cp.async; "
                           "f32 or unaligned rows (simt): f32-FMA tiles "
                           "through shared memory",
    "flash_decode": "the flash_decode_paged body (splits, tc / simt "
                    "routes) over a strided contiguous cache, with the "
                    "optional window",
    "rwkv6_chunked": "f32 (route tile): one 128-thread block per (row, "
                     "head, slice of 32 state columns) walks chunks of 16, "
                     "each chunk's r/k/w rows and v slice landing by "
                     "cp.async in a 2-stage ring while the one before "
                     "computes; cumsum as a shuffle scan across lanes; "
                     "scores, y = [r' | A] [S ; v] (K split over the 4 "
                     "warps) and the state update on 4x4 register tiles "
                     "fed by LDS.128, the slice's state in registers; "
                     "unaligned rows (simt): one block per (row, head), the "
                     "64x64 state in shared memory",
    "ssd_chunked": "f32 (route tile), state 128: one 256-thread block per "
                   "(row, 2 heads) walks chunks of 64, B/C/dt in a 2-stage "
                   "cp.async ring and each head's x reloaded once that "
                   "head is done; C B^T once per chunk for both heads; per "
                   "head y = exp(cs) C h + M x and the state update on 4x4 "
                   "and 4x8 register tiles fed by LDS.128, each thread's "
                   "4x8 of the state in registers (221 KB of shared "
                   "memory, one block an SM); state 16: one 256-thread "
                   "block per (row, head, "
                   "slice of 32 state columns) walks chunks of 64, x/B/C/dt "
                   "landing by cp.async in a 2-stage ring; C B^T on 4x4 "
                   "register tiles once per chunk for the block's heads, "
                   "turned into M = C B^T exp(cs_t - cs_s) dt_s (f64 cs) "
                   "in shared memory; y = [M | exp(cs) C] [x ; h] on 4x4 "
                   "register tiles fed by LDS.128, K split across warp "
                   "pairs, the causal triangle skipped by 16-row band; the "
                   "slice's state in registers; unaligned rows (simt): one "
                   "block per (row, head), the 16x64 state in shared "
                   "memory",
    "grouped_matmul": "bf16 C > 16 (tc_prefill): swapped (f on M, C on N) "
                      "wgmma.m64n160k16, 2 consumer warpgroups a 128x160 "
                      "tile, a producer warp's TMA copies into a 4-stage "
                      "ring handed over by mbarriers; bf16 C <= 16 "
                      "(tc_decode): swapped mma.sync.m16n8k16 over "
                      "128-column weight tiles, 4-stage cp.async ring; f32 "
                      "or unaligned (simt): f32-FMA tiles"}
# the kernels whose machine-instruction counts the kernels line carries
SASS_TAG = {"rwkv6_chunked": "wkv6_", "ssd_chunked": "ssd_"}
ROUTE_TOL = 1e-4                   # router logit K/K+1 margins counted as
                                   # near-ties in phase 13
# The block matrices are drawn at the JAX init's std 0.02 and then scaled by
# this: at 0.02 the tied-embedding residual dominates every layer's update
# and each greedy stream repeats its last prompt token, which would leave
# the stream comparison of phase 4 nothing to compare.
WEIGHT_SCALE = 10.0
# phases 24 and 25's depth: qwen3-0.6b's width on all 16 slots of its
# 1 x 4 x 4 mesh, 1 layer a stage. The spmd wave and decode step are
# host-bound (~27.5 k device ops a layer and train wave; a decode step is
# 4 tp shards x 8 one-row microbatches of small ops a layer, ~2.5 k device
# ops); at all 28 layers a wave took 24.2 s and the train phase 328 s, a
# decode step 1.5-1.9 s (PERF.md, train-spmd and serve-spmd), too long
# beside the other phases in the time limit; spmd_train_phase(dev,
# layers=None) and spmd_serve_phase(dev, layers=None, checks=False) run
# the full depth.
SPMD_LAYERS = 4
SPMD_SERVE_LAYERS = 4
DENSE_MATS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo")
# bf16 greedy picks whose top-2 logit margin is under this (the kernels'
# bf16 tolerance) count as near-ties in the chaos-serve comparison
BF16_TIE = 5e-2


# granite4h-serve-chat's serve shapes: 64 slots, prompts of 64..512
# tokens in the frozen [64, 512] prefill group (MoE capacity couples its
# rows), answers of up to 1024 tokens, pages of 16
G4H_SLOTS, G4H_PROMPT, G4H_GEN, G4H_PAGE = 64, 512, 1024, 16
# the row lengths of the cell's usual group: one admitted prompt of ~215
# tokens, the Scheduler's 63 idle rows at length 1
G4H_CELL_LENS = (215,) + (1,) * (G4H_SLOTS - 1)


def g4h_ssd_operands(dev, randn, gen, lengths, s):
    """ssd_chunked's operands in a granite-4.0-h prefill group of
    len(lengths) rows of width s, as models/ssm.py:ssd_mix hands them over:
    x, B_ and C_ column slices of one [rows, s, H P + 2 N] conv output (x a
    [rows, H, s, P] view), dt = exp(U(-7, -1.2)) as a [rows, H, s] view of
    [rows, s, H] memory, 0 past each row's length (lens padding: x, B_, C_
    stay nonzero there), a = -(1..16) over the H heads."""
    import torch

    from repro_torch.configs import get_arch
    cfg = get_arch("granite-4.0-h-small")
    H, N = cfg.n_ssm_heads, cfg.ssm_state
    P = cfg.d_inner // H
    rows = len(lengths)
    conv = randn(rows, s, H * P + 2 * N).mul_(0.5)
    x = conv[..., :H * P].reshape(rows, s, H, P).transpose(1, 2)
    dt = torch.empty((rows, s, H), device=dev).uniform_(
        -7.0, -1.2, generator=gen).exp_()
    live = torch.arange(s, device=dev)[None, :] < torch.as_tensor(
        lengths, device=dev)[:, None]
    dt = torch.where(live[..., None], dt, 0.0).transpose(1, 2)
    return (x, dt, conv[..., H * P:H * P + N], conv[..., H * P + N:],
            -torch.linspace(1.0, 16.0, H, device=dev))


def granite4h_cases(dev, randn, gen):
    """The kernel launches of granite-4.0-h-small's serve path at the
    shapes one card of its two-card expert-parallel deployment launches
    them in granite4h-serve-chat: widths from its config; ssd_chunked at
    (P, N) = (64, 128) over a [64, 128 heads, 512, 64] group whose rows are
    padded by their lengths (dt = 0 past them: lengths 64..512, and the
    cell's own pattern, one row of 215 and 63 of 1), a 100-token tail and
    one token; grouped_matmul over the 36 held experts' w_in (the [E, d, G ff]
    view, d 4096 -> 2 x 768) and w_out (768 -> 4096) at the expert rows
    models/moe.py's capacity gives a decode step's 64 tokens and a prefill
    group's 64 x 512; flash_attention_fwd over the [64, 512] group and
    flash_decode_paged over the 4 attention layers' pool at lengths up to
    prompt + answer, at 32 / 8 heads of 128. Yields (kernel, label, dtype,
    route, got, want): got / want give the kernel's output and its plain
    version's (a recurrence's: (y, final state)), to be called before the
    next case is drawn; every launch takes the wrapper's pick (tile for
    ssd_chunked) and the forced simt route (simt_bf16 for bf16)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode_paged
    from repro_torch.kernels.mamba_ssd import ssd_chunked
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.models.moe import capacity
    cfg = get_arch("granite-4.0-h-small")
    B, S, bf = G4H_SLOTS, G4H_PROMPT, torch.bfloat16

    def lens(n, lo, hi):
        """n row lengths spread log-uniformly over [lo, hi], hi first."""
        return torch.logspace(torch.log10(torch.tensor(float(hi))),
                              torch.log10(torch.tensor(float(lo))), n,
                              device=dev).round().long()

    for s, ln, what in ((S, lens(B, 64, S), "lengths 64..512"),
                        (S, G4H_CELL_LENS, "lengths 215, 63 x 1"),
                        (100, lens(8, 1, 100), "lengths 1..100"),
                        (1, lens(8, 1, 1), "one token")):
        ops = g4h_ssd_operands(dev, randn, gen, ln, s)
        for route in (None, "simt"):
            yield ("ssd_chunked", f"{list(ops[0].shape)} N "
                   f"{ops[2].shape[-1]}, {what}", torch.float32, route,
                   lambda: ssd_chunked(*ops, route=route),
                   lambda: kref.ssd_ref(*ops))
    del ops
    # one card holds half of the experts; the router and capacity count all
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts // 2
    for step, T in (("decode", B), ("prefill", B * S)):
        C = capacity(T, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
        for mat, (k, G, f) in (("w_in", (d, 2, ff)), ("w_out", (ff, 1, d))):
            x = randn(C, E, k, dtype=bf).transpose(0, 1)
            w = (randn(E, k, G, f) * k ** -0.5).to(bf).reshape(E, k, G * f)
            for route in (None, "simt_bf16"):
                yield ("grouped_matmul", f"{step} {mat} E {E} C {C}", bf,
                       route, lambda: grouped_matmul(x, w, route=route),
                       lambda: kref.gmm_ref(x, w))
    del x, w
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    heads = f"{Hq}/{KV}x{hd}"
    q = randn(B, S, Hq, hd, dtype=bf).transpose(1, 2)
    k = randn(B, S, KV, hd, dtype=bf).transpose(1, 2)
    v = randn(B, S, KV, hd, dtype=bf).transpose(1, 2)
    for route in (None, "simt_bf16"):
        yield ("flash_attention_fwd", f"{heads} [{B}, {S}]", bf, route,
               lambda: flash_attention_fwd(q, k, v, causal=True, route=route),
               lambda: kref.attention_ref(q, k, v, causal=True))
    del q, k, v
    ps, L = G4H_PAGE, sum(t == "attention" for t in cfg.layer_types)
    npg = (S + G4H_GEN) // ps
    ln = lens(B, S + 1, S + G4H_GEN).to(torch.int32)
    tab = torch.randperm(B * npg, generator=gen, device=dev).to(
        torch.int32).reshape(B, npg)
    tab = torch.where(torch.arange(npg, device=dev)[None] * ps < ln[:, None],
                      tab, -1).to(torch.int32)
    kp = randn(L, B * npg + 1, ps, KV, hd, dtype=bf)
    vp = randn(L, B * npg + 1, ps, KV, hd, dtype=bf)
    q1 = randn(B, Hq, hd, dtype=bf)
    for route in (None, "simt_bf16"):
        yield ("flash_decode_paged", f"{heads} B {B} pool {L} layers",
               bf, route,
               lambda: flash_decode_paged(q1, kp, vp, tab, ln, layer=L - 1,
                                          route=route),
               lambda: kref.decode_paged_ref(q1, kp, vp, tab, ln,
                                             layer=L - 1))


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def profile_run(label, run, cpu=True):
    """Profile one short run (`run()` returns its ServeReport, or anything
    else for a training wave; cpu=False records the device's activity
    only, for runs of many thousands of ops): wall time,
    device busy time (the sum of CUDA kernel and copy durations), the
    device's idle share and the top kernels. Returns (wall s, busy s; None
    when the profiler saw no device event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * cpu +
                 [ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        rep = run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name: dict = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + us, n + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e6
    if not by_name:
        log("profile", f"wall {wall * 1e3:.1f} ms; the profiler recorded no "
            f"device events: device busy share not measured")
        return wall, None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's kernels on the path, whether or not they make the top
    mine = {n: v for n, v in by_name.items() if any(
        f"::{k}<" in n or f"::{k}(" in n for k in (
            "decode_tc_kernel", "decode_simt_kernel", "attn_tc_kernel",
            "attn_kernel", "gmm_kernel", "gmm_tc_decode", "gmm_tc_prefill",
            "wkv6_kernel", "wkv6_tile_kernel", "ssd_kernel",
            "ssd_tile_kernel"))}
    detail = (f" ({rep.decode_steps} decode steps, {rep.prefill_calls} "
              f"prefills)" if hasattr(rep, "decode_steps") else "")
    log("profile", f"{label}{detail} "
        f"under torch.profiler: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f}, "
        f"{sum(n for _, n in by_name.values())} device kernels/copies; "
        f"top: " +
        "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top) +
        "; the port's kernels: " + ("; ".join(
            f"{n.replace('(anonymous namespace)::', '')[:70]} "
            f"{t / 1e3:.3f} ms x{c}" for n, (t, c) in sorted(mine.items()))
            or "none"))
    return wall, busy


def ptxas_entries(lib_name, tag):
    """(kernel, registers line, spill line) for each kernel of
    csrc/<lib_name>.cu whose name holds `tag`, from nvcc's -Xptxas -v log
    (names demangled with c++filt where the machine has it)."""
    import shutil
    from repro_torch.kernels import _build

    lines = _build.build_log(lib_name).splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or tag not in line:
            continue
        name = line.split("'")[1]
        if shutil.which("c++filt"):
            name = subprocess.run(["c++filt", name], capture_output=True,
                                  text=True).stdout.strip()
        name = name.replace("(anonymous namespace)::", "")
        info = [x.split("info    : ")[-1].strip() for x in lines[i + 1:i + 4]]
        out.append((name, next((x for x in info if "registers" in x), "?"),
                    next((x for x in info if "spill" in x), "?")))
    return out


def sass_counts(lib_name, tag, ops):
    """[(kernel, {op: count})] for each kernel of csrc/<lib_name>.cu whose
    name holds `tag`, counting the machine instructions that start with
    each of `ops` in `cuobjdump -sass` of the built library; [] where the
    toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    sass = subprocess.run([tool, "-sass", str(_build._build_dir() /
                                               f"lib{lib_name}.so")],
                          capture_output=True, text=True).stdout
    out = []
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if tag not in name:
            continue
        if shutil.which("c++filt"):
            name = subprocess.run(["c++filt", name], capture_output=True,
                                  text=True).stdout.strip()
        name = name.replace("(anonymous namespace)::", "")
        instrs = [line.split("*/", 1)[1].strip() for line in
                  block.splitlines() if line.strip().startswith("/*") and
                  "*/" in line and line.split("*/", 1)[1].strip()]
        out.append((name, {op: sum(i.lstrip("@!P0123456789T ").startswith(op)
                                   for i in instrs) for op in ops}))
    return out


def bf16_copy(params):
    """A bfloat16 copy of a param tree (blocks nested one level down)."""
    import torch
    return {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                if k == "blocks" else v.to(torch.bfloat16))
            for k, v in params.items()}


def _on_device(tree, dev) -> bool:
    """Every tensor leaf of a tree lives on `dev`'s device type."""
    import torch
    from repro_torch.core import tree as tree_lib
    return all(t.device.type == dev.type for t in tree_lib.leaves(tree)
               if isinstance(t, torch.Tensor))


def train_phases(dev):
    """Phases 15-17: training at full width (see the module docstring)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.api import (ClusterSpec, Engine, PartitionSpec, Plan,
                                 RunSpec, WSP, get_preset)
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.wave import build_local_wave_step, wave_grads
    from repro_torch.data.pipeline import MarkovLM, ShardedLoader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.obs import Tracer
    from repro_torch.optim import make_optimizer

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    q = ARCHS["qwen3-0.6b"]
    free()

    # ---- 15. train-step ------------------------------------------------
    t_phase = time.monotonic()
    TB, TS, NW = 16, 512, 6
    eng = Engine(Plan(arch=q, cluster=ClusterSpec(num_vw=1), sync=WSP(D=0),
                      run=RunSpec(max_waves=NW, batch=TB, seq=TS,
                                  optimizer="adamw", lr=1e-3)))
    if eng.device.type != dev.type:
        raise AssertionError(f"Engine(plan) trains on {eng.device}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, steps = [], []
    for _ in range(NW):
        t0 = time.monotonic()
        losses.append(eng.step())
        torch.cuda.synchronize()
        steps.append(dict(eng.step_times, total_s=time.monotonic() - t0))
    launched = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    ctx = eng._step_ctx
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train-step: losses {losses}")
    if not (_on_device(ctx["params"], dev) and
            _on_device(ctx["opt_state"], dev) and
            _on_device(eng._params, dev)):
        raise AssertionError("train-step: a worker tensor left the card")
    if launched:
        raise AssertionError(f"train-step: kernels launched {launched}; "
                             f"training runs the plain path")
    wave = [1e3 * s["wave_s"] for s in steps]
    med = float(np.median(wave[1:]))
    ms = lambda k: float(np.median([1e3 * s[k] for s in steps[1:]]))
    log("train", f"qwen3-0.6b full width ({q.num_layers} layers, "
        f"{sum(t.numel() for t in tree_lib.leaves(eng._params)):,} params, "
        f"f32, adamw 1e-3), Engine.step() x {NW} at batch {TB} x seq {TS}, "
        f"Nm {q.num_microbatches}: wave ms first {wave[0]:.1f}, median of "
        f"the rest {med:.1f} ({', '.join(f'{w:.1f}' for w in wave)}); "
        f"{TB * TS / (med / 1e3):.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; per wave (median of waves 2-{NW}): push "
        f"{ms('push_s'):.1f} ms (D2H {ms('d2h_s'):.1f} of it, "
        f"{ctx['staging'].nbytes / 2**20:.0f} MiB), pull {ms('pull_s'):.1f} "
        f"ms (H2D {ms('h2d_s'):.1f} of it), step total "
        f"{ms('total_s'):.1f} ms; losses "
        f"{', '.join(f'{l:.4f}' for l in losses)}; kernels launched: none; "
        f"{time.monotonic() - t_phase:.1f} s")
    profile_run("train-step: one Engine.step() wave", eng.step, cpu=False)
    del eng, ctx
    free()
    log("train", f"phase 15 took {time.monotonic() - t_phase:.1f} s")

    # ---- 16. train-parity: the card against the CPU ------------------
    t_phase = time.monotonic()
    ra = reduced(q)
    nm = ra.num_microbatches
    pcpu = lm.init_params(ra, torch.Generator().manual_seed(0))
    x, y = ShardedLoader(MarkovLM(ra.vocab_size, seed=0), 8, 64, 0, 1,
                         seed=17).next()
    out = {}
    for where in ("cpu", "cuda"):
        p = tree_lib.tree_map(lambda t: t.to(where), pcpu)
        opt = make_optimizer("adamw", 1e-3)
        d, _, loss = build_local_wave_step(ra, nm, opt)(p, opt.init(p), x, y)
        _, g = wave_grads(ra, nm, p, torch.as_tensor(x, device=where),
                          torch.as_tensor(y, device=where))
        out[where] = (float(loss), tree_lib.flatten_with_path(g),
                      tree_lib.flatten_with_path(d))
    # grads: the head product's operand grads are rounded to bf16 on both
    # devices (trap T4), so where the two f32 sums differ in their last
    # bits an element lands on the neighbouring bf16 value: one bf16 step
    # of the element (2^-8 |g|, the tied embedding's head part) plus 5e-4
    # of the leaf's largest |g| (what such a step does downstream) + 1e-8.
    # adamw's first delta is about -lr sign(g): compared within 1e-7 where
    # |g| > 10 x (5e-4 max|g| + 1e-8) and > 1e-5, bounded by lr (1 + wd
    # |p|) elsewhere.
    (lc, gc_, dc), (lg, gg, dg) = out["cpu"], out["cuda"]
    if abs(lc - lg) > 1e-5:
        raise AssertionError(f"train-parity: loss cpu {lc} cuda {lg}")
    worst_g = worst_d = 0.0
    covered = []
    pc = dict(tree_lib.flatten_with_path(pcpu))
    for (path, a), (_, b), (_, da), (_, db) in zip(gc_, gg, dc, dg):
        a, b = a.numpy(), b.cpu().numpy()
        da, db = da.numpy(), db.cpu().numpy()
        tol = 5e-4 * float(np.abs(a).max()) + 1e-8
        over = np.abs(a - b) - 2.0 ** -8 * np.abs(a) - tol
        if over.max() > 0:
            raise AssertionError(f"train-parity: grad {path} off by "
                                 f"{float(np.abs(a - b).max())}")
        worst_g = max(worst_g, float(np.abs(a - b).max()) /
                      (float(np.abs(a).max()) + 1e-30))
        res = (np.abs(a) > 10 * tol) & (np.abs(a) > 1e-5)
        ed = float(np.abs(da - db)[res].max()) if res.any() else 0.0
        bound = 1e-3 * (1 + 0.1 * np.abs(pc[path].numpy())) + 1e-9
        if ed > 1e-7 or np.any(np.abs(db) > bound):
            raise AssertionError(f"train-parity: delta {path} {ed}")
        worst_d = max(worst_d, ed)
        if a.ndim >= 2:
            covered.append(res.mean())
    log("train", f"train-parity: reduced qwen3-0.6b ({ra.num_layers} "
        f"layers, d {ra.d_model}), one adamw wave of 8 x 64 (Nm {nm}) on "
        f"the card against the CPU: loss {lg:.6f} / {lc:.6f}; grads within "
        f"{worst_g:.2e} of each leaf's max (tolerance 2^-8 of the element "
        f"+ 5e-4 of the max); deltas within "
        f"{worst_d:.2e} where |g| is resolved (tolerance 1e-7; "
        f"{min(covered):.3f}-{max(covered):.3f} of each matrix); "
        f"{time.monotonic() - t_phase:.1f} s")
    free()

    # ---- 17. fleet: fit() at full width --------------------------------
    # 4-row microbatches (Nm 4): a wave's host dispatch is a quarter of
    # phase 15's, so the phase stays short
    run = RunSpec(max_waves=4, batch=16, seq=256, optimizer="adamw",
                  lr=1e-3)
    part = PartitionSpec(num_microbatches=4)
    fleet = [("single_node", get_preset("single_node").replace(
                 arch=q, run=run, partition=part)),
             ("bsp_baseline", get_preset("bsp_baseline").replace(
                 arch=q, run=run, partition=part)),
             ("paper_hetero", get_preset("paper_hetero").replace(
                 arch=dataclasses.replace(q, num_layers=4), run=run,
                 partition=part))]
    def fleet_run(name, plan):
        """fit() one fleet Plan, check and print it; everything it builds
        is freed when it returns."""
        t_phase = time.monotonic()
        tracer = Tracer()
        eng = Engine(plan, tracer=tracer)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rep = eng.fit()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        by_vw = rep.losses_by_worker()
        if len(by_vw) != plan.cluster.num_vw or not all(
                np.all(np.isfinite(v)) and len(v) == run.max_waves
                for v in by_vw.values()):
            raise AssertionError(f"fleet {name}: losses {by_vw}")
        audit = "BSP: no staleness"
        if eng.workers:
            smax = rep.telemetry.staleness_max()
            if smax is None or smax > plan.sync.D or \
                    rep.telemetry.counters.get("wsp/staleness_violations"):
                raise AssertionError(f"fleet {name}: staleness {smax} > "
                                     f"D {plan.sync.D}")
            audit = f"staleness max {smax:.0f} <= D {plan.sync.D}"
            for w in eng.workers.values():
                if not (_on_device(w.params, dev) and
                        _on_device(w.opt_state, dev)):
                    raise AssertionError(f"fleet {name}: {w.wid} state "
                                         f"left the card")
            per = {wid: (f"wave {1e3 * np.median(w.metrics.wave_times):.1f} "
                         f"ms, push {1e3 * np.median(w.metrics.push_s):.1f} "
                         f"ms, pull {1e3 * np.median(w.metrics.pull_s):.1f} "
                         f"ms, overlap {w.metrics.overlap_seconds:.2f} s")
                   for wid, w in sorted(eng.workers.items())}
        else:
            if not _on_device(eng._params, dev):
                raise AssertionError(f"fleet {name}: weights left the card")
            per = {}
        waits = {k: round(v, 3) for k, v in rep.wait_seconds.items()}
        ends = {k: (round(v[0], 3), round(v[-1], 3))
                for k, v in sorted(by_vw.items())}
        log("train", f"fleet {name} ({plan.describe()}, "
            f"{plan.arch.num_layers} layers, batch 16 x seq 256, Nm 4): "
            f"{rep.waves} waves in {rep.wall_s:.1f} s; per VW: {per}; gate "
            f"waits {waits}; overlap {rep.overlap_seconds:.2f} s; pushed "
            f"{rep.bytes_pushed / 2**30:.2f} GiB (wire "
            f"{rep.bytes_wire / 2**30:.2f}), modeled network "
            f"{rep.comm_seconds:.2f} s; losses first/last per VW {ends}; "
            f"{audit}; peak device memory {peak / 2**30:.2f} GiB (held "
            f"before the run {held / 2**30:.2f}); "
            f"{time.monotonic() - t_phase:.1f} s")

    for name, plan in fleet:
        fleet_run(name, plan)
        free()


def chaos_train_phase(dev):
    """Phase 22: chaos training at full width (see the module docstring)."""
    import gc
    import threading

    import numpy as np
    import torch

    from repro_torch.api import (ClusterSpec, Engine, FaultPlan, FaultPolicy,
                                 LinkFault, PartitionSpec, Plan, PSStall,
                                 RunSpec, WSP, WorkerCrash, WorkerSlowdown)
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core import tree as tree_lib
    from repro_torch.obs import Tracer
    from repro_torch.obs.summary import main as summary_main

    t_phase = time.monotonic()
    faults = FaultPlan(seed=22, events=(
        WorkerCrash(vw=1, wave=2),
        LinkFault(src="vw0", dst="ps", start_msg=0, n_msgs=6, kind="loss",
                  p=0.5),
        PSStall(at_push=3, seconds=0.5),
        WorkerSlowdown(vw=0, wave=1, extra_s=0.5)))
    # a full-width wave takes seconds: the stall grace is far above it, so
    # only the crashed worker (dead: its thread is gone) is ever evicted
    policy = FaultPolicy(evict_lag=1, rejoin_after_waves=1,
                         stall_grace_s=120.0)

    def plan(arch, batch, seq):
        return Plan(arch=arch, cluster=ClusterSpec(num_vw=2), sync=WSP(D=1),
                    partition=PartitionSpec(num_microbatches=4),
                    run=RunSpec(max_waves=6, batch=batch, seq=seq,
                                optimizer="adamw", lr=1e-3),
                    faults=faults, fault_policy=policy)
    # the same plan on the CPU at reduced width: the digest depends on the
    # plan, not on the model or the device
    cpu = Engine(plan(reduced(ARCHS["qwen3-0.6b"]), 4, 32),
                 device="cpu").fit()
    t_cpu = time.monotonic() - t_phase
    q = ARCHS["qwen3-0.6b"]
    tracer = Tracer()
    eng = Engine(plan(q, 16, 256), tracer=tracer)
    # device memory sampled while the crashed worker still trains beside
    # vw0 ("before") and while its successor does ("after")
    samples = {"before": [], "after": []}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            ws = dict(eng.workers)
            v0, v1, v1r = ws.get("vw0"), ws.get("vw1"), ws.get("vw1r")
            if v1r is not None and v1r.is_alive():
                samples["after"].append(torch.cuda.memory_allocated(dev))
            elif v1 is not None and v1.is_alive() and not v1.crashed and \
                    v0 is not None and v0.params is not None and \
                    v1.params is not None:
                samples["before"].append(torch.cuda.memory_allocated(dev))
            time.sleep(0.02)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    mon = threading.Thread(target=watch, daemon=True)
    mon.start()
    try:
        rep = eng.fit()
        torch.cuda.synchronize()
    finally:
        stop.set()
        mon.join()
    digest = rep.fault_digest()
    if digest != cpu.fault_digest():
        raise AssertionError(f"chaos train: the card's digest {digest} != "
                             f"the CPU's {cpu.fault_digest()}")
    succ = eng.workers.get("vw1r")
    if ("vw1", "dead") not in digest["evictions"] or succ is None or \
            not succ.done or succ.metrics.waves <= 0:
        raise AssertionError(f"chaos train: evictions {rep.evictions}, "
                             f"rejoins {rep.rejoins}")
    losses = [l for _, _, l in rep.losses]
    if not (losses and np.all(np.isfinite(losses))):
        raise AssertionError(f"chaos train: losses {losses}")
    dead = eng.workers["vw1"]
    if dead.params is not None or dead.opt_state is not None:
        raise AssertionError("chaos train: the crashed worker still holds "
                             "its device state")
    before, after = (max(samples[k]) if samples[k] else None
                     for k in ("before", "after"))
    if before is None or after is None:
        raise AssertionError(f"chaos train: no device memory sampled while "
                             f"vw1 ({len(samples['before'])} samples) or "
                             f"vw1r ({len(samples['after'])}) trained")
    worker_bytes = sum(t.numel() * t.element_size() for t in
                       tree_lib.leaves(eng.workers["vw0"].params))

    def device_bytes(*trees):
        """Bytes of the distinct device storages the trees hold."""
        seen = {}
        for t in tree_lib.leaves(list(trees)):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    def state_of(w):
        return [w.params, w.opt_state,
                w.staging._dev if w.staging is not None else None]
    # the two peaks differ by how the two workers' activations happen to
    # overlap in each window, which is timing, not state. What stays on the
    # card once the run has ended is exact: every byte above what was held
    # before the run must belong to the Engine's params or to a live
    # worker, so a dead worker's tensors cannot hide in it
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev) - held
    live = device_bytes(eng._params, *(state_of(w) for wid, w in
                                       eng.workers.items() if wid != "vw1"))
    one_worker = device_bytes(*state_of(succ))
    stray = resident - live
    if stray > 0.5 * worker_bytes:
        raise AssertionError(f"chaos train: {resident} B stay on the card "
                             f"after the run, {stray} B of them held by no "
                             f"live worker (one worker's params: "
                             f"{worker_bytes} B, its whole state: "
                             f"{one_worker} B)")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "chaos_train_trace.json")
    tracer.export(path)
    if summary_main([path]) != 0:
        raise AssertionError("chaos train: repro_torch.obs.summary failed "
                             "on the exported trace")
    smax = rep.telemetry.staleness_max()
    if smax is None or smax > 1 or \
            rep.telemetry.counters.get("wsp/staleness_violations"):
        raise AssertionError(f"chaos train: staleness max {smax} > D 1")
    per = {wid: (w.metrics.waves, round(float(np.median(w.metrics.wave_times))
                                        * 1e3, 1) if w.metrics.wave_times
                 else None) for wid, w in sorted(eng.workers.items())}
    log("chaos", f"train qwen3-0.6b full width ({q.num_layers} layers, f32, "
        f"adamw 1e-3), 2 VWs, WSP D 1, Nm 4, batch 16 x seq 256, 6 waves "
        f"under {faults.describe()} and FaultPolicy(evict_lag=1, "
        f"rejoin_after_waves=1, stall_grace_s=120): digest {digest} equals "
        f"the CPU run's at reduced width ({t_cpu:.1f} s); evictions "
        f"{rep.evictions}, rejoins {rep.rejoins}; per worker (waves, median "
        f"wave ms) {per}; ps_stalls {rep.ps_stalls}, late pushes "
        f"{rep.late_pushes}; losses first/last {losses[0]:.4f} / "
        f"{losses[-1]:.4f}, all finite; staleness max {smax:.0f} <= D 1; "
        f"peak device memory before the crash {before / 2**30:.2f} GiB, "
        f"after the rejoin {after / 2**30:.2f} GiB (one worker's params "
        f"{worker_bytes / 2**30:.2f} GiB, its whole state "
        f"{one_worker / 2**30:.2f} GiB; held before the run "
        f"{held / 2**30:.2f} GiB); after the run {resident / 2**30:.2f} GiB "
        f"stay, {live / 2**30:.2f} of them the Engine's params and the live "
        f"workers' state, {stray / 2**20:.1f} MiB held by neither: the dead "
        f"worker's state was released; "
        f"wall {rep.wall_s:.1f} s; phase {time.monotonic() - t_phase:.1f} s")
    del eng, rep
    gc.collect()
    torch.cuda.empty_cache()


def spmd_train_phase(dev, arch=None, layers=SPMD_LAYERS, card=""):
    """Phase 24: spmd training at full width (see the module docstring).
    `arch` replaces qwen3-0.6b (a CPU rehearsal passes a reduced one);
    `layers` cuts its depth (None: all of its layers); `card` is the
    card's name and power limit as nvidia-smi gives them, printed beside
    the phase's times."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.api import Engine, PartitionSpec, Plan, RunSpec, WSP
    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced
    from repro_torch.core import tree as tree_lib
    from repro_torch.core import wave
    from repro_torch.data.pipeline import MarkovLM, ShardedLoader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh_auto
    from repro_torch.models import lm, moe
    from repro_torch.optim import make_optimizer

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.monotonic() - t0

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in
                   tree_lib.leaves(tree) if isinstance(t, torch.Tensor))

    def worst(a, b, rel=False):
        """max |a - b| over the leaves (rel: each leaf's over its max)."""
        out = 0.0
        for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)):
            d = float((x - y).abs().max())
            out = max(out, d / float(y.abs().max()) if rel else d)
        return out

    t_phase = time.monotonic()
    reset_launches()
    names = ("data", "stage", "tp")
    q = arch or ARCHS["qwen3-0.6b"]
    depth = q.num_layers
    if layers is not None:
        q = dataclasses.replace(q, num_layers=layers)
    TB, TS, nm = 16, 512, q.num_microbatches
    mesh = make_mesh_auto((1, q.stages, q.tp), names)
    slots = {d.type for d in mesh.devices.ravel()}
    if slots != {dev.type}:
        raise AssertionError(f"spmd: mesh slots on {slots}")
    x, y = ShardedLoader(MarkovLM(q.vocab_size, seed=24), TB, TS, 0,
                         1).next()

    # ---- 24a. one sgd step: the pipeline against the local wave ---------
    params = lm.init_params(q, torch.Generator(device=dev).manual_seed(24),
                            device=dev)
    sgd = make_optimizer("sgd", 0.1)

    def spmd_step(overlap):
        run = RunConfig(arch=q, shape=ShapeConfig("spmd", TS, TB, "train"),
                        optimizer="sgd", lr=0.1, compute_dtype="float32",
                        loss_chunk=512, overlap=overlap)
        step, _ = wave.build_train_step(run, mesh)
        t0 = time.monotonic()
        new, _, m = step(params, sgd.init(params),
                         {"inputs": x, "labels": y})
        return new, float(m["loss"]), sync_s(t0)

    base, l_base, t_base = spmd_step(False)
    t0 = time.monotonic()
    deltas, _, l_local = wave.build_local_wave_step(q, nm, sgd)(
        params, sgd.init(params), x, y)
    l_local = float(l_local)
    t_local = sync_s(t0)
    local = tree_lib.tree_map(torch.add, params, deltas)
    del deltas
    d_local = worst(base, local)
    del local
    free()
    over, l_over, t_over = spmd_step(True)
    d_over = worst(over, base, rel=True)
    del over
    if d_local >= 1e-4 or abs(l_base - l_local) > 1e-5 * abs(l_local):
        raise AssertionError(f"spmd: pipelined step vs the local wave: "
                             f"params {d_local:.3e} (tolerance 1e-4), loss "
                             f"{l_base} / {l_local}")
    if l_over != l_base or d_over > 1e-6:
        raise AssertionError(f"spmd: overlap vs base: loss {l_over} / "
                             f"{l_base}, params {d_over:.3e} of the leaf "
                             f"max (tolerance 1e-6)")
    log("spmd", f"qwen3-0.6b full width ({q.num_layers} of its {depth} "
        f"layers, {q.layer_slots} a stage; f32, TF32 off) on mesh (1, {q.stages}, {q.tp}) = {mesh.size} slots on "
        f"{len(mesh.physical())} device(s), batch {TB} x seq {TS}, Nm {nm}: "
        f"one sgd-0.1 step of build_train_step against "
        f"build_local_wave_step(cfg, {nm}) on the same params and batch: "
        f"params within {d_local:.3e} (tolerance 1e-4), loss {l_base:.6f} / "
        f"{l_local:.6f}; the overlap schedule: loss {l_over:.6f} (equal), "
        f"params within {d_over:.3e} of each leaf's max (tolerance 1e-6); "
        f"step s: base {t_base:.2f}, local {t_local:.2f}, overlap "
        f"{t_over:.2f}")
    del base, params
    free()

    # ---- 24b. Engine.fit() on backend="spmd", adamw ---------------------
    plan = Plan(arch=q, partition=PartitionSpec(stages=q.stages, tp=q.tp,
                                                data=1),
                sync=WSP(D=0),
                run=RunSpec(backend="spmd", max_waves=4, batch=TB, seq=TS,
                            optimizer="adamw", lr=1e-3))
    held = torch.cuda.memory_allocated(dev)
    eng = Engine(plan)
    eng._ensure_spmd()
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated(dev) - held
    st = eng._spmd
    want = nbytes(st["params"]) + nbytes(st["opt_state"])
    if abs(built - want) > 0.1 * want:
        raise AssertionError(f"spmd: the built Engine holds {built} B, "
                             f"params + moments are {want} B")
    torch.cuda.reset_peak_memory_stats()
    waves = []
    rep = eng.fit(callback=lambda w, loss, dt: waves.append(dt))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    uncollected = torch.cuda.memory_allocated(dev) - held
    gc.collect()
    resident = torch.cuda.memory_allocated(dev) - held
    losses = [l for _, _, l in rep.losses]
    if not (len(losses) == 4 and np.all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"spmd: losses {losses}")
    if abs(resident - want) > 0.1 * want or \
            uncollected - resident > 0.01 * want:
        raise AssertionError(f"spmd: after fit() {uncollected} B stay "
                             f"({resident} B once the cyclic gc ran), params "
                             f"+ moments are {want} B")
    med = float(np.median(waves[1:]))
    log("spmd", f"Engine(plan).fit() on backend spmd ({card}), adamw "
        f"1e-3, 4 waves of {TB} x {TS}: wave ms first {1e3 * waves[0]:.1f}, median of the "
        f"rest {1e3 * med:.1f} ({', '.join(f'{1e3 * w:.1f}' for w in waves)})"
        f"; {TB * TS / med:.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} of it above "
        f"the {held / 2**30:.2f} GiB held before the Engine; the built "
        f"Engine holds "
        f"{built / 2**30:.3f} GiB = params + adamw moments "
        f"{want / 2**30:.3f} GiB (the shard views copy no weight), after "
        f"fit() {uncollected / 2**30:.3f} GiB ({resident / 2**30:.3f} once "
        f"the cyclic gc ran: no reference cycle holds a wave's tensors); "
        f"losses "
        f"{', '.join(f'{l:.4f}' for l in losses)}; wait_seconds "
        f"{rep.wait_seconds}")
    profile_run("spmd: one Engine.step() wave", eng.step, cpu=False)
    del eng, st, rep
    free()

    # ---- 24c. granite-moe reduced on a (2, 2, 2) mesh of card slots -----
    g = reduced(ARCHS["granite-moe-1b-a400m"], stages=2, tp=2, num_layers=4,
                num_microbatches=2, remat=True, capacity_factor=8.0)
    gmesh = make_mesh_auto((2, 2, 2), names)
    gp = lm.init_params(g, torch.Generator(device=dev).manual_seed(25),
                        device=dev)
    xg, yg = ShardedLoader(MarkovLM(g.vocab_size, seed=25), 8, 32, 0,
                           1).next()
    step, _ = wave.build_train_step(
        RunConfig(arch=g, shape=ShapeConfig("g", 32, 8, "train"),
                  optimizer="sgd", lr=0.1, compute_dtype="float32",
                  loss_chunk=16), gmesh)
    new, _, m = step(gp, sgd.init(gp), {"inputs": xg, "labels": yg})
    with moe.record_routing() as recs:
        dg, _, lg = wave.build_local_wave_step(g, 4, sgd)(
            gp, sgd.init(gp), xg, yg)
    margin = min(float(moe.topk_margin(r["logits"].detach(),
                                       g.top_k).min()) for r in recs)
    d_g = worst(new, tree_lib.tree_map(torch.add, gp, dg))
    if d_g >= 1e-4 or not float(m["aux"]) > 0:
        raise AssertionError(f"spmd: granite (2, 2, 2) vs its local wave: "
                             f"params {d_g:.3e}, aux {float(m['aux'])}, "
                             f"router K/K+1 margin {margin:.3e}")
    launched = {k: v for k, v in LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"spmd: kernels launched {launched}; training "
                             f"runs the plain path")
    log("spmd", f"granite-moe-1b-a400m reduced ({g.num_layers} layers, d "
        f"{g.d_model}, {g.num_experts} experts top-{g.top_k}) on mesh "
        f"(2, 2, 2) = 8 {dev.type} slots: one sgd step within {d_g:.3e} of "
        f"its local wave (tolerance 1e-4), loss {float(m['loss']):.6f} / "
        f"{float(lg):.6f}, aux {float(m['aux']):.4f}, smallest router K/K+1 "
        f"margin {margin:.3e}; kernels launched in the phase: none; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    free()


def spmd_serve_phase(dev, arch=None, layers=SPMD_SERVE_LAYERS, card="",
                     checks=True):
    """Phase 25: spmd serving at full width (see the module docstring).
    `arch` replaces qwen3-0.6b (a CPU rehearsal passes a reduced one);
    `layers` cuts its depth (None: all of its layers); `card` is the
    card's name and power limit as nvidia-smi gives them, printed beside
    the phase's numbers; checks=False runs the bf16 generate and Scheduler
    alone (the full-depth record). Returns {path: launches} of the measured
    runs."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.api import (Engine, PartitionSpec, Plan, RunSpec,
                                 ServeSpec)
    from repro_torch.api.serving import Request, Scheduler
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged)
    from repro_torch.models import lm

    def measured():
        return dict(LAUNCHES, routes={n: dict(r) for n, r in ROUTES.items()})

    def expect(tag, got, need, f32=False):
        """`need` {kernel: launches}: exactly those, every other kernel
        none, and (bf16) every launch on its fast route."""
        for name in LAUNCHES:
            if got[name] != need.get(name, 0):
                raise AssertionError(f"serve-spmd {tag}: launches {got} "
                                     f"against exactly {need}")
            fast = sum(n for r, n in got["routes"].get(name, {}).items()
                       if (r == "simt_f32" if f32 else
                           r.startswith("tc") or r == "tile"))
            if name in got["routes"] and fast != got[name]:
                raise AssertionError(f"serve-spmd {tag}: {name} routes "
                                     f"{got['routes'][name]}")

    def scaled(a, seed, dtype, mats=DENSE_MATS):
        """Seeded random params of `a` on the card, the block matrices
        `mats` scaled by WEIGHT_SCALE, in `dtype`."""
        p = lm.init_params(a, torch.Generator(device=dev).manual_seed(seed),
                           dtype=torch.float32, device=dev)
        for name in mats:
            p["blocks"][name].mul_(WEIGHT_SCALE)
        return {k: ({n: t.to(dtype) for n, t in v.items()}
                    if k == "blocks" else v.to(dtype)) for k, v in p.items()}

    def err_max(a, b):
        return (a.float() - b.float()).abs().max().item()

    class Margins(Scheduler):
        """Records each greedy pick's top-2 logit margin, keyed (rid, k)."""

        def __init__(self, engine):
            super().__init__(engine)
            self.margins = {}

        def _pick_one(self, row, rid, k):
            top = np.partition(row, -2)[-2:]
            self.margins[(rid, k)] = float(top[1] - top[0])
            return super()._pick_one(row, rid, k)

    def streams_held(tag, got, oracle):
        """got's streams equal the oracle's (a Margins run) but after a
        step whose oracle top-2 margin is under LOGIT_TOL; returns the
        divergences and the smallest margin."""
        parted = 0
        for a, b in zip(got.requests, oracle.requests):
            if a.tokens != b.tokens:
                k = next(i for i, (x, y) in enumerate(zip(a.tokens,
                                                          b.tokens)) if x != y)
                m = oracle_margins[tag][(b.rid, k)]
                if m >= LOGIT_TOL:
                    raise AssertionError(
                        f"serve-spmd f32 {tag}: rid {a.rid} parts at token "
                        f"{k}, top-2 margin {m:.3e} >= {LOGIT_TOL}")
                log("serve-spmd", f"f32 {tag}: rid {a.rid} parts at token "
                    f"{k} after a top-2 margin of {m:.3e} (< {LOGIT_TOL})")
                parted += 1
        return parted

    t_phase = time.monotonic()
    q = arch or ARCHS["qwen3-0.6b"]
    depth = q.num_layers
    if layers is not None:
        q = dataclasses.replace(q, num_layers=layers)
    S_, T_ = q.stages, q.tp
    part = PartitionSpec(stages=S_, tp=T_, data=1)
    spmd = RunSpec(backend="spmd", compute_dtype="bfloat16")
    gen_sv = ServeSpec(prompt_len=128, gen=32, max_batch=8,
                       kernel_backend="cuda")
    sch_sv = ServeSpec(prompt_len=128, gen=16, max_batch=8, page_size=16,
                       max_pages=48, kernel_backend="cuda")
    nm = min(q.num_microbatches, gen_sv.max_batch)
    per = q.num_layers * T_ * nm          # launches a prefill / decode step
    rng = np.random.default_rng(25)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, q.vocab_size, int(rng.integers(16, 129)), dtype=np.int32))
        for i in range(8)]
    held = torch.cuda.memory_allocated(dev)
    p16 = scaled(q, 25, torch.bfloat16)
    out = {}
    shape = (f"{q.name} full width ({q.num_layers} of its {depth} layers, "
             f"{q.layer_slots} a stage; d {q.d_model}, "
             f"{q.num_heads}/{q.num_kv_heads} heads of {q.head_dim}, vocab "
             f"{q.vocab_size}) on mesh (1, {S_}, {T_}), Nm {nm}, bf16")

    # ---- 25a. Engine.generate, contiguous cache --------------------------
    plan = Plan(arch=q, run=spmd, partition=part, serve=gen_sv)
    eng = Engine(plan, params=p16, device=dev)
    Engine(plan.replace(serve__gen=2), params=p16, device=dev).generate()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rep = eng.generate()
    torch.cuda.synchronize()
    got = measured()
    expect("generate", got, {"flash_attention_fwd": per,
                             "flash_decode": per * rep.decode_steps})
    if rep.tokens.shape != (8, 32) or not (
            (rep.tokens >= 0) & (rep.tokens < q.vocab_size)).all():
        raise AssertionError(f"serve-spmd generate: tokens {rep.tokens}")
    out[f"{q.name} generate-spmd"] = got
    log("serve-spmd", f"{shape}; {card}: generate 8 x 128 + 32: prefill "
        f"{rep.prefill_s * 1e3:.1f} ms, decode step {rep.ms_per_token():.2f}"
        f" ms over {rep.decode_steps} steps, {rep.tokens_per_s():.1f} tok/s;"
        f" launches a step: {per} flash_decode, the prefill {per} "
        f"flash_attention_fwd (exact, all tc); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} above "
        f"the {held / 2**30:.2f} held before the phase)")
    profile_run("serve-spmd: Engine.generate, batch 8 x 4 tokens",
                Engine(plan.replace(serve__gen=4), params=p16,
                       device=dev).generate, cpu=False)
    del eng, rep

    # ---- 25b. the paged Scheduler ----------------------------------------
    plan_s = plan.replace(serve=sch_sv)
    eng = Engine(plan_s, params=p16, device=dev)
    Scheduler(eng).run([Request(100 + i, r.prompt, max_new_tokens=2)
                        for i, r in enumerate(reqs[:2])])
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rep = Scheduler(eng).run([Request(r.rid, r.prompt) for r in reqs])
    torch.cuda.synchronize()
    got = measured()
    expect("Scheduler", got, {
        "flash_attention_fwd": per * rep.prefill_calls,
        "flash_decode_paged": per * rep.decode_steps})
    toks = [t for r in rep.requests for t in r.tokens]
    if rep.tokens_out != 8 * 16 or not all(0 <= t < q.vocab_size
                                           for t in toks):
        raise AssertionError(f"serve-spmd Scheduler: {rep.tokens_out} "
                             f"tokens")
    out[f"{q.name} serve-spmd"] = got
    store = eng.serve_store()
    stats = store.stats()
    slot = store.tree[0][0][0]["kv_full"]
    slot_bytes = sum(t.numel() * t.element_size() for t in slot)
    log("serve-spmd", f"{shape}; {card}: Scheduler, 8 requests of 16-128 "
        f"+ 16 tokens over 48 pages of 16: {rep.tokens_out} tokens "
        f"({len(set(toks))} distinct) in {rep.wall_s:.3f} s = "
        f"{rep.tokens_per_s():.1f} tok/s; decode step "
        f"{rep.ms_per_token():.2f} ms over {rep.decode_steps} steps; mean "
        f"TTFT {rep.mean_ttft() * 1e3:.1f} ms over {rep.prefill_calls} "
        f"prefill groups ({rep.prefill_s / rep.prefill_calls * 1e3:.1f} ms "
        f"each); peak pages {rep.peak_pages}/{rep.pages_total}; pool "
        f"{stats['pool_bytes'] / 2**20:.2f} MiB, one (stage, tp) slot's "
        f"K + V pools {slot_bytes / 2**20:.3f} MiB ({slot[0].shape[0]} "
        f"layer groups x {tuple(slot[0].shape[1:])}); launches {per} a "
        f"step / prefill group (exact, all tc); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not checks:
        log("serve-spmd", f"phase {time.monotonic() - t_phase:.1f} s")
        return out

    # ---- 25c. each kernel against its plain version at the shard shapes --
    errs = {}
    kp, vp = slot
    for t_ in (kp, vp):
        t_.normal_()
    store.alloc(0, 144)
    tab = store.tree[0][0][0]["block_tab"][:1]
    g = torch.Generator(device=dev).manual_seed(26)
    hq, hkv, hd = q.num_heads // T_, q.num_kv_heads // T_, q.head_dim
    q1 = torch.randn((1, hq, hd), generator=g, device=dev).to(torch.bfloat16)
    for n in (1, 77, 144):
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        for layer in range(kp.shape[0]):
            e = err_max(flash_decode_paged(q1, kp, vp, tab, lens,
                                           layer=layer),
                        kref.decode_paged_ref(q1, kp, vp, tab, lens,
                                              layer=layer))
            errs["flash_decode_paged"] = max(errs.get(
                "flash_decode_paged", 0.0), e)
    grp = torch.randn((2, 8, 160, hkv, hd), generator=g,
                      device=dev).to(torch.bfloat16)
    kc, vc = grp[0, 5:6].transpose(1, 2), grp[1, 5:6].transpose(1, 2)
    lens = torch.tensor([133], dtype=torch.int32, device=dev)
    errs["flash_decode"] = err_max(flash_decode(q1, kc, vc, lens),
                                   kref.decode_ref(q1, kc, vc, lens))
    qa = torch.randn((1, 128, hq, hd), generator=g,
                     device=dev).to(torch.bfloat16).transpose(1, 2)
    ka, va = (torch.randn((1, 128, hkv, hd), generator=g,
                          device=dev).to(torch.bfloat16).transpose(1, 2)
              for _ in range(2))
    errs["flash_attention_fwd"] = err_max(
        flash_attention_fwd(qa, ka, va), kref.attention_ref(qa, ka, va))
    if max(errs.values()) > TOL["bfloat16"]:
        raise AssertionError(f"serve-spmd: kernels vs plain at the shard "
                             f"shapes {errs}")
    log("serve-spmd", f"kernels vs plain at one shard's shapes (q {hq} / "
        f"kv {hkv} x {hd}, 1 row; the paged decode over slot (0, 0)'s own "
        f"pool, every layer group, lengths 1 / 77 / 144): max |kernel - "
        f"plain| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
        f"(tolerance {TOL['bfloat16']})")
    del eng, store, slot, kp, vp, grp
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 25d. f32: kernels against the plain spmd path and threads -------
    p32 = scaled(q, 25, torch.float32)
    plan32 = plan_s.replace(run=RunSpec(backend="spmd",
                                        compute_dtype="float32"))
    oracle_margins = {}
    reset_launches()
    got_k = Scheduler(Engine(plan32, params=p32, device=dev)).run(
        [Request(r.rid, r.prompt) for r in reqs])
    torch.cuda.synchronize()
    f32_launches = measured()
    expect("f32", f32_launches, {
        "flash_attention_fwd": per * got_k.prefill_calls,
        "flash_decode_paged": per * got_k.decode_steps}, f32=True)
    parted = {}
    for tag, p in (("spmd ref", plan32.replace(
            serve__kernel_backend="ref")), ("threads", plan32.replace(
                run=RunSpec(compute_dtype="float32"),
                partition=PartitionSpec(), serve__kernel_backend="ref"))):
        sch = Margins(Engine(p, params=p32, device=dev))
        oracle = sch.run([Request(r.rid, r.prompt) for r in reqs])
        oracle_margins[tag] = sch.margins
        parted[tag] = streams_held(tag, got_k, oracle)
    log("serve-spmd", f"f32, the same requests through the kernels on the "
        f"spmd Engine ({got_k.decode_steps} decode steps, launches exact on "
        f"simt_f32) against the plain spmd path and the threads Engine: "
        + "; ".join(f"{tag}: {8 - n}/8 streams identical, smallest top-2 "
                    f"margin {min(oracle_margins[tag].values()):.3e}"
                    for tag, n in parted.items()))
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 25e. the other kernels, reduced, on a (1, 2, 2) mesh -------------
    # Every launch of these passes is held against its plain version on the
    # very inputs the pass hands the kernel (grouped_matmul at a tp shard's
    # f = G ff / tp, the scans on a microbatch's rows, the attention
    # kernels at a shard's heads): ops' kernel names are wrapped for the
    # passes, each wrapper launching once (the count the pass reads) and
    # running the plain version beside it, which launches nothing. The
    # recurrences (f32 inputs) within atol = rtol = RWKV_TOL / SSD_TOL
    # everywhere, as phase 2 holds them; the bf16 kernels within
    # TOL["bfloat16"] of an O(1) output, scaled by max(1, max |plain|).
    plain = {"grouped_matmul": kref.gmm_ref, "rwkv6_chunked": kref.rwkv6_ref,
             "ssd_chunked": kref.ssd_ref,
             "flash_attention_fwd": kref.attention_ref,
             "flash_decode": kref.decode_ref,
             "flash_decode_paged": kref.decode_paged_ref}
    rec_tol = {"rwkv6_chunked": RWKV_TOL, "ssd_chunked": SSD_TOL}
    path_err: dict = {}
    idle: dict = {}
    bad: list = []

    def held(name, kernel):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            want = plain[name](*args, **kw)
            rows = slice(None)
            if name == "flash_decode_paged":
                # the rows whose live positions all lie on mapped pages: on
                # an unmapped (-1) page the plain version reads the trash
                # page where the kernel, as the TPU kernel, reads nothing;
                # the others are the Scheduler's idle slots (position 0, no
                # pages), whose outputs it discards
                tab = args[3]
                lens = kref._row_lengths(args[4], tab.shape[0], tab.device)
                first = torch.arange(tab.shape[1], device=tab.device)
                rows = ~((tab < 0) & (first[None] * args[1].shape[2]
                                      < lens[:, None])).any(dim=1)
                idle[name] = idle.get(name, 0) + int((~rows).sum())
            pairs = [(a[rows].float(), b[rows].float()) for a, b in (
                zip(out, want) if isinstance(out, tuple) else [(out, want)])]
            e = max((err_max(a, b) for a, b in pairs if a.numel()),
                    default=0.0)
            if name in rec_tol:
                tol = rec_tol[name]
                ok = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
                         for a, b in pairs)
            else:
                tol = TOL[str(out.dtype).split(".")[-1]]
                ok = e <= tol * max(1.0, pairs[0][1].abs().max().item()
                                    if pairs[0][1].numel() else 0.0)
            shape = " ".join("x".join(map(str, t.shape)) for t in args[:2])
            if not (ok and all(bool(torch.isfinite(a).all())
                               for a, _ in pairs)):
                bad.append(f"{name} ({shape}): max |kernel - plain| "
                           f"{e:.3e} (tolerance {tol})")
            by_shape = path_err.setdefault(name, {})
            by_shape[shape] = max(by_shape.get(shape, 0.0), e)
            return out
        return call

    # widths the scan kernels take (WKV heads of 64; SSD heads of 64,
    # state 16); need(L layers, Lf full-attention layers, Nm, report): the
    # exact launches (tp 2; the RWKV6 layers and the SSD branch run once)
    for name, over, mats, need in (
            ("granite-moe-1b-a400m", {"capacity_factor": 8.0}, GRANITE_MATS,
             lambda L, Lf, n, r: {
                 "grouped_matmul": 2 * L * 2 * n * (r.prefill_calls
                                                    + r.decode_steps),
                 "flash_attention_fwd": L * 2 * n * r.prefill_calls,
                 "flash_decode_paged": L * 2 * n * r.decode_steps}),
            ("rwkv6-3b", {"d_model": 128}, RWKV_MATS, lambda L, Lf, n, r: {
                "rwkv6_chunked": L * n * r.prefill_calls}),
            ("hymba-1.5b", {"ssm_state": 16}, HYMBA_MATS,
             lambda L, Lf, n, r: {
                "ssd_chunked": L * n * r.prefill_calls,
                "flash_attention_fwd": Lf * 2 * n * r.prefill_calls,
                "flash_decode_paged": Lf * 2 * n * r.decode_steps})):
        a = reduced(ARCHS[name], stages=2, tp=2, num_microbatches=2,
                    num_layers=4, **over)
        pa = scaled(a, 27, torch.bfloat16, mats)
        sv = ServeSpec(prompt_len=32, gen=8, max_batch=4, page_size=8,
                       max_pages=24, kernel_backend="cuda")
        rq = [Request(rid=i, prompt=rng.integers(
            0, a.vocab_size, int(rng.integers(4, 33)), dtype=np.int32))
            for i in range(6)]
        ea = Engine(Plan(arch=a, run=spmd, serve=sv, partition=PartitionSpec(
            stages=2, tp=2, data=1)), params=pa, device=dev)
        Scheduler(ea).run([Request(50, rq[0].prompt, max_new_tokens=2)])
        kernels = {k: getattr(kernel_ops, k) for k in plain}
        path_err.clear()
        idle.clear()
        bad.clear()
        try:
            for k, fn in kernels.items():
                setattr(kernel_ops, k, held(k, fn))
            reset_launches()
            ra = Scheduler(ea).run(rq)
            torch.cuda.synchronize()
            got = measured()
        finally:
            for k, fn in kernels.items():
                setattr(kernel_ops, k, fn)
        full = sum(1 for k in a.layer_kinds() if k == 0) \
            if a.attn_type != "none" else 0
        want = need(a.num_layers, full, 2, ra)
        expect(name, got, want)
        if bad:
            raise AssertionError(f"serve-spmd {name}: kernels against their "
                                 f"plain versions on the path's inputs: "
                                 + "; ".join(bad))
        if set(path_err) != {k for k, n in want.items() if n}:
            raise AssertionError(f"serve-spmd {name}: held {sorted(path_err)}"
                                 f" against the launched {sorted(want)}")
        out[f"{name} serve-spmd (reduced, 1 x 2 x 2)"] = got
        log("serve-spmd", f"{name} reduced ({a.num_layers} layers, d "
            f"{a.d_model}) on mesh (1, 2, 2), bf16 through the kernels: "
            f"{ra.tokens_out} tokens, {ra.prefill_calls} prefill groups, "
            f"{ra.decode_steps} decode steps; launches "
            f"{ {k: got[k] for k in want} } (exact, fast routes); every "
            f"launch against its plain version on the same inputs (idle "
            f"Scheduler slots' rows left out: {idle or 'none'}), max "
            f"|kernel - plain| by the first two inputs' shapes "
            + json.dumps({k: {sh: float(f"{e:.3e}") for sh, e in v.items()}
                          for k, v in sorted(path_err.items())}))
        del ea, pa
    log("serve-spmd", f"phase {time.monotonic() - t_phase:.1f} s")
    return out


def dryrun_phase(dev, arch=None, layers=SPMD_SERVE_LAYERS, card=""):
    """Phase 26: the dry run held against the card, and moe_mlp_ep on the
    card (see the module docstring). `arch` replaces qwen3-0.6b and
    granite-moe-1b-a400m (a CPU rehearsal passes reduced ones, `dev` the
    CPU); `layers` cuts the serve depth; `card` is the card's name and
    power limit. Returns {path: launches} of the expert-parallel run."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.api import (Engine, PartitionSpec, Plan, RunSpec,
                                 ServeSpec)
    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import dryrun
    from repro_torch.launch.costs import CostCounter
    from repro_torch.models import lm, moe

    t_phase = time.monotonic()
    q = (arch or {}).get("qwen3") or ARCHS["qwen3-0.6b"]
    q = dataclasses.replace(q, num_layers=layers)
    S_, T_ = q.stages, q.tp

    def routes():
        return {n: {r: c for r, c in rs.items() if c}
                for n, rs in ROUTES.items() if LAUNCHES[n]}

    def counted(fn):
        """fn() under a cost counter: (result, its counter)."""
        with CostCounter() as c:
            out = fn()
        c.close()
        return out, c

    def dry_routes(c):
        return {n: {r: v for r, v in k.items() if r not in ("flops",
                                                             "bytes")}
                for n, k in c.total().kernels.items()}

    # ---- 26a. phase 25's Plan: the card's steps against the dry run -------
    plan = Plan(arch=q, run=RunSpec(backend="spmd", compute_dtype="bfloat16"),
                partition=PartitionSpec(stages=S_, tp=T_, data=1),
                serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                                kernel_backend="cuda"))
    rng = np.random.default_rng(26)
    prompts = rng.integers(0, q.vocab_size, (8, 128), dtype=np.int64)
    nxt = rng.integers(0, q.vocab_size, (8, 1), dtype=np.int64)
    # each row's position, as the Scheduler hands them over: a Python int
    # would take a device branch inside torch.as_tensor (built on meta
    # directly, on the CPU and copied to CUDA: one aten op more on the card)
    pos = np.full(8, 128, dtype=np.int64)
    p16 = lm.init_params(q, torch.Generator(device=dev).manual_seed(26),
                         dtype=torch.bfloat16, device=dev)
    eng = Engine(plan, params=p16, device=dev)
    steps = {"prefill": lambda e, c: e.prefill(prompts),
             "decode": lambda e, c: e.decode(nxt, c, pos)}
    _, warm = eng.prefill(prompts)                       # warm-up
    eng.decode(nxt, warm, pos)
    card_rec = {}
    cache = None
    for name, fn in steps.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out, cache_new = fn(eng, cache)
        torch.cuda.synchronize()
        grow = torch.cuda.max_memory_allocated(dev) - base
        launches, rts = dict(LAUNCHES), routes()
        (_, _), c = counted(lambda: fn(eng, cache))      # the card's ops
        torch.cuda.synchronize()
        card_rec[name] = dict(grow=grow, launches=launches, routes=rts,
                              ops=c.total().ops)
        if name == "prefill":
            cache = cache_new
        del out, c
    wall, busy = profile_run("dry run vs card: one prefill group and one "
                             "decode step", lambda: (
                                 steps["decode"](eng, steps["prefill"](
                                     eng, None)[1])), cpu=False) or (0, None)
    del eng, cache, warm, p16
    gc.collect()
    torch.cuda.empty_cache()

    meta = Engine(plan, params=lm.param_shapes(q, torch.bfloat16),
                  device=torch.device("meta"))
    t0 = time.monotonic()
    meta.prefill(prompts)               # builds the shard views, as above
    dry = {}
    mcache = None
    for name, fn in steps.items():
        (out, cache_new), c = counted(lambda: fn(meta, mcache))
        dry[name] = dict(ops=c.total().ops, peak=c.peak_bytes,
                         routes=dry_routes(c),
                         dot_flops=c.total().dot_flops,
                         kflops=sum(k["flops"] for k in
                                    c.total().kernels.values()))
        if name == "prefill":
            mcache = cache_new
    dry_s = time.monotonic() - t0
    del meta, mcache
    bad = []
    for name in steps:
        cr, dr = card_rec[name], dry[name]
        if cr["routes"] != dr["routes"] or any(
                cr["launches"][n] != sum(dr["routes"].get(n, {}).values())
                for n in LAUNCHES):
            bad.append(f"{name}: launches on the card {cr['routes']}, "
                       f"dry run {dr['routes']}")
        if cr["ops"] != dr["ops"]:
            bad.append(f"{name}: aten ops on the card {cr['ops']}, dry run "
                       f"{dr['ops']}")
        tol = max(0.1 * cr["grow"], 8 * 2**20)
        if abs(dr["peak"] - cr["grow"]) > tol:
            bad.append(f"{name}: peak live bytes, dry run {dr['peak']}, the "
                       f"card's growth {cr['grow']} (tolerance {tol:.0f})")
    if bad:
        raise AssertionError("dry run vs card: " + "; ".join(bad))
    log("dryrun", f"qwen3-0.6b full width ({q.num_layers} layers) on mesh "
        f"(1, {S_}, {T_}), bf16, kernels \"cuda\" ({card}): the dry run "
        f"(meta, {dry_s:.1f} s) against the card, one prefill group of 8 x "
        f"128 and one decode step: " + "; ".join(
            f"{n}: launches {dry[n]['routes']} (exact), aten ops "
            f"{dry[n]['ops']} (the card's: {card_rec[n]['ops']}), peak live "
            f"{dry[n]['peak'] / 2**20:.2f} MiB against the card's growth "
            f"{card_rec[n]['grow'] / 2**20:.2f} MiB, dot FLOPs "
            f"{dry[n]['dot_flops']:.4e} ({dry[n]['kflops']:.4e} in kernels)"
            for n in steps) + f"; both steps under the profiler: device "
        f"busy {'not measured' if busy is None else f'{busy * 1e3:.2f} ms'}"
        f", wall {wall * 1e3:.1f} ms")

    # phase 24's train step at 1 layer: argument bytes against the built
    # Engine's params + moments
    q1 = dataclasses.replace(ARCHS["qwen3-0.6b"] if not arch else
                             arch["qwen3"], num_layers=1)
    TB, TS = 16, 512
    tplan = Plan(arch=q1, partition=PartitionSpec(stages=q1.stages,
                                                  tp=q1.tp, data=1),
                 run=RunSpec(backend="spmd", max_waves=1, batch=TB, seq=TS,
                             optimizer="adamw", lr=1e-3))
    held = torch.cuda.memory_allocated(dev)
    teng = Engine(tplan, device=dev)
    teng._ensure_spmd()
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated(dev) - held
    st = teng._spmd
    want = sum(t.numel() * t.element_size() for t in tree_lib.leaves(
        (st["params"], st["opt_state"])) if isinstance(t, torch.Tensor))
    del teng, st
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    from repro_torch.launch.mesh import make_mesh_auto
    run = RunConfig(arch=q1, shape=ShapeConfig("plan", TS, TB, "train"),
                    optimizer="adamw", lr=1e-3, compute_dtype="float32",
                    loss_chunk=min(512, TS))
    mmesh = make_mesh_auto((1, q1.stages, q1.tp), ("data", "stage", "tp"),
                           devices="meta")
    step, _ = dryrun.build_step(run, mmesh)
    rec = dryrun.count_step(step, dryrun.meta_args(run, mmesh, None), mmesh,
                            run)
    args = rec["memory"]["argument_bytes"]
    if abs(args - built) > 0.01 * built:
        raise AssertionError(f"dry run: train step arguments {args} B, the "
                             f"built Engine holds {built} B")
    log("dryrun", f"phase 24's train step at 1 layer (adamw, {TB} x {TS}): "
        f"the dry run's argument bytes {args / 2**30:.4f} GiB against the "
        f"built Engine's {built / 2**30:.4f} GiB (params + moments "
        f"{want / 2**30:.4f} GiB; within 1%); the dry run's wave: "
        f"{rec['ops']} aten ops, dot FLOPs {rec['dot_flops']:.4e}, peak "
        f"live {rec['memory']['peak_bytes'] / 2**30:.3f} GiB, "
        f"{time.monotonic() - t0:.1f} s on meta")

    # ---- 26b. moe_mlp_ep at granite-moe-1b-a400m's width ------------------
    g = (arch or {}).get("granite") or ARCHS["granite-moe-1b-a400m"]
    n, E, d, ff = 4, g.num_experts, g.d_model, g.d_ff
    gen = torch.Generator(device=dev).manual_seed(27)

    def draw(*shape, scale=0.02):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)

    router = draw(d, E, scale=1.0)
    w_in, w_out = draw(E, d, 2, ff), draw(E, ff, d)
    ps = [{"router": router, "w_in": w_in[i * E // n:(i + 1) * E // n],
           "w_out": w_out[i * E // n:(i + 1) * E // n]} for i in range(n)]
    xs = [draw(8, 128, d, scale=1.0) for _ in range(n)]
    cap = moe.capacity(8 * 128, E, g.top_k, g.capacity_factor)
    errs, shapes = [], set()
    real = kernel_ops.grouped_matmul

    def held(x, w):
        out = real(x, w)
        want = kref.gmm_ref(x, w)
        e = (out.float() - want.float()).abs().max().item()
        if e > TOL["bfloat16"] * max(1.0, want.float().abs().max().item()):
            raise AssertionError(f"moe_mlp_ep: grouped_matmul {tuple(x.shape)}"
                                 f" x {tuple(w.shape)}: max |kernel - plain| "
                                 f"{e:.3e}")
        errs.append(e)
        shapes.add((tuple(x.shape), tuple(w.shape)))
        return out

    reset_launches()
    kernel_ops.grouped_matmul = held
    try:
        ys, auxs = moe.moe_mlp_ep(ps, xs, num_experts=E, top_k=g.top_k,
                                  mlp_type=g.mlp_type,
                                  capacity_factor=g.capacity_factor,
                                  backend="cuda")
        torch.cuda.synchronize()
    finally:
        kernel_ops.grouped_matmul = real
    got = dict(LAUNCHES, routes={k: dict(r) for k, r in ROUTES.items()})
    rows = {x[0][1] for x in shapes}
    if got["grouped_matmul"] != 2 * n or rows != {n * cap} or any(
            v for k, v in LAUNCHES.items() if k != "grouped_matmul"):
        raise AssertionError(f"moe_mlp_ep: launches {dict(LAUNCHES)}, "
                             f"shapes {sorted(shapes)}")
    full = {"router": router, "w_in": w_in, "w_out": w_out}
    worst = 0.0
    for x, y in zip(xs, ys):
        want, _ = moe.moe_mlp(full, x, num_experts=E, top_k=g.top_k,
                              mlp_type=g.mlp_type,
                              capacity_factor=g.capacity_factor)
        e = (y.float() - want.float()).abs().max().item()
        worst = max(worst, e)
        if e > TOL["bfloat16"] * max(1.0, want.float().abs().max().item()) \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"moe_mlp_ep: a shard's output {e:.3e} off "
                                 f"the plain moe_mlp on its tokens")
    log("dryrun", f"moe_mlp_ep at granite-moe-1b-a400m's width (E {E} "
        f"top-{g.top_k}, d {d}, ff {ff}, {g.mlp_type}) over {n} slots of "
        f"{dev.type}, 4 shards x 8 x 128 tokens, bf16, kernels \"cuda\": "
        f"{got['grouped_matmul']} grouped_matmul launches at "
        f"{sorted(shapes)} (routes "
        f"{ {r: c for r, c in got['routes']['grouped_matmul'].items() if c} }"
        f"), each within {max(errs):.3e} of its plain version (tolerance "
        f"{TOL['bfloat16']} x max(1, |plain|)); each shard's output within "
        f"{worst:.3e} of the plain moe_mlp on its tokens with every expert; "
        f"aux {', '.join(f'{float(a):.4f}' for a in auxs)}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return {f"granite-moe-1b-a400m moe_mlp_ep ({n} shards)": got}


def cluster_phase(dev, arch=None):
    """Phase 23: qwen3-0.6b served by three replicas behind the Router (see
    the module docstring). `arch` (default: qwen3-0.6b at full width) is a
    seam for rehearsing the phase at a small size. Returns the launch
    counts of the measured bf16 run, ROUTES under "routes"."""
    import gc
    import threading

    import numpy as np
    import torch

    from repro_torch.api import (ClusterSpec, Engine, FaultPlan,
                                 PartitionSpec, Plan, ReplicaDown,
                                 ReplicaSpec, RunSpec, ServeSpec)
    from repro_torch.api.serving import Request, Scheduler
    from repro_torch.configs import ARCHS
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
    from repro_torch.models import lm
    from repro_torch.obs import Tracer
    from repro_torch.serve.router import Router

    t_phase = time.monotonic()
    q = arch or ARCHS["qwen3-0.6b"]
    L = q.num_layers
    P, G, PS = 128, 32, 16
    plan = Plan(arch=q, partition=PartitionSpec(data=3),
                cluster=ClusterSpec(topology="hetero"),
                run=RunSpec(compute_dtype="bfloat16"),
                serve=ServeSpec(prompt_len=P, gen=G, max_batch=8,
                                page_size=PS, max_pages=48, share_prefix=True,
                                evict=True, kernel_backend="cuda",
                                replicas=(ReplicaSpec(8, 48),
                                          ReplicaSpec(4, 24),
                                          ReplicaSpec(4, 24))))
    # evict: the prefix index keeps every retired prompt's pages, and
    # without eviction they fill a persistent pool until nothing is
    # admitted again (the reference's Scheduler then spins, trap P8)
    crng = np.random.default_rng(23)
    system = crng.integers(0, q.vocab_size, 4 * PS, dtype=np.int32)

    def traffic(deadlines=False):
        """24 requests: 8 open with one 64-token system prompt (4 pages)
        and a tail of their own, 16 of 16-128 random tokens; budgets
        1-32 (with `deadlines`, 8-96 decode steps)."""
        rng = np.random.default_rng(230)
        out = []
        for i in range(24):
            if i % 3 == 0:
                tail = rng.integers(0, q.vocab_size, int(rng.integers(1, 65)),
                                    dtype=np.int32)
                prompt = np.concatenate([system, tail])
            else:
                prompt = rng.integers(0, q.vocab_size,
                                      int(rng.integers(16, P + 1)),
                                      dtype=np.int32)
            out.append(Request(rid=i, prompt=prompt,
                               max_new_tokens=int(rng.integers(1, G + 1)),
                               deadline=int(rng.integers(8, 97))
                               if deadlines else 0))
        return out

    class Recording(Scheduler):
        """Records the stream each run launches on (in the replica's
        thread) and every pick's top-2 logit margin, keyed (rid, k)."""

        def __init__(self, engine, policy, streams, margins):
            super().__init__(engine, policy=policy)
            self.streams, self.margins = streams, margins

        def run(self, requests, **kw):
            self.streams.append((threading.current_thread().name,
                                 torch.cuda.current_stream(dev).cuda_stream))
            return super().run(requests, **kw)

        def _pick_one(self, row, rid, k):
            top = np.partition(row, -2)[-2:]
            self.margins[(rid, k)] = float(top[1] - top[0])
            return super()._pick_one(row, rid, k)

    def instrument(router):
        streams, margins = [], {}
        for r in router.replicas:
            r.scheduler = Recording(r.engine, r.scheduler.policy, streams,
                                    margins)
        return streams, margins

    def placement(rep):
        out = {}
        for sub in rep.replicas:
            for s in sub.requests:
                out.setdefault(sub.router["replica"], []).append(s.rid)
        return {i: sorted(v) for i, v in sorted(out.items())}

    def held_to(tag, got, want, margins):
        """`got` streams equal `want` except after a step whose top-2
        margin (in `margins`, keyed (rid, k), of the run whose stream is
        the same up to that step) is under LOGIT_TOL (trap T3); returns
        the margins let through."""
        ties = []
        for r in got.requests:
            w = want[r.rid]
            if r.tokens == w:
                continue
            k = next((i for i, (a, b) in enumerate(zip(r.tokens, w))
                      if a != b), min(len(r.tokens), len(w)))
            m = margins[(r.rid, k)]
            if m >= LOGIT_TOL:
                raise AssertionError(f"{tag}: rid {r.rid} diverges at token "
                                     f"{k} with a top-2 margin {m:.3e} >= "
                                     f"{LOGIT_TOL}")
            ties.append((r.rid, k, float(f"{m:.3e}")))
        return ties

    # ---- P1: one copy of the weights beside three pools -----------------
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    router = Router(plan, device=dev)
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated(dev) - mem0
    weights = sum(t.numel() * t.element_size()
                  for t in tree_lib.leaves(router.params))
    pools = [r.store.stats() for r in router.replicas]
    want_bytes = weights + sum(s["pool_bytes"] + s["slot_state_bytes"]
                               for s in pools)
    if not abs(built - want_bytes) <= 0.1 * want_bytes:
        raise AssertionError(f"cluster: building the Router took {built} B "
                             f"of device memory, not one weight copy "
                             f"({weights} B) plus three pools "
                             f"({want_bytes - weights} B) within 10%")
    streams, margins = instrument(router)
    reqs = traffic()
    shared_rids = [r.rid for r in reqs if r.rid % 3 == 0]
    # ---- 1. least_loaded, bf16: warm-up, then the measured run ----------
    t0 = time.monotonic()
    Router(plan, params=router.params, device=dev).run(
        [Request(rid=100 + i, prompt=r.prompt[::-1].copy(),
                 max_new_tokens=4) for i, r in enumerate(reqs[1:7])])
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    gc.collect()
    reset_launches()
    rep = router.run(reqs)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES, routes={n: dict(r) for n, r in ROUTES.items()})
    subs = rep.replicas
    need = {"flash_attention_fwd": L * sum(s.prefill_calls for s in subs),
            "flash_decode_paged": L * sum(s.decode_steps for s in subs)}
    got = {n: launches[n] for n in need}
    tc = {n: launches["routes"][n]["tc"] for n in need}
    if got != need or tc != need or any(
            v for n, v in LAUNCHES.items() if n not in need):
        raise AssertionError(f"cluster: launches {launches}, needed exactly "
                             f"{need} (28 a prefill group / decode step of "
                             f"every replica), all on tc")
    toks = [t for r in rep.requests for t in r.tokens]
    if rep.tokens_out != sum(r.max_new_tokens for r in reqs) or \
            len(rep.requests) != len(reqs) or rep.failed_requests or \
            not all(0 <= t < q.vocab_size for t in toks):
        raise AssertionError(f"cluster: {len(rep.requests)} requests, "
                             f"{rep.tokens_out} tokens, "
                             f"{rep.failed_requests} failed")
    if rep.router["affinity_hits"] < len(shared_rids) - 1 or \
            rep.prefix_hit_tokens <= 0:
        raise AssertionError(f"cluster: router {rep.router}, prefix hits "
                             f"{rep.prefix_hit_tokens}")
    owners = [r.idx for r in router.replicas
              if r.mm.index.match(reqs[0].prompt)[0] > 0]
    by_rep = placement(rep)
    if len(owners) != 1 or any(rid not in by_rep[owners[0]]
                               for rid in shared_rids):
        raise AssertionError(f"cluster: the shared system prompt's pages "
                             f"lie on replicas {owners}; placement {by_rep}")
    if len({s for _, s in streams}) != 1 or \
            len({n for n, _ in streams}) < 2:
        raise AssertionError(f"cluster: replica threads launched on "
                             f"streams {streams}: not one stream from "
                             f"several threads")
    log("cluster", f"qwen3-0.6b ({L} layers, d {q.d_model}) x 3 replicas "
        f"(ReplicaSpec 8/48, 4/24, 4/24 slots/pages) behind the Router, "
        f"topology hetero (vw0, vw1 one pod; vw2 across 10 GbE), bf16: "
        f"building the Router took {built / 2**20:.1f} MiB of device memory "
        f"= one weight copy {weights / 2**20:.1f} MiB + pools "
        + " + ".join(f"{s['pool_bytes'] / 2**20:.1f}" for s in pools)
        + f" MiB (P1, within 10%); replica threads and their stream: "
        f"{sorted(set(streams))} (one stream, P3); warm-up {warm_s:.1f} s")
    for sub in subs:
        i = sub.router["replica"]
        log("cluster", f"replica {i} ({router.replicas[i].describe()}): "
            f"{len(sub.requests)} requests, {sub.prefill_calls} prefill "
            f"groups, {sub.decode_steps} decode steps, "
            f"{sub.ms_per_token():.2f} ms a decode step, peak pages "
            f"{sub.peak_pages}/{sub.pages_total}, prefix hits "
            f"{sub.prefix_hit_tokens} tokens, wall {sub.wall_s:.3f} s")
    log("cluster", f"merged least_loaded bf16: {len(reqs)} requests, "
        f"{rep.tokens_out} tokens in wall_s {rep.wall_s:.3f} s = "
        f"{rep.tokens_per_s():.1f} tok/s; modeled_fleet_wall_s "
        f"{rep.router['modeled_fleet_wall_s']:.3f} s (the busiest replica); "
        f"occupancy {rep.occupancy():.3f}, page utilization "
        f"{rep.page_utilization():.3f}; router "
        f"{ {k: v for k, v in rep.router.items() if k != 'modeled_fleet_wall_s'} }; "
        f"placement {by_rep} (the system-prompt rids {shared_rids} on "
        f"replica {owners[0]}); prefix hits {rep.prefix_hit_tokens} tokens, "
        f"pages shared {rep.pages_shared}, CoW {rep.cow_copies}; launches "
        f"{got} = {L} x (prefill groups, decode steps) summed over the "
        f"replicas, all on tc")
    # the same traffic with the replicas run one after the other in this
    # thread (parallel=False): what the threads cost on one host
    seq = Router(plan, params=router.params, device=dev,
                 parallel=False).run(traffic())
    torch.cuda.synchronize()
    log("cluster", f"the same traffic, replicas in turn (parallel=False): "
        f"{seq.tokens_out} tokens in {seq.wall_s:.3f} s = "
        f"{seq.tokens_per_s():.1f} tok/s (threads: "
        f"{rep.tokens_per_s():.1f}); ms a decode step by replica "
        + ", ".join(f"{s.router['replica']}: {s.ms_per_token():.2f}"
                    for s in seq.replicas)
        + f"; placement {'equal' if placement(seq) == by_rep else placement(seq)}")
    short = [Request(rid=200 + i, prompt=r.prompt, max_new_tokens=8)
             for i, r in enumerate(reqs[:9])]
    profile_run("serve-cluster Router, 3 replicas, 9 requests x 8 tokens",
                lambda: router.run(short), cpu=False)
    params16 = router.params
    del router, rep, seq
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2. f32 through the Router and the single-replica oracle -------
    gen = torch.Generator(device=dev).manual_seed(0)
    p32 = lm.init_params(q, gen, dtype=torch.float32, device=dev)
    for name in DENSE_MATS:
        p32["blocks"][name].mul_(WEIGHT_SCALE)
    plan32 = plan.replace(run__compute_dtype="float32")
    osched = Recording(Engine(plan32.replace(
        partition__data=1, cluster__topology=None, serve__replicas=()),
        params=p32, device=dev), "fifo", [], {})
    oracle = osched.run(traffic())
    want = {r.rid: r.tokens for r in oracle.requests}
    r32 = Router(plan32, params=p32, device=dev)
    _, m32 = instrument(r32)
    f32 = r32.run(traffic())
    torch.cuda.synchronize()
    ties32 = held_to("cluster f32 vs the single-replica oracle", f32, want,
                     osched.margins)
    same32 = sum(r.tokens == want[r.rid] for r in f32.requests)
    log("cluster", f"f32 Router streams against the single-replica "
        f"Scheduler (max_batch 8, 48 pages, the same params): {same32}/24 "
        f"identical; divergences (rid, token, oracle top-2 margin) under "
        f"{LOGIT_TOL}: {ties32 or 'none'} (P4); min oracle margin "
        f"{min(osched.margins.values()):.3e}; placement {placement(f32)}")
    del r32
    # ---- 3. ReplicaDown(1, 4), f32 -------------------------------------
    tracer = Tracer()
    rd = Router(plan32.replace(faults=FaultPlan(events=(ReplicaDown(1, 4),))),
                params=p32, device=dev, tracer=tracer)
    instrument(rd)
    down = rd.run(traffic())
    torch.cuda.synchronize()
    tel = tracer.metrics.snapshot()["counters"]
    if down.router["replica_downs"] != 1 or down.router["rounds"] < 2 or \
            down.router["rebalances"] <= 0 or down.failed_requests or \
            len(down.requests) != 24 or \
            tel.get("fault/replica_downs") != 1:
        raise AssertionError(f"cluster ReplicaDown: router {down.router}, "
                             f"{down.failed_requests} failed, "
                             f"{len(down.requests)} requests, fault "
                             f"counters {tel}")
    run2 = {r.rid: r.tokens for r in f32.requests}
    ties_d = held_to("cluster ReplicaDown vs the fault-free f32 run", down,
                     run2, m32)
    same_d = sum(r.tokens == run2[r.rid] for r in down.requests)
    log("cluster", f"ReplicaDown(replica 1, step 4), f32: router "
        f"{ {k: v for k, v in down.router.items() if k in ('rounds', 'rebalances', 'replica_downs', 'dispatches')} }, "
        f"fault/replica_downs {tel.get('fault/replica_downs')}; sub-reports "
        f"(replica, requests, aborted at) "
        f"{[(s.router['replica'], len(s.requests), s.aborted_step) for s in down.replicas]}; "
        f"{same_d}/24 streams equal the fault-free run's, divergences at "
        f"margins under {LOGIT_TOL}: {ties_d or 'none'}")
    del rd, p32
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 4. the deadline policy ----------------------------------------
    dl = Router(plan, policy="deadline", params=params16, device=dev)
    dreqs = traffic(deadlines=True)
    drep = dl.run(dreqs)
    torch.cuda.synchronize()
    if drep.tokens_out != sum(r.max_new_tokens for r in dreqs) or \
            drep.failed_requests:
        raise AssertionError(f"cluster deadline: {drep.tokens_out} tokens, "
                             f"{drep.failed_requests} failed")
    log("cluster", f"deadline policy, bf16: dispatch {placement(drep)} "
        f"(slack order: deadline - budget), {drep.tokens_out} tokens in "
        f"{drep.wall_s:.3f} s = {drep.tokens_per_s():.1f} tok/s; router "
        f"{ {k: v for k, v in drep.router.items() if k in ('dispatches_by_policy', 'affinity_hits')} }")
    del dl, params16
    gc.collect()
    torch.cuda.empty_cache()
    log("cluster", f"phase {time.monotonic() - t_phase:.1f} s")
    return launches


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.api import Engine, Plan, RunSpec, ServeSpec
    from repro_torch.api.serving import Request, Scheduler
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import (LAUNCHES, ROUTES, _build, build_all,
                                     reset_launches)
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import _route as fa_route
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged)
    from repro_torch.kernels.mamba_ssd import cost as ssd_cost
    from repro_torch.kernels.mamba_ssd import ssd_chunked
    from repro_torch.kernels.moe_gmm import cost as gmm_cost
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.kernels.rwkv6_scan import cost as rwkv6_cost
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunked
    from repro_torch.launch import costs
    from repro_torch.models import blocks, lm, moe, ssm
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.models.layers import rms_norm

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script measures "
              "the port on an H100 and has nothing to run here",
              file=sys.stderr)
        return 2

    # ---- 1. device and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log("device", f"{smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    build_s = build_all()
    log("build", f"{build_s:.1f} s for {sorted(_build._LIBS)} into "
        f"{_build._build_dir()}")
    for name in sorted(_build._LIBS):
        regs = [line.split("info    : ")[-1] for line in
                _build.build_log(name).splitlines() if "registers" in line]
        log("build", f"{name}: {len(regs)} instantiations, e.g. {regs[:1]}")
    # the tensor-core kernels' registers, spills (nvcc -Xptxas -v) and
    # dynamic shared memory (set at launch, so not in that log)
    for lib_name in ("moe_gmm", "flash_attention", "flash_decode"):
        for kern, regs, spill in ptxas_entries(lib_name, "_tc_"):
            log("build", f"{lib_name}: {kern}: {regs}; {spill}")
    # hd 256 holds 128 (attention) or 64 (decode) f32 accumulators a lane:
    # its tensor-core instantiations must not spill
    hd256 = [(kern, spill) for lib_name in ("flash_attention", "flash_decode")
             for kern, _, spill in ptxas_entries(lib_name, "_tc_")
             if re.search(r"[<, ]256[,>]|Li256E", kern)]
    spilled = [k for k, sp in hd256
               if "0 bytes spill stores, 0 bytes spill loads" not in sp]
    if len(hd256) != 5 or spilled:   # 1 attention, 4 decode
        raise AssertionError(f"hd-256 tensor-core instantiations: "
                             f"{len(hd256)} of 5, spilling: {spilled}")
    log("build", f"hd 256: {len(hd256)} tensor-core instantiations, none "
        f"spills")
    simt = ptxas_entries("flash_decode", "decode_simt")
    used = [int(r.split("Used ")[1].split()[0]) for _, r, _ in simt]
    log("build", f"flash_decode: {len(simt)} simt instantiations, "
        f"{min(used)}..{max(used)} registers; spills: " + (", ".join(
            f"{k}: {sp}" for k, _, sp in simt
            if not sp.startswith("0 bytes stack")) or "none"))
    gmm_smem = _build.load("moe_gmm").grouped_matmul_smem_bytes
    gmm_smem.restype, gmm_smem.argtypes = _build.INT, [_build.INT]
    att_smem = _build.load("flash_attention").flash_attention_smem_bytes
    att_smem.restype, att_smem.argtypes = _build.INT, [_build.INT] * 3
    dec_smem = _build.load("flash_decode").flash_decode_tc_smem_bytes
    dec_smem.restype, dec_smem.argtypes = _build.INT, [_build.INT] * 3
    log("build", f"dynamic shared memory a block: grouped_matmul tc_decode "
        f"{gmm_smem(1)} B, tc_prefill {gmm_smem(2)} B; flash_attention_fwd "
        f"tc (1 / 2 query heads a block) and simt at hd 64 "
        f"{att_smem(64, 1, 1)} / {att_smem(64, 2, 1)} and "
        f"{att_smem(64, 1, 0)} B, at hd 128 {att_smem(128, 1, 1)} / "
        f"{att_smem(128, 2, 1)} and {att_smem(128, 1, 0)} B, at hd 256 "
        f"(one query head a block) {att_smem(256, 1, 1)} and "
        f"{att_smem(256, 1, 0)} B; flash_decode "
        f"tc (bf16 / fp8 pool) a warp at hd 64 {dec_smem(64, 0, 1)} / "
        f"{dec_smem(64, 1, 1)} B, at hd 128 {dec_smem(128, 0, 1)} / "
        f"{dec_smem(128, 1, 1)} B (up to 8 warps a block), at hd 256 "
        f"{dec_smem(256, 0, 1)} / {dec_smem(256, 1, 1)} B (up to "
        f"{fd.SPAN_HD256['tc'] // 32} warps a block)")
    # the tensor-core instructions in the decode kernels' machine code
    for kern, ops in sass_counts("flash_decode", "decode_tc_kernel",
                                 ("HMMA", "LDSM", "MOVM", "LDGSTS")):
        log("build", f"flash_decode SASS: {kern}: " + ", ".join(
            f"{op} {n}" for op, n in ops.items()))
    # the WKV6 and SSD tile kernels' registers, spills and shared memory, and
    # both routes' machine instructions: FFMA against the shared loads (LDS
    # counts every width, LDS.128 among them), the cp.async copies (LDGSTS),
    # shuffles, barriers, exponentials and f64 adds
    for lib_name in ("rwkv6_scan", "mamba_ssd"):
        for kern, regs, spill in ptxas_entries(lib_name, "_tile_"):
            log("build", f"{lib_name}: {kern}: {regs}; {spill}")
    wkv_smem = _build.load("rwkv6_scan").rwkv6_tile_smem_bytes
    wkv_smem.restype, wkv_smem.argtypes = _build.INT, []
    ssd_smem = _build.load("mamba_ssd").ssd_tile_smem_bytes
    ssd_smem.restype, ssd_smem.argtypes = _build.INT, [_build.INT]
    log("build", f"dynamic shared memory a block: rwkv6_chunked tile "
        f"{wkv_smem()} B, ssd_chunked tile {ssd_smem(16)} B at state 16 "
        f"and {ssd_smem(128)} B at state 128")
    scan_sass = {}
    for lib_name, tag in (("rwkv6_scan", "wkv6_"), ("mamba_ssd", "ssd_")):
        for kern, ops in sass_counts(lib_name, tag, (
                "FFMA", "LDS.128", "LDS.64", "LDS", "STS", "LDGSTS", "SHFL",
                "BAR", "MUFU.EX2", "DADD")):
            scan_sass[kern] = ops
            log("build", f"{lib_name} SASS: {kern}: " + ", ".join(
                f"{op} {n}" for op, n in ops.items()))

    dev = torch.device("cuda")

    def free_device():
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    # ---- 2. kernel parity ----------------------------------------------
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in LAUNCHES}
    for name in ("rwkv6_chunked", "ssd_chunked"):      # f32 only
        worst[name] = {"float32": 0.0}
    # the attention kernels' errors per head shape (query/kv heads, hd)
    by_heads: dict = {}
    # the routes held against the plain version: each dtype's own (None:
    # the wrapper's pick), and in bf16 the SIMT route too
    ROUTE_CHECKS = {torch.bfloat16: (None, "simt_bf16"), torch.float32: (None,)}

    def hold(name, out, ref, dtype, heads, zero_row=None, route=None):
        """`out` against `ref` within TOL; `route` names a forced route
        (its errors kept apart from the default route's)."""
        torch.cuda.synchronize()
        e = err(out, ref)
        d = str(dtype).split(".")[-1]
        key = d if route is None else f"{d} {route}"
        worst[name][key] = max(worst[name].get(key, 0.0), e)
        if heads is not None:
            per = by_heads.setdefault(heads, {}).setdefault(name, {})
            per[d] = max(per.get(d, 0.0), e)
        tol = TOL[d]
        if not (e <= tol and torch.isfinite(out.float()).all()):
            raise AssertionError(f"{name} {dtype} {heads}: max |kernel - "
                                 f"plain| = {e:.3e} > {tol}")
        if zero_row is not None and not bool((out[zero_row] == 0).all()):
            raise AssertionError(f"{name}: a length-0 row is not exact zeros")

    def attention_parity(H, KV, hd):
        heads = f"{H}/{KV}x{hd}"
        for dt in (torch.bfloat16, torch.float32):
            for B, S, window in ((8, 128, 0), (2, 100, 0), (2, 77, 40),
                                 (1, 300, 0)):
                # q/k/v as the model hands them over: [B, S, heads, hd]
                q = randn(B, S, H, hd, dtype=dt).transpose(1, 2)
                k = randn(B, S, KV, hd, dtype=dt).transpose(1, 2)
                v = randn(B, S, KV, hd, dtype=dt).transpose(1, 2)
                ref = kref.attention_ref(q, k, v, causal=True, window=window)
                for route in ROUTE_CHECKS[dt]:
                    hold("flash_attention_fwd", flash_attention_fwd(
                        q, k, v, causal=True, window=window, route=route),
                         ref, dt, heads, route=route)
            # decode over a 160-position cache / pool (B 8): lengths at the
            # tile edges and at the SIMT routes' split edges (_splits' chunk:
            # 32 at qwen3's and granite's heads, 16 at hymba's; the
            # tensor-core route takes the 160 in one chunk), windows 0 and
            # 48 (mid-chunk), each route of the dtype
            B, S = 8, 160
            cache_k = randn(3, B, S, KV, hd, dtype=dt)
            cache_v = randn(3, B, S, KV, hd, dtype=dt)
            q1 = randn(B, H, hd, dtype=dt)
            chunk = fd._splits(B, KV, S, "simt_f32")[1]
            for lens in ([0, 1, 15, 16, 17, 77, 159, 160],
                         [0, chunk - 1, chunk, chunk + 1, 2 * chunk + 1,
                          3 * chunk - 1, 131, 150]):
                lens = torch.tensor(lens, device=dev, dtype=torch.int32)
                for window in (0, 48):
                    kv = (cache_k[1].transpose(1, 2),
                          cache_v[1].transpose(1, 2))
                    ref = kref.decode_ref(q1, *kv, lens, window=window)
                    for route in ROUTE_CHECKS[dt]:
                        hold("flash_decode", flash_decode(
                            q1, *kv, lens, window=window, route=route), ref,
                             dt, heads, zero_row=0, route=route)
                ps, npg = 16, 10
                P1 = B * npg + 1
                perm = torch.randperm(B * npg, generator=gen, device=dev)
                tab = perm.to(torch.int32).reshape(B, npg)
                for b in range(B):   # pages past each row's length unmapped
                    tab[b, (int(lens[b]) + ps - 1) // ps:] = -1
                for pool_dt in (dt, torch.float8_e4m3fn):
                    kp = randn(3, P1, ps, KV, hd, dtype=pool_dt)
                    vp = randn(3, P1, ps, KV, hd, dtype=pool_dt)
                    ref = kref.decode_paged_ref(q1, kp, vp, tab, lens,
                                                layer=2)
                    for route in ROUTE_CHECKS[dt]:
                        hold("flash_decode_paged", flash_decode_paged(
                            q1, kp, vp, tab, lens, layer=2, route=route),
                             ref, dt, heads, zero_row=0, route=route)

    def attention_parity_long(H, KV, hd, B, S, n_new):
        """flash_attention_fwd and flash_decode at a generate path's own
        shapes: the causal prefill of B full rows of S tokens, and decode
        over a strided [B, S + n_new] cache at lengths S + 1 .. S + n_new."""
        heads = f"{H}/{KV}x{hd} S{S}"
        Sc = S + n_new
        lens = torch.linspace(S + 1, Sc, B, device=dev).round().to(
            torch.int32)
        for dt in (torch.bfloat16, torch.float32):
            q = randn(B, S, H, hd, dtype=dt).transpose(1, 2)
            k = randn(B, S, KV, hd, dtype=dt).transpose(1, 2)
            v = randn(B, S, KV, hd, dtype=dt).transpose(1, 2)
            ref = kref.attention_ref(q, k, v, causal=True)
            for route in ROUTE_CHECKS[dt]:
                hold("flash_attention_fwd",
                     flash_attention_fwd(q, k, v, causal=True, route=route),
                     ref, dt, heads, route=route)
            del ref
            del q, k, v
            cache_k = randn(3, B, Sc, KV, hd, dtype=dt)
            cache_v = randn(3, B, Sc, KV, hd, dtype=dt)
            kv = (cache_k[1].transpose(1, 2), cache_v[1].transpose(1, 2))
            q1 = randn(B, H, hd, dtype=dt)
            # the generate lengths, then the tensor-core route's split
            # edges (chunks of 256 at this shape)
            for dl in (lens, torch.tensor([255, 256, 257, Sc], device=dev,
                                          dtype=torch.int32)):
                ref = kref.decode_ref(q1, *kv, dl)
                for route in ROUTE_CHECKS[dt]:
                    hold("flash_decode", flash_decode(q1, *kv, dl,
                                                      route=route),
                         ref, dt, heads, route=route)

    attention_parity(16, 8, 128)          # qwen3-0.6b: G 2
    attention_parity(25, 5, 64)           # hymba-1.5b: G 5
    attention_parity(16, 8, 64)           # granite-moe-1b-a400m: G 2
    # hymba-1.5b's generate phase (11): batch 4 x prompt 1100 + 32 tokens
    attention_parity_long(25, 5, 64, 4, 1100, 32)

    def gemma3_parity():
        """gemma3-1b's heads (4 query / 1 kv of 256, G 4; and 1 / 1, G 1,
        as one tp shard of the spmd backend holds them): every bf16 launch
        must take the tensor-core route, `_route`'s pick, and is held
        against the plain version beside a forced simt_bf16 launch; f32
        takes simt_f32. Prefill attention with window 0 and 512 over rows
        of 128 (the serve prompts) and 600 (past the window); both decode
        kernels at the global layers' shapes (B 8, a [8, 160] cache at
        lengths across the tiles, a pool of 16-position pages in the dtype
        and in fp8). Returns {kernel: routes launched}."""
        hd = 256
        seen = {}

        def routed(name, dt, route, fn):
            before = dict(ROUTES[name])
            out = fn()
            torch.cuda.synchronize()
            ran = {r for r, n in ROUTES[name].items() if n != before.get(r, 0)}
            want = route or ("tc" if dt == torch.bfloat16 else "simt_f32")
            if ran != {want}:
                raise AssertionError(f"{name} at hd 256 {dt}: routes {ran}, "
                                     f"wanted {want}")
            seen.setdefault(name, set()).add(want)
            return out
        for H in (4, 1):
            heads = f"{H}/1x{hd}"
            for dt in (torch.bfloat16, torch.float32):
                pick = "tc" if dt == torch.bfloat16 else "simt_f32"
                for B, S in ((8, 128), (2, 600)):
                    q = randn(B, S, H, hd, dtype=dt).transpose(1, 2)
                    k = randn(B, S, 1, hd, dtype=dt).transpose(1, 2)
                    v = randn(B, S, 1, hd, dtype=dt).transpose(1, 2)
                    if fa_route(q, k, v) != pick:
                        raise AssertionError(f"hd 256 {dt}: _route gives "
                                             f"{fa_route(q, k, v)}")
                    for window in (0, 512):
                        ref = kref.attention_ref(q, k, v, causal=True,
                                                 window=window)
                        for route in ROUTE_CHECKS[dt]:
                            hold("flash_attention_fwd", routed(
                                "flash_attention_fwd", dt, route,
                                lambda: flash_attention_fwd(
                                    q, k, v, causal=True, window=window,
                                    route=route)),
                                 ref, dt, heads, route=route)
                B, S = 8, 160
                q1 = randn(B, H, hd, dtype=dt)
                cache = randn(2, B, S, 1, hd, dtype=dt)
                kv = (cache[0].transpose(1, 2), cache[1].transpose(1, 2))
                lens = torch.tensor([0, 1, 15, 16, 17, 77, 140, 160],
                                    device=dev, dtype=torch.int32)
                ref = kref.decode_ref(q1, *kv, lens)
                for route in ROUTE_CHECKS[dt]:
                    hold("flash_decode", routed(
                        "flash_decode", dt, route, lambda: flash_decode(
                            q1, *kv, lens, route=route)),
                         ref, dt, heads, zero_row=0, route=route)
                ps, npg = 16, 10
                tab = torch.randperm(B * npg, generator=gen, device=dev).to(
                    torch.int32).reshape(B, npg)
                live_pg = torch.arange(npg, device=dev)[None] * ps < \
                    lens[:, None]
                tab = torch.where(live_pg, tab, -1).to(torch.int32)
                for pool_dt in (dt, torch.float8_e4m3fn):
                    kp = randn(4, B * npg + 1, ps, 1, hd, dtype=pool_dt)
                    vp = randn(4, B * npg + 1, ps, 1, hd, dtype=pool_dt)
                    ref = kref.decode_paged_ref(q1, kp, vp, tab, lens,
                                                layer=3)
                    for route in ROUTE_CHECKS[dt]:
                        hold("flash_decode_paged", routed(
                            "flash_decode_paged", dt, route,
                            lambda: flash_decode_paged(
                                q1, kp, vp, tab, lens, layer=3,
                                route=route)),
                             ref, dt, heads, zero_row=0, route=route)
        return {k: sorted(v) for k, v in seen.items()}

    gemma_parity_routes = gemma3_parity()
    log("parity", f"gemma3-1b 4/1 x 256 and a tp shard's 1/1 x 256 (bf16 "
        f"on tc, held beside a forced simt_bf16; f32 on simt_f32; bf16 and "
        f"fp8 pools): routes {gemma_parity_routes}; max |kernel - plain| "
        f"{by_heads['4/1x256']}, {by_heads['1/1x256']}")
    H, KV, hd = 16, 8, 128

    def hold_recurrence(name, tol, S, got, want, route=None):
        """A chunked kernel's (y, final state) against its sequential plain
        version: |kernel - plain| <= tol + tol |plain| everywhere; `route`
        names a forced route (its errors kept apart)."""
        key = "float32" if route is None else f"float32 {route}"
        for what, a, b in zip(("y", "state"), got, want):
            e = err(a, b)
            worst[name][key] = max(worst[name].get(key, 0.0), e)
            if not (torch.isfinite(a).all() and bool(
                    ((a - b).abs() <= tol + tol * b.abs()).all())):
                raise AssertionError(
                    f"{name} S {S} {what} (route {route or 'tile'}): max "
                    f"|kernel - plain| = {e:.3e} outside atol = rtol = {tol}")

    def row_lens(S):
        return torch.tensor([S, S - 1, S // 2, 1, S, 3, S // 3, 2],
                            device=dev).clamp(1, S)

    # the chunked WKV6 kernel, f32 only, at the rwkv6-3b shapes: S a multiple
    # of the chunk, a masked tail chunk, a prime, one token; r/k/v/w handed
    # over as the model does ([B, S, H, hd] memory through a [B, H, S, hd]
    # view); each row's tail past its length made a no-op as lens padding
    # makes it (k = 0, w = 0); w drawn in [-4, 0]
    Hr, hdr = 40, 64
    u_r = 0.3 + 0.1 * randn(Hr, hdr)

    def wkv_inputs(B, S):
        r, k, v = (randn(B, S, Hr, hdr).mul_(0.5).transpose(1, 2)
                   for _ in range(3))
        w = (-4.0 * torch.rand((B, S, Hr, hdr), generator=gen,
                               device=dev)).transpose(1, 2)
        return r, k, v, w

    for S in (128, 100, 17, 1):
        r, k, v, w = wkv_inputs(8, S)
        live = (torch.arange(S, device=dev)[None, :] < row_lens(S)[:, None])
        live = live[:, None, :, None]
        k, w = torch.where(live, k, 0.0), torch.where(live, w, 0.0)
        want = kref.rwkv6_ref(r, k, v, w, u_r)
        for route in (None, "simt"):
            got = rwkv6_chunked(r, k, v, w, u_r, route=route)
            torch.cuda.synchronize()
            hold_recurrence("rwkv6_chunked", RWKV_TOL, S, got, want, route)
    # the chunked SSD kernel, f32 only, at the hymba-1.5b shapes (50 heads of
    # 64, state 16): S two full chunks of 64, a masked tail, the generate
    # phase's 1100 (17 chunks and a 12-row tail), a prime, one token; x and
    # B/C handed over as the model does (column slices of one [B, S, d_inner
    # + 2N] conv output, x through a [B, H, S, P] view), dt as a [B, H, S]
    # view of [B, S, H] memory; dt = exp(U(-7, -1.2)) against a = -(1..16),
    # so the per-step decays exp(dt a) spread over (0.008, 0.999); each row's
    # tail past its length made a no-op as lens padding makes it (dt = 0)
    Hs, Ps, Ns = 50, 64, 16
    a_s = -torch.linspace(1.0, 16.0, Hs, device=dev)   # hymba's -exp(A_log)

    def ssd_inputs(B, S):
        conv = randn(B, S, Hs * Ps + 2 * Ns).mul_(0.5)
        x = conv[..., :Hs * Ps].reshape(B, S, Hs, Ps).transpose(1, 2)
        Bm, Cm = conv[..., Hs * Ps:Hs * Ps + Ns], conv[..., Hs * Ps + Ns:]
        dt = torch.empty((B, S, Hs), device=dev).uniform_(-7.0, -1.2,
                                                          generator=gen)
        return x, dt.exp_().transpose(1, 2), Bm, Cm, a_s

    for S in (128, 100, 1100, 17, 1):
        x, dt, Bm, Cm, _ = ssd_inputs(8, S)
        live = torch.arange(S, device=dev)[None, :] < row_lens(S)[:, None]
        dt = torch.where(live[:, None, :], dt, 0.0)
        want = kref.ssd_ref(x, dt, Bm, Cm, a_s)
        for route in (None, "simt"):
            got = ssd_chunked(x, dt, Bm, Cm, a_s, route=route)
            torch.cuda.synchronize()
            hold_recurrence("ssd_chunked", SSD_TOL, S, got, want, route)
    # the grouped matmul at granite-moe-1b-a400m's expert GEMMs: w_in as the
    # [E, d, G ff] view of [E, d, 2, 512], w_out [E, 512, d], C 8 (a decode
    # step of 8 slots) and 320 (a prefill group of 8 x 128 at top-8 of 32,
    # capacity factor 1.25), and a ragged shape; x a strided view with its
    # last dim contiguous; w scaled by d^-1/2 so the outputs are O(1)
    gmm_shapes = {"decode w_in": (32, 8, 1024, 2, 512),
                  "decode w_out": (32, 8, 512, 1, 1024),
                  "prefill w_in": (32, 320, 1024, 2, 512),
                  "prefill w_out": (32, 320, 512, 1, 1024),
                  "ragged": (4, 13, 72, 1, 40)}

    def gmm_inputs(E, C, d, G, ff, dt):
        x = randn(C, E, d, dtype=dt).transpose(0, 1)
        w = (randn(E, d, G, ff) * d ** -0.5).to(dt).reshape(E, d, G * ff)
        return x, w

    for dt in (torch.bfloat16, torch.float32):
        for E, C, d, G, ff in gmm_shapes.values():
            x, w = gmm_inputs(E, C, d, G, ff, dt)
            ref = kref.gmm_ref(x, w)
            for route in ROUTE_CHECKS[dt]:
                hold("grouped_matmul", grouped_matmul(x, w, route=route), ref,
                     dt, None, route=route)
    del x, w
    # granite4h-serve-chat's launches at the cell's own shapes, each one
    # launch on the route named (None: the fast one, tile or tc*)
    for name, label, dt, route, got, want in granite4h_cases(dev, randn, gen):
        ref = want()
        before = LAUNCHES[name], dict(ROUTES[name])
        out = got()
        torch.cuda.synchronize()
        ran = [r for r, n in ROUTES[name].items() if n != before[1][r]]
        fast = ran and ran[0].startswith(("tc", "tile"))
        if LAUNCHES[name] - before[0] != 1 or len(ran) != 1 or not (
                ran[0] == route if route else fast):
            raise AssertionError(f"{name} {label}: routes {ran}, launches "
                                 f"{LAUNCHES[name] - before[0]}, want "
                                 f"{route or 'tile / tc'} once")
        if name == "ssd_chunked":
            hold_recurrence(name, SSD_TOL, label, out, ref, route)
        else:
            hold(name, out, ref, dt,
                 label if name.startswith("flash") else None, route=route)
        del ref, out
    free_device()
    log("parity", "max |kernel - plain| " + json.dumps(
        {k: {d: float(f"{e:.3e}") for d, e in v.items()}
         for k, v in worst.items()}) + f" within {TOL} (rwkv6_chunked: "
        f"f32, atol = rtol = {RWKV_TOL}; ssd_chunked: f32, atol = rtol = "
        f"{SSD_TOL})")
    log("parity", "attention kernels by query/kv heads x hd: " + json.dumps(
        {h: {k: {d: float(f"{e:.3e}") for d, e in v.items()}
             for k, v in per.items()} for h, per in by_heads.items()}))

    def time_ms(fn, argsets, reps=3, graph=True):
        """Mean ms per call over `reps` passes through argsets (one set
        per layer, so the working set exceeds the 50 MB L2). With `graph`
        (kernels and library calls) each pass replays one CUDA graph
        captured over argsets, so the time is the device's alone; without
        it (the plain versions, and every `eager_ms`) the host dispatches
        each call, as on the serve path."""
        for a in argsets[:2]:
            fn(*a)
        torch.cuda.synchronize()
        if graph:
            cg = torch.cuda.CUDAGraph()
            with torch.cuda.graph(cg):
                for a in argsets:
                    fn(*a)
            run = cg.replay
        else:
            def run():
                for a in argsets:
                    fn(*a)
        run()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            run()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / (reps * len(argsets))

    def bound(cost, *args, **kw):
        """The least time one call could take (PERF.md §6's bound column):
        the kernel's cost() (the bytes and FLOPs the call needs: inputs
        read once, outputs written once) at one H100's HBM rate and its
        peak for the operands' dtype."""
        return costs.bound_ms(*cost(*args, **kw), args[0].dtype)

    import torch.nn.functional as F
    bf, f32 = torch.bfloat16, torch.float32
    timing = {}

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    # prefill attention at the serve shapes (B 8, S 128: the prompt width)
    # of qwen3 (16/8 heads of 128), granite (16/8 of 64) and hymba (25/5 of
    # 64), and at hymba's generate prefill (B 4, S 1100): each route (the
    # tensor-core bf16 one, the SIMT bf16 and f32 ones) beside SDPA
    att_shapes = {"qwen3 16/8x128": (8, 128, 16, 8, 128),
                  "granite 16/8x64": (8, 128, 16, 8, 64),
                  "hymba 25/5x64": (8, 128, 25, 5, 64),
                  "hymba generate 25/5x64 S1100": (4, 1100, 25, 5, 64)}
    att_times = {}
    for what, (B, S, Hq, KVq, hdq) in att_shapes.items():
        sets = {dt: [tuple(randn(B, S, n, hdq, dtype=dt).transpose(1, 2)
                           for n in (Hq, KVq, KVq))
                     for _ in range(N_LAYERS if S <= 128 else 3)]
                for dt in (bf, f32)}
        t = att_times[what] = dict(
            routes={"tc": time_ms(flash_attention_fwd, sets[bf]),
                    "simt_bf16": time_ms(lambda q, k, v: flash_attention_fwd(
                        q, k, v, route="simt_bf16"), sets[bf]),
                    "simt_f32": time_ms(flash_attention_fwd, sets[f32])},
            eager_ms=time_ms(flash_attention_fwd, sets[bf], graph=False),
            plain_ms=time_ms(kref.attention_ref, sets[bf], graph=False),
            library_ms=time_ms(sdpa, sets[bf]),
            library_eager_ms=time_ms(sdpa, sets[bf], graph=False),
            shape=f"B{B} S{S} H{Hq} KV{KVq} hd{hdq} bf16",
            bound=bound(fa.cost, *sets[bf][0]),
            bound_f32=bound(fa.cost, *sets[f32][0]))
        t["ms"] = t["routes"]["tc"]
        del sets
    timing["flash_attention_fwd"] = dict(
        att_times["qwen3 16/8x128"],
        library="scaled_dot_product_attention(is_causal, enable_gqa)",
        dtype="bfloat16", tolerance=TOL, by_shape=att_times)
    # decode at the serve shapes, each route in turns (tc, simt_bf16, simt_f32)
    # beside the library call: paged over a pool of 16-token pages (B 8, the
    # same lengths 17..160 and block table at every head shape, pages past
    # each length unmapped) at qwen3's, granite's and hymba's heads;
    # contiguous over qwen3's generate cache [8, 160] at length 140 and
    # hymba's generate cache [4, 1132] at lengths 1101..1132. Each shape
    # cycles its model's layer count of inputs, raised until the live K/V
    # read is twice the 50 MB L2.
    B, ps, npg, P1 = 8, 16, 10, 49
    dlens = torch.tensor(np.random.default_rng(0).integers(17, 161, B),
                         device=dev, dtype=torch.int32)
    tab = torch.full((B, npg), -1, dtype=torch.int32, device=dev)
    free = iter(torch.randperm(P1 - 1, generator=gen, device=dev).tolist())
    for b in range(B):
        for i in range((int(dlens[b]) + ps - 1) // ps):
            tab[b, i] = next(free)
    live = int(dlens.sum())
    pos = torch.arange(npg * ps, device=dev)
    pmask = (pos[None] < dlens[:, None])[:, None, None, :]

    def n_sets(layers, live_pos, KVq, hdq):
        return max(layers, -(-2 * 50_000_000 // (4 * live_pos * KVq * hdq)))

    def split_sweep(fn, sets, pairs, cap, hd):
        """The tc route's device time as its span at head dim hd (the
        floor of a chunk, fd.SPAN["tc"], fd.SPAN_HD256["tc"] at hd 256)
        moves: {span: [splits, chunk, ms]}; the span is put back after."""
        spans = fd.SPAN_HD256 if hd == 256 else fd.SPAN
        keep, out = spans["tc"], {}
        try:
            for span in (16, 64, 128, 192, 256, 512):
                spans["tc"] = span
                out[span] = [*fd._splits(pairs, 1, cap, "tc", hd),
                             time_ms(fn, sets)]
        finally:
            spans["tc"] = keep
        return out

    def routes_in_turns(timers):
        """{route: ms} from {route: a call of time_ms}: each timed in the
        order given, then again in reverse, averaged (drift between the
        passes falls on every route alike)."""
        ms = {r: [t()] for r, t in timers.items()}
        for r, t in reversed(list(timers.items())):
            ms[r].append(t())
        return {r: sum(v) / len(v) for r, v in ms.items()}

    def decode_times(fn, plain, library, sets, cost, shape, pairs, cap,
                     hd=128):
        """A decode kernel's routes (in turns), eager, plain and library
        times over `sets` (per dtype), and the tc route's split sweep over
        `pairs` (row, kv head) pairs of `cap` positions at head dim hd; its
        bound from `cost` of one call's arguments."""
        routes = routes_in_turns({
            "tc": lambda: time_ms(fn, sets[bf]),
            "simt_bf16": lambda: time_ms(
                lambda *a: fn(*a, route="simt_bf16"), sets[bf]),
            "simt_f32": lambda: time_ms(fn, sets[f32])})
        return dict(
            ms=routes["tc"], routes=routes,
            split_sweep=split_sweep(fn, sets[bf], pairs, cap, hd),
            eager_ms=time_ms(fn, sets[bf], graph=False),
            plain_ms=time_ms(plain, sets[bf], graph=False),
            library_ms=time_ms(library, sets[bf]),
            library_eager_ms=time_ms(library, sets[bf], graph=False),
            shape=shape + " bf16", bound=bound(cost, *sets[bf][0]),
            bound_f32=bound(cost, *sets[f32][0]))

    paged_times = {}
    for what, (Hq, KVq, hdq, layers) in {
            "qwen3 16/8x128": (16, 8, 128, N_LAYERS),
            "granite 16/8x64": (16, 8, 64, 24),
            "hymba 25/5x64": (25, 5, 64, 32)}.items():
        n = n_sets(layers, live, KVq, hdq)
        sets = {}
        for dt in (bf, f32):
            kp = randn(n, P1, ps, KVq, hdq, dtype=dt)
            vp = randn(n, P1, ps, KVq, hdq, dtype=dt)
            q1 = randn(B, Hq, hdq, dtype=dt)
            sets[dt] = [(q1, kp, vp, tab, dlens, layer)
                        for layer in range(n)]

        def paged(q1, kp, vp, tab, lens, layer, route=None):
            return flash_decode_paged(q1, kp, vp, tab, lens, layer=layer,
                                      route=route)

        def paged_plain(q1, kp, vp, tab, lens, layer):
            return kref.decode_paged_ref(q1, kp, vp, tab, lens, layer=layer)

        def gathered_sdpa(q1, kp, vp, tab, lens, layer):
            phys = torch.where(tab >= 0, tab, P1 - 1).long()
            kk = kp[layer][phys].reshape(B, -1, *kp.shape[-2:]).transpose(1, 2)
            vv = vp[layer][phys].reshape(B, -1, *vp.shape[-2:]).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q1[:, :, None], kk, vv, attn_mask=pmask, enable_gqa=True)

        # q read and the output written, the live K/V rows read once, the
        # block table and lengths (int32); 4 G hd flops a live position
        paged_times[what] = decode_times(
            paged, paged_plain, gathered_sdpa, sets,
            lambda q1, kp, vp, tab, lens, layer: fd.cost_paged(
                q1, kp, vp, tab, lens),
            f"B{B} pool[{n},{P1},{ps},{KVq},{hdq}] live {live} positions",
            B * KVq, npg * ps)
        del sets, kp, vp
    timing["flash_decode_paged"] = dict(
        paged_times["qwen3 16/8x128"],
        library="page gather + scaled_dot_product_attention(mask)",
        dtype="bfloat16", tolerance=TOL, by_shape=paged_times)
    cont_times = {}
    for what, (Bc, Sc, lens, Hq, KVq, hdq, layers) in {
            "qwen3 16/8x128 [8,160]": (8, 160, [140] * 8, 16, 8, 128,
                                       N_LAYERS),
            "hymba generate 25/5x64 [4,1132]": (
                4, 1132, torch.linspace(1101, 1132, 4).round().int().tolist(),
                25, 5, 64, 32)}.items():
        glens = torch.tensor(lens, device=dev, dtype=torch.int32)
        n = n_sets(layers, int(glens.sum()), KVq, hdq)
        sets = {}
        for dt in (bf, f32):
            ck = randn(n, Bc, Sc, KVq, hdq, dtype=dt)
            cv = randn(n, Bc, Sc, KVq, hdq, dtype=dt)
            q1 = randn(Bc, Hq, hdq, dtype=dt)
            sets[dt] = [(q1, ck[i].transpose(1, 2), cv[i].transpose(1, 2),
                         glens) for i in range(n)]
        cmask = (torch.arange(Sc, device=dev)[None] < glens[:, None])[
            :, None, None, :]

        def masked_sdpa(q, k, v, n, cmask=cmask):
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=cmask, enable_gqa=True)

        cont_times[what] = decode_times(
            flash_decode, kref.decode_ref, masked_sdpa, sets, fd.cost,
            f"B{Bc} cache[{n},{Bc},{Sc},{KVq},{hdq}] strided, lengths "
            f"{min(lens)}..{max(lens)}", Bc * KVq, Sc)
        del sets, ck, cv
    timing["flash_decode"] = dict(
        cont_times["qwen3 16/8x128 [8,160]"],
        library="scaled_dot_product_attention(mask)",
        dtype="bfloat16", tolerance=TOL, by_shape=cont_times)
    def in_turns(fn, sets):
        """A chunked kernel's device time on its tile route (the pick) and
        on the simt route, timed in turns (tile, simt, simt, tile) on the
        same inputs: {route: mean ms}."""
        def simt(*a):
            return fn(*a, route="simt")
        t = [time_ms(f, sets) for f in (fn, simt, simt, fn)]
        return {"tile": (t[0] + t[3]) / 2, "simt": (t[1] + t[2]) / 2}

    def scan_times(fn, plain, plain_scan, sets, shape, bnd):
        """A chunked kernel's routes in turns, eager, plain and plain-scan
        times over `sets`, its f32 bound."""
        routes = in_turns(fn, sets)
        return dict(
            ms=routes["tile"], routes=routes,
            eager_ms=time_ms(fn, sets, graph=False),
            plain_ms=time_ms(plain, sets, graph=False),
            plain_scan_ms=time_ms(plain_scan, sets, graph=False),
            library_ms=None, library_eager_ms=None, shape=shape,
            bound=bnd, bound_f32=bnd)

    # the WKV6 prefill at the rwkv6-3b serve shape: B 8, S 128 (the prompt
    # width), 40 heads of 64, f32; 32 layers' inputs (1.3 GB) cycled. The
    # plain version is the sequential recurrence the kernel is held against;
    # the plain scan is the chunked torch scan kernel_backend="ref" serves.
    B, S = 8, 128
    wkv_sets = [(*wkv_inputs(B, S), u_r) for _ in range(N_RWKV_LAYERS)]
    timing["rwkv6_chunked"] = dict(scan_times(
        rwkv6_chunked, kref.rwkv6_ref,
        lambda r, k, v, w, u: ssm.wkv6_chunked_scan(
            *(a.transpose(1, 2) for a in (r, k, v, w)), u), wkv_sets,
        f"B{B} S{S} H{Hr} hd{hdr} f32", bound(rwkv6_cost, *wkv_sets[0])),
        library="none (no single PyTorch call computes WKV6)",
        dtype="float32", tolerance={"float32": RWKV_TOL})
    del wkv_sets

    # the SSD prefill at the hymba-1.5b serve shape (B 8, S 128: the prompt
    # width; 32 layers' inputs, 0.42 GB, cycled) and at its generate shape
    # (B 4, S 1100: 17 chunks and a tail of 12; 3 layers' inputs, 0.17 GB):
    # 50 heads of 64, state 16, f32, strided as the model hands them over.
    # The plain version is the sequential recurrence; the plain scan is the
    # chunked torch scan kernel_backend="ref" serves.
    ssd_times = {}
    for what, (B, S, layers) in {
            "hymba serve [8,50,128,64]": (8, 128,
                                          ARCHS["hymba-1.5b"].num_layers),
            "hymba generate [4,50,1100,64]": (4, 1100, 3)}.items():
        ssd_sets = [ssd_inputs(B, S) for _ in range(layers)]
        ssd_times[what] = scan_times(
            ssd_chunked, kref.ssd_ref,
            lambda x, dt, Bm, Cm, a: ssm.ssd_chunked_scan(
                x.transpose(1, 2), dt.transpose(1, 2), Bm, Cm, a), ssd_sets,
            f"B{B} S{S} H{Hs} P{Ps} N{Ns} f32",
            bound(ssd_cost, *ssd_sets[0]))
        del ssd_sets
    # and at granite4h-serve-chat's padded group: 64 rows of 512, 128 heads
    # of 64, state 128, the cell's lengths (one row of 215, 63 of 1; dt = 0
    # past them); 2 input sets (2.2 GB)
    g4h_sets = [g4h_ssd_operands(dev, randn, gen, G4H_CELL_LENS, G4H_PROMPT)
                for _ in range(2)]
    ssd_times["granite4h group [64,128,512,64]"] = scan_times(
        ssd_chunked, kref.ssd_ref,
        lambda x, dt, Bm, Cm, a: ssm.ssd_chunked_scan(
            x.transpose(1, 2), dt.transpose(1, 2), Bm, Cm, a), g4h_sets,
        f"B{G4H_SLOTS} S{G4H_PROMPT} H128 P64 N128 f32",
        bound(ssd_cost, *g4h_sets[0]))
    del g4h_sets
    timing["ssd_chunked"] = dict(
        ssd_times["hymba serve [8,50,128,64]"],
        library="none (no single PyTorch call computes SSD)",
        dtype="float32", tolerance={"float32": SSD_TOL}, by_shape=ssd_times)
    # the grouped matmul at granite-moe-1b-a400m's four expert GEMM shapes;
    # 24 layers' inputs cycled (1.5 GB of bf16 w_in alone): each route (the
    # tensor-core bf16 one, the SIMT bf16 and f32 ones) beside torch.bmm in
    # bf16; the headline shape is decode w_in (48 launches of the two
    # shapes per decode step)
    gmm_times = {}
    for what, (E, C, d, G, ff) in list(gmm_shapes.items())[:4]:
        sets = {dt: [gmm_inputs(E, C, d, G, ff, dt) for _ in range(24)]
                for dt in (bf, f32)}
        f = G * ff
        tc = "tc_decode" if C <= 16 else "tc_prefill"
        t = gmm_times[what] = dict(
            routes={tc: time_ms(grouped_matmul, sets[bf]),
                    "simt_bf16": time_ms(lambda x, w: grouped_matmul(
                        x, w, route="simt_bf16"), sets[bf]),
                    "simt_f32": time_ms(grouped_matmul, sets[f32])},
            eager_ms=time_ms(grouped_matmul, sets[bf], graph=False),
            plain_ms=time_ms(kref.gmm_ref, sets[bf], graph=False),
            library_ms=time_ms(torch.bmm, sets[bf]),
            library_eager_ms=time_ms(torch.bmm, sets[bf], graph=False),
            shape=f"E{E} C{C} d{d} f{f} bf16",
            bound=bound(gmm_cost, *sets[bf][0]),
            bound_f32=bound(gmm_cost, *sets[f32][0]))
        t["ms"] = t["routes"][tc]
        del sets
    timing["grouped_matmul"] = dict(
        gmm_times["decode w_in"], library="torch.bmm (bf16)",
        dtype="bfloat16", tolerance=TOL, by_shape=gmm_times)
    for name, by in (("flash_decode_paged", paged_times),
                     ("flash_decode", cont_times)):
        for what, t in by.items():
            log("timing", f"{name} {what} tc route by span (splits x chunk: "
                f"ms): " + ", ".join(f"{sp} ({n} x {c}: {ms:.4f})" for sp, (
                    n, c, ms) in t["split_sweep"].items()))
    for name, by in (("flash_attention_fwd", att_times),
                     ("flash_decode_paged", paged_times),
                     ("flash_decode", cont_times),
                     ("grouped_matmul", gmm_times)):
        for what, t in by.items():
            log("timing", f"{name} {what} [{t['shape']}]: routes " + ", ".join(
                f"{r} {ms:.4f} ms" for r, ms in t["routes"].items()) +
                f" (device time, CUDA graph); the tensor-core route eager "
                f"{t['eager_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
                f"library {t['library_ms']:.4f} ms (eager "
                f"{t['library_eager_ms']:.4f}); bound {t['bound'][0]:.4f} ms "
                f"({t['bound'][1]}), in f32 {t['bound_f32'][0]:.4f} ms "
                f"({t['bound_f32'][1]})")
    for name, by in (("rwkv6_chunked", {"rwkv6-3b serve [8,40,128,64]":
                                         timing["rwkv6_chunked"]}),
                     ("ssd_chunked", ssd_times)):
        for what, t in by.items():
            log("timing", f"{name} {what} [{t['shape']}]: routes (in turns) "
                + ", ".join(f"{r} {ms:.4f} ms" for r, ms in t["routes"].items())
                + f" (device time, CUDA graph); eager {t['eager_ms']:.4f} ms; plain {t['plain_ms']:.4f} "
                f"ms, plain chunked scan {t['plain_scan_ms']:.4f} ms; library "
                f"none; bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")

    # gemma3-1b's hd-256 shapes, each route in turns (tc, simt_bf16,
    # simt_f32, then back): prefill attention at the serve shape (B 8, S
    # 128, window 0: the global layers' call) over 26 layers' inputs and at
    # B 2 x S 600 with window 512 (the band inside the rows), beside SDPA
    # (with the band as a mask); paged decode over the serve pool of phase
    # 2's decode timing (the same block table and lengths 17..160) and
    # contiguous decode over a [8, 160] cache at length 140, beside the
    # gathered / masked SDPA, with the tc route's split sweep. Bounds as
    # above; flops counted inside the band.
    Hg, KVg, hdg = 4, 1, 256
    gemma_times = {}
    for what, (B, S, window, layers) in {
            "gemma3 4/1x256": (8, 128, 0, 26),
            "gemma3 4/1x256 S600 window 512": (2, 600, 512, 4)}.items():
        sets = {dt: [tuple(randn(B, S, n, hdg, dtype=dt).transpose(1, 2)
                           for n in (Hg, KVg, KVg)) for _ in range(layers)]
                for dt in (bf, f32)}
        pos_ = torch.arange(S, device=dev)
        band = pos_[None] <= pos_[:, None]
        if window:
            band = band & (pos_[:, None] - pos_[None] < window)

        def attn(q, k, v, window=window, route=None):
            return flash_attention_fwd(q, k, v, causal=True, window=window,
                                       route=route)

        def attn_plain(q, k, v, window=window):
            return kref.attention_ref(q, k, v, causal=True, window=window)

        def banded_sdpa(q, k, v, band=band):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                  enable_gqa=True)
        t = gemma_times[f"flash_attention_fwd {what}"] = dict(
            routes=routes_in_turns({
                "tc": lambda: time_ms(attn, sets[bf]),
                "simt_bf16": lambda: time_ms(
                    lambda q, k, v: attn(q, k, v, route="simt_bf16"),
                    sets[bf]),
                "simt_f32": lambda: time_ms(attn, sets[f32])}),
            eager_ms=time_ms(attn, sets[bf], graph=False),
            plain_ms=time_ms(attn_plain, sets[bf], graph=False),
            library_ms=time_ms(banded_sdpa, sets[bf]),
            library_eager_ms=time_ms(banded_sdpa, sets[bf], graph=False),
            shape=f"B{B} S{S} H{Hg} KV{KVg} hd{hdg} window {window} bf16",
            bound=bound(fa.cost, *sets[bf][0], window=window),
            bound_f32=bound(fa.cost, *sets[f32][0], window=window))
        t["ms"] = t["routes"]["tc"]
        att_times[what] = t
        del sets
    B = 8
    n = n_sets(4, live, KVg, hdg)
    sets = {}
    for dt in (bf, f32):
        kp = randn(n, P1, ps, KVg, hdg, dtype=dt)
        vp = randn(n, P1, ps, KVg, hdg, dtype=dt)
        q1 = randn(B, Hg, hdg, dtype=dt)
        sets[dt] = [(q1, kp, vp, tab, dlens, layer) for layer in range(n)]

    def paged_g(q1, kp, vp, tab, lens, layer, route=None):
        return flash_decode_paged(q1, kp, vp, tab, lens, layer=layer,
                                  route=route)

    def paged_g_plain(q1, kp, vp, tab, lens, layer):
        return kref.decode_paged_ref(q1, kp, vp, tab, lens, layer=layer)

    def gathered_g(q1, kp, vp, tab, lens, layer):
        phys = torch.where(tab >= 0, tab, P1 - 1).long()
        kk = kp[layer][phys].reshape(B, -1, *kp.shape[-2:]).transpose(1, 2)
        vv = vp[layer][phys].reshape(B, -1, *vp.shape[-2:]).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q1[:, :, None], kk, vv, attn_mask=pmask, enable_gqa=True)
    t = gemma_times["flash_decode_paged gemma3 4/1x256"] = decode_times(
        paged_g, paged_g_plain, gathered_g, sets,
        lambda q1, kp, vp, tab, lens, layer: fd.cost_paged(
            q1, kp, vp, tab, lens),
        f"B{B} pool[{n},{P1},{ps},{KVg},{hdg}] live {live} positions",
        B * KVg, npg * ps, hd=hdg)
    paged_times["gemma3 4/1x256"] = t
    del sets, kp, vp
    glens = torch.full((8,), 140, device=dev, dtype=torch.int32)
    n = n_sets(4, int(glens.sum()), KVg, hdg)
    sets = {}
    for dt in (bf, f32):
        ck = randn(n, 8, 160, KVg, hdg, dtype=dt)
        cv = randn(n, 8, 160, KVg, hdg, dtype=dt)
        q1 = randn(8, Hg, hdg, dtype=dt)
        sets[dt] = [(q1, ck[i].transpose(1, 2), cv[i].transpose(1, 2), glens)
                    for i in range(n)]
    gmask = (torch.arange(160, device=dev)[None] < glens[:, None])[
        :, None, None, :]

    def masked_g(q, k, v, n, gmask=gmask):
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=gmask, enable_gqa=True)
    t = gemma_times["flash_decode gemma3 4/1x256 [8,160]"] = decode_times(
        flash_decode, kref.decode_ref, masked_g, sets, fd.cost,
        f"B8 cache[{n},8,160,{KVg},{hdg}] strided, length 140", 8 * KVg,
        160, hd=hdg)
    cont_times["gemma3 4/1x256 [8,160]"] = t
    del sets, ck, cv
    for what, t in gemma_times.items():
        log("timing", f"{what} [{t['shape']}]: routes in turns " + ", ".join(
            f"{r} {ms:.4f} ms" for r, ms in t["routes"].items()) +
            f" (device time, CUDA graph); "
            f"eager {t['eager_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
            f"library {t['library_ms']:.4f} ms (eager "
            f"{t['library_eager_ms']:.4f}); bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]}), in f32 {t['bound_f32'][0]:.4f} ms "
            f"({t['bound_f32'][1]})" + ("; tc by span (splits x chunk: ms): "
                                        + ", ".join(
                f"{sp} ({n} x {c}: {ms:.4f})" for sp, (n, c, ms) in
                t["split_sweep"].items()) if "split_sweep" in t else ""))

    def check_launches(tag, launches, rep, need):
        """`need` maps each kernel of the path to ("prefill" | "decode" |
        "both", its launches per prefill group, decode step or either); the
        counts must equal that."""
        ok = rep.prefill_calls and rep.decode_steps
        for name, (per, n) in need.items():
            calls = {"prefill": rep.prefill_calls, "decode": rep.decode_steps,
                     "both": rep.prefill_calls + rep.decode_steps}[per]
            ok = ok and launches[name] == n * calls
        if not ok:
            raise AssertionError(f"{tag} missed its kernels: {launches} for "
                                 f"{rep.prefill_calls} prefill groups, "
                                 f"{rep.decode_steps} decode steps; needed "
                                 f"exactly {need}")

    def fast(route):
        """A kernel's fast route: tensor-core tiles (attention, decode, the
        grouped matmul in bf16) or register tiles (WKV6, SSD)."""
        return route.startswith("tc") or route == "tile"

    def check_routes(tag, launches):
        """Every launch of every kernel on the path took its fast route."""
        for name, routes in launches["routes"].items():
            n_ok = sum(n for r, n in routes.items() if fast(r))
            if n_ok != launches[name]:
                raise AssertionError(
                    f"{tag}: {name} launched {launches[name]} times, {n_ok} "
                    f"of them on its fast route (tc* or tile): {routes}")

    def measured_launches():
        """LAUNCHES, with ROUTES beside them under "routes"."""
        return dict(LAUNCHES, routes={n: dict(r) for n, r in ROUTES.items()})

    def serve_phase(tag, eng, reqs, need, pool, routing=None):
        """`reqs` through the Scheduler once to warm up (cuBLAS, the
        allocator) and once with the launch counts at 0: every kernel of
        `need` launched, every request's tokens out and in the vocabulary,
        a page pool only if `pool`; then a profiled short run. Returns the
        launch counts of the measured run. With `routing` (a callable of the
        MoE routing records and the report), the measured run records the
        routing of every MoE layer and hands it over."""
        arch, sv = eng.plan.arch, eng.plan.serve
        t0 = time.monotonic()
        Scheduler(eng).run(reqs[:2])
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with moe.record_routing() as records:
            rep = Scheduler(eng).run(reqs)
            torch.cuda.synchronize()
        launches = measured_launches()
        check_launches(tag, launches, rep, need)
        check_routes(tag, launches)
        toks = [t for r in rep.requests for t in r.tokens]
        if rep.tokens_out != len(reqs) * sv.gen or \
                bool(rep.pages_total) != pool or \
                not all(0 <= t < arch.vocab_size for t in toks):
            raise AssertionError(f"{tag}: bad serve output: {rep.tokens_out} "
                                 f"tokens, {rep.pages_total} pages")
        stats = eng.serve_store().stats()
        log("serve", f"{tag} bf16: {len(reqs)} requests, {rep.tokens_out} "
            f"tokens ({len(set(toks))} distinct) in {rep.wall_s:.3f} s = "
            f"{rep.tokens_per_s():.1f} tok/s; {rep.ms_per_token():.2f} ms "
            f"per decode step over {rep.decode_steps} steps; mean TTFT "
            f"{rep.mean_ttft() * 1e3:.1f} ms over {rep.prefill_calls} "
            f"prefill groups ({rep.prefill_s / rep.prefill_calls * 1e3:.1f} "
            f"ms each); peak pages {rep.peak_pages}/{rep.pages_total}, "
            f"admission blocked {rep.admit_blocked}x; pool "
            f"{stats['pool_bytes'] / 2**20:.1f} MiB; per-slot state "
            f"{stats['slot_state_bytes'] / 2**20:.1f} MiB; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"warm-up {warm_s:.1f} s")
        log("serve", f"{tag} launches {launches} (needed per prefill group "
            f"/ decode step, exactly: {need}; every launch on its kernel's "
            f"fast route: tc* or tile)")
        if routing is not None:
            routing(records, rep)
        del records
        short = [Request(rid=100 + i, prompt=r.prompt, max_new_tokens=8)
                 for i, r in enumerate(reqs[:8])]
        profile_run(f"{tag} Scheduler, 8 requests x 8 tokens",
                    lambda: Scheduler(eng).run(short))
        return launches

    def generate_phase(tag, plan, params, need):
        """Engine.generate over the contiguous cache, warmed up, then with
        the launch counts at 0; then a profiled short run. Returns the
        launch counts of the measured run."""
        arch, sv = plan.arch, plan.serve
        eg = Engine(plan, params=params)
        eg.generate()                             # warm-up
        reset_launches()
        rep = eg.generate()
        torch.cuda.synchronize()
        launches = measured_launches()
        check_launches(f"{tag} generate", launches, rep, need)
        check_routes(f"{tag} generate", launches)
        if rep.tokens.shape != (sv.max_batch, sv.gen) or not (
                (rep.tokens >= 0) & (rep.tokens < arch.vocab_size)).all():
            raise AssertionError(f"{tag}: bad generate output "
                                 f"{rep.tokens.shape}")
        log("generate", f"{tag} bf16, batch {sv.max_batch}, prompt "
            f"{sv.prompt_len}, {sv.gen} tokens: prefill "
            f"{rep.prefill_s * 1e3:.1f} ms, {rep.ms_per_token():.2f} ms/token "
            f"over {rep.decode_steps} steps, {rep.tokens_per_s():.1f} tok/s; "
            f"launches {launches}")
        profile_run(f"{tag} Engine.generate, batch {sv.max_batch} x 8 tokens",
                    Engine(plan.replace(serve__gen=8), params=params).generate)
        return launches

    # ---- 3. full-width paged serving -----------------------------------
    arch = ARCHS["qwen3-0.6b"]
    params32 = lm.init_params(arch, torch.Generator(device=dev).manual_seed(0),
                              dtype=torch.float32, device=dev)
    for name in ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo"):
        params32["blocks"][name].mul_(WEIGHT_SCALE)
    params_bf16 = bf16_copy(params32)
    sv = ServeSpec(prompt_len=128, gen=32, max_batch=8, page_size=16,
                   max_pages=48, kernel_backend="cuda")
    plan = Plan(arch=arch, run=RunSpec(compute_dtype="bfloat16"), serve=sv)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, arch.vocab_size, int(rng.integers(16, 129)), dtype=np.int32))
        for i in range(16)]
    main_launches = serve_phase(
        f"qwen3-0.6b full width ({arch.num_layers} layers, d "
        f"{arch.d_model}, {arch.num_heads}/{arch.num_kv_heads} heads, hd "
        f"{arch.head_dim}, vocab {arch.vocab_size})",
        Engine(plan, params=params_bf16), reqs,
        {"flash_attention_fwd": ("prefill", N_LAYERS),
         "flash_decode_paged": ("decode", N_LAYERS)}, pool=True)

    # ---- 4. kernel path against the plain path, f32 --------------------
    class MarginScheduler(Scheduler):
        """Records each pick's top-2 logit margin, keyed (rid, k), and with
        `records` (an MoE routing log of `layers` layers a forward call) the
        index of the forward call the pick came from."""

        def __init__(self, engine, records=None, layers=1):
            super().__init__(engine)
            self.margins, self.calls = {}, {}
            self.records, self.layers = records, layers

        def _pick_one(self, row, rid, k):
            top = np.partition(row, -2)[-2:]
            self.margins[(rid, k)] = float(top[1] - top[0])
            if self.records is not None:
                self.calls[(rid, k)] = len(self.records) // self.layers - 1
            return super()._pick_one(row, rid, k)

    def swapped(a, b):
        """[T] expert choices that differ between two routing records of one
        MoE layer call (the kernel and the plain side), per position."""
        hot = [torch.nn.functional.one_hot(r["idx"], r["logits"].shape[1])
               .sum(1) for r in (a, b)]
        return (hot[0] != hot[1]).sum(-1) // 2

    def row_flips(recs_k, recs_r):
        """[B] expert choices that differ between the two sides' routing of
        one forward call (its layers' records), by row."""
        return sum(swapped(a, b).view(*a["shape"]).sum(-1)
                   for a, b in zip(recs_k, recs_r)).cpu()

    def first_flip(recs_k, recs_r):
        """One forward call recorded on both sides: (its first layer whose
        expert choices differ, or None; the positions that flip there; the
        largest router-logit difference at layer 0 and at the last layer
        before it). A flip moves the capacity drops of the whole group, so
        the layers after it are a cascade."""
        diffs = []
        for layer, (a, b) in enumerate(zip(recs_k, recs_r)):
            flipped = swapped(a, b) > 0
            if flipped.any():
                return layer, int(flipped.sum()), diffs[:1] + diffs[-1:]
            diffs.append(err(a["logits"], b["logits"]))
        return None, 0, diffs[:1] + diffs[-1:]

    def moe_layer_parity(arch, params, prompts):
        """Every layer of `arch` in f32 on the same input: the plain path's
        hidden state enters both backends (teacher forcing; prefill over
        full rows, no cache), so each layer's kernel path is held alone,
        not through the layers before it. The outputs agree within 1e-5 of
        their scale, the routing is the same except at near-ties (a layer
        with a flip is counted, not compared). Returns (the worst relative
        output difference, positions flipped)."""
        x = lm.embed_tokens(arch, params, prompts)
        worst, tied = 0.0, 0
        with torch.inference_mode():
            for layer in range(arch.num_layers):
                p_l = {k: v[layer] for k, v in params["blocks"].items()}
                out = {}
                for be in ("cuda", "ref"):
                    with moe.record_routing() as rec:
                        y, _ = blocks.apply_layer(arch, p_l, x, blocks.LayerCtx(
                            mode="prefill", kernel_backend=be))
                    out[be] = y, rec[0]
                (yk, rk), (yr, rr) = out["cuda"], out["ref"]
                flipped = swapped(rk, rr) > 0
                if flipped.any():
                    m = float(moe.topk_margin(rr["logits"], arch.top_k)[
                        flipped].max())
                    if m >= ROUTE_TOL:
                        raise AssertionError(
                            f"{arch.name} layer {layer}: on the same input a "
                            f"choice with a K/K+1 margin {m:.3e} >= "
                            f"{ROUTE_TOL} flipped")
                    tied += int(flipped.sum())
                else:
                    rel = err(yk, yr) / float(yr.abs().max())
                    if not rel <= 1e-5:
                        raise AssertionError(
                            f"{arch.name} layer {layer}: on the same input "
                            f"the kernel path differs by {rel:.3e} of the "
                            f"output's scale (> 1e-5)")
                    worst = max(worst, rel)
                x = yr
        return worst, tied

    def near_ties(recs):
        """Routed positions whose K-th and (K+1)-th router logits are closer
        than ROUTE_TOL (summed over the records' layers)."""
        return sum(int((moe.topk_margin(r["logits"], r["idx"].shape[1])
                        < ROUTE_TOL).sum()) for r in recs)

    def f32_streams(tag, plan32, params32, reqs, moe_layers=0, tile=(),
                    exact=False):
        """`reqs` in f32 through the kernels and through the plain path: the
        first prefill's logits agree within LOGIT_TOL and the greedy streams
        match except at a step whose plain top-2 margin is under it; every
        launch of the kernels named in `tile` (launched at least once) on
        their tile route. With
        `moe_layers`, the routing of both sides is recorded: the first
        prefill's logits may differ only if an expert choice flipped there,
        and a stream may also diverge after a flipped choice that reached it
        (in its prefill group, where capacity couples the rows, or in its
        own row of a later decode step). With `exact`, every stream must
        equal its plain twin."""
        sv = plan32.serve
        e_k = Engine(plan32, params=params32)
        e_r = Engine(plan32.replace(serve__kernel_backend="ref"),
                     params=params32)
        first, first_recs = [], []
        for e in (e_k, e_r):
            store = e.serve_store()
            prompts = np.zeros((sv.max_batch, sv.prompt_len), np.int32)
            lens = np.ones(sv.max_batch, np.int32)
            for j, r in enumerate(reqs[:4]):
                store.alloc(j, len(r.prompt) + sv.gen)
                prompts[j, :len(r.prompt)] = r.prompt
                lens[j] = len(r.prompt)
            with moe.record_routing() as recs:
                first.append(e.prefill_into(store, prompts, lens,
                                            [0, 1, 2, 3])[:4])
            first_recs.append(recs)
            del store
        d_logits = err(first[0], first[1])
        flips0 = int(row_flips(*first_recs).sum()) if moe_layers else 0
        if moe_layers:
            ff0 = first_flip(*first_recs)
        if not (torch.isfinite(first[0]).all() and
                (d_logits <= LOGIT_TOL or flips0)):
            raise AssertionError(f"{tag}: f32 first-prefill logits differ by "
                                 f"{d_logits:.3e} > {LOGIT_TOL}")
        reset_launches()
        with moe.record_routing() as recs_k:
            out_k = Scheduler(e_k).run(reqs)
        torch.cuda.synchronize()
        for name in tile:
            if not ROUTES[name]["tile"] == LAUNCHES[name] > 0:
                raise AssertionError(f"{tag} f32: {name} launched "
                                     f"{LAUNCHES[name]} times, routes "
                                     f"{ROUTES[name]}: not all on tile")
        tiled = {name: LAUNCHES[name] for name in tile}
        with moe.record_routing() as recs_r:
            ref_sched = MarginScheduler(e_r, recs_r, max(moe_layers, 1))
            out_r = ref_sched.run(reqs)
        L = moe_layers
        if L and len(recs_k) != len(recs_r):
            raise AssertionError(f"{tag}: the two runs made "
                                 f"{len(recs_k)} and {len(recs_r)} MoE calls")

        flips = [row_flips(recs_k[c * L:(c + 1) * L], recs_r[c * L:(c + 1) * L])
                 for c in range(len(recs_r) // L)] if L else []
        ties, after_flip, diverged = 0, 0, 0
        for a, b in zip(out_k.requests, out_r.requests):
            if a.tokens != b.tokens:
                k = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                         if x != y)
                margin = ref_sched.margins[(b.rid, k)]
                if margin < LOGIT_TOL:
                    ties += 1
                elif L and (int(flips[ref_sched.calls[(b.rid, 0)]].sum()) or
                            any(int(flips[c][b.slot]) for c in range(
                                ref_sched.calls[(b.rid, 0)] + 1,
                                ref_sched.calls[(b.rid, k)] + 1))):
                    after_flip += 1
                else:
                    raise AssertionError(
                        f"{tag}: rid {a.rid}: streams diverge at token {k} "
                        f"with a top-2 margin {margin:.3e} >= {LOGIT_TOL}"
                        + (" and no expert choice flipped before it"
                           if L else ""))
            diverged += a.tokens != b.tokens
        if exact and diverged:
            raise AssertionError(f"{tag}: {diverged} f32 kernel stream(s) "
                                 f"differ from the plain path's")
        route = ""
        if L:
            route = (f"; routing: first prefill {flips0} flipped choice(s), "
                     f"the first at layer {ff0[0]} ({ff0[1]} position(s); "
                     f"router logits kernel vs plain differ by "
                     f"{' growing to '.join(f'{v:.1e}' for v in ff0[2]) or '-'} "
                     f"over the layers before it), "
                     f"{near_ties(first_recs[1])} position(s) with a K/K+1 router "
                     f"margin under {ROUTE_TOL} (of "
                     f"{sum(r['idx'].shape[0] for r in first_recs[1])} "
                     f"routed positions); {after_flip} divergence(s) after "
                     f"a flipped choice in the request's prefill group or "
                     f"its row")
        log("f32", f"{tag}: first-prefill logits max |cuda - ref| "
            f"{d_logits:.3e} (tolerance {LOGIT_TOL}); streams identical for "
            f"{len(reqs) - diverged}/{len(reqs)} requests, {ties} "
            f"divergence(s) at a top-2 margin under {LOGIT_TOL}; "
            f"min margin {min(ref_sched.margins.values()):.3e}" + route +
            "".join(f"; {n}: {c} launches, all on tile"
                    for n, c in tiled.items()))

    f32_streams("qwen3-0.6b", plan.replace(run__compute_dtype="float32"),
                params32, reqs)
    del params32

    # ---- 5. Engine.generate at full width, contiguous cache ------------
    gen_launches = generate_phase(
        "qwen3-0.6b full width",
        Plan(arch=arch, run=RunSpec(compute_dtype="bfloat16"),
             serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                             kernel_backend="cuda")), params_bf16,
        {"flash_attention_fwd": ("prefill", N_LAYERS),
         "flash_decode": ("decode", N_LAYERS)})
    del params_bf16

    # ---- 6. rwkv6-3b at full width, bf16, Scheduler ----------------------
    rw = ARCHS["rwkv6-3b"]
    rgen = torch.Generator(device=dev).manual_seed(1)
    rparams32 = lm.init_params(rw, rgen, dtype=torch.float32, device=dev)
    blk = rparams32["blocks"]
    for name in RWKV_MATS:
        blk[name].mul_(WEIGHT_SCALE)
    # the JAX init's wa = wb = 0 makes the decay one constant: draw the LoRA
    # so the decay varies per token and channel and the clip is reached
    # (raw ~ -5 + N(0, ~3) against the clip at [-8, 1.386]), and draw the
    # token-shift mixes and the u-bonus
    blk["wa"].normal_(0.0, 0.02, generator=rgen)
    blk["wb"].normal_(0.0, 0.5, generator=rgen)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cm_mu_k",
                 "cm_mu_r", "u"):
        blk[name].uniform_(0.0, 1.0, generator=rgen)
    rparams_bf16 = bf16_copy(rparams32)
    rplan = Plan(arch=rw, run=RunSpec(compute_dtype="bfloat16"),
                 serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                                 kernel_backend="cuda"))
    rreqs = [Request(rid=i, prompt=rng.integers(
        0, rw.vocab_size, int(rng.integers(16, 129)), dtype=np.int32))
        for i in range(16)]
    rwkv_need = {"rwkv6_chunked": ("prefill", N_RWKV_LAYERS)}
    rw_launches = serve_phase(
        f"rwkv6-3b full width ({rw.num_layers} layers, d {rw.d_model}, "
        f"{rw.n_ssm_heads} WKV heads of {rw.d_model // rw.n_ssm_heads}, "
        f"d_ff {rw.d_ff}, vocab {rw.vocab_size}, untied head)",
        Engine(rplan, params=rparams_bf16), rreqs, rwkv_need, pool=False)

    # ---- 7. rwkv6-3b kernel path against the plain path, f32 ------------
    f32_streams("rwkv6-3b", rplan.replace(run__compute_dtype="float32"),
                rparams32, rreqs, tile=("rwkv6_chunked",))
    del rparams32

    # ---- 8. rwkv6-3b Engine.generate, contiguous cache -------------------
    rw_gen_launches = generate_phase("rwkv6-3b full width", rplan,
                                     rparams_bf16, rwkv_need)
    del rparams_bf16

    # ---- 9. hymba-1.5b at full width, bf16, Scheduler --------------------
    hy = ARCHS["hymba-1.5b"]
    n_full = hy.layer_kinds()[:hy.num_layers].count(0)   # full attention
    hgen = torch.Generator(device=dev).manual_seed(2)
    hparams32 = lm.init_params(hy, hgen, dtype=torch.float32, device=dev)
    blk = hparams32["blocks"]
    for name in HYMBA_MATS:
        blk[name].mul_(WEIGHT_SCALE)
    # the SSD in_proj's dt columns (its last H) stay at the init's scale:
    # scaled, their pre-activation is ~N(0, 8) and exp(dt a) underflows to
    # 0 for nearly every head, so no state would cross a chunk. dt_bias is
    # drawn in [-6, -1] so the per-step decays spread over (0, 1) and some
    # heads carry their state across a 64-row chunk; D, the SSD norm scale
    # and the two branch norms are drawn off their constant inits
    blk["ssd_in_proj"][..., :-hy.n_ssm_heads].mul_(WEIGHT_SCALE)
    blk["ssd_dt_bias"].uniform_(-6.0, -1.0, generator=hgen)
    blk["ssd_D"].uniform_(0.5, 1.5, generator=hgen)
    for name in ("ssd_norm_scale", "bn_attn", "bn_ssm"):
        blk[name].uniform_(-0.5, 0.5, generator=hgen)
    hreqs = [Request(rid=i, prompt=rng.integers(
        0, hy.vocab_size, int(rng.integers(16, 129)), dtype=np.int32))
        for i in range(16)]
    with torch.inference_mode():      # layer 0's SSD decays on one prompt
        p0 = {k[4:]: v[0] for k, v in blk.items() if k.startswith("ssd_")}
        xn = rms_norm(lm.embed_tokens(hy, hparams32, torch.as_tensor(
            hreqs[0].prompt, device=dev)[None]), blk["ln1"][0])
        dt0 = ssm.ssd_projections(p0, xn, hy.n_ssm_heads, hy.d_inner,
                                  hy.ssm_state)[4]
        la = dt0 * -torch.exp(p0["A_log"])                 # [1, S, H]
        step_dec = torch.exp(la)
        spread = float(((step_dec >= 0.01) & (step_dec <= 0.99)).float()
                       .mean())
        chunk_dec = torch.exp(la[:, :64].sum(dim=1))       # per head
    log("weights", f"hymba-1.5b layer 0 SSD: per-step decays exp(dt a) in "
        f"[0.01, 0.99]: {spread:.3f} of {step_dec.numel()}; heads whose "
        f"decay over 64 steps exceeds "
        f"0.01: {int((chunk_dec > 0.01).sum())}/{hy.n_ssm_heads}")
    hparams_bf16 = bf16_copy(hparams32)
    hsv = ServeSpec(prompt_len=128, gen=32, max_batch=8, page_size=16,
                    max_pages=48, kernel_backend="cuda")
    hplan = Plan(arch=hy, run=RunSpec(compute_dtype="bfloat16"), serve=hsv)
    h_eng = Engine(hplan, params=hparams_bf16)
    hy_launches = serve_phase(
        f"hymba-1.5b full width ({hy.num_layers} layers, {n_full} "
        f"full + {hy.num_layers - n_full} windowed at "
        f"{hy.window_size}, d {hy.d_model}, {hy.num_heads}/"
        f"{hy.num_kv_heads} heads of {hy.head_dim}, {hy.n_ssm_heads} SSD "
        f"heads of {hy.d_inner // hy.n_ssm_heads} with state "
        f"{hy.ssm_state}, d_ff {hy.d_ff}, vocab {hy.vocab_size}, untied "
        f"head)", h_eng, hreqs,
        {"ssd_chunked": ("prefill", hy.num_layers),
         "flash_attention_fwd": ("prefill", n_full),
         "flash_decode_paged": ("decode", n_full)}, pool=True)
    kf = h_eng.serve_store().tree["kv_full"][0]
    log("serve", f"hymba-1.5b pool: {kf.shape[0]} kv_full groups allocated "
        f"(stages x m_full, the JAX package's stage-major layout), "
        f"{n_full} of them written")
    del h_eng, kf

    # ---- 10. hymba-1.5b kernel path against the plain path, f32 ---------
    f32_streams("hymba-1.5b", hplan.replace(run__compute_dtype="float32"),
                hparams32, hreqs, tile=("ssd_chunked",))
    del hparams32

    # ---- 11. hymba-1.5b Engine.generate past the window -----------------
    hy_gen_launches = generate_phase(
        "hymba-1.5b full width, rings wrapped",
        Plan(arch=hy, run=RunSpec(compute_dtype="bfloat16"),
             serve=ServeSpec(prompt_len=1100, gen=32, max_batch=4,
                             kernel_backend="cuda")), hparams_bf16,
        {"ssd_chunked": ("prefill", hy.num_layers),
         "flash_attention_fwd": ("prefill", n_full),
         "flash_decode": ("decode", n_full)})
    del hparams_bf16

    # ---- 12. granite-moe-1b-a400m at full width, bf16, Scheduler ---------
    gr = ARCHS["granite-moe-1b-a400m"]
    NG = gr.num_layers
    ggen = torch.Generator(device=dev).manual_seed(3)
    gparams32 = lm.init_params(gr, ggen, dtype=torch.float32, device=dev)
    blk = gparams32["blocks"]
    for name in GRANITE_MATS:
        blk[name].mul_(WEIGHT_SCALE)
    # the router stays at the init's std 0.02: the spread printed below says
    # whether it routes evenly
    greqs = [Request(rid=i, prompt=rng.integers(
        0, gr.vocab_size, int(rng.integers(16, 129)), dtype=np.int32))
        for i in range(16)]
    gparams_bf16 = bf16_copy(gparams32)
    gsv = ServeSpec(prompt_len=128, gen=32, max_batch=8, page_size=16,
                    max_pages=48, kernel_backend="cuda")
    gplan = Plan(arch=gr, run=RunSpec(compute_dtype="bfloat16"), serve=gsv)
    g_need = {"grouped_matmul": ("both", 2 * NG),
              "flash_attention_fwd": ("prefill", NG),
              "flash_decode_paged": ("decode", NG)}

    def routing_report(records, rep):
        """The router's logit spread and K/K+1 margins, the first prefill
        group's expert loads per layer, and each group's dropped choices at
        real prompt positions and at padding (short prompts, dead rows)."""
        pre = [r for r in records if r["shape"][1] == gsv.prompt_len]
        if len(pre) != NG * rep.prefill_calls:
            raise AssertionError(f"{len(pre)} MoE prefill records for "
                                 f"{rep.prefill_calls} groups")
        std = [float(r["logits"].std()) for r in pre[:NG]]
        marg = torch.cat([moe.topk_margin(r["logits"], gr.top_k)
                          for r in pre[:NG]])
        log("routing", f"granite router logits (first group) std per layer "
            f"{min(std):.3f}..{max(std):.3f}; K/K+1 margin median "
            f"{float(marg.median()):.3e}, min {float(marg.min()):.3e}; "
            f"routed positions with a margin under {ROUTE_TOL}: "
            f"{int((marg < ROUTE_TOL).sum())}/{marg.numel()}")
        loads = [torch.bincount(r["idx"][r["keep"]], minlength=gr.num_experts)
                 for r in pre[:NG]]
        log("routing", f"granite first group expert loads (capacity "
            f"{pre[0]['cap']}): max per layer "
            f"{[int(x.max()) for x in loads]}, mean "
            f"{float(torch.stack(loads).float().mean()):.1f}")
        drops = []
        for g in range(rep.prefill_calls):
            rows = sorted((r for r in rep.requests if r.group == g),
                          key=lambda r: r.slot)
            live = torch.zeros(gsv.max_batch, gsv.prompt_len,
                               dtype=torch.bool, device=dev)
            for j, r in enumerate(rows):
                live[j, :r.prompt_len] = True
            real = pad = 0
            for r in pre[g * NG:(g + 1) * NG]:
                drop = (~r["keep"]).view(gsv.max_batch, gsv.prompt_len, -1)
                real += int(drop[live].sum())
                pad += int(drop[~live].sum())
            drops.append((len(rows), real, pad))
        log("routing", "granite dropped choices per prefill group (rows, "
            "real, padding), over all layers: " + "; ".join(
                f"g{g} {n} rows: {a}/{b}" for g, (n, a, b) in
                enumerate(drops)))

    gr_launches = serve_phase(
        f"granite-moe-1b-a400m full width ({NG} layers, d {gr.d_model}, "
        f"{gr.num_heads}/{gr.num_kv_heads} heads of {gr.head_dim}, "
        f"{gr.num_experts} experts top-{gr.top_k} with d_ff {gr.d_ff}, vocab "
        f"{gr.vocab_size}, tied)", Engine(gplan, params=gparams_bf16), greqs,
        g_need, pool=True, routing=routing_report)

    # ---- 13. granite kernel path against the plain path, f32 -------------
    lp_prompts = torch.as_tensor(np.random.default_rng(14).integers(
        0, gr.vocab_size, (8, 128)), device=dev)
    worst_rel, tied = moe_layer_parity(gr, gparams32, lp_prompts)
    log("f32", f"granite-moe-1b-a400m layer by layer on the same input (8 x "
        f"128 tokens, the plain path's hidden state into both): outputs "
        f"within {worst_rel:.3e} of their scale (tolerance 1e-5), "
        f"{tied} position(s) flipped at a near-tie")
    f32_streams("granite-moe-1b-a400m",
                gplan.replace(run__compute_dtype="float32"), gparams32, greqs,
                moe_layers=NG)
    del gparams32

    # ---- 14. granite Engine.generate, contiguous cache -------------------
    gr_gen_launches = generate_phase(
        "granite-moe-1b-a400m full width",
        Plan(arch=gr, run=RunSpec(compute_dtype="bfloat16"),
             serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                             kernel_backend="cuda")), gparams_bf16,
        {"grouped_matmul": ("both", 2 * NG),
         "flash_attention_fwd": ("prefill", NG),
         "flash_decode": ("decode", NG)})
    del gparams_bf16

    # ---- 15-17. training ------------------------------------------------
    train_phases(dev)
    free_device()

    def layer_parity(arch, params, prompts):
        """Every layer of `arch` alone on the same input, in f32 (each
        layer's weights widened from their bf16 copy): the plain path's
        hidden state enters both backends (prefill over full rows, no
        cache), outputs within 1e-5 of their scale. Returns the worst
        relative difference."""
        x = lm.embed_tokens(arch, params, prompts).float()
        worst = 0.0
        with torch.inference_mode():
            for layer in range(arch.num_layers):
                p_l = {k: v[layer].float() for k, v in params["blocks"].items()}
                out = {be: blocks.apply_layer(arch, p_l, x, blocks.LayerCtx(
                    mode="prefill", kernel_backend=be))[0]
                    for be in ("cuda", "ref")}
                rel = err(out["cuda"], out["ref"]) / float(
                    out["ref"].abs().max())
                if not rel <= 1e-5:
                    raise AssertionError(
                        f"{arch.name} layer {layer}: on the same input the "
                        f"kernel path differs by {rel:.3e} of the output's "
                        f"scale (> 1e-5)")
                worst = max(worst, rel)
                x = out["ref"]
        return worst

    def scaled(arch, seed, dtype, mats=DENSE_MATS):
        """Seeded random params of `arch` on the card, the block matrices
        scaled by WEIGHT_SCALE."""
        p = lm.init_params(arch, torch.Generator(device=dev).manual_seed(seed),
                           dtype=dtype, device=dev)
        for name in mats:
            p["blocks"][name].mul_(WEIGHT_SCALE)
        return p

    def chaos_serve(cparams):
        """Phase 21: qwen3-0.6b in bf16 through the kernels under two slot
        faults, once recovered by requeue and once by reprefill: the
        streams equal the fault-free run's except at a near-tie (its top-2
        margin printed), and the report's and the trace's fault counters
        equal the plan's."""
        from repro_torch.api import FaultPlan, FaultPolicy, SlotFault
        from repro_torch.obs import Tracer
        q = ARCHS["qwen3-0.6b"]
        crng = np.random.default_rng(21)
        # prompts of at most 96 tokens: prompt + generated tokens still fit
        # the prefill width of 128, so a reprefill can rebuild the slot
        creqs = [Request(rid=i, prompt=crng.integers(
            0, q.vocab_size, int(crng.integers(16, 97)), dtype=np.int32))
            for i in range(16)]
        cplan = Plan(arch=q, run=RunSpec(compute_dtype="bfloat16"),
                     serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                                     page_size=16, max_pages=64,
                                     kernel_backend="cuda"))
        events = (SlotFault(slot=0, step=3), SlotFault(slot=5, step=9))
        base_s = MarginScheduler(Engine(cplan, params=cparams))
        base = base_s.run(creqs)
        want = {r.rid: r.tokens for r in base.requests}
        for mode, pol, counts in (
                ("requeue", FaultPolicy(),
                 dict(requeues=2, quarantined=2, reprefills=0)),
                ("reprefill", FaultPolicy(slot_recovery="reprefill",
                                          quarantine_slots=False),
                 dict(reprefills=2, requeues=0, quarantined=0))):
            tracer = Tracer()
            t0 = time.monotonic()
            rep = Scheduler(Engine(cplan.replace(
                faults=FaultPlan(events=events), fault_policy=pol),
                params=cparams, tracer=tracer)).run(creqs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            got = dict(slot_faults=rep.slot_faults,
                       **{k: getattr(rep, k) for k in counts})
            need = dict(slot_faults=len(events), **counts)
            tel = {k.split("/", 1)[1]: v for k, v in
                   rep.telemetry.counters.items() if k.startswith("fault/")}
            if got != need or tel.get("slot_faults") != len(events) or \
                    tel.get(mode + "s") != 2 or rep.failed_requests or \
                    rep.shed or rep.tokens_out != 16 * 32:
                raise AssertionError(f"chaos serve ({mode}): counters {got} "
                                     f"(the plan's: {need}), fault/* "
                                     f"telemetry {tel}, {rep.tokens_out} "
                                     f"tokens")
            ties, same = [], 0
            for r in rep.requests:
                if r.tokens == want[r.rid]:
                    same += 1
                    continue
                k = next(i for i, (a, b) in enumerate(zip(r.tokens,
                                                          want[r.rid]))
                         if a != b)
                m = base_s.margins[(r.rid, k)]
                if m >= BF16_TIE:
                    raise AssertionError(
                        f"chaos serve ({mode}): rid {r.rid} diverges from the "
                        f"fault-free stream at token {k}, top-2 margin "
                        f"{m:.3e} >= {BF16_TIE}")
                ties.append((r.rid, k, round(m, 5)))
            log("chaos", f"serve qwen3-0.6b bf16 kernels, 16 requests x 32 "
                f"tokens under {[(e.slot, e.step) for e in events]} (slot, "
                f"step) faults, {mode}: {same}/16 streams equal the "
                f"fault-free run's; divergences (rid, token, fault-free "
                f"top-2 margin) at near-ties under {BF16_TIE}: "
                f"{ties or 'none'}; counters {got} = the plan's; fault/* "
                f"telemetry {tel}; {rep.prefill_calls} prefill calls, "
                f"{rep.decode_steps} decode steps in {wall:.2f} s "
                f"(fault-free: {base.prefill_calls}, {base.decode_steps})")

    # ---- 18. gemma3-1b at full width: bf16 Scheduler, f32 streams -------
    ga = ARCHS["gemma3-1b"]
    kinds = list(ga.layer_kinds()[:ga.num_layers])
    n_glob = kinds.count(0)
    g3p32 = scaled(ga, 4, torch.float32)
    g3bf = bf16_copy(g3p32)
    g3reqs = [Request(rid=i, prompt=rng.integers(
        0, ga.vocab_size, int(rng.integers(16, 129)), dtype=np.int32))
        for i in range(16)]
    g3plan = Plan(arch=ga, run=RunSpec(compute_dtype="bfloat16"),
                  serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                                  page_size=16, max_pages=48,
                                  kernel_backend="cuda"))
    g3_launches = serve_phase(
        f"gemma3-1b full width ({ga.num_layers} layers, {n_glob} global, "
        f"window {ga.window_size}, d {ga.d_model}, {ga.num_heads}/"
        f"{ga.num_kv_heads} heads of {ga.head_dim}, d_ff {ga.d_ff}, vocab "
        f"{ga.vocab_size}, tied)", Engine(g3plan, params=g3bf), g3reqs,
        {"flash_attention_fwd": ("prefill", n_glob),
         "flash_decode_paged": ("decode", n_glob)}, pool=True)
    f32_streams("gemma3-1b", g3plan.replace(run__compute_dtype="float32"),
                g3p32, g3reqs, exact=True)
    del g3p32, g3bf
    free_device()

    # ---- 19. minitron-8b at full width, bf16 ----------------------------
    mt = ARCHS["minitron-8b"]
    torch.cuda.reset_peak_memory_stats()
    mtp = scaled(mt, 5, torch.bfloat16)
    init_peak = torch.cuda.max_memory_allocated()
    n_mt = sum(t.numel() for t in tree_leaves(mtp))
    big = max(t.numel() for t in tree_leaves(mtp))
    log("weights", f"minitron-8b: {n_mt:,} params in bf16 "
        f"({2 * n_mt / 2**30:.2f} GiB); peak device memory during the init "
        f"{init_peak / 2**30:.2f} GiB (each leaf is drawn in f32 and cast: "
        f"the largest transient f32 copy, {4 * big / 2**30:.2f} GiB, is "
        f"in it)")
    mt_prompts = torch.as_tensor(np.random.default_rng(19).integers(
        0, mt.vocab_size, (8, 128)), device=dev)
    mt_rel = layer_parity(mt, mtp, mt_prompts)
    log("f32", f"minitron-8b layer by layer on the same input (8 x 128 "
        f"tokens, the plain path's hidden state into both, each layer's "
        f"weights widened to f32): outputs within {mt_rel:.3e} of their "
        f"scale (tolerance 1e-5)")
    mtreqs = [Request(rid=i, prompt=rng.integers(
        0, mt.vocab_size, int(rng.integers(16, 129)), dtype=np.int32))
        for i in range(8)]
    mt_launches = serve_phase(
        f"minitron-8b full width ({mt.num_layers} layers, d {mt.d_model}, "
        f"{mt.num_heads}/{mt.num_kv_heads} heads of {mt.head_dim}, relu^2 "
        f"d_ff {mt.d_ff}, vocab {mt.vocab_size}, untied)",
        Engine(Plan(arch=mt, run=RunSpec(compute_dtype="bfloat16"),
                    serve=ServeSpec(prompt_len=128, gen=16, max_batch=8,
                                    page_size=16, max_pages=48,
                                    kernel_backend="cuda")), params=mtp),
        mtreqs, {"flash_attention_fwd": ("prefill", mt.num_layers),
                 "flash_decode_paged": ("decode", mt.num_layers)}, pool=True)
    del mtp
    free_device()

    # ---- 20. musicgen-medium through the stub frontend --------------------
    mg = ARCHS["musicgen-medium"]
    mg_launches = generate_phase(
        f"musicgen-medium full width ({mg.num_layers} layers, d "
        f"{mg.d_model}, {mg.num_heads} heads of {mg.head_dim}, vocab "
        f"{mg.vocab_size}; stub frontend: prompts and each step's input are "
        f"[B, S, d] embeddings)",
        Plan(arch=mg, run=RunSpec(compute_dtype="bfloat16"),
             serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                             kernel_backend="cuda")),
        scaled(mg, 6, torch.bfloat16),
        {"flash_attention_fwd": ("prefill", mg.num_layers),
         "flash_decode": ("decode", mg.num_layers)})
    free_device()

    # ---- 21. chaos serving: slot faults at full width --------------------
    chaos_serve(scaled(ARCHS["qwen3-0.6b"], 0, torch.bfloat16))
    free_device()

    # ---- 22. chaos training ------------------------------------------------
    chaos_train_phase(dev)

    # ---- 23. serve-cluster: three replicas behind the Router -------------
    free_device()
    cl_launches = cluster_phase(dev)

    # ---- 24. spmd training at full width ---------------------------------
    free_device()
    spmd_train_phase(dev, card=smi)

    # ---- 25. spmd serving at full width ----------------------------------
    free_device()
    sp_launches = spmd_serve_phase(dev, card=smi)

    # ---- 26. the dry run against the card; moe_mlp_ep ----------------------
    free_device()
    ep_launches = dryrun_phase(dev, card=smi)

    # ---- 27. the kernels line ------------------------------------------
    src = {"flash_attention_fwd": ("src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:94"),
           "flash_decode_paged": ("src/repro_torch/kernels/csrc/"
                                  "flash_decode.cu",
                                  "src/repro/kernels/flash_decode.py:241"),
           "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                            "src/repro/kernels/flash_decode.py:127"),
           "rwkv6_chunked": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                             "src/repro/kernels/rwkv6_scan.py:67"),
           "ssd_chunked": ("src/repro_torch/kernels/csrc/mamba_ssd.cu",
                           "src/repro/kernels/mamba_ssd.py:62"),
           "grouped_matmul": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                              "src/repro/kernels/moe_gmm.py:49")}
    # each path's launch counts, read just after its measured run; a
    # kernel's "launches" are those of the first path that runs it
    paths = {"qwen3-0.6b serve": main_launches,
             "qwen3-0.6b generate": gen_launches,
             "rwkv6-3b serve": rw_launches,
             "rwkv6-3b generate": rw_gen_launches,
             "hymba-1.5b serve": hy_launches,
             "hymba-1.5b generate": hy_gen_launches,
             "granite-moe-1b-a400m serve": gr_launches,
             "granite-moe-1b-a400m generate": gr_gen_launches,
             "gemma3-1b serve": g3_launches,
             "minitron-8b serve": mt_launches,
             "musicgen-medium generate": mg_launches,
             "qwen3-0.6b serve-cluster (3 replicas)": cl_launches,
             **sp_launches, **ep_launches}
    power = smi.split(",")[-1].strip()
    kernels = []
    for name in ("flash_decode_paged", "flash_attention_fwd",
                 "flash_decode", "rwkv6_chunked", "ssd_chunked",
                 "grouped_matmul"):
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        t = timing[name]
        errs = worst[name]
        kernels.append({
            "name": name, "route": "cuda", "design": DESIGN[name],
            "source": src[name][0],
            "replaces": src[name][1], "launches": next(iter(
                by_path.values())), "launches_by_path": by_path,
            "max_abs_err": errs[t["dtype"]], "max_abs_err_dtype": t["dtype"],
            "max_abs_err_f32": errs["float32"], "tolerance": t["tolerance"],
            "max_abs_err_by_route": {k: v for k, v in errs.items()
                                     if " " in k} or None,
            "ms": t["ms"], "kernel_ms": t["ms"], "eager_ms": t["eager_ms"],
            "timing": "ms: device time, CUDA graph over 3-150 layers' "
                      "inputs; eager_ms: host-dispatched calls",
            "routes": t.get("routes"),
            "sass": {k: v for k, v in scan_sass.items()
                     if SASS_TAG.get(name, "-") in k} or None,
            "routes_by_path": {p: n["routes"][name] for p, n in paths.items()
                               if n[name]} if name in ROUTES else None,
            "plain_ms": t["plain_ms"],
            "plain_scan_ms": t.get("plain_scan_ms"),
            "max_abs_err_by_heads": {h: per[name] for h, per in
                                     by_heads.items() if name in per},
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            "library_eager_ms": t.get("library_eager_ms"),
            "library": t["library"],
            "shape": t["shape"], "card": card, "power_limit": power,
            "by_shape": {w: {k: v for k, v in b.items()
                             if k not in ("bound", "bound_f32")}
                         | {"bound_ms": b["bound"][0],
                            "bound_by": b["bound"][1],
                            "bound_f32_ms": b["bound_f32"][0],
                            "bound_f32_by": b["bound_f32"][1]}
                         for w, b in t.get("by_shape", {}).items()} or None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
