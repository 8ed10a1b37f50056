#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, each printed on its own line:
  (a) the card (nvidia-smi name and power limit), torch and CUDA versions,
      and the build of every CUDA kernel from `src/repro_torch/csrc`;
  (b) each inference kernel at the main path's largest shapes (B=32, T=4)
      against its plain PyTorch version on the same card: LIF exact; the
      counts fires (rows 4 and 5, `lif_counts` and `lif_counts_fwd`)
      bit for bit at every drive of FIRE_DRIVES (the models' widths,
      K = 37, an unaligned drive, R = 12), each with its launch from the
      C library; SDSA (rows 7-8) bit for bit: the word entry
      `sdsa_packed` at (1024, 64, 2) words and the spike entry
      `sdsa_or_spikes` on SpikingFormer's (4, 32, 8, 64, 48) head views,
      each with `ms`, `device_ms` (a CUDA graph) and plain times; the CSR
      matmuls at SpikingFormer-4-384's stage-1
      patch matmul (131072x432)x(432x96), FFN fc1 (8192x384)x(384x1536)
      and fc2 (8192x1536)x(1536x384) on data with 50% occupied tiles: the
      serial kernels 11 (f32) and 13 (words), event walks, and the
      pipelined kernels 12 and 14, each within 1e-5 * max|ref| + 1e-5 of
      its plain version, 11 and 13 equal bit for bit to their k-order
      chains (`spike_matmul_csr_chain_plain`, packed twin), and all four
      equal bit for bit, with the live events, its distance from the fp64
      product (`err64`), kernel, plain and cuBLAS fp32 times, the bound (one
      fp32 instruction a nonzero spike of a live tile and a column,
      against the bytes; `spike_bounds`) with the dense-tile fp32-FMA and
      split-TF32 tensor-core bounds beside, and kernel 14's launch (n-tile
      width, thread tile, grid, waves, as its C library reports it);
  (e) the training kernels (LIF forward with residual, with and without
      counts, and the surrogate backward) at the stage-1 drive, equal to
      their plain versions bit for bit, with the same times;
  (c) SpikingFormer-4-384 inference (T=4, v_th=0.5, random weights from a
      seed) on 4 batches of 32 images through the port's entry points
      under `torch.inference_mode()`, once on the kernels and once under
      `use_backend("ref")`: finite logits, exactly 12 lif-counts, 13 lif,
      11 pipelined CSR (kernel 12) and 4 SDSA launches per forward, no
      dense occupancy pre-pass,
      every registry call agreeing with `ref` on the same inputs, and the
      free-running per-stage spike drift within FREE_RUNNING_SPIKE_TOL;
      then one forward on the serial CSR kernel by override
      (`use_backend("cuda")` for spike_matmul and econv: exactly 11
      kernel-11 launches, none of kernel 12), its spike drift against
      `ref` gated as above and against the pipelined forward reported,
      and a per-op device-time breakdown of one forward on each route;
  (g) the predicated spike matmul (kernel 10) at SegNet-64's two
      transposed-conv patch matmuls, (131072x288)x(288x16) and
      (524288x144)x(144x2), on the model's own patch maps and on data
      with 50% occupied tiles: within 1e-5 * max|ref| + 1e-5 of its plain
      version and equal bit for bit to the pipelined CSR kernel 12 on the
      same spikes and `build_csr` of the same map, with its `err64`,
      kernel and cuBLAS fp32 times taken in turns, kernel 12's, plain and
      bound times and the achieved bytes a second;
  (h) the paper's CNNs end to end (VGG11 and ResNet18 on 32x32
      `class_images`, SegNet on 64x64 `seg_batch` images; B=32, T=4,
      v_th=0.5, random weights from a seed), 2 batches each, on the
      kernels and on `ref`: finite outputs, exact launches per forward
      (CNN_LAUNCHES, every other kernel 0), the dense occupancy pre-passes
      only where no map exists (CNN_PREPASSES), every registry call
      agreeing with `ref` on the same inputs, per-layer spike drift within
      FREE_RUNNING_SPIKE_TOL; per-layer spike rates; VGG11 also at B=1
      and B=3, whose 2x2 fires have a ragged R = 4B, with the same exact
      launches and registry calls equal to `ref`; then a per-op
      device-time breakdown of one forward on each;
  (f) SpikingFormer-4-384 training (cuDNN set deterministic, so the
      losses are one value from run to run): 3 AdamW steps (cross-entropy,
      `torch.autograd.grad` over the parameter leaves, `adamw.update`) on
      `class_images` batches of 32, on the kernels: finite losses and
      gradients, no all-zero gradient leaf, exactly 13 lif-fwd, 12
      lif-counts-fwd, 25 lif-bwd, 11 pipelined CSR and 4 SDSA launches per
      step and
      no primal LIF launch; every registry call's backward agreeing with
      `ref`'s on the same inputs and cotangent (SAME_INPUT_GRAD_TOL); the
      same 3 steps on `ref` printed beside them; then a per-op forward and
      backward device-time breakdown of one step;
  (i) APEC on SpikingFormer-4-384's own spike maps (one forward at
      B=32, T=4, captured): row 19's two entries for g = 2, 4, 8 on the
      FFN fc1 and fc2 inputs and the stage-1 patch matrix, the spike
      entry exactly equal to its plain version and to the old pack route
      (pad, pack, word entry, unpack; timed in turns with it), the word
      entry on the same spikes' words exactly equal to its plain version,
      each with `device_ms` (a CUDA graph), its byte bound and a device
      copy of the same bytes; the fused union-CSR APEC
      matmuls, serial (kernel 17) and pipelined (kernel 18), g = 2, each
      within 1e-5 * max|ref| + 1e-5 of its plain version at fc1, fc2 and
      stage 1, on the model's maps and on data with 50% occupied tiles,
      kernel 17 (an event walk) equal bit for bit to its k-order fmaf
      chain (`apec_matmul_csr_chain_plain`), kernel 18 (tensor cores) no
      further from the fp64 product (`err64`) than twice kernel 17,
      kernels 15 and 16 on the same spikes' words equal to 17 and 18 bit
      for bit, with kernel (timed in turns 17, 18, 18, 17), plain,
      library (cuBLAS fp32 on the unpacked spikes) and bound times (17's
      by its events, `events` and `events_before` printed, the dense-tile
      FMAs beside; 18's by bf16 tensor-core operations, the fp32 bound
      beside); kernels 17 / 18 and 15 / 16 at g = 1, 16 and 128 on fc1
      under the same gates, 17 == 15; then `core.apec.apec_matmul` on
      the FFN inputs and the stage-1 patch matrix for g = 2 and 4, with
      the carried map and on the bare spikes: finite, within 1e-5 * max|ref| + 1e-5 of the CSR
      matmul on the same spikes, exactly 1 spike-entry decompose and 1
      kernel-18 launch per call (APEC_LAUNCHES), no pack or unpack, 0
      dense pre-passes with the map and 2 without, and one call on kernel
      17 by override (`use_backend("cuda", op="apec_matmul")`:
      APEC_SERIAL_LAUNCHES); the route's split (decompose, work list,
      kernel 18 and the rest, each in device ms and host enqueue ms);
      the route's device ms beside the serial route's and the CSR
      routes'; and `apec_stats` (G2, G4, G8) of every fire of the
      forward;
  (j) packed payloads (`SpikingConfig(packed=True)`, uint32 words between
      the spiking layers): the packed fire (kernel 6) at every drive of
      FIRE_DRIVES, words and counts equal to its plain version and the
      words to the packed spikes of the counts kernel; the packed CSR matmul
      (kernel 13) at the packed stage-1 patch matrix, fc1 and fc2 on the
      model's maps and on data with 50% occupied tiles, within
      1e-5 * max|ref| + 1e-5 of its plain version, and it and kernel 11 on
      the same spikes unpacked equal bit for bit to each other and to their
      k-order chains, with both times and the live events; the packed
      APEC matmuls, serial
      (kernel 15) and pipelined (kernel 16), g=2, at fc1, fc2 and stage 1
      on the forward's packed inputs, each against its plain version, 15
      equal to its k-order chain, 16 within twice 15's `err64`, 15 and 16
      equal to kernels 17 and 18 on the same spikes unpacked bit for bit,
      timed in turns (15's bound by its events); and
      `core.apec.apec_matmul` on them with the carried map (1 decompose +
      1 kernel-16 launch, PACKED_APEC_LAUNCHES, no pre-pass, no pack or
      unpack), once on kernel 15 by override (`use_backend("cuda-packed",
      op="apec_matmul")`, within 1e-5 * max|ref| + 1e-5 of the CSR
      matmul), beside the dense
      APEC, CSR and packed CSR routes; then SpikingFormer-4-384 (4
      batches of 32) and VGG11, ResNet18, SegNet-64 (one batch of 32)
      packed forwards on the kernels (kernel 14; the coded conv on 12) and
      on `ref`: finite outputs, every
      fire's output packed-only, exact launches (PACKED_LAUNCHES), dense
      and word pre-passes (PACKED_PREPASSES), every registry call equal to
      `ref` on the same inputs, per-stage spike drift against the dense
      kernel forward within FREE_RUNNING_SPIKE_TOL (against the packed
      `ref` forward: reported); a breakdown of the packed and the dense
      SpikingFormer forward in turns; one packed SpikingFormer forward on
      the serial word kernel by override (`use_backend("cuda-packed")`:
      exactly 11 kernel-13 launches);
  (k) the spiking LM, TinyLlama-1.1B at full width (22 layers, d 2048,
      32 heads / 4 KV heads, d_ff 5632, vocab 32000, T=2, v_th 1.0; bf16
      weights from seed 0): (k1) the causal-status kernel (TPU row 9) at
      (BH, N, dw) = (256, 1024, 2), (32, 32768, 2) and a ragged N=1000,
      on kv bits at 1/(4N) so the status still changes in the last chunks
      (checked), the spike entry `causal_sdsa_spikes` on one prefill
      layer's (2, 8, 32, 1024, 64) bf16 head views, and the bf16 LIF fire
      at the decode and prefill drives, each bit for bit against its
      plain version, with kernel (`ms`, `device_ms`), plain, library
      (`torch.cummax` for the status) and bound times; (k2) `prefill` of
      8 `markov_tokens` prompts of 1024 tokens under
      `torch.inference_mode()`, on the kernels and on `ref`: finite
      logits, exactly LM_PREFILL_LAUNCHES per prefill (every other kernel
      0), every registry call equal to `ref` on the same inputs, per-layer
      spike drift within FREE_RUNNING_SPIKE_TOL, per-layer spike rates;
      (k3) serving on 8 slots: `prefill_chunked` of 8 prompts of ragged
      lengths 65-128 (right-padded to 128), then 16 greedy `decode_step`s
      at per-slot positions, with exactly LM_DECODE_LAUNCHES per decode
      step; slot 3 decoded with every other slot empty (its state moved
      into a fresh pool by `merge_slot_state`) gives the pool's tokens;
      the share of tokens equal to `ref`'s serve; and `prefill` against
      `prefill_chunked` on equal-length prompts (max |dlogits| and spike
      drift, reported);
  (l) hybrid dispatch (`SpikingConfig(hybrid=True)`, routes chosen on
      the card from the carried maps by the H100-calibrated cost model):
      SpikingFormer-4-384 on (c)'s first batch and VGG11 / ResNet18 on
      (h)'s, each against its automatic forward: logits and every layer's
      spikes bit for bit, the same number of host syncs (the sync debug
      mode), the launches, each hybrid call's route and bucket, and both
      spans in turns; one CUDA graph of a hybrid `spike_matmul` at
      HYBRID_GRAPH_SHAPE replayed on a sparse map and a full map, the
      device flags equal to `event_route_wins` for each (the two differ)
      and the output within 1e-5 * max|ref| + 1e-5 of the plain
      version's, with kernel 11's gated launch on and off in device ms;
      `core.apec.apec_matmul` under hybrid at (i)'s shapes within 1e-5 *
      max|ref| + 1e-5 of the CSR route; kernel 10 at the forward's fc1,
      fc2 and stage-1 maps (where hybrid sends the models' calls) equal
      bit for bit to kernels 11 and 12, timed in turns with them and
      cuBLAS; one training step under hybrid with the loss and every
      gradient equal to the automatic step's bit for bit;
  (m) the serve scheduler (`repro_torch.launch.serve`) at TinyLlama-1.1B
      width (weights from seed 0), in both modes: a `Server` of 8 slots
      and `max_seq` 256 serving 8 requests of 5-16 `markov_tokens` prompt
      tokens, 16 new tokens each, admitted in waves (submit 3, step
      twice, submit 3, step, submit 2, drain): every request done with no
      retry and no cause, no slot left, 8 admissions, exactly 132
      `lif_bf16` launches a decode step and 132 x bucket an admission in
      spiking mode and no launch in dense mode (the launch counters set to
      0 just before each run and read just after it), requests 0 and 5
      each served alone in an 8-slot `Server` giving the pool's tokens bit
      for bit; the spiking traffic on `ref` (its share of equal tokens
      reported), the dense KV cache's bytes; request 5's slot NaN'd
      mid-stream (`nan_decode_state`): it retries, ends done with its
      solo tokens; a `ReplicaPool` of two replicas steering a request
      away from the preloaded one; `attention_dense` at (B, N, D) = (2,
      2048, 2048), 32 / 4 heads, bf16, blockwise (kv_block 1024) within
      DENSE_ATTN_TOL of one block, causal and with a 512 window; a dense
      `prefill` of 8 x 1024 tokens (finite), in turns with the spiking
      one. Its lines carry the card's name and power limit;
  (n) LM training at TinyLlama-1.1B width (`train_loop`, the bf16
      residual fire and surrogate backward, a step against `ref`, a
      dense step, a resume);
  (o) the attention-family configs: (o1) qwen2-moe-a2.7b at full width
      and depth (24 layers, d 2048, 60 routed experts top-4 and 4 shared,
      bf16 weights from seed 0), a spiking `prefill` of MOE_BATCH x
      MOE_PROMPT tokens on the kernels, again, and on `ref`: logits
      equal bit for bit, exactly MOE_PREFILL_LAUNCHES, the dropped
      assignments, span, enqueue and peak memory; the routed and shared
      expert fires and the causal SDSA on the prefill's own drives bit
      for bit against their plain versions (zero drives silent); a dense
      prefill finite; (o2) its `Server` over MOE_SERVE_REQUESTS
      staggered requests: clean, MOE_DECODE_LAUNCHES a decode step, the
      tokens equal on `ref` and on a second run, requests MOE_SOLO alone
      equal to their `ref` solo runs (against the pool: reported, as an
      MoE decode step couples its slots); (o3) whisper-medium's
      `forward_hidden` over 1500 stub frames: WHISPER_LAUNCHES (24
      encoder `sdsa`), equal to `ref`, the encoder's `sdsa` on its own
      spikes against its plain version; (o4) REDUCED_ARCHS' prefill and
      decode steps in both modes, equal to `ref`;
  (p) the SSM configs (`models/ssm.py`): (p1) xlstm-350m uncut (24
      layers, d 1024, 222,763,264 parameters), dense, spiking at the
      config's lif_vth = 1.0 (silent: the first fire's spike rate printed
      and equal on both routes) and at XLSTM_FIRING_VTH (its rate must be
      above 0): a `prefill` of SSM_BATCH x SSM_PROMPT tokens, then
      `prefill_chunked` over ragged lengths and XLSTM_DECODE_STEPS greedy
      decode steps, on the kernels and on `ref`: logits and tokens equal
      bit for bit, exactly XLSTM_LAUNCHES a prefill and a decode step
      (none dense), the prefill's and a decode step's spans, host enqueue
      and the scan loops' host and device time, peak memory; the fire on
      the firing variant's first drive against its plain version; (p2) a
      `Server` of 8 slots over it, (m)'s traffic, dense and spiking at
      XLSTM_FIRING_VTH: clean, exact launches, tokens equal on `ref`,
      each request alone decoding its pool tokens; (p3)
      jamba-1.5-large-398b at full width over one period (8 layers, 7
      Mamba and 1 attention, MLP FFNs, 8,998,805,504 parameters) as
      (p1), JAMBA_PREFILL_LAUNCHES / JAMBA_STEP_LAUNCHES, peak under 80
      GB, the fire on a Mamba layer's input and the causal SDSA on the
      attention layer's spikes against their plain versions; (p4) both
      configs' REDUCED sizes as in (o4);
  (q) guarded execution (`dispatch.use_guard`, the maps on the card):
      (q1) SpikingFormer-4-384 on (c)'s first batch and VGG11 / ResNet18
      / SegNet-64 on (h)'s, dense and packed, under `off`, `audit` and
      `repair`: logits and every layer's spikes bit for bit with the
      unguarded forward, no watcher record, a guarded call in each, the
      unguarded launches (plus one gated kernel-10 launch a support audit
      under repair), the same host syncs, and the audit's and repair's
      spans in turns with the unguarded one; (q2) at (b)'s stage-1 / fc1
      / fc2 shapes on 50% occupied tiles, `spike_matmul` and
      `apec_matmul` (g = 2), dense and packed: an undercount all NaN under
      audit (one record under a watcher), repaired bit for bit
      (`spike_matmul`) or within 1e-5 * max|ref| + 1e-5 (APEC), a bit
      flip in an empty tile flagged and repaired to the corrupted
      payload's product, both also within that bound of an f64 product
      of the payload's bits, `ops.support_map` equal to a plain per-tile
      count, an overcount never flagged, a wrong grid raising (econv
      too), with each mode's ms and `device_ms`; (q3) one CUDA graph of a
      repaired `spike_matmul` replayed on the clean map, an undercount
      and the clean map again (the clean output bit for bit each time,
      where the unguarded undercount differs), kernel 10 gated on and off
      in device ms; (q4)
      one training step under repair with an undercount planted in block
      0's fc1: the loss and every gradient within 1e-5 of the clean step.
      Each line carries the card's name and power limit;
  (d) one JSON line listing every kernel with its launches on the main
      paths ((c) and (h) for inference kernels, (f) for the training
      ones, (i) for the APEC ones, (j) for the packed ones, (k), (m) and
      (o) and (p) for the LM ones, (l) adding its hybrid forwards' and APEC
      calls', (n) the training fires', (q) its guarded forwards' and
      fault calls'; the serial kernels 11, 13, 15 and 17 by their override
      calls), error and times (rows 16 and 18: kernels 16 and 18).
Each phase prints its wall time on a `phase_time` line.
The last line is {"ok": true, "device": {...}}. Any failed check exits
nonzero before it; without a CUDA device, or without the repo's `src`
beside this file, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOPS = 67e12               # H100 SXM fp32, CUDA cores
BF16_TC_FLOPS = 989e12           # H100 SXM bf16, tensor cores, dense
TF32_FLOPS = 495e12              # H100 SXM TF32, tensor cores, dense
# bf16 MMAs per fp32 product in the pipelined APEC kernels 18 / 16: binary
# spikes times the exact split w = hi + mid + lo (csrc/tile_tc.cuh).
APEC_SPLIT_PARTS = 3
# TF32 MMAs per product of a split-TF32 design (w = hi + lo; binary spikes
# exact): printed as the tensor-core bound beside the fp32 bound the CSR
# kernels run at (csrc/tile_mma.cuh says why they stay on fp32 FMA).
SPLIT_PASSES = 2
SEED = 0
B, T, DEPTH, DIM, HEADS, V_TH = 32, 4, 4, 384, 8, 0.5
TRAIN_STEPS, LR = 3, 1e-3
EXPECTED_LAUNCHES = {"lif_counts": 12, "lif": 13,
                     "spike_matmul_csr_pipe": 11, "spike_matmul_csr": 0,
                     "spike_matmul_pred": 0, "sdsa_or": 4}
# The same forward with spike_matmul and econv pinned to the serial kernel.
SERIAL_LAUNCHES = {**EXPECTED_LAUNCHES, "spike_matmul_csr_pipe": 0,
                   "spike_matmul_csr": 11}
# Per training step: every fire runs the residual forward and the
# surrogate backward; the matmul backwards are plain products and SDSA's
# and econv's replay `ref`, so the forward kernels launch once per call.
EXPECTED_TRAIN_LAUNCHES = {"lif_fwd": 13, "lif_counts_fwd": 12,
                           "lif_bwd": 25, "spike_matmul_csr_pipe": 11,
                           "spike_matmul_csr": 0, "sdsa_or": 4, "lif": 0,
                           "lif_counts": 0}
# Per CNN forward (T=4, B=32); every kernel not named launches 0 times.
CNN_LAUNCHES = {
    "vgg11": {"spike_matmul_csr_pipe": 8, "lif_counts": 8},
    "resnet18": {"spike_matmul_csr_pipe": 20, "lif_counts": 17},
    "segnet": {"spike_matmul_csr_pipe": 4, "lif_counts": 5,
               "spike_matmul_pred": 2},
}
# Dense occupancy pre-passes per CNN forward on the kernels: the
# direct-coded input, and SegNet's two transposed convs (zero-insertion
# leaves no map to carry).
CNN_PREPASSES = {"vgg11": 1, "resnet18": 1, "segnet": 3}
CNN_BATCHES = 2
# VGG11 batches whose 2x2 fires have R = 4B rows, not a multiple of 8.
RAGGED_BATCHES = (1, 3)
INFERENCE_KERNELS = ("lif_counts", "lif", "spike_matmul_csr",
                     "spike_matmul_csr_pipe", "spike_matmul_pred", "sdsa_or")
TRAINING_KERNELS = ("lif_fwd", "lif_counts_fwd", "lif_bwd")
APEC_KERNELS = ("apec_decompose", "apec_decompose_spikes", "apec_matmul_csr",
                "apec_matmul_csr_pipe")
# Per `core.apec.apec_matmul` call on the card (every other kernel 0):
# row 19's spike entry, then the pipelined kernel 18 automatically, the
# serial kernel 17 by override; the packed calls row 19's word entry and
# likewise kernels 16 and 15.
APEC_LAUNCHES = {"apec_decompose_spikes": 1, "apec_matmul_csr_pipe": 1}
APEC_SERIAL_LAUNCHES = {"apec_decompose_spikes": 1, "apec_matmul_csr": 1}
PACKED_APEC_LAUNCHES = {"apec_decompose": 1,
                        "apec_matmul_packed_csr_pipe": 1}
PACKED_APEC_SERIAL_LAUNCHES = {"apec_decompose": 1,
                               "apec_matmul_packed_csr": 1}
APEC_PATH_GROUPS = (2, 4)
APEC_STAT_GROUPS = (2, 4, 8)
PACKED_KERNELS = ("lif_counts_packed", "spike_matmul_packed_csr",
                  "spike_matmul_packed_csr_pipe", "apec_matmul_packed_csr",
                  "apec_matmul_packed_csr_pipe")
# Per packed forward (T=4, B=32); every kernel not named launches 0 times.
# The direct-coded first conv stays a dense econv (its drive is not
# binary) on kernel 12; SegNet's transposed convs unpack and run kernel 10.
PACKED_LAUNCHES = {
    "spikingformer": {"lif_counts_packed": 12, "lif": 13,
                      "spike_matmul_packed_csr_pipe": 11, "sdsa_or": 4},
    "vgg11": {"spike_matmul_csr_pipe": 1, "spike_matmul_packed_csr_pipe": 7,
              "lif_counts_packed": 8},
    "resnet18": {"spike_matmul_csr_pipe": 1,
                 "spike_matmul_packed_csr_pipe": 19,
                 "lif_counts_packed": 17},
    "segnet": {"spike_matmul_csr_pipe": 1, "spike_matmul_packed_csr_pipe": 3,
               "spike_matmul_pred": 2, "lif_counts_packed": 5},
}
# The packed SpikingFormer forward pinned to the serial word kernel.
PACKED_SERIAL_LAUNCHES = {**PACKED_LAUNCHES["spikingformer"],
                          "spike_matmul_packed_csr_pipe": 0,
                          "spike_matmul_packed_csr": 11}
# The pipelined CSR kernels' shapes: SpikingFormer-4-384's stage-1 patch
# matmul and FFN fc1 / fc2 (T=4, B=32).
CSR_SHAPES = (("econv_stage1", (T * B * 1024, 432, 96)),
              ("ffn_fc1", (T * B * 64, DIM, 4 * DIM)),
              ("ffn_fc2", (T * B * 64, 4 * DIM, DIM)))
# (dense, word) occupancy pre-passes per packed forward: the word pass
# runs where an econv's input channels are not a multiple of 32 (no
# carried map lines up with the word patches: SpikingFormer's ci=48,
# SegNet's 8 and 16); the dense ones where no map exists.
PACKED_PREPASSES = {"spikingformer": (0, 1), "vgg11": (1, 0),
                    "resnet18": (1, 0), "segnet": (3, 2)}
LM_KERNELS = ("sdsa_causal", "lif_bf16")
LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_PROMPT, LM_SERVE_PAD, LM_NEW = 8, 1024, 128, 16
LM_SOLO_SLOT = 3
# Per prefill / per decode step, 22 layers: each runs 6 fires (ln1, q, k,
# v, ln2, the MLP's hidden) and the prefill one causal SDSA; every other
# kernel launches 0 times.
LM_PREFILL_LAUNCHES = {"lif_bf16": 6 * 22, "sdsa_causal": 22}
LM_DECODE_LAUNCHES = {"lif_bf16": 6 * 22}
# The counts fires' drives (rows 4, 5 and 6; T=4, B=32): SpikingFormer-
# 4-384's stage-1 and stage-0 patch fires, SegNet-64's first conv, VGG11's
# first conv and the FFN's fc1 fire; a width K % 4 != 0 (the kernel's
# scalar path); R = 12 (VGG11's 2x2 fire at B = 3: chunks span steps).
FIRE_DRIVES = (("sps_stage1", (T, B * 1024, 96)),
               ("sps_stage0", (T, B * 1024, 48)),
               ("segnet_conv1", (T, B * 4096, 8)),
               ("vgg11_conv1", (T, B * 1024, 64)),
               ("ffn_fc1", (T, B * 64, 4 * DIM)),
               ("k37", (T, 4096, 37)),
               ("offset1", (T, 2048, 96)),
               ("r12", (T, 12, 96)),
               ("r12_k8", (T, 12, 8)))
SOURCES = {"lif": "src/repro_torch/csrc/lif.cu",
           "lif_counts": "src/repro_torch/csrc/lif.cu",
           "lif_fwd": "src/repro_torch/csrc/lif.cu",
           "lif_counts_fwd": "src/repro_torch/csrc/lif.cu",
           "lif_bwd": "src/repro_torch/csrc/lif.cu",
           "spike_matmul_csr": "src/repro_torch/csrc/spike_matmul_csr.cu",
           "spike_matmul_csr_pipe":
               "src/repro_torch/csrc/spike_matmul_csr_pipe.cu",
           "spike_matmul_packed_csr_pipe":
               "src/repro_torch/csrc/spike_matmul_csr_pipe.cu",
           "spike_matmul_pred": "src/repro_torch/csrc/spike_matmul.cu",
           "sdsa_or": "src/repro_torch/csrc/sdsa.cu",
           "apec_decompose": "src/repro_torch/csrc/apec.cu",
           "apec_decompose_spikes": "src/repro_torch/csrc/apec.cu",
           "apec_matmul_csr": "src/repro_torch/csrc/apec_matmul_csr.cu",
           "lif_counts_packed": "src/repro_torch/csrc/lif.cu",
           "spike_matmul_packed_csr":
               "src/repro_torch/csrc/spike_matmul_csr.cu",
           "apec_matmul_packed_csr":
               "src/repro_torch/csrc/apec_matmul_csr.cu",
           "apec_matmul_csr_pipe":
               "src/repro_torch/csrc/apec_matmul_csr_pipe.cu",
           "apec_matmul_packed_csr_pipe":
               "src/repro_torch/csrc/apec_matmul_csr_pipe.cu",
           "sdsa_causal": "src/repro_torch/csrc/sdsa_causal.cu",
           "lif_bf16": "src/repro_torch/csrc/lif.cu",
           "lif_fwd_bf16": "src/repro_torch/csrc/lif.cu",
           "lif_bwd_bf16": "src/repro_torch/csrc/lif.cu"}
# Same inputs, one op call: the fire and attention ops are exact, the
# matmul-form ops agree to fp32 summation order (relative to max|ref|).
SAME_INPUT_TOL = {"lif_scan": 0.0, "lif_scan_occ": 0.0, "sdsa": 0.0,
                  "causal_sdsa": 0.0, "spike_matmul": 1e-5, "econv": 1e-5,
                  "tconv": 1e-5}
# Free-running kernel forward vs ref forward, share of differing spikes
# per stage. Not 1e-3: a spike whose membrane sits within fp32 rounding of
# the threshold flips when the summation order changes (econv's CSR walk
# vs cuDNN, ~1e-6 relative), and every flip perturbs the next threshold
# stage. On the H100 a handful of stage-1 ties (4 of 12.6M spikes) grew
# to 0.17% by stage 10 while every op agreed on identical inputs.
FREE_RUNNING_SPIKE_TOL = 1e-2
# Same inputs and cotangent, one op's backward, max |delta| / max|ref|:
# the LIF kernel and ref's autograd associate the reset term differently;
# the matmul rule and ref's matmul backward sum in other orders; SDSA's
# kernel backend replays ref itself.
SAME_INPUT_GRAD_TOL = {"lif_scan": 1e-5, "lif_scan_occ": 1e-5,
                       "spike_matmul": 1e-5, "econv": 1e-5, "sdsa": 0.0}
REPLACES = {"lif": "src/repro/kernels/lif_scan.py:36",
            "lif_counts": "src/repro/kernels/lif_scan.py:191",
            "lif_fwd": "src/repro/kernels/lif_scan.py:87",
            "lif_counts_fwd": "src/repro/kernels/lif_scan.py:209",
            "lif_bwd": "src/repro/kernels/lif_scan.py:107",
            "spike_matmul_csr": "src/repro/kernels/spike_matmul.py:156",
            "spike_matmul_csr_pipe": "src/repro/kernels/spike_matmul.py:181",
            "spike_matmul_packed_csr_pipe":
                "src/repro/kernels/spike_matmul.py:318",
            "spike_matmul_pred": "src/repro/kernels/spike_matmul.py:48",
            "sdsa_or": "src/repro/kernels/sdsa_kernel.py:29",
            "apec_decompose": "src/repro/kernels/apec_kernel.py:21",
            "apec_decompose_spikes": "src/repro/kernels/apec_kernel.py:21",
            "apec_matmul_csr": "src/repro/kernels/spike_matmul.py:581",
            "lif_counts_packed": "src/repro/kernels/lif_scan.py:262",
            "spike_matmul_packed_csr": "src/repro/kernels/spike_matmul.py:296",
            "apec_matmul_packed_csr": "src/repro/kernels/spike_matmul.py:423",
            "apec_matmul_csr_pipe": "src/repro/kernels/spike_matmul.py:616",
            "apec_matmul_packed_csr_pipe":
                "src/repro/kernels/spike_matmul.py:460",
            "sdsa_causal": "src/repro/kernels/sdsa_kernel.py:104",
            "lif_bf16": "src/repro/kernels/lif_scan.py:36",
            "lif_fwd_bf16": "src/repro/kernels/lif_scan.py:87",
            "lif_bwd_bf16": "src/repro/kernels/lif_scan.py:107"}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_routes(dispatch, packed: bool = False) -> dict:
    """op -> the backend automatic selection must pick on the card: the
    pipelined kernels for the CSR-matmul ops and APEC, `cuda` for the
    rest."""
    piped = dispatch.CUDA_PACKED_PIPE if packed else dispatch.CUDA_PIPE
    return {op: piped if op in ("spike_matmul", "econv", "apec_matmul")
            else dispatch.CUDA for op in dispatch.op_names()}


@contextlib.contextmanager
def pinned(dispatch, backend):
    """spike_matmul and econv pinned to `backend` (the serial kernels by
    override); None pins nothing (automatic selection)."""
    with contextlib.ExitStack() as stack:
        if backend is not None:
            for op in ("spike_matmul", "econv"):
                stack.enter_context(dispatch.use_backend(backend, op=op))
        yield


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` in ms over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def turns_ms(torch, fa, fb, reps: int = 20) -> tuple:
    """Device ms of `fa` and `fb` timed in turns (a, b, b, a), each the
    mean of its two turns: a comparison inside one call on one card."""
    a1, b1 = cuda_ms(torch, fa, reps), cuda_ms(torch, fb, reps)
    b2, a2 = cuda_ms(torch, fb, reps), cuda_ms(torch, fa, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one call of `fn`: `reps` calls captured in one CUDA
    graph and replayed, so the host's enqueue of each call (the Python
    wrapper, the ctypes call) is not in the time, as it is in
    `cuda_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm, off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, flops: float = 0.0,
             flops_per_s: float = FP32_FLOPS):
    """(least time in ms, what bounds it) on the H100's published peaks:
    `flops` at `flops_per_s` (fp32 FMA unless given) or `n_bytes` over
    HBM."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def err64(out, exact) -> float:
    """max |out - exact| / max |exact| against an fp64 product (the
    absolute distance where `exact` is all zero)."""
    scale = exact.abs().max().item()
    err = (out.double() - exact).abs().max().item()
    return err / scale if scale else err


def apec_exact(torch, res, ov, w, g):
    """res @ w + repeat(ov @ w, g) in fp64 (f32 operands; unpack words
    first)."""
    wd = w.double()
    return res.double() @ wd + (ov.double() @ wd).repeat_interleave(g, 0)


# ------------------------------------------------------------ phase (a)
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi[0]


def phase_build():
    from repro_torch.kernels import _build
    _build.library(verbose=True)
    emit("build", seconds=_build.BUILD_INFO["seconds"],
         cached=_build.BUILD_INFO["cached"], library=_build.BUILD_INFO["path"])


# ------------------------------------------------------------ phase (b)
def clustered_spikes(torch, m, k, gen, device, tile_p=0.5, p=0.2):
    """Binary (m, k) spikes whose 128x128 tiles are empty with
    probability 1 - tile_p and hold density-p events otherwise."""
    mt, kt = -(-m // 128), -(-k // 128)
    tiles = torch.rand((mt, kt), generator=gen) < tile_p
    mask = tiles.repeat_interleave(128, 0).repeat_interleave(128, 1)[:m, :k]
    s = (torch.rand((m, k), generator=gen) < p) & mask
    return s.float().to(device)


def as_int32(t):
    """uint32 words as an int32 view (the dtype torch.equal compares)."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def fire_drive(torch, label, shape, gen, device):
    """A counts fire's drive from `gen`; "offset1" lies one element into
    its storage, so no row starts 16-byte aligned (the scalar path)."""
    n = math.prod(shape) + (label == "offset1")
    x = (0.6 * torch.randn((n,), generator=gen, device=gen.device)
         + 0.2).to(device)
    return x[n - math.prod(shape):].view(shape)


def counts_case(torch, name, label, x, kw):
    """One counts fire (`lif_counts`, `lif_counts_packed` or
    `lif_counts_fwd`) on the drive `x`, gated bit for bit against its
    plain version: -> (outputs, the `kernel` line's record: back-to-back
    wrapper calls `ms`, the calls alone in a CUDA graph `device_ms`)."""
    from repro_torch.kernels import lif_scan
    fn, plain = getattr(lif_scan, name), getattr(lif_scan, name + "_plain")
    got, want = fn(x, **kw), plain(x, **kw)
    torch.cuda.synchronize()
    check(all(a.shape == b.shape for a, b in zip(got, want)),
          f"{name} kernel's output shapes differ ({label})")
    err = max((as_int32(a).double() - as_int32(b).double()).abs().max()
              .item() if a.numel() else 0.0 for a, b in zip(got, want))
    check(all(torch.equal(as_int32(a), as_int32(b))
              for a, b in zip(got, want)),
          f"{name} kernel disagrees with its plain version ({label}, max "
          f"|d| {err})")
    n_bytes = x.numel() * 4 + sum(t.numel() * t.element_size() for t in got)
    b_ms, by = bound_ms(n_bytes)
    rec = dict(max_abs_err=err, ms=cuda_ms(torch, lambda: fn(x, **kw)),
               device_ms=graph_ms(torch, lambda: fn(x, **kw)),
               plain_ms=cuda_ms(torch, lambda: plain(x, **kw), reps=5),
               bound_ms=b_ms, bound_by=by, library_ms=None,
               shape=list(x.shape),
               launch=lif_scan.counts_launch(x.shape[1], x.shape[2], name))
    emit("kernel", name=name, case=label, **rec)
    return got, rec


def phase_lif(torch, gen, device, results):
    from repro_torch.kernels import lif_scan
    kw = dict(decay=0.5, v_th=V_TH, soft_reset=True)
    x = (0.6 * torch.randn((T, B * 1024, 96), generator=gen) + 0.2).to(device)
    # Rows 4 and 5 at every drive of FIRE_DRIVES (the stage-1 drive drawn
    # above, R = 12 cut from it; the rest from their own generator).
    fgen = torch.Generator(device=device).manual_seed(SEED)
    for label, shape in FIRE_DRIVES:
        xd = x if label == "sps_stage1" else \
            x[:, :12, :].contiguous() if label == "r12" else \
            fire_drive(torch, label, shape, fgen, device)
        for name in ("lif_counts", "lif_counts_fwd"):
            _, rec = counts_case(torch, name, label, xd, kw)
            if label == "sps_stage1" and name == "lif_counts":
                results[name] = rec
    x2 = x.reshape(T, -1)
    s2 = lif_scan.lif(x2, **kw)
    err = (s2 - lif_scan.lif_plain(x2, **kw)).abs().max().item()
    check(err == 0.0, "lif kernel disagrees with its plain version")
    # The fire's scalar path: P % 8 != 0, rows that do not start 16-byte
    # aligned (a view one element into its storage), and a ragged tail
    # behind aligned vectors (T = 1).
    flat = x.reshape(-1)[:2 * 1003 + 1]
    for dt in (torch.float32, torch.bfloat16):
        buf = flat.to(dt)
        for xs in (buf[:-1].view(2, 1003), buf[1:].view(2, 1003),
                   buf[:1003].view(1, 1003)):
            check(torch.equal(lif_scan.lif(xs, **kw),
                              lif_scan.lif_plain(xs, **kw)),
                  f"lif kernel disagrees with its plain version at P = "
                  f"1003 ({dt}, offset {xs.storage_offset()})")
    got, want = lif_scan.lif_fwd(flat[1:].view(2, 1003), **kw), \
        lif_scan.lif_fwd_plain(flat[1:].view(2, 1003), **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "lif_fwd kernel disagrees with its plain version at P = 1003")
    b_ms, by = bound_ms(2 * x.numel() * 4)
    results["lif"] = dict(max_abs_err=err,
                          ms=cuda_ms(torch, lambda: lif_scan.lif(x2, **kw)),
                          plain_ms=cuda_ms(torch, lambda: lif_scan.lif_plain(
                              x2, **kw), reps=5),
                          bound_ms=b_ms, bound_by=by, library_ms=None,
                          shape=list(x.shape))
    emit("kernel", name="lif", **results["lif"])


def head_spikes(torch, gen, shape, p, dtype, device):
    """(T, B, N, H, dh) spikes at rate p -> the models' head-transposed
    (T, B, H, N, dh) view (`models/spikingformer.py`, `transformer.py`)."""
    s = torch.rand(shape, generator=gen, device=gen.device) < p
    return s.to(dtype).to(device).transpose(2, 3)


def sdsa_spike_case(torch, name, label, fn, plain, args, library=None):
    """One SDSA spike entry (`sdsa_or_spikes` or `causal_sdsa_spikes`) on
    the models' views, bit for bit against its plain version and laid out
    like q: -> the `kernel` line's record (back-to-back wrapper calls
    `ms`, the calls alone in a CUDA graph `device_ms`, plain, library and
    byte-bound times)."""
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    check(got.stride() == args[0].stride() and got.dtype == args[0].dtype,
          f"{name} output is not laid out like q ({label})")
    check(torch.equal(got, want),
          f"{name} kernel disagrees with its plain version ({label}, "
          f"{int((got != want).sum().item())} elements)")
    b_ms, by = bound_ms(4 * got.numel() * got.element_size())
    rec = dict(max_abs_err=0.0, ms=cuda_ms(torch, lambda: fn(*args)),
               device_ms=graph_ms(torch, lambda: fn(*args)),
               plain_ms=cuda_ms(torch, lambda: plain(*args), reps=5),
               bound_ms=b_ms, bound_by=by,
               library_ms=None if library is None else cuda_ms(torch,
                                                               library),
               shape=list(args[0].shape), dtype=str(args[0].dtype))
    emit("kernel", name=name, case=label, entry=fn.__name__, **rec)
    return rec


def phase_sdsa(torch, gen, device, results):
    from repro_torch.core.spikes import pack_spikes
    from repro_torch.kernels import sdsa_kernel
    bh, n, d = 4 * B * 8, 64, DIM // HEADS
    words = []
    for _ in range(3):
        bits = (torch.rand((bh, n, 64), generator=gen) < 0.3).float()
        bits[..., d:] = 0                            # d_head=48: 16 pad bits
        words.append(pack_spikes(bits.to(device)))
    q, k, v = words
    out = sdsa_kernel.sdsa_packed(q, k, v)
    ref = sdsa_kernel.sdsa_packed_plain(q, k, v)
    torch.cuda.synchronize()
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
          "sdsa kernel disagrees with its plain version")
    b_ms, by = bound_ms(4 * q.numel() * 4)
    emit("kernel", name="sdsa_or", case="words", entry="sdsa_packed",
         max_abs_err=0.0,
         ms=cuda_ms(torch, lambda: sdsa_kernel.sdsa_packed(q, k, v)),
         device_ms=graph_ms(torch, lambda: sdsa_kernel.sdsa_packed(q, k, v)),
         plain_ms=cuda_ms(torch, lambda: sdsa_kernel.sdsa_packed_plain(
             q, k, v), reps=5),
         bound_ms=b_ms, bound_by=by, library_ms=None, shape=list(q.shape))
    # The main path's call: SpikingFormer-4-384's SSA, (T, B, H, N, dh)
    # views of its q, k, v fires (f32).
    sgen = torch.Generator(device=device).manual_seed(SEED)
    qkv = [head_spikes(torch, sgen, (T, B, n, HEADS, d), 0.3, torch.float32,
                       device) for _ in range(3)]
    results["sdsa_or"] = sdsa_spike_case(
        torch, "sdsa_or", "spikingformer", sdsa_kernel.sdsa_or_spikes,
        sdsa_kernel.sdsa_or_spikes_plain, qkv)


def csr_work(torch, occ, m, k, n, occ_ov=None, g=1, spike_bytes=4.0):
    """(flops, bytes) this map's occupied tiles need: each occupied tile's
    rows x k-columns x N FMAs, its spike bytes (`spike_bytes` per spike:
    4 for f32, 1/8 for packed words), the weight rows of every k-tile used
    once, and the output written once. `occ_ov`: APEC's overlap map on the
    same grid (tiles of rows/g rows), whose occupied tiles add their own
    FMAs and spike bytes; a k-tile that either operand uses reads its
    weight rows once."""
    rows = torch.clamp(m - 128 * torch.arange(occ.shape[0]), max=128)
    cols = torch.clamp(k - 128 * torch.arange(occ.shape[1]), max=128)
    area = rows[:, None] * cols[None, :]
    live = occ.cpu() > 0
    elems = (area * live).sum().item()
    used = live.any(0)
    if occ_ov is not None:
        live_ov = occ_ov.cpu() > 0
        elems += (area * live_ov).sum().item() / g
        used = used | live_ov.any(0)
    k_used = (cols * used).sum().item()
    return 2.0 * elems * n, spike_bytes * elems + 4.0 * (k_used * n + m * n)


def live_nonzeros(torch, s, occ, tile_m: int = 128) -> int:
    """The nonzero spikes of `s` (M, K) inside the map's live tile_m x 128
    tiles: the spikes a CSR or predicated matmul must take in (APEC's
    overlap: tiles of 128/g rows)."""
    m, k = s.shape
    live = (occ > 0).repeat_interleave(tile_m, 0).repeat_interleave(128, 1)
    return int(((s != 0) & live[:m, :k]).sum().item())


def spike_bounds(n_bytes: float, nnz: int, n: int,
                 dense_flops: float) -> dict:
    """A spike matmul's bound fields. Its operations are one fp32
    instruction a nonzero spike of a live tile and a column: an fmaf on an
    f32 spike, or an add under a set bit, which takes the same issue slot
    (so 2 * nnz * N flops at FP32_FLOPS, which counts an FMA as two),
    against the bytes. Beside: the FMAs over every element of the live
    tiles (`dense_flops`), what the f32 kernels' dense tile loops issue."""
    flops = 2.0 * nnz * n
    b_ms, by = bound_ms(n_bytes, flops)
    return dict(bound_ms=b_ms, bound_by=by,
                bytes_bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                fp32_ops_bound_ms=flops / FP32_FLOPS * 1e3,
                dense_fp32_ops_bound_ms=dense_flops / FP32_FLOPS * 1e3)


def phase_csr(torch, gen, device, results):
    """The CSR matmuls at CSR_SHAPES on data with 50% occupied tiles: the
    serial kernels 11 and 13 (event walks) and the pipelined kernels 12
    and 14, f32 and words on the same spikes and work list, each against
    its plain version, 11 and 13 equal bit for bit to their k-order chains
    (`*_chain_plain`), and all four equal bit for bit (one fmaf chain in k
    order), beside cuBLAS fp32 on the f32 spikes (timed in turns with
    kernel 12) and the live events (`events`, what 11 and 13 walk);
    kernels 12 and 14's launches (n-tile width, thread tile, grid, waves
    of two blocks an SM, as their C library reports them) beside their
    times. Kernel 13's main numbers stay phase (j)'s, on the model's
    words."""
    from repro_torch.core.spikes import build_csr, pack_spikes_padded
    from repro_torch.kernels import ops, spike_matmul as sm
    worst: dict = {}
    kernels = (
        ("spike_matmul_csr", sm.spike_matmul_csr, sm.spike_matmul_csr_plain,
         False),
        ("spike_matmul_csr_pipe", sm.spike_matmul_csr_pipe,
         sm.spike_matmul_csr_pipe_plain, False),
        ("spike_matmul_packed_csr", sm.spike_matmul_packed_csr,
         sm.spike_matmul_packed_csr_plain, True),
        ("spike_matmul_packed_csr_pipe", sm.spike_matmul_packed_csr_pipe,
         sm.spike_matmul_packed_csr_pipe_plain, True))
    for label, (m, k, n) in CSR_SHAPES:
        s = clustered_spikes(torch, m, k, gen, device)
        w = (torch.randn((k, n), generator=gen) / k ** 0.5).to(device)
        occ = ops.padded_occupancy(s)
        csr = build_csr(occ, 128, 128)
        p = pack_spikes_padded(s).contiguous()
        library_ms = cuda_ms(torch, lambda: torch.matmul(s, w))
        exact = torch.matmul(s.double(), w.double())
        nnz = live_nonzeros(torch, s, occ)
        outs = []
        for name, kernel, plain, packed in kernels:
            a = p if packed else s
            out = kernel(a, w, csr)
            outs.append(out)
            ref = plain(a, w, csr)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item() + 1e-5
            check(err <= tol, f"{name} off by {err} > {tol} ({label})")
            chain = getattr(sm, name + "_chain_plain", None)
            if chain:                   # the walks: their k-order chain
                same_bits(torch, out, chain(a, w, csr),
                          f"{name} and its k-order chain", label)
            # Distance from the fp64 product, relative to its max |value|.
            err64 = ((out.double() - exact).abs().max() /
                     exact.abs().max()).item()
            worst[name] = max(worst.get(name, 0.0), err)
            flops, n_bytes = csr_work(torch, occ, m, k, n,
                                      spike_bytes=1 / 8 if packed else 4.0)
            t_tc = SPLIT_PASSES * flops / TF32_FLOPS * 1e3
            call = functools.partial(kernel, a, w, csr)
            if name == "spike_matmul_csr_pipe":     # cuBLAS in turns
                ms, cublas_ms = turns_ms(torch, call, functools.partial(
                    torch.matmul, s, w))
            else:
                ms, cublas_ms = cuda_ms(torch, call), library_ms
            rec = dict(max_abs_err=err, tolerance=tol, err64=err64, ms=ms,
                       plain_ms=cuda_ms(torch, functools.partial(
                           plain, a, w, csr), reps=3, warmup=1),
                       **spike_bounds(n_bytes, nnz, n, flops),
                       tensor_core_ops_bound_ms=t_tc, library_ms=cublas_ms,
                       events=nnz,
                       occupied_share=(occ > 0).float().mean().item(),
                       shape=[m, k, n])
            launch = {"spike_matmul_csr_pipe": sm.pipe_launch,
                      "spike_matmul_packed_csr_pipe": sm.packed_pipe_launch
                      }.get(name)
            if launch:
                rec["launch"] = launch(n, -(-m // 128))
            emit("kernel", name=name, case=label, **rec)
            if label == "econv_stage1" and name != "spike_matmul_packed_csr":
                results[name] = rec
        check(all(torch.equal(o, outs[0]) for o in outs),
              f"CSR kernels 11-14 differ bit for bit ({label})")
    for name, err in worst.items():
        if name in results:
            results[name]["max_abs_err"] = err


# ------------------------------------------------------------ phase (e)
def phase_train_kernels(torch, gen, device, results):
    """The training kernels at the stage-1 drive (T, B*32*32, 96): each
    must equal its plain version bit for bit (both round every operation
    on its own, in the same order)."""
    from repro_torch.kernels import lif_scan
    kw = dict(decay=0.5, v_th=V_TH, soft_reset=True)
    x = (0.6 * torch.randn((T, B * 1024, 96), generator=gen) + 0.2).to(device)
    g = torch.randn((T, B * 1024, 96), generator=gen).to(device)
    x2 = x.reshape(T, -1)
    _, vres = lif_scan.lif_fwd_plain(x, **kw)
    cases = (
        ("lif_fwd", lambda: lif_scan.lif_fwd(x2, **kw),
         lambda: lif_scan.lif_fwd_plain(x2, **kw), 5),
        ("lif_counts_fwd", lambda: lif_scan.lif_counts_fwd(x, **kw),
         lambda: lif_scan.lif_counts_fwd_plain(x, **kw), 5),
        ("lif_bwd", lambda: (lif_scan.lif_bwd(vres, g, **kw),),
         lambda: (lif_scan.lif_bwd_plain(vres, g, **kw),), 11))
    elems = x.numel()
    for name, fn, plain, flops in cases:
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} kernel disagrees with its plain version (max |d| "
              f"{err})")
        n_bytes = sum(t.numel() * t.element_size() for t in got) + \
            (2 if name == "lif_bwd" else 1) * elems * 4
        b_ms, by = bound_ms(n_bytes, flops * elems)
        results[name] = dict(max_abs_err=err, ms=cuda_ms(torch, fn),
                             plain_ms=cuda_ms(torch, plain, reps=5),
                             bound_ms=b_ms, bound_by=by, library_ms=None,
                             shape=list(x.shape))
        emit("kernel", name=name, **results[name])


# ------------------------------------------------------------ phase (c)
@contextlib.contextmanager
def shadow_ref(torch, dispatch):
    """While active, every registry call also runs the `ref` backend on the
    SAME inputs and records, per op, the worst disagreement: for the fire
    ops the share of differing entries of the spikes and (with counts) of
    the tile and chunk maps, max |delta| / (max|ref| + 1e-30) for the
    rest. This isolates each kernel's own error from the cascade that a
    single flipped spike starts in the layers after it."""
    orig = dispatch.dispatch
    rec: dict = {}

    def as_int(t):                  # uint32 words compare as int32 views
        return t.view(torch.int32) if t.dtype == torch.uint32 else t

    def both(op, *args, **kwargs):
        out = orig(op, *args, **kwargs)
        with dispatch.use_backend(dispatch.REF):
            ref = orig(op, *args, **kwargs)
        if op.startswith("lif"):
            pairs = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]
            err = max((as_int(a) != as_int(r)).float().mean().item()
                      for a, r in pairs)
        else:
            err = ((out - ref).abs().max() / (ref.abs().max() + 1e-30)).item()
        rec[op] = max(rec.get(op, 0.0), err)
        return out

    dispatch.dispatch = both
    try:
        yield rec
    finally:
        dispatch.dispatch = orig


@contextlib.contextmanager
def op_timeline(torch, dispatch):
    """While active, CUDA events bracket every registry call, so the
    forward's device span splits into per-op intervals (the kernel plus
    the op's own shape plumbing) and the rest (dense matmuls, the stage-0
    conv, pooling, map propagation, launch gaps)."""
    orig = dispatch.dispatch
    marks: list = []

    def timed(op, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(op, *args, **kwargs)
        stop.record()
        marks.append((op, start, stop))
        return out

    dispatch.dispatch = timed
    try:
        yield marks
    finally:
        dispatch.dispatch = orig


def forward_breakdown(torch, forward) -> dict:
    """One forward (`forward()`, under `torch.inference_mode()`): device
    span, host time to enqueue it, per-op device time, and the rest."""
    from repro_torch.kernels import dispatch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    with torch.inference_mode(), op_timeline(torch, dispatch) as marks:
        forward()
    stop.record()
    host_s = time.perf_counter() - t0
    stop.synchronize()
    per_op: dict = {}
    for op, a, b in marks:
        per_op[op] = per_op.get(op, 0.0) + a.elapsed_time(b)
    span = start.elapsed_time(stop)
    return dict(device_span_ms=span, host_enqueue_ms=host_s * 1e3,
                per_op_ms=per_op, rest_ms=span - sum(per_op.values()),
                calls=len(marks))


def phase_breakdown(torch, params, x, cfg):
    """One kernel forward of SpikingFormer on each CSR route (pipelined,
    serial, serial, pipelined): its breakdown."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import spikingformer as sf
    for route in (None, dispatch.CUDA, dispatch.CUDA, None):
        with pinned(dispatch, route):
            emit("breakdown", csr_route=route or dispatch.CUDA_PIPE,
                 **forward_breakdown(torch, lambda: sf.spikingformer_apply(
                     params, x, n_heads=HEADS, spiking_cfg=cfg)))


def phase_end_to_end(torch, device):
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.core.spikes import watch_occupancy_prepasses
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.kernels.ops import padded_occupancy
    from repro_torch.models import spikingformer as sf
    resolved = dispatch.resolved_backends(device)
    emit("resolution", backends=resolved)
    check(resolved == card_routes(dispatch),
          f"ops not resolved to the kernels on the card: {resolved}")
    gen = torch.Generator().manual_seed(SEED)
    params = sf.spikingformer_init(DEPTH, DIM, generator=gen, device=device)
    cfg = SpikingConfig(t_steps=T, lif_vth=V_TH)
    img_gen = torch.Generator().manual_seed(SEED + 1)
    totals = {name: 0 for name in INFERENCE_KERNELS}
    for batch in range(4):
        x = torch.rand((B, 32, 32, 3), generator=img_gen).to(device)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode(), watch_occupancy_prepasses() as pre:
            logits, stats = sf.spikingformer_apply(
                params, x, n_heads=HEADS, spiking_cfg=cfg, collect_stats=True)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        counts = launch_counts()
        check({k: counts[k] for k in EXPECTED_LAUNCHES} == EXPECTED_LAUNCHES,
              f"launches per forward {counts} != {EXPECTED_LAUNCHES}")
        check(pre["calls"] == 0,
              f"kernel forward ran {pre['calls']} dense occupancy pre-passes")
        for name in totals:
            totals[name] += counts[name]
        t0 = time.perf_counter()
        with torch.inference_mode(), dispatch.use_backend(dispatch.REF):
            ref_logits, ref_stats = sf.spikingformer_apply(
                params, x, n_heads=HEADS, spiking_cfg=cfg, collect_stats=True)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        check(tuple(logits.shape) == (B, 10) and
              bool(torch.isfinite(logits).all()), "logits not finite")
        stages = [dict(stage=i, spike_rate=a.float().mean().item(),
                       occupied_tile_share=(padded_occupancy(a) > 0).float()
                       .mean().item(),
                       differing_share=(a != r).float().mean().item())
                  for i, (a, r) in enumerate(zip(stats, ref_stats))]
        with torch.inference_mode(), shadow_ref(torch, dispatch) as shadow:
            sf.spikingformer_apply(params, x, n_heads=HEADS, spiking_cfg=cfg)
        emit("end_to_end", batch=batch,
             max_abs_dlogits=(logits - ref_logits).abs().max().item(),
             kernel_forward_s=kernel_s, ref_forward_s=ref_s,
             launches=counts, stages=stages, same_input_ops=shadow)
        for op, err in shadow.items():
            check(err <= SAME_INPUT_TOL[op],
                  f"{op} on the kernels differs from ref on the same inputs "
                  f"by {err} > {SAME_INPUT_TOL[op]}")
        for st in stages:
            check(st["differing_share"] <= FREE_RUNNING_SPIKE_TOL,
                  f"stage {st['stage']}: {st['differing_share']} of spikes "
                  f"differ")
    # The serial kernel 11 by override, on the last batch.
    reset_launch_counts()
    with torch.inference_mode(), pinned(dispatch, dispatch.CUDA):
        ser_logits, ser_stats = sf.spikingformer_apply(
            params, x, n_heads=HEADS, spiking_cfg=cfg, collect_stats=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    check({k: counts[k] for k in SERIAL_LAUNCHES} == SERIAL_LAUNCHES,
          f"serial forward launches {counts} != {SERIAL_LAUNCHES}")
    # Gated against `ref`, as the forward above; against the pipelined
    # forward reported (it compounds both routes' tie flips).
    drift = [(a != b).float().mean().item()
             for a, b in zip(ser_stats, ref_stats)]
    drift_pipe = [(a != b).float().mean().item()
                  for a, b in zip(ser_stats, stats)]
    emit("serial_forward", launches=counts, stage_differing_share=drift,
         stage_differing_share_pipe=drift_pipe,
         max_abs_dlogits=(ser_logits - ref_logits).abs().max().item(),
         max_abs_dlogits_pipe=(ser_logits - logits).abs().max().item())
    check(bool(torch.isfinite(ser_logits).all()) and
          max(drift) <= FREE_RUNNING_SPIKE_TOL,
          f"serial forward: logits not finite or spike drift {max(drift)}")
    for name in totals:
        totals[name] += counts[name]
    phase_breakdown(torch, params, x, cfg)
    return totals


# ------------------------------------------------------------ phase (g)
def cnn_setup(torch, name, device):
    """(config, forward(x, collect_stats), batch(i)) of one paper CNN at
    T=4, v_th=0.5, with random weights from SEED."""
    import dataclasses
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.configs.registry import paper_cnn_configs
    from repro_torch.data.synthetic import class_images, seg_batch
    from repro_torch.models import cnn
    cfg = dataclasses.replace(paper_cnn_configs()[name],
                              spiking=SpikingConfig(t_steps=T, lif_vth=V_TH))
    params = getattr(cnn, f"{name}_init")(
        cfg, generator=torch.Generator().manual_seed(SEED), device=device)
    apply = getattr(cnn, f"{name}_apply")

    def batch(i):
        b = seg_batch(SEED, 0, i, B, img=cfg.img) if name == "segnet" else \
            class_images(SEED, 0, i, B, img=cfg.img)
        return torch.from_numpy(b["image"]).to(device)

    def forward(x, collect_stats=False, hybrid=False, packed=False):
        run_cfg = dataclasses.replace(cfg, spiking=dataclasses.replace(
            cfg.spiking, hybrid=hybrid, packed=packed)) \
            if hybrid or packed else cfg
        return apply(run_cfg, params, x, collect_stats=collect_stats)
    return cfg, forward, batch


def phase_pred(torch, gen, device, results):
    """Kernel 10 at SegNet-64's two tconv patch matmuls: the model's own
    patch matrices and maps (captured from one forward), and clustered
    data with 50% occupied tiles at the same shapes. Each case: within
    1e-5 * max|ref| + 1e-5 of its plain version, equal bit for bit to the
    pipelined CSR kernel 12 on the same spikes and `build_csr` of the same
    map (one fmaf chain in k order), its distance from the fp64 product
    (`err64`), kernel 10 and cuBLAS fp32 timed in turns, kernel 12's time
    beside them."""
    from repro_torch.core.spikes import build_csr
    from repro_torch.kernels import ops, spike_matmul
    _, forward, batch = cnn_setup(torch, "segnet", device)
    captured = []
    orig = spike_matmul.spike_matmul_pred

    def capture(s, w, occ):
        captured.append((s.clone(), w.clone(), occ.clone()))
        return orig(s, w, occ)
    spike_matmul.spike_matmul_pred = capture
    try:
        with torch.inference_mode():
            forward(batch(0))
    finally:
        spike_matmul.spike_matmul_pred = orig
    check(len(captured) == 2, f"SegNet ran {len(captured)} predicated "
          f"matmuls, expected 2")
    worst, recs = 0.0, []
    for label, (s, w, occ) in zip(("tconv1", "tconv2"), captured):
        m, k = s.shape
        n = w.shape[1]
        syn = clustered_spikes(torch, m, k, gen, device)
        for data, s_in, occ_in in (("model", s, occ),
                                   ("clustered50", syn,
                                    ops.padded_occupancy(syn))):
            pred = functools.partial(spike_matmul.spike_matmul_pred, s_in, w,
                                     occ_in)
            csr = build_csr(occ_in, 128, 128)
            pipe = functools.partial(spike_matmul.spike_matmul_csr_pipe,
                                     s_in, w, csr)
            out = pred()
            ref = spike_matmul.spike_matmul_pred_plain(s_in, w, occ_in)
            out12 = pipe()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item() + 1e-5
            check(err <= tol, f"predicated kernel off by {err} > {tol} "
                  f"({label}, {data})")
            check(torch.equal(out, out12), f"kernel 10 differs from kernel "
                  f"12 bit for bit ({label}, {data})")
            worst = max(worst, err)
            flops, n_bytes = csr_work(torch, occ_in, m, k, n)
            n_bytes += occ_in.numel() * 4
            ms, library_ms = turns_ms(
                torch, pred, functools.partial(torch.matmul, s_in, w))
            rec = dict(max_abs_err=err, tolerance=tol,
                       err64=err64(out, torch.matmul(s_in.double(),
                                                     w.double())),
                       ms=ms,
                       plain_ms=cuda_ms(
                           torch, functools.partial(
                               spike_matmul.spike_matmul_pred_plain, s_in, w,
                               occ_in), reps=5),
                       **spike_bounds(n_bytes,
                                      live_nonzeros(torch, s_in, occ_in), n,
                                      flops),
                       library_ms=library_ms,
                       kernel12_ms=cuda_ms(torch, pipe),
                       bytes_per_s=n_bytes / (ms * 1e-3),
                       occupied_share=(occ_in > 0).float().mean().item(),
                       shape=[m, k, n])
            emit("kernel", name="spike_matmul_pred", case=f"{label}_{data}",
                 **rec)
            recs.append((label, data, rec))
    results["spike_matmul_pred"] = dict(
        [r for label, data, r in recs if (label, data) ==
         ("tconv2", "model")][0], max_abs_err=worst)


# ------------------------------------------------------------ phase (h)
def phase_cnn(torch, device):
    """VGG11, ResNet18 and SegNet-64 forwards on the kernels, gated, and on
    `ref`; per-layer spike rates and drift; a breakdown of each."""
    from repro_torch.core.spikes import watch_occupancy_prepasses
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    totals: dict = {}
    for name, expected in CNN_LAUNCHES.items():
        cfg, forward, batch = cnn_setup(torch, name, device)
        for i in range(CNN_BATCHES):
            x = batch(i)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode(), watch_occupancy_prepasses() as pre:
                out, stats = forward(x, collect_stats=True)
            torch.cuda.synchronize()
            kernel_s = time.perf_counter() - t0
            counts = launch_counts()
            want = {k: expected.get(k, 0) for k in counts}
            check(counts == want, f"{name}: launches per forward {counts} "
                  f"!= {want}")
            check(pre["calls"] == CNN_PREPASSES[name],
                  f"{name}: {pre['calls']} dense occupancy pre-passes, "
                  f"expected {CNN_PREPASSES[name]}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            t0 = time.perf_counter()
            with torch.inference_mode(), dispatch.use_backend(dispatch.REF):
                ref_out, ref_stats = forward(x, collect_stats=True)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            shape = (B, cfg.img, cfg.img, 2) if name == "segnet" else \
                (B, cfg.n_classes)
            check(tuple(out.shape) == shape and
                  bool(torch.isfinite(out).all()),
                  f"{name}: output {tuple(out.shape)} not finite / != {shape}")
            layers = [dict(layer=j, spike_rate=a.float().mean().item(),
                           differing_share=(a != r).float().mean().item())
                      for j, (a, r) in enumerate(zip(stats, ref_stats))]
            with torch.inference_mode(), shadow_ref(torch, dispatch) as shadow:
                forward(x)
            emit("cnn", model=name, batch=i,
                 max_abs_dout=(out - ref_out).abs().max().item(),
                 kernel_forward_s=kernel_s, ref_forward_s=ref_s,
                 launches=counts, prepasses=pre["calls"], layers=layers,
                 same_input_ops=shadow)
            for op, err in shadow.items():
                check(err <= SAME_INPUT_TOL[op],
                      f"{name}: {op} on the kernels differs from ref on the "
                      f"same inputs by {err} > {SAME_INPUT_TOL[op]}")
            for st in layers:
                check(st["differing_share"] <= FREE_RUNNING_SPIKE_TOL,
                      f"{name} layer {st['layer']}: "
                      f"{st['differing_share']} of spikes differ")
        if name == "vgg11":
            for k, v in vgg11_ragged(torch, dispatch, forward, x,
                                     expected).items():
                totals[k] = totals.get(k, 0) + v
        for backend in (None, dispatch.CUDA, dispatch.REF):
            with contextlib.nullcontext() if backend is None else \
                    dispatch.use_backend(backend):
                for _ in range(3):                        # warm forwards
                    with torch.inference_mode():
                        forward(x)
                emit("cnn_breakdown", model=name,
                     backend=backend or "automatic",
                     **forward_breakdown(torch, lambda: forward(x)))
    return totals


def vgg11_ragged(torch, dispatch, forward, x, expected):
    """VGG11 at batches whose 2x2 fires have R = 4B rows, not a multiple
    of 8: the same kernels launch as at B=32 (the fire masks the ragged
    rows), and every registry call equals `ref` on the same inputs."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    totals: dict = {}
    for b in RAGGED_BATCHES:
        reset_launch_counts()
        with torch.inference_mode():
            out = forward(x[:b])
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: expected.get(k, 0) for k in counts}
        check(counts == want, f"vgg11 B={b}: launches per forward {counts} "
              f"!= {want}")
        check(tuple(out.shape) == (b, 10) and bool(torch.isfinite(out).all()),
              f"vgg11 B={b}: output {tuple(out.shape)} not finite")
        with torch.inference_mode(), shadow_ref(torch, dispatch) as shadow:
            forward(x[:b])
        emit("cnn_ragged", model="vgg11", batch=b, launches=counts,
             same_input_ops=shadow)
        for op, err in shadow.items():
            check(err <= SAME_INPUT_TOL[op],
                  f"vgg11 B={b}: {op} on the kernels differs from ref on "
                  f"the same inputs by {err} > {SAME_INPUT_TOL[op]}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ------------------------------------------------------------ phase (f)
def leaf_names(tree, prefix=""):
    """Names of the leaves of a param tree, in `adamw.leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def fresh_params(torch, device):
    """SpikingFormer-4-384 params from SEED, every leaf an autograd leaf."""
    from repro_torch.models import spikingformer as sf
    from repro_torch.optim import adamw
    params = sf.spikingformer_init(
        DEPTH, DIM, generator=torch.Generator().manual_seed(SEED),
        device=device)
    for leaf in adamw.leaves(params):
        leaf.requires_grad_(True)
    return params


def train_batch(torch, step, device):
    from repro_torch.data.synthetic import class_images
    b = class_images(SEED, 0, step, B)
    return (torch.from_numpy(b["image"]).to(device),
            torch.from_numpy(b["label"]).long().to(device))


def train_loss(torch, params, batch, cfg):
    """Mean softmax cross-entropy of SpikingFormer's logits."""
    from repro_torch.models import spikingformer as sf
    logits = sf.spikingformer_apply(params, batch[0], n_heads=HEADS,
                                    spiking_cfg=cfg)
    return torch.nn.functional.cross_entropy(logits, batch[1])


def train_step(torch, params, opt, batch, cfg):
    """One step: loss, gradients over the leaves, in-place AdamW update
    with a constant schedule. Returns (loss, grads, new optimizer state)."""
    from repro_torch.optim import adamw, schedule
    leaves = adamw.leaves(params)
    loss = train_loss(torch, params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    _, opt = adamw.update(list(grads), opt, leaves, adamw.AdamWConfig(lr=LR),
                          schedule.constant(opt.step))
    return loss.detach(), grads, opt


@contextlib.contextmanager
def shadow_vjp(torch, dispatch):
    """While active, every differentiable registry call records its inputs
    and, when the backward reaches it, its output cotangent. After the
    backward, `same_input_vjp_errors` replays each call's backward on the
    kernel backend and on `ref` with those inputs and that cotangent."""
    orig = dispatch.dispatch
    calls: list = []

    def record(op, *args, **kwargs):
        out = orig(op, *args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        if first.requires_grad:
            entry = [op, [a.detach() for a in args], kwargs, None]
            calls.append(entry)

            def hook(g, entry=entry):
                entry[3] = g.detach().clone()
            first.register_hook(hook)
        return out

    dispatch.dispatch = record
    try:
        yield calls
    finally:
        dispatch.dispatch = orig


def same_input_vjp_errors(torch, dispatch, calls):
    """op -> worst max |d_kernel - d_ref| / max |d_ref| over its calls and
    inputs, for the recorded inputs and cotangents."""
    errs: dict = {}
    for op, args, kwargs, g in calls:
        if g is None:
            continue
        kernel = dispatch.resolve(op, *args, **kwargs)
        check(kernel.name == card_routes(dispatch)[op],
              f"{op} resolved to {kernel.name}")
        pulled = []
        for be in (kernel, dispatch.get_backend(op, dispatch.REF)):
            xs = [a.clone().requires_grad_(a.is_floating_point())
                  for a in args]
            with torch.enable_grad():
                out = be.fn(*xs, **kwargs)
                out = out[0] if isinstance(out, tuple) else out
                diff = [x for x in xs if x.requires_grad]
                pulled.append(torch.autograd.grad(out, diff, g))
        err = max(((a.float() - r.float()).abs().max() /
                   (r.float().abs().max() + 1e-30)).item()
                  for a, r in zip(*pulled))
        errs[op] = max(errs.get(op, 0.0), err)
    return errs


@contextlib.contextmanager
def step_timeline(torch, dispatch):
    """`op_timeline` for a training step: CUDA events bracket every
    registry call's forward, and pass-through autograd nodes mark when its
    output cotangent arrives and when its input cotangents are ready, so
    the backward splits per op too (other ready backward work can land
    inside an op's interval)."""
    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, event, *xs):
            ctx.event = event
            return tuple(x.view_as(x) for x in xs)

        @staticmethod
        def backward(ctx, *gs):
            ctx.event.record()
            recorded.add(id(ctx.event))
            return (None,) + gs

    orig = dispatch.dispatch
    fwd: list = []
    bwd: list = []
    recorded: set = set()

    def timed(op, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        b_start = torch.cuda.Event(enable_timing=True)
        b_stop = torch.cuda.Event(enable_timing=True)
        args = list(args)
        diff = [i for i, a in enumerate(args) if a.requires_grad]
        if diff:
            for i, a in zip(diff, Mark.apply(b_stop, *(args[i]
                                                       for i in diff))):
                args[i] = a
        start.record()
        out = orig(op, *args, **kwargs)
        stop.record()
        fwd.append((op, start, stop))
        if diff:
            first = out[0] if isinstance(out, tuple) else out
            (marked,) = Mark.apply(b_start, first)
            out = (marked,) + tuple(out[1:]) if isinstance(out, tuple) \
                else marked
            bwd.append((op, b_start, b_stop))
        return out

    dispatch.dispatch = timed
    try:
        yield fwd, bwd, recorded
    finally:
        dispatch.dispatch = orig


def phase_train_breakdown(torch, params, opt, cfg, device):
    """One training step on the kernels: device span, host time, per-op
    forward and backward device time, the optimizer update."""
    from repro_torch.kernels import dispatch
    from repro_torch.optim import adamw, schedule
    batch = train_batch(torch, TRAIN_STEPS, device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    with step_timeline(torch, dispatch) as (fwd, bwd, recorded):
        leaves = adamw.leaves(params)
        loss = train_loss(torch, params, batch, cfg)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    adamw.update(list(grads), opt, leaves, adamw.AdamWConfig(lr=LR),
                 schedule.constant(opt.step))
    ev[3].record()
    host_s = time.perf_counter() - t0
    ev[3].synchronize()
    per_fwd: dict = {}
    per_bwd: dict = {}
    for op, a, b in fwd:
        per_fwd[op] = per_fwd.get(op, 0.0) + a.elapsed_time(b)
    for op, a, b in bwd:
        if id(a) in recorded and id(b) in recorded:
            per_bwd[op] = per_bwd.get(op, 0.0) + a.elapsed_time(b)
    span = ev[0].elapsed_time(ev[3])
    emit("train_breakdown", device_span_ms=span, host_ms=host_s * 1e3,
         forward_ms=ev[0].elapsed_time(ev[1]),
         backward_ms=ev[1].elapsed_time(ev[2]),
         optimizer_ms=ev[2].elapsed_time(ev[3]),
         per_op_forward_ms=per_fwd, per_op_backward_ms=per_bwd,
         rest_ms=span - sum(per_fwd.values()) - sum(per_bwd.values()) -
         ev[2].elapsed_time(ev[3]), calls=len(fwd))


def phase_train(torch, device):
    """3 AdamW steps of SpikingFormer-4-384 on the kernels, gated; the same
    steps on `ref`, printed; the same-input backward check; a breakdown."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.optim import adamw
    cfg = SpikingConfig(t_steps=T, lif_vth=V_TH)
    batches = [train_batch(torch, i, device) for i in range(TRAIN_STEPS)]
    runs = {}
    totals = {name: 0 for name in TRAINING_KERNELS}
    for backend in (None, dispatch.REF):
        params = fresh_params(torch, device)
        names = leaf_names(params)
        opt = adamw.init(params, adamw.AdamWConfig(lr=LR))
        losses, grads, seconds = [], [], []
        for i, batch in enumerate(batches):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.nullcontext() if backend is None else \
                    dispatch.use_backend(backend):
                loss, g, opt = train_step(torch, params, opt, batch, cfg)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts = launch_counts()
            losses.append(loss.item())
            grads.append(g)
            if backend is not None:
                continue
            check({k: counts[k] for k in EXPECTED_TRAIN_LAUNCHES} ==
                  EXPECTED_TRAIN_LAUNCHES,
                  f"launches per training step {counts} != "
                  f"{EXPECTED_TRAIN_LAUNCHES}")
            for name in totals:
                totals[name] += counts[name]
            check(bool(torch.isfinite(loss)), f"step {i}: loss {loss}")
            for name, leaf in zip(names, g):
                check(bool(torch.isfinite(leaf).all()),
                      f"step {i}: gradient of {name} not finite")
                check(bool((leaf != 0).any()),
                      f"step {i}: gradient of {name} is all zero")
        runs[backend] = dict(losses=losses, grads=grads, seconds=seconds,
                             params=params, opt=opt)
    kern, ref = runs[None], runs[dispatch.REF]
    for i in range(TRAIN_STEPS):
        rel = {n: ((a - r).norm() / (r.norm() + 1e-30)).item()
               for n, a, r in zip(names, kern["grads"][i], ref["grads"][i])}
        emit("train_step", step=i, loss=kern["losses"][i],
             ref_loss=ref["losses"][i], step_s=kern["seconds"][i],
             ref_step_s=ref["seconds"][i], max_grad_rel_l2=max(rel.values()),
             grad_rel_l2=rel)
    emit("train_launches", per_step=EXPECTED_TRAIN_LAUNCHES, totals=totals)

    params = fresh_params(torch, device)
    with shadow_vjp(torch, dispatch) as calls:
        loss = train_loss(torch, params, batches[0], cfg)
        torch.autograd.grad(loss, adamw.leaves(params))
    errs = same_input_vjp_errors(torch, dispatch, calls)
    emit("train_same_input_vjp", calls=len(calls), errors=errs,
         limits=SAME_INPUT_GRAD_TOL)
    check(set(errs) == set(SAME_INPUT_GRAD_TOL),
          f"same-input backward check saw ops {sorted(errs)}")
    for op, err in errs.items():
        check(err <= SAME_INPUT_GRAD_TOL[op],
              f"{op}'s backward on the kernels differs from ref's on the "
              f"same inputs by {err} > {SAME_INPUT_GRAD_TOL[op]}")
    phase_train_breakdown(torch, kern["params"], kern["opt"], cfg, device)
    return totals


# ------------------------------------------------------------ phase (i)
def apec_capture(torch, device):
    """One SpikingFormer-4-384 forward (B=32, T=4, v_th=0.5, seed 0) on
    the kernels, recording block 0's FFN inputs (spikes, weights, carried
    map), the stage-1 econv input and its propagated patch map, and every
    fire's spikes."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.kernels import dispatch
    from repro_torch.models import spikingformer as sf
    params = sf.spikingformer_init(
        DEPTH, DIM, generator=torch.Generator().manual_seed(SEED),
        device=device)
    x = torch.rand((B, 32, 32, 3),
                   generator=torch.Generator().manual_seed(SEED + 1)
                   ).to(device)
    cap = {"spike_matmul": [], "econv": [], "fires": []}
    orig = dispatch.dispatch

    def record(op, *args, **kwargs):
        out = orig(op, *args, **kwargs)
        if op in ("spike_matmul", "econv"):
            cap[op].append((args[0], args[1], kwargs.get("occupancy")))
        elif op.startswith("lif"):
            cap["fires"].append(out[0] if isinstance(out, tuple) else out)
        return out
    dispatch.dispatch = record
    try:
        with torch.inference_mode():
            sf.spikingformer_apply(params, x, n_heads=HEADS,
                                   spiking_cfg=SpikingConfig(t_steps=T,
                                                             lif_vth=V_TH))
    finally:
        dispatch.dispatch = orig
    torch.cuda.synchronize()
    return cap


def host_ms(torch, fn, reps: int = 20) -> float:
    """Host ms to enqueue one call of `fn`: `reps` calls after a
    synchronise, none inside them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / reps


def copy_ms(torch, n_bytes: float, device) -> float:
    """A device copy that reads and writes `n_bytes` in all."""
    src = torch.empty(int(n_bytes) // 8, device=device)
    dst = torch.empty_like(src)
    return cuda_ms(torch, functools.partial(dst.copy_, src))


def old_decompose_route(torch, s, g, words=None):
    """The dense decompose route before the spike entry, kept here for
    comparison only: pad C to whole words, pack through int64 bits, row
    19's word entry (or `words`, another build's), unpack both outputs,
    slice."""
    from repro_torch.core.spikes import PACK, pack_spikes, unpack_spikes
    from repro_torch.kernels import apec_kernel
    c = s.shape[1]
    sp = torch.nn.functional.pad(s, (0, (-c) % PACK))
    ov, res = (words or apec_kernel.apec_decompose_packed)(
        pack_spikes(sp, axis=-1).contiguous(), g)
    return tuple(unpack_spikes(x, axis=-1, dtype=s.dtype)[:, :c]
                 for x in (ov, res))


def same_words(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) if \
        a.dtype == torch.uint32 else torch.equal(a, b)


def phase_apec_decompose(torch, cap, results):
    """Row 19's two entries at the FFN fc1 and fc2 inputs and the stage-1
    patch matrix, g = 2, 4, 8: the spike entry (`apec_decompose_spikes`)
    equal bit for bit to its plain version and to the old route
    (`old_decompose_route`), timed in turns with it; the word entry on the
    same spikes' words equal to its plain version
    (`apec_decompose_packed_ref`). Each with
    `ms` (back-to-back wrapper calls), `device_ms` (a CUDA graph), the
    byte bound (each input read, each output written once), a device copy
    of the same bytes and its plain version's ms."""
    from repro_torch.core.spikes import pack_spikes_padded
    from repro_torch.kernels import apec_kernel, dispatch
    (s1, _, _), (s2, _, _) = cap["spike_matmul"][:2]
    s_conv, w_conv, _ = cap["econv"][0]
    patches = dispatch.econv_patches(s_conv, w_conv.shape[0],
                                     w_conv.shape[1], 1, "SAME")
    entries = (("apec_decompose_spikes", apec_kernel.apec_decompose_spikes,
                apec_kernel.apec_decompose_spikes_plain),
               ("apec_decompose", apec_kernel.apec_decompose_packed,
                apec_kernel.apec_decompose_packed_plain))
    for label, dense in (("ffn_fc1", s1.reshape(-1, s1.shape[-1])),
                         ("ffn_fc2", s2.reshape(-1, s2.shape[-1])),
                         ("econv_stage1", patches)):
        words = pack_spikes_padded(dense).contiguous()
        for g in APEC_STAT_GROUPS:
            for (name, fn, plain), x in zip(entries, (dense, words)):
                got = fn(x, g)
                torch.cuda.synchronize()
                check(all(same_words(torch, a, b)
                          for a, b in zip(got, plain(x, g))),
                      f"{name} disagrees with its plain version ({label}, "
                      f"g={g})")
                n_bytes = x.element_size() * (2 * x.numel() +
                                              x.numel() // g)
                b_ms, by = bound_ms(n_bytes)
                rec = dict(max_abs_err=0.0, g=g, shape=list(x.shape),
                           dtype=str(x.dtype).replace("torch.", ""),
                           device_ms=graph_ms(torch, lambda: fn(x, g)),
                           copy_ms=copy_ms(torch, n_bytes, x.device),
                           plain_ms=cuda_ms(torch, lambda: plain(x, g),
                                            reps=5),
                           bound_ms=b_ms, bound_by=by, library_ms=None)
                if name == "apec_decompose_spikes":
                    old = old_decompose_route(torch, x, g)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, old)),
                          f"{name} disagrees with the old pack route "
                          f"({label}, g={g})")
                    rec["ms"], rec["old_route_ms"] = turns_ms(
                        torch, lambda: fn(x, g),
                        lambda: old_decompose_route(torch, x, g))
                else:
                    rec["ms"] = cuda_ms(torch, lambda: fn(x, g))
                rec["bound_share"] = b_ms / rec["device_ms"]
                emit("kernel", name=name, case=f"{label}_g{g}", **rec)
                if (label, g) == ("econv_stage1", 2):
                    results[name] = rec


APEC_PAIRS = (("apec_matmul_csr", "apec_matmul_csr_pipe"),
              ("apec_matmul_packed_csr", "apec_matmul_packed_csr_pipe"))


def apec_pair(torch, serial, pipe, args, exact, what):
    """The serial APEC kernel `serial` (17 or 15, an event walk) and its
    pipelined twin `pipe` (18 or 16, the tensor cores) on the same call:
    each within 1e-5 * max|ref| + 1e-5 of its plain version, the serial
    kernel equal bit for bit to its k-order chain (`<serial>_chain_plain`:
    the spikes are binary), and the twin's distance from the fp64 product
    `exact` (`err64`) at most twice the serial kernel's (2^-23 where that
    is 0). Returns ({name: (error, tolerance, plain version, err64)},
    {name: output})."""
    from repro_torch.kernels import spike_matmul
    got = {}
    for name in (serial, pipe):
        plain = getattr(spike_matmul, name + "_plain")
        out, ref = getattr(spike_matmul, name)(*args), plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item() + 1e-5
        check(err <= tol, f"{name} off by {err} > {tol} ({what})")
        got[name] = (out, err, tol, plain, err64(out, exact))
    same_bits(torch, got[serial][0], getattr(
        spike_matmul, serial + "_chain_plain")(*args),
        f"{serial} and its k-order chain", what)
    e_pipe, e_ser = got[pipe][-1], got[serial][-1]
    limit = 2 * e_ser if e_ser > 0 else 2.0 ** -23
    check(e_pipe <= limit, f"{pipe} is {e_pipe} from the fp64 product, "
          f"over {limit} (twice {serial}'s {e_ser}; {what})")
    return {n: v[1:] for n, v in got.items()}, {n: v[0] for n, v in
                                                 got.items()}


def same_bits(torch, a, b, pair, what):
    """Two kernels (or a kernel and its chain) on the same spikes: equal
    bit for bit. Kernels 18 and 16 build the same A bits into the same
    MMAs; kernels 17 and 15 walk the same events in the same order."""
    torch.cuda.synchronize()
    delta = (a - b).abs().max().item()
    check(torch.equal(a, b), f"{pair} differ by {delta} ({what})")


def apec_events(torch, s, res, ov, map_r, map_o, g) -> dict:
    """The events an APEC matmul walks: the nonzeros of the residual in
    its live 128 x 128 tiles and of the overlap in its live 128/g x 128
    tiles (`events`), and the spikes before decomposition
    (`events_before`)."""
    return dict(events=live_nonzeros(torch, res, map_r) +
                live_nonzeros(torch, ov, map_o, 128 // g),
                events_before=int((s != 0).sum().item()))


def phase_apec_matmul_kernel(torch, gen, cap, results):
    """Kernels 17 and 18 (g = 2) at FFN fc1, fc2 and the stage-1 patch
    matmul, on the model's spikes and on clustered data: each against its
    plain version and the fp64 product (18 within twice 17's distance),
    17 equal to its k-order chain, kernels 15 and 16 on the same spikes'
    words equal to 17 and 18 bit for bit, 17 and 18 timed in turns
    beside cuBLAS fp32 on the same spikes; 17's bound counts its events
    (`apec_events`)."""
    from repro_torch.core.spikes import (pack_spikes_padded,
                                         ragged_tile_occupancy)
    from repro_torch.kernels import dispatch, ops, spike_matmul
    g = 2
    serial, pipe = APEC_PAIRS[0]
    (s1, w1, _), (s2, w2, _) = cap["spike_matmul"][:2]
    s_conv, w_conv, _ = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    cases = (("ffn_fc1", s1.reshape(-1, s1.shape[-1]), w1),
             ("ffn_fc2", s2.reshape(-1, s2.shape[-1]), w2),
             ("econv_stage1",
              dispatch.econv_patches(s_conv, kh, kw, 1, "SAME"),
              w_conv.permute(2, 0, 1, 3).reshape(ci * kh * kw, co)))
    worst = {serial: 0.0, pipe: 0.0}
    for label, s_model, w in cases:
        m, k = s_model.shape
        n = w.shape[1]
        w = w.float().contiguous()
        syn = clustered_spikes(torch, m, k, gen, s_model.device)
        for data, s in (("model", s_model), ("clustered50", syn)):
            ov, res = ops.apec_decompose(s, g)
            res, ov = res.contiguous(), ov.contiguous()
            work = ops.apec_union_worklist(res, ov, g)
            args = (res, ov, w, g) + work
            what = f"{label}, {data}"
            errs, got = apec_pair(torch, serial, pipe, args,
                                  apec_exact(torch, res, ov, w, g), what)
            words = (pack_spikes_padded(res).contiguous(),
                     pack_spikes_padded(ov).contiguous(), w, g) + work
            for name, kernel in zip((serial, pipe), APEC_PAIRS[1]):
                same_bits(torch, got[name], getattr(spike_matmul, kernel)(
                    *words), f"{name} and {kernel}", what)
            map_r = ops.padded_occupancy(res)
            map_o = ragged_tile_occupancy(ov, 128 // g, 128)
            flops, n_bytes = csr_work(torch, map_r, m, k, n, map_o, g)
            events = apec_events(torch, s, res, ov, map_r, map_o, g)
            library_ms = cuda_ms(torch, functools.partial(torch.matmul, s, w))
            times = turns_ms(torch, functools.partial(
                spike_matmul.apec_matmul_csr, *args), functools.partial(
                spike_matmul.apec_matmul_csr_pipe, *args))
            for name, ms in zip((serial, pipe), times):
                err, tol, plain, e64 = errs[name]
                worst[name] = max(worst[name], err)
                rec = dict(max_abs_err=err, tolerance=tol, err64=e64, ms=ms,
                           plain_ms=cuda_ms(torch, functools.partial(
                               plain, *args), reps=3, warmup=1),
                           **apec_bounds(name == pipe, n_bytes, flops,
                                         events["events"], n),
                           **events, library_ms=library_ms,
                           residual_occupied_share=(map_r > 0).float()
                           .mean().item(),
                           overlap_occupied_share=(map_o > 0).float()
                           .mean().item(),
                           overlap_density=ov.mean().item(),
                           spike_density=s.mean().item(), g=g,
                           shape=[m, k, n])
                emit("kernel", name=name, case=f"{label}_{data}", **rec)
                if (label, data) == ("econv_stage1", "model"):
                    results[name] = rec
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


def apec_bounds(tensor_cores: bool, n_bytes: float, flops: float,
                events: int, n: int) -> dict:
    """An APEC kernel's bound fields, against the bytes. The serial
    kernels 17 / 15 walk events: one fp32 instruction an event and a
    column (2 * events * N flops at FP32_FLOPS, as `spike_bounds` counts
    rows 10-14), the FMAs over every element of the live tiles (`flops`)
    beside (`dense_fp32_ops_bound_ms`). The pipelined 18 / 16 run
    APEC_SPLIT_PARTS bf16 MMAs per dense product (over BF16_TC_FLOPS),
    with the dense fp32 bound beside."""
    if tensor_cores:
        b_ms, by = bound_ms(n_bytes, APEC_SPLIT_PARTS * flops, BF16_TC_FLOPS)
        return dict(bound_ms=b_ms, bound_by=by,
                    bytes_bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                    fp32_ops_bound_ms=flops / FP32_FLOPS * 1e3,
                    tensor_core_ops_bound_ms=APEC_SPLIT_PARTS * flops /
                    BF16_TC_FLOPS * 1e3)
    return spike_bounds(n_bytes, events, n, flops)


# g = 1 needs the 64 KB epilogue tile in dynamic shared memory; at 16 and
# 128 the overlap tile has fewer rows (8, 1) than the block thread rows.
APEC_WIDE_GROUPS = (1, 16, 128)


def phase_apec_groups(torch, cap):
    """Kernels 17 / 18 (f32) and 15 / 16 (words) at APEC_WIDE_GROUPS on the
    FFN fc1 spikes: within 1e-5 * max|ref| + 1e-5 of their plain versions,
    17 and 15 equal to their k-order chains, 18 and 16 within twice 17's
    and 15's distance from the fp64 product, 17 == 15 and 18 == 16 bit
    for bit, timed in turns."""
    from repro_torch.core.spikes import pack_spikes_padded
    from repro_torch.kernels import apec_kernel, ops, spike_matmul
    s1, w1, _ = cap["spike_matmul"][0]
    s = s1.reshape(-1, s1.shape[-1]).float().contiguous()
    w = w1.float().contiguous()
    words = pack_spikes_padded(s).contiguous()
    for g in APEC_WIDE_GROUPS:
        ov, res = ops.apec_decompose(s, g)
        res, ov = res.contiguous(), ov.contiguous()
        ov_p, res_p = apec_kernel.apec_decompose_packed(words, g)
        exact = apec_exact(torch, res, ov, w, g)
        twins = []
        for (serial, pipe), args in zip(APEC_PAIRS, (
                (res, ov, w, g) + ops.apec_union_worklist(res, ov, g),
                (res_p, ov_p, w, g) + ops.apec_union_worklist(
                    res_p, ov_p, g, packed=True))):
            errs, got = apec_pair(torch, serial, pipe, args, exact,
                                  f"g={g}")
            twins.append((got[serial], got[pipe]))
            times = turns_ms(torch, functools.partial(
                getattr(spike_matmul, serial), *args), functools.partial(
                getattr(spike_matmul, pipe), *args))
            for name, ms in zip((serial, pipe), times):
                emit("kernel", name=name, case=f"ffn_fc1_g{g}", g=g,
                     max_abs_err=errs[name][0], tolerance=errs[name][1],
                     err64=errs[name][3], ms=ms,
                     overlap_density=ov.mean().item(), shape=list(s.shape))
        for (a, b), pair in zip(zip(*twins), ("kernels 17 and 15",
                                              "kernels 18 and 16")):
            same_bits(torch, a, b, pair, f"g={g}")


def route_split(torch, parts, route) -> dict:
    """Device ms (a CUDA graph) and host enqueue ms of each named part of
    a route and of the whole `route`; `rest` is the route less its
    parts (the wrappers, the registry, shape checks, casts)."""
    split = {}
    for name, fn in (*parts, ("route", route)):
        split[name] = dict(device_ms=graph_ms(torch, fn),
                           host_ms=host_ms(torch, fn))
    split["rest"] = {key: split["route"][key] - sum(
        split[name][key] for name, _ in parts)
        for key in ("device_ms", "host_ms")}
    return split


def phase_apec_path(torch, cap):
    """`core.apec.apec_matmul` on the FFN inputs (EventTensors with their
    carried maps) and the stage-1 patch matrix (with its propagated map),
    g = 2 and 4, with the map and bare: exactly APEC_LAUNCHES (row 19's
    spike entry and kernel 18), the pre-passes, no pack or unpack,
    agreement with the CSR matmul on the same spikes; one call on kernel
    17 by override (APEC_SERIAL_LAUNCHES); the route's ms and its
    decompose step's in turns with the same on the old decompose
    (`old_decompose_route`; the outputs equal bit for bit), the serial
    route's and the CSR routes' ms, and the route's split (`route_split`:
    decompose, work list, kernel 18, the rest)."""
    from repro_torch.core import apec
    from repro_torch.core.events import EventTensor
    from repro_torch.core.spikes import watch_occupancy_prepasses
    from repro_torch.kernels import dispatch, launch_counts, ops, \
        reset_launch_counts, spike_matmul
    (s1, w1, m1), (s2, w2, m2) = cap["spike_matmul"][:2]
    s_conv, w_conv, m_conv = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    patches = dispatch.econv_patches(s_conv, kh, kw, 1, "SAME")
    inputs = (("ffn_fc1", EventTensor(s1, m1), w1),
              ("ffn_fc2", EventTensor(s2, m2), w2),
              ("econv_stage1", EventTensor(patches, m_conv),
               w_conv.permute(2, 0, 1, 3).reshape(ci * kh * kw, co)
               .contiguous()))
    totals = {name: 0 for name in APEC_KERNELS}

    def counted(fn, want, what):
        reset_launch_counts()
        torch.cuda.synchronize()
        with torch.inference_mode(), watch_occupancy_prepasses() as pre, \
                count_pack_calls() as packs:
            out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {name: want.get(name, 0) for name in counts},
              f"{what}: launches {counts} != {want}")
        check(packs["calls"] == 0, f"{what}: {packs['calls']} packs or "
              f"unpacks on the dense APEC route")
        for name in totals:
            totals[name] += counts[name]
        return out, pre["calls"]

    def inference(fn):
        def run():
            with torch.inference_mode():
                return fn()
        return run

    def old_route(fn):
        """`fn` with the dense route's decompose step as it was before the
        spike entry (`old_decompose_route`)."""
        def run():
            saved = ops.apec_decompose
            ops.apec_decompose = functools.partial(old_decompose_route,
                                                   torch)
            try:
                with torch.inference_mode():
                    return fn()
            finally:
                ops.apec_decompose = saved
        return run
    for label, et, w in inputs:
        check(et.occupancy is not None, f"{label}: no carried map")
        with torch.inference_mode():
            csr_out = ops.spike_matmul_csr(et, w)
        csr_ms = cuda_ms(torch, lambda: ops.spike_matmul_csr(et, w))
        csr_pipe_ms = cuda_ms(torch, lambda: ops.spike_matmul_csr(
            et, w, pipeline=True))
        tol = 1e-5 * csr_out.abs().max().item() + 1e-5
        flat = et.spikes.reshape(-1, et.shape[-1])
        w32 = w.float().contiguous()
        for g in APEC_PATH_GROUPS:
            # The route's decompose step alone (row 19's spike entry), in
            # turns with the old route's.
            rec = dict(case=label, g=g, csr_ms=csr_ms,
                       csr_pipe_ms=csr_pipe_ms, tolerance=tol)
            rec["decompose_ms"], rec["decompose_old_route_ms"] = turns_ms(
                torch, lambda: ops.apec_decompose(flat, g),
                lambda: old_decompose_route(torch, flat, g))
            ov, res = ops.apec_decompose(flat, g)
            for form, operand, prepasses, occ, csr in (
                    ("carried", et, 0, et.occupancy_for(128, 128),
                     et.csr(128, 128)),
                    ("bare", et.spikes, 2, None, None)):
                what = f"{label} g={g} {form}"
                out, pre = counted(lambda: apec.apec_matmul(operand, w, g),
                                   APEC_LAUNCHES, what)
                check(pre == prepasses, f"{what}: {pre} dense pre-passes, "
                      f"expected {prepasses}")
                check(tuple(out.shape) == tuple(csr_out.shape) and
                      bool(torch.isfinite(out).all()),
                      f"{what}: output not finite / shape "
                      f"{tuple(out.shape)}")
                err = (out - csr_out).abs().max().item()
                check(err <= tol, f"{what}: APEC off the CSR matmul by "
                      f"{err} > {tol}")
                before = old_route(lambda: apec.apec_matmul(operand, w, g))
                same_bits(torch, out, before(), "the route and the route "
                          "with the old decompose", what)
                rec[f"{form}_ms"], rec[f"{form}_old_route_ms"] = turns_ms(
                    torch, inference(lambda: apec.apec_matmul(operand, w,
                                                              g)), before)
                with torch.inference_mode():
                    work = ops.apec_union_worklist(res, ov, g, occ, csr)
                rec[f"{form}_max_abs_err"] = err
                rec[f"{form}_prepasses"] = pre
                rec[f"{form}_split"] = route_split(torch, (
                    ("decompose", lambda: ops.apec_decompose(flat, g)),
                    ("work_list", inference(
                        lambda: ops.apec_union_worklist(res, ov, g, occ,
                                                        csr))),
                    ("kernel", lambda: spike_matmul.apec_matmul_csr_pipe(
                        res.float(), ov.float(), w32, g, *work))),
                    inference(lambda: apec.apec_matmul(operand, w, g)))
            # The serial kernel 17 by override, carried map.
            with dispatch.use_backend(dispatch.CUDA, op="apec_matmul"):
                ser, _ = counted(lambda: apec.apec_matmul(et, w, g),
                                 APEC_SERIAL_LAUNCHES, f"{label} g={g} "
                                 f"serial")
                with torch.inference_mode():
                    rec["serial_carried_ms"] = cuda_ms(
                        torch, lambda: apec.apec_matmul(et, w, g))
            err = (ser - csr_out).abs().max().item()
            check(err <= tol, f"{label} g={g} serial: APEC off the CSR "
                  f"matmul by {err} > {tol}")
            rec["serial_max_abs_err"] = err
            emit("apec_path", launches=APEC_LAUNCHES,
                 serial_launches=APEC_SERIAL_LAUNCHES, **rec)
    return totals


def phase_apec_stats(torch, cap):
    """`apec_stats` for G2, G4, G8 on every fire of the captured forward;
    positions are tokens or row-major pixels of each image and step."""
    from repro_torch.core.apec import apec_stats
    layers = []
    for i, s in enumerate(cap["fires"]):
        flat = s.reshape(-1, math.prod(s.shape[2:-1]), s.shape[-1])
        row = dict(fire=i, shape=list(s.shape),
                   spike_rate=s.float().mean().item())
        for g in APEC_STAT_GROUPS:
            st = apec_stats(flat, g)
            row[f"G{g}"] = dict(
                reduction_ratio=st.reduction_ratio.item(),
                overlap_mean=st.overlap_mean.item(),
                eliminated_share=(st.eliminated /
                                  st.events_before.clamp(min=1.0)).item())
        layers.append(row)
    emit("apec_stats", layers=layers)


def phase_apec(torch, gen, device, results):
    """Phase (i): both APEC kernels against their plain versions, the
    public entry point on the model's spike maps, and the statistics."""
    cap = apec_capture(torch, device)
    check(len(cap["spike_matmul"]) == 2 * DEPTH and len(cap["econv"]) == 3,
          f"captured {len(cap['spike_matmul'])} spike matmuls and "
          f"{len(cap['econv'])} econvs")
    phase_apec_decompose(torch, cap, results)
    phase_apec_matmul_kernel(torch, gen, cap, results)
    phase_apec_groups(torch, cap)
    totals = phase_apec_path(torch, cap)
    phase_apec_stats(torch, cap)
    return totals

# ------------------------------------------------------------ phase (j)
def phase_packed_fire(torch, gen, device, results):
    """Kernel 6 at every drive of FIRE_DRIVES: words and counts equal to
    its plain version, and the words equal to the packed spikes of kernel
    4 on the same drive (the stage-1 and stage-0 drives drawn from `gen`
    as before, the rest from their own generator)."""
    from repro_torch.core.spikes import pack_spikes_padded
    from repro_torch.kernels import lif_scan
    kw = dict(decay=0.5, v_th=V_TH, soft_reset=True)
    drawn = {label: (0.6 * torch.randn(shape, generator=gen) + 0.2).to(
        device) for label, shape in FIRE_DRIVES[:2]}
    fgen = torch.Generator(device=device).manual_seed(SEED + 1)
    for label, shape in FIRE_DRIVES:
        x = drawn[label] if label in drawn else \
            fire_drive(torch, label, shape, fgen, device)
        (words, _), rec = counts_case(torch, "lif_counts_packed", label, x,
                                      kw)
        s, _ = lif_scan.lif_counts(x, **kw)
        torch.cuda.synchronize()
        check(torch.equal(as_int32(words), as_int32(pack_spikes_padded(s))),
              f"packed fire's words are not the counts kernel's spikes "
              f"packed ({label})")
        if label == "sps_stage1":
            results["lif_counts_packed"] = rec


def packed_capture(torch, device):
    """One packed SpikingFormer-4-384 forward (B=32, T=4, seed 0) on the
    kernels, recording every registry call (op, args, kwargs) and the
    operands of every packed CSR launch (words, weights, work list; the
    forward launches the pipelined kernel 14)."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.kernels import dispatch, spike_matmul
    from repro_torch.models import spikingformer as sf
    params = sf.spikingformer_init(
        DEPTH, DIM, generator=torch.Generator().manual_seed(SEED),
        device=device)
    x = torch.rand((B, 32, 32, 3),
                   generator=torch.Generator().manual_seed(SEED + 1)
                   ).to(device)
    cap = {"calls": [], "csr": []}
    orig_dispatch = dispatch.dispatch
    orig_kernel = spike_matmul.spike_matmul_packed_csr_pipe

    def record(op, *args, **kwargs):
        cap["calls"].append((op, args, kwargs))
        return orig_dispatch(op, *args, **kwargs)

    def kernel(p, w, csr):
        cap["csr"].append((p, w, csr))
        return orig_kernel(p, w, csr)
    dispatch.dispatch = record
    spike_matmul.spike_matmul_packed_csr_pipe = kernel
    try:
        with torch.inference_mode():
            sf.spikingformer_apply(params, x, n_heads=HEADS,
                                   spiking_cfg=SpikingConfig(
                                       t_steps=T, lif_vth=V_TH, packed=True))
    finally:
        dispatch.dispatch = orig_dispatch
        spike_matmul.spike_matmul_packed_csr_pipe = orig_kernel
    torch.cuda.synchronize()
    check(len(cap["csr"]) == 3 + 2 * DEPTH,
          f"captured {len(cap['csr'])} packed CSR launches")
    return cap


def phase_packed_csr(torch, gen, cap, results):
    """Kernel 13 at the packed stage-1 patch matrix, fc1 and fc2: the
    model's words and work lists, and clustered data with 50% occupied
    tiles; at each, kernels 13 and 11 (on the same spikes unpacked) equal
    bit for bit to each other and to their k-order chains, with their
    times and the live events they walk."""
    from repro_torch.core.spikes import (build_csr, pack_spikes_padded,
                                         ragged_packed_tile_occupancy,
                                         unpack_spikes)
    from repro_torch.kernels import spike_matmul
    cases = (("econv_stage1", cap["csr"][0]), ("ffn_fc1", cap["csr"][3]),
             ("ffn_fc2", cap["csr"][4]))
    worst = 0.0
    for label, (p_model, w, csr_model) in cases:
        m = p_model.shape[0]
        k, n = w.shape
        syn = clustered_spikes(torch, m, k, gen, p_model.device)
        p_syn = pack_spikes_padded(syn).contiguous()
        for data, p, csr in (("model", p_model, csr_model),
                             ("clustered50", p_syn, build_csr(
                                 ragged_packed_tile_occupancy(p_syn, 128,
                                                              128),
                                 128, 128))):
            out = spike_matmul.spike_matmul_packed_csr(p, w, csr)
            ref = spike_matmul.spike_matmul_packed_csr_plain(p, w, csr)
            dense = unpack_spikes(p)[:, :k].contiguous()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item() + 1e-5
            check(err <= tol, f"packed CSR kernel off by {err} > {tol} "
                  f"({label}, {data})")
            what = f"{label}, {data}"
            chain = spike_matmul.spike_matmul_packed_csr_chain_plain
            same_bits(torch, out, chain(p, w, csr),
                      "spike_matmul_packed_csr and its k-order chain", what)
            k11 = spike_matmul.spike_matmul_csr(dense, w, csr)
            chain = spike_matmul.spike_matmul_csr_chain_plain
            same_bits(torch, k11, chain(dense, w, csr),
                      "spike_matmul_csr and its k-order chain", what)
            same_bits(torch, out, k11, "kernels 13 and 11", what)
            worst = max(worst, err)
            occ = ragged_packed_tile_occupancy(p, 128, 128)
            nnz = live_nonzeros(torch, dense, occ)
            flops, n_bytes = csr_work(torch, occ, m, k, n, spike_bytes=1 / 8)
            rec = dict(max_abs_err=err, tolerance=tol,
                       ms=cuda_ms(torch, lambda: spike_matmul
                                  .spike_matmul_packed_csr(p, w, csr)),
                       plain_ms=cuda_ms(torch, lambda: spike_matmul
                                        .spike_matmul_packed_csr_plain(
                                            p, w, csr), reps=5),
                       **spike_bounds(n_bytes, nnz, n, flops),
                       library_ms=cuda_ms(torch, functools.partial(
                           torch.matmul, dense, w)),
                       kernel11_ms=cuda_ms(torch, functools.partial(
                           spike_matmul.spike_matmul_csr, dense, w, csr)),
                       events=nnz,
                       occupied_share=(occ > 0).float().mean().item(),
                       shape=[m, p.shape[1], k, n])
            emit("kernel", name="spike_matmul_packed_csr",
                 case=f"{label}_{data}", **rec)
            if (label, data) == ("econv_stage1", "model"):
                results["spike_matmul_packed_csr"] = rec
    results["spike_matmul_packed_csr"]["max_abs_err"] = worst


@contextlib.contextmanager
def count_pack_calls():
    """Counts every pack and unpack the port's wrappers make while
    active (the packed APEC route should make none)."""
    from repro_torch.core import events
    from repro_torch.kernels import dispatch, ops, spike_matmul
    rec = {"calls": 0}
    patched = []
    for mod in (ops, spike_matmul, events, dispatch):
        for name in ("pack_spikes", "pack_spikes_padded", "unpack_spikes",
                     "_unpack_words"):
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def counted(*a, _fn=fn, **kw):
                rec["calls"] += 1
                return _fn(*a, **kw)
            patched.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield rec
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def phase_packed_apec(torch, cap, results):
    """Kernels 15 and 16 (g=2) at fc1 and fc2 on the forward's packed
    inputs and at the packed stage-1 patch matrix: each against its plain
    version and the fp64 product (16 within twice 15's distance), 15
    equal to its k-order chain, kernels 17 and 18 on the same spikes
    unpacked equal to 15 and 16 bit for bit, 15 and 16 timed in turns
    (15's bound counts its events); and
    `core.apec.apec_matmul` on them (fc1/fc2 with the carried map; stage
    1 bare, as its econv has no map to carry): exactly
    PACKED_APEC_LAUNCHES (kernel 16), one call on kernel 15 by override,
    beside the dense APEC, CSR and packed CSR routes on the same
    spikes."""
    from repro_torch.core import apec
    from repro_torch.core.events import EventTensor
    from repro_torch.core.spikes import (ragged_packed_tile_occupancy,
                                         unpack_spikes_padded,
                                         watch_occupancy_prepasses,
                                         watch_word_prepasses)
    from repro_torch.kernels import (apec_kernel, dispatch, launch_counts,
                                     ops, reset_launch_counts, spike_matmul)
    g = 2
    serial, pipe = APEC_PAIRS[1]
    ffn = [(args[0], args[1], kw["occupancy"]) for op, args, kw in
           cap["calls"] if op == "spike_matmul"][:2]
    stage1 = cap["csr"][0][:2] + (None,)
    totals = {name: 0 for name in PACKED_KERNELS + ("apec_decompose",)}
    worst = {serial: 0.0, pipe: 0.0}

    def counted(fn, want, what):
        reset_launch_counts()
        torch.cuda.synchronize()
        with torch.inference_mode(), watch_occupancy_prepasses() as pre, \
                watch_word_prepasses() as wpre, count_pack_calls() as packs:
            out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {name: want.get(name, 0) for name in counts},
              f"{what}: packed APEC launches {counts} != {want}")
        for name in totals:
            totals[name] += counts[name]
        return out, pre["calls"], wpre["calls"], packs["calls"]
    for label, (words, w, occ) in zip(("ffn_fc1", "ffn_fc2", "econv_stage1"),
                                      ffn + [stage1]):
        k, n = w.shape
        et = EventTensor(None, occ, packed=words, feature_size=k)
        dense_et = EventTensor(et.dense().contiguous(), occ)
        p2 = words.reshape(-1, words.shape[-1]).contiguous()
        m = p2.shape[0]
        ov, res = apec_kernel.apec_decompose_packed(p2, g)
        work = ops.apec_union_worklist(res, ov, g, packed=True)
        call = (res, ov, w, g) + work
        dense_res, dense_ov = (unpack_spikes_padded(x, k).contiguous()
                               for x in (res, ov))
        errs, got = apec_pair(torch, serial, pipe, call, apec_exact(
            torch, dense_res, dense_ov, w, g), label)
        for name, kernel in zip((serial, pipe), APEC_PAIRS[0]):
            same_bits(torch, getattr(spike_matmul, kernel)(
                dense_res, dense_ov, w, g, *work), got[name],
                f"{kernel} and {name}", label)
        map_r = ragged_packed_tile_occupancy(res, 128, 128)
        map_o = ragged_packed_tile_occupancy(ov, 128 // g, 128)
        flops, n_bytes = csr_work(torch, map_r, m, k, n, map_o, g,
                                  spike_bytes=1 / 8)
        events = apec_events(torch, unpack_spikes_padded(p2, k), dense_res,
                             dense_ov, map_r, map_o, g)
        flat = dense_et.spikes.reshape(-1, k)
        library_ms = cuda_ms(torch, functools.partial(torch.matmul, flat, w))
        times = turns_ms(torch, functools.partial(
            spike_matmul.apec_matmul_packed_csr, *call), functools.partial(
            spike_matmul.apec_matmul_packed_csr_pipe, *call))
        for name, ms in zip((serial, pipe), times):
            err, tol, plain, e64 = errs[name]
            worst[name] = max(worst[name], err)
            rec = dict(max_abs_err=err, tolerance=tol, err64=e64, ms=ms,
                       plain_ms=cuda_ms(torch, functools.partial(
                           plain, *call), reps=3, warmup=1),
                       **apec_bounds(name == pipe, n_bytes, flops,
                                     events["events"], n),
                       **events, library_ms=library_ms,
                       residual_occupied_share=(map_r > 0).float().mean()
                       .item(),
                       overlap_occupied_share=(map_o > 0).float().mean()
                       .item(),
                       g=g, shape=[m, p2.shape[1], k, n])
            emit("kernel", name=name, case=label, **rec)
            if label == "ffn_fc1":
                results[name] = rec
        # The public entry point on the packed EventTensor, carried map.
        with torch.inference_mode():
            csr_out = ops.spike_matmul_csr(dense_et, w)
        got, pre, wpre, packs = counted(lambda: apec.apec_matmul(et, w, g),
                                        PACKED_APEC_LAUNCHES, label)
        check(pre == 0 and wpre == (0 if occ is not None else 2) and
              packs == 0, f"{label}: packed APEC route ran {pre} dense and "
              f"{wpre} word pre-passes and {packs} packs or unpacks")
        route_err = (got - csr_out).abs().max().item()
        route_tol = 1e-5 * csr_out.abs().max().item() + 1e-5
        check(bool(torch.isfinite(got).all()) and route_err <= route_tol,
              f"{label}: packed APEC route off the CSR matmul by "
              f"{route_err} > {route_tol}")
        # The serial kernel 15 by override.
        with dispatch.use_backend(dispatch.CUDA_PACKED, op="apec_matmul"):
            ser, *_ = counted(lambda: apec.apec_matmul(et, w, g),
                              PACKED_APEC_SERIAL_LAUNCHES, f"{label} serial")
            with torch.inference_mode():
                serial_ms = cuda_ms(torch, lambda: apec.apec_matmul(et, w,
                                                                    g))
        serial_err = (ser - csr_out).abs().max().item()
        check(bool(torch.isfinite(ser).all()) and serial_err <= route_tol,
              f"{label}: packed APEC route on kernel 15 off the CSR matmul "
              f"by {serial_err} > {route_tol}")
        with torch.inference_mode():
            routes = dict(
                packed_apec_ms=cuda_ms(torch, lambda: apec.apec_matmul(
                    et, w, g)),
                packed_apec_serial_ms=serial_ms,
                dense_apec_ms=cuda_ms(torch, lambda: apec.apec_matmul(
                    dense_et, w, g)),
                csr_ms=cuda_ms(torch, lambda: ops.spike_matmul_csr(
                    dense_et, w)),
                packed_csr_ms=cuda_ms(torch, lambda: ops.spike_matmul_packed(
                    et, w)),
                csr_pipe_ms=cuda_ms(torch, lambda: ops.spike_matmul_csr(
                    dense_et, w, pipeline=True)),
                packed_csr_pipe_ms=cuda_ms(
                    torch, lambda: ops.spike_matmul_packed(et, w,
                                                           pipeline=True)))
        emit("packed_apec_path", case=label, g=g, carried=occ is not None,
             word_prepasses=wpre, launches=PACKED_APEC_LAUNCHES,
             serial_launches=PACKED_APEC_SERIAL_LAUNCHES,
             max_abs_err=route_err, serial_max_abs_err=serial_err,
             tolerance=route_tol, **routes)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err
    return totals


@contextlib.contextmanager
def fire_outputs(module):
    """Records every EventTensor `module.lif_fire_events` returns."""
    fires: list = []
    orig = module.lif_fire_events

    def rec(*a, **kw):
        et = orig(*a, **kw)
        fires.append(et)
        return et
    module.lif_fire_events = rec
    try:
        yield fires
    finally:
        module.lif_fire_events = orig


def packed_forward_check(torch, name, forward, x, module, out_shape):
    """One packed forward on the kernels, gated (launches, pre-passes,
    packed-only fires, same-input agreement with `ref`, drift against the
    dense kernel forward; the drift against the packed `ref` forward is
    reported); returns its launch counts."""
    from repro_torch.core.spikes import (watch_occupancy_prepasses,
                                         watch_word_prepasses)
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), watch_occupancy_prepasses() as pre, \
            watch_word_prepasses() as wpre, fire_outputs(module) as fires:
        out, stats = forward(x, True, True)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {k: PACKED_LAUNCHES[name].get(k, 0) for k in counts}
    check(counts == want, f"{name} packed: launches {counts} != {want}")
    prepasses = (pre["calls"], wpre["calls"])
    check(prepasses == PACKED_PREPASSES[name],
          f"{name} packed: (dense, word) pre-passes {prepasses} != "
          f"{PACKED_PREPASSES[name]}")
    check(len(fires) > 0 and all(f.spikes is None and
                                 f.packed.dtype == torch.uint32
                                 for f in fires),
          f"{name} packed: a fire carried f32 spikes")
    check(tuple(out.shape) == out_shape and bool(torch.isfinite(out).all()),
          f"{name} packed: output {tuple(out.shape)} not finite / != "
          f"{out_shape}")
    with torch.inference_mode():
        dense_out, dense_stats = forward(x, False, True)
        t0 = time.perf_counter()
        with dispatch.use_backend(dispatch.REF):
            ref_out, ref_stats = forward(x, True, True)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    stages = [dict(stage=i, spike_rate=a.float().mean().item(),
                   differing_share_dense=(a != d).float().mean().item(),
                   differing_share_ref=(a != r).float().mean().item())
              for i, (a, d, r) in enumerate(zip(stats, dense_stats,
                                                ref_stats))]
    with torch.inference_mode(), shadow_ref(torch, dispatch) as shadow:
        forward(x, True, False)
    emit("packed_forward", model=name,
         max_abs_dout_dense=(out - dense_out).abs().max().item(),
         max_abs_dout_ref=(out - ref_out).abs().max().item(),
         kernel_forward_s=kernel_s, ref_forward_s=ref_s, launches=counts,
         prepasses=dict(dense=prepasses[0], word=prepasses[1]),
         fires=len(fires), stages=stages, same_input_ops=shadow)
    for op, err in shadow.items():
        check(err <= SAME_INPUT_TOL[op], f"{name} packed: {op} on the "
              f"kernels differs from ref on the same inputs by {err} > "
              f"{SAME_INPUT_TOL[op]}")
    # Gated against the dense kernel forward; the drift against the
    # packed `ref` forward is reported: it compounds both routes' tie
    # flips (ResNet18's deepest stage reached 1.5e-2 on the H100 while
    # every op agreed with `ref` on the same inputs).
    for st in stages:
        check(st["differing_share_dense"] <= FREE_RUNNING_SPIKE_TOL,
              f"{name} packed stage {st['stage']}: "
              f"{st['differing_share_dense']} of spikes differ from the "
              f"dense kernel forward")
    return counts


def phase_packed_models(torch, device):
    """Packed SpikingFormer-4-384 (4 batches of 32) and VGG11, ResNet18,
    SegNet-64 (one batch of 32) forwards, gated; each model's packed and
    dense forward breakdowns in turns (dense, packed, packed, dense)."""
    import dataclasses
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.models import cnn
    from repro_torch.models import spikingformer as sf
    resolved = dispatch.resolved_backends(device, packed=True)
    emit("packed_resolution", backends=resolved)
    check(resolved == card_routes(dispatch, packed=True),
          f"packed calls not resolved to the packed kernels: {resolved}")
    totals = {name: 0 for name in PACKED_KERNELS}
    params = sf.spikingformer_init(DEPTH, DIM, generator=torch.Generator()
                                   .manual_seed(SEED), device=device)
    base = SpikingConfig(t_steps=T, lif_vth=V_TH)

    def sf_forward(x, packed, collect_stats):
        return sf.spikingformer_apply(params, x, n_heads=HEADS,
                                      spiking_cfg=base.replace(packed=packed),
                                      collect_stats=collect_stats)
    img_gen = torch.Generator().manual_seed(SEED + 1)
    for _ in range(4):
        x = torch.rand((B, 32, 32, 3), generator=img_gen).to(device)
        counts = packed_forward_check(torch, "spikingformer", sf_forward, x,
                                      sf, (B, 10))
        for name in totals:
            totals[name] += counts[name]
    # The serial word kernel 13 by override, on the last batch.
    reset_launch_counts()
    with torch.inference_mode(), pinned(dispatch, dispatch.CUDA_PACKED):
        ser_out, ser_stats = sf_forward(x, True, True)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: PACKED_SERIAL_LAUNCHES.get(k, 0) for k in counts}
    check(counts == want, f"packed serial forward launches {counts} != "
          f"{want}")
    # Gated against the dense serial forward (kernel 13's sums are kernel
    # 11's on the same spikes); against the packed pipelined one reported.
    with torch.inference_mode():
        out, stats = sf_forward(x, True, True)
        with pinned(dispatch, dispatch.CUDA):
            dense_out, dense_stats = sf_forward(x, False, True)
    drift = [(a != b).float().mean().item()
             for a, b in zip(ser_stats, dense_stats)]
    drift_pipe = [(a != b).float().mean().item()
                  for a, b in zip(ser_stats, stats)]
    emit("packed_serial_forward", launches=counts,
         stage_differing_share=drift, stage_differing_share_pipe=drift_pipe,
         max_abs_dlogits=(ser_out - dense_out).abs().max().item(),
         max_abs_dlogits_pipe=(ser_out - out).abs().max().item())
    check(bool(torch.isfinite(ser_out).all()) and
          max(drift) <= FREE_RUNNING_SPIKE_TOL,
          f"packed serial forward: logits not finite or spike drift "
          f"{max(drift)}")
    for name in totals:
        totals[name] += counts[name]
    for name in ("vgg11", "resnet18", "segnet"):
        cfg, _, batch = cnn_setup(torch, name, device)
        cnn_params = getattr(cnn, f"{name}_init")(
            cfg, generator=torch.Generator().manual_seed(SEED), device=device)
        apply = getattr(cnn, f"{name}_apply")

        def cnn_forward(x, packed, collect_stats, cfg=cfg, apply=apply,
                        cnn_params=cnn_params):
            c = dataclasses.replace(cfg, spiking=dataclasses.replace(
                cfg.spiking, packed=packed))
            return apply(c, cnn_params, x, collect_stats=collect_stats)
        shape = (B, cfg.img, cfg.img, 2) if name == "segnet" else \
            (B, cfg.n_classes)
        x_cnn = batch(0)
        counts = packed_forward_check(torch, name, cnn_forward, x_cnn, cnn,
                                      shape)
        for k in totals:
            totals[k] += counts[k]
        for _ in range(2):                               # warm forwards
            with torch.inference_mode():
                cnn_forward(x_cnn, True, False)
        for packed in (False, True, True, False):
            emit("packed_cnn_breakdown", model=name, packed=packed,
                 **forward_breakdown(torch, lambda: cnn_forward(
                     x_cnn, packed, False)))
    for _ in range(3):                                   # warm forwards
        with torch.inference_mode():
            sf_forward(x, True, False)
            sf_forward(x, False, False)
    for packed in (False, True, True, False):
        emit("packed_breakdown", packed=packed, **forward_breakdown(
            torch, lambda: sf_forward(x, packed, False)))
    return totals


def phase_packed(torch, gen, device, results):
    """Phase (j): the packed kernels against their plain versions, the
    packed APEC route, and the packed model forwards."""
    phase_packed_fire(torch, gen, device, results)
    cap = packed_capture(torch, device)
    phase_packed_csr(torch, gen, cap, results)
    totals = phase_packed_apec(torch, cap, results)
    for name, n in phase_packed_models(torch, device).items():
        totals[name] += n
    return totals


# ------------------------------------------------------------ phase (k)
@contextlib.contextmanager
def capture_fires(torch, dispatch, against=None):
    """While active, every `lif_scan` registry call's spikes are recorded
    as booleans; with `against` (an earlier capture of the same calls),
    each call's share of spikes differing from it is recorded instead."""
    orig = dispatch.dispatch
    rec: list = []

    def record(op, *args, **kwargs):
        out = orig(op, *args, **kwargs)
        if op == "lif_scan":
            fired = out != 0
            if against is None:
                rec.append(fired)
            else:
                rec.append((fired != against[len(rec)]).float().mean()
                           .item())
        return out

    dispatch.dispatch = record
    try:
        yield rec
    finally:
        dispatch.dispatch = orig


FIRE_NAMES = ("ln1", "q", "k", "v", "ln2", "hidden")


def per_layer(values, n_layers, names=FIRE_NAMES):
    """Per-call values (len(names) fires per layer, in layer order) by
    layer."""
    per = len(names)
    check(len(values) == per * n_layers,
          f"{len(values)} fires for {n_layers} layers")
    return [dict(zip(names, values[per * i:per * (i + 1)]))
            for i in range(n_layers)]


def lif_case(torch, label, x, reps=20, plain_reps=3, v_th=1.0):
    """The bf16 fire on a drive `x` (T, ...) at threshold `v_th` against
    its plain version bit for bit, silent where the drive is 0 at every
    step: the `kernel` line's record (`ms` back-to-back wrapper calls, the
    host's enqueue included; `device_ms` the kernel alone, `reps` launches
    in a CUDA graph)."""
    from repro_torch.kernels import lif_scan
    kw = dict(decay=0.5, v_th=v_th, soft_reset=True)
    out = lif_scan.lif(x, **kw)
    want = lif_scan.lif_plain(x, **kw)
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16 and torch.equal(out, want),
          f"lif_bf16 kernel disagrees with its plain version ({label})")
    silent = (x == 0).all(0)
    check(not bool((out != 0).any(0)[silent].any()),
          f"lif_bf16 fires where the drive is 0 ({label})")
    b_ms, by = bound_ms(4 * x.numel())
    rec = dict(max_abs_err=0.0,
               ms=cuda_ms(torch, lambda: lif_scan.lif(x, **kw), reps=reps),
               device_ms=graph_ms(torch, lambda: lif_scan.lif(x, **kw),
                                  reps=reps),
               plain_ms=cuda_ms(torch, lambda: lif_scan.lif_plain(x, **kw),
                                reps=plain_reps, warmup=1),
               bound_ms=b_ms, bound_by=by, library_ms=None,
               shape=list(x.shape), zero_drive_share=silent.float().mean()
               .item(), spike_share=(out != 0).float().mean().item())
    emit("kernel", name="lif_bf16", case=label, **rec)
    return rec


def phase_lm_kernels(torch, device, results):
    """(k1): the causal-status kernel (row 9) and the bf16 fire (row 1's
    bf16 instance) against their plain versions, bit for bit, at the LM's
    shapes."""
    from repro_torch.core.spikes import pack_spikes, unpack_spikes
    from repro_torch.kernels import sdsa_kernel
    dgen = torch.Generator(device=device).manual_seed(SEED)
    for label, (bh, n, dw) in (("prefill_b8_n1024", (256, 1024, 2)),
                               ("prefill_32k_b1", (32, 32768, 2)),
                               ("ragged_n1000", (256, 1000, 2))):
        # 1/(4N) per bit: a column's first bit falls anywhere in the
        # sequence, so the prefix-OR keeps changing in the last chunks and
        # the carry across every chunk is checked (at a fixed density the
        # status saturates within a few hundred tokens).
        bits = torch.rand((bh, n, 32 * dw), generator=dgen,
                          device=device) < 1 / (4 * n)
        kv = pack_spikes(bits).contiguous()
        out = sdsa_kernel.sdsa_causal_status(kv)
        want = sdsa_kernel.sdsa_causal_status_plain(kv)
        torch.cuda.synchronize()
        wi = want.view(torch.int32)
        late = wi[:, n // 2:] != wi[:, n // 2 - 1:-1]
        check(not bool((wi == -1).all()) and bool(late.any()),
              f"sdsa_causal check ({label}) saturates: it cannot tell a "
              f"carry fault")
        check(torch.equal(out.view(torch.int32), wi),
              f"sdsa_causal kernel disagrees with its plain version "
              f"({label})")
        dense = unpack_spikes(kv, dtype=torch.bfloat16)
        b_ms, by = bound_ms(2 * kv.numel() * 4)
        rec = dict(max_abs_err=0.0,
                   ms=cuda_ms(torch, lambda: sdsa_kernel.sdsa_causal_status(
                       kv)),
                   device_ms=graph_ms(torch, lambda: sdsa_kernel
                                      .sdsa_causal_status(kv)),
                   plain_ms=cuda_ms(torch, lambda: sdsa_kernel
                                    .sdsa_causal_status_plain(kv), reps=5),
                   bound_ms=b_ms, bound_by=by,
                   library_ms=cuda_ms(torch, lambda: torch.cummax(dense,
                                                                  dim=1)),
                   shape=[bh, n, dw])
        emit("kernel", name="sdsa_causal", case=label,
             entry="sdsa_causal_status",
             ones_share=bits.float().mean().item(),
             status_ones_share=unpack_spikes(want).mean().item(),
             late_turn_ons=int(late.sum().item()), **rec)
    # The main path's call: one LM layer's causal SDSA in prefill, (T, B,
    # H, N, dh) views of its bf16 q, k, v fires; kv at 1/(4N) a channel
    # and token, so the status still turns on in the last chunks
    # (checked); library: torch.cummax of the folded kv over the tokens.
    sgen = torch.Generator(device=device).manual_seed(SEED + 1)
    shape = (2, LM_BATCH, LM_PROMPT, 32, 64)
    q = head_spikes(torch, sgen, shape, 0.2, torch.bfloat16, device)
    k, v = (head_spikes(torch, sgen, shape, (1 / (8 * LM_PROMPT)) ** 0.5,
                        torch.bfloat16, device) for _ in range(2))
    kv = ((k != 0) & (v != 0)).any(0).to(torch.bfloat16)
    seen = kv.to(torch.uint8).cummax(-2).values
    check(bool((seen[..., -1, :] > seen[..., LM_PROMPT // 2, :]).any()),
          "causal spike check saturates: it cannot tell a carry fault")
    results["sdsa_causal"] = sdsa_spike_case(
        torch, "sdsa_causal", "lm_prefill", sdsa_kernel.causal_sdsa_spikes,
        sdsa_kernel.causal_sdsa_spikes_plain, (q, k, v),
        library=lambda: torch.cummax(kv, dim=-2))
    for label, p in (("decode_hidden", LM_BATCH * 5632),
                     ("prefill_hidden", LM_BATCH * LM_PROMPT * 5632)):
        x = (torch.randn((2, p), generator=dgen, device=device) * 0.8
             + 0.6).bfloat16()
        rec = lif_case(torch, label, x)
        if label == "prefill_hidden":
            results["lif_bf16"] = rec


def lm_launch_check(counts, expected, what):
    want = {k: expected.get(k, 0) for k in counts}
    check(counts == want, f"launches per {what} {counts} != {want}")


def phase_lm_prefill(torch, device, cfg, params):
    """(k2): prefill of 8 x 1024 tokens on the kernels and on ref."""
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.models import lm
    tokens = torch.from_numpy(markov_tokens(
        SEED, 0, 0, LM_BATCH, LM_PROMPT, cfg.vocab)[:, :LM_PROMPT]).long() \
        .to(device)
    with torch.inference_mode():
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_fires(torch, dispatch) as fires:
            logits = lm.prefill(cfg, params, tokens, True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = launch_counts()
        lm_launch_check(counts, LM_PREFILL_LAUNCHES, "prefill")
        check(tuple(logits.shape) == (LM_BATCH, cfg.vocab) and
              bool(torch.isfinite(logits).all()), "prefill logits not finite")
        t0 = time.perf_counter()
        lm.prefill(cfg, params, tokens, True)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with dispatch.use_backend(dispatch.REF), \
                capture_fires(torch, dispatch, against=fires) as drift:
            ref_logits = lm.prefill(cfg, params, tokens, True)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        with shadow_ref(torch, dispatch) as shadow:
            lm.prefill(cfg, params, tokens, True)
    rates = per_layer([f.float().mean().item() for f in fires],
                      cfg.n_layers)
    drifts = per_layer(drift, cfg.n_layers)
    emit("lm_prefill", batch=LM_BATCH, tokens=LM_PROMPT,
         first_prefill_s=first_s, kernel_prefill_s=kernel_s,
         ref_prefill_s=ref_s, launches=counts,
         max_abs_dlogits=(logits - ref_logits).abs().max().item(),
         max_abs_logits=ref_logits.abs().max().item(),
         same_input_ops=shadow,
         layers=[dict(layer=i, spike_rate=r,
                      differing_share=max(d.values()))
                 for i, (r, d) in enumerate(zip(rates, drifts))])
    for op, err in shadow.items():
        check(err <= SAME_INPUT_TOL[op],
              f"{op} on the kernels differs from ref on the same inputs "
              f"by {err} > {SAME_INPUT_TOL[op]}")
    worst = max(max(d.values()) for d in drifts)
    check(worst <= FREE_RUNNING_SPIKE_TOL,
          f"LM prefill: {worst} of a fire's spikes differ from ref")
    emit("lm_prefill_breakdown", **forward_breakdown(
        torch, lambda: lm.prefill(cfg, params, tokens, True)))
    return dict(counts)


def lm_serve(torch, cfg, params, tokens, lengths, counted=False,
             spiking=True, new=LM_NEW, max_seq=LM_SERVE_PAD + LM_NEW):
    """prefill_chunked + `new` greedy decode steps at per-slot positions:
    (generated tokens (B, 1 + new), [launch counts of prefill_chunked,
    then of each decode step] when `counted`)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    reset_launch_counts()
    last, state = lm.prefill_chunked(cfg, params, tokens, lengths, spiking,
                                     max_seq)
    chunked = [launch_counts()] if counted else []
    gen, per_step = lm_decode(torch, cfg, params, state, last.argmax(-1),
                              lengths.clone(), counted, spiking, new)
    return gen, chunked + per_step


def lm_decode(torch, cfg, params, state, token, pos, counted=False,
              spiking=True, new=LM_NEW):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    out, per_step = [token], []
    for _ in range(new):
        if counted:
            reset_launch_counts()
        logits, state = lm.decode_step(cfg, params, state, token, pos,
                                       spiking)
        if counted:
            per_step.append(launch_counts())
        token = logits.argmax(-1)
        pos = pos + 1
        out.append(token)
    return torch.stack(out, 1), per_step


def phase_lm_serve(torch, device, cfg, params):
    """(k3): 8 ragged requests served on 8 slots, on the kernels and on
    ref; slot 3 alone; prefill against prefill_chunked."""
    import numpy as np
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import dispatch, reset_launch_counts
    from repro_torch.models import lm
    rng = np.random.default_rng(SEED)
    lengths_np = rng.integers(LM_SERVE_PAD // 2 + 1, LM_SERVE_PAD + 1,
                              LM_BATCH)
    prompts = markov_tokens(SEED + 1, 0, 0, LM_BATCH, LM_SERVE_PAD,
                            cfg.vocab)[:, :LM_SERVE_PAD]
    prompts[np.arange(LM_SERVE_PAD)[None, :] >= lengths_np[:, None]] = 0
    tokens = torch.from_numpy(prompts).long().to(device)
    lengths = torch.from_numpy(lengths_np).to(device)
    with torch.inference_mode():
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, counted = lm_serve(torch, cfg, params, tokens, lengths,
                                counted=True)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        chunked, per_step = counted[0], counted[1:]
        # prefill_chunked is LM_SERVE_PAD decode steps
        lm_launch_check(chunked, {k: v * LM_SERVE_PAD for k, v in
                                  LM_DECODE_LAUNCHES.items()},
                        "prefill_chunked")
        for counts in per_step:
            lm_launch_check(counts, LM_DECODE_LAUNCHES, "decode step")
        with dispatch.use_backend(dispatch.REF):
            ref_gen, _ = lm_serve(torch, cfg, params, tokens, lengths)
        # Slot 3 alone: the same 8-slot shapes with every other slot
        # empty, its state moved into a fresh pool through merge_slot_state.
        solo_tokens = torch.zeros_like(tokens)
        solo_tokens[LM_SOLO_SLOT] = tokens[LM_SOLO_SLOT]
        solo_len = torch.ones_like(lengths)
        solo_len[LM_SOLO_SLOT] = lengths[LM_SOLO_SLOT]
        last, state = lm.prefill_chunked(cfg, params, solo_tokens, solo_len,
                                         True, LM_SERVE_PAD + LM_NEW)
        one = [st._replace(sdsa=type(st.sdsa)(
            st.sdsa.status[:, LM_SOLO_SLOT:LM_SOLO_SLOT + 1])) for st in state]
        pool = lm.merge_slot_state(
            lm.init_decode_state(cfg, LM_BATCH, LM_SERVE_PAD + LM_NEW, True,
                                 device=device), one, LM_SOLO_SLOT)
        token = torch.zeros(LM_BATCH, dtype=torch.long, device=device)
        token[LM_SOLO_SLOT] = last[LM_SOLO_SLOT].argmax()
        pos = torch.zeros_like(lengths)
        pos[LM_SOLO_SLOT] = lengths[LM_SOLO_SLOT]
        solo_gen, _ = lm_decode(torch, cfg, params, pool, token, pos)
        # prefill against prefill_chunked on equal-length prompts
        eq = tokens[:, :LM_SERVE_PAD // 2]
        with capture_fires(torch, dispatch) as full_fires:
            full = lm.prefill(cfg, params, eq, True)
        with capture_fires(torch, dispatch) as step_fires:
            streamed, _ = lm.prefill_chunked(
                cfg, params, eq, torch.full_like(lengths, eq.shape[1]), True,
                eq.shape[1])
        torch.cuda.synchronize()
    emit("lm_decode_breakdown", **forward_breakdown(
        torch, lambda: lm.decode_step(cfg, params, pool, token, pos, True)))
    per = len(full_fires)
    drift = [(torch.stack(step_fires[c::per], dim=2) != full_fires[c])
             .float().mean().item() for c in range(per)]
    check(torch.equal(solo_gen[LM_SOLO_SLOT], gen[LM_SOLO_SLOT]),
          f"slot {LM_SOLO_SLOT} decoded alone gives other tokens than in "
          f"the pool")
    check(bool((gen >= 0).all()) and gen.shape == (LM_BATCH, 1 + LM_NEW),
          "serve produced no tokens")
    emit("lm_serve", slots=LM_BATCH, prompt_lengths=lengths_np.tolist(),
         new_tokens=LM_NEW, kernel_serve_s=kernel_s,
         prefill_chunked_launches=chunked, decode_launches=per_step[0],
         solo_slot=LM_SOLO_SLOT, solo_equal=True,
         tokens_equal_ref_share=(gen == ref_gen).float().mean().item(),
         prefill_vs_chunked=dict(
             tokens=int(eq.shape[1]),
             max_abs_dlogits=(full - streamed).abs().max().item(),
             max_abs_logits=full.abs().max().item(),
             max_layer_spike_drift=max(max(d.values()) for d in per_layer(
                 drift, cfg.n_layers))))
    return {k: chunked[k] + sum(c[k] for c in per_step) for k in chunked}


def phase_lm(torch, device, results):
    """Phase (k): the spiking LM on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    cfg = get_config(LM_ARCH)
    phase_lm_kernels(torch, device, results)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    emit("lm_setup", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=lm.param_count(cfg), init_s=time.perf_counter() - t0,
         allow_bf16_reduced_precision_reduction=torch.backends.cuda.matmul
         .allow_bf16_reduced_precision_reduction,
         resolved={op: dispatch.resolved_backends(device)[op]
                   for op in ("lif_scan", "causal_sdsa")})
    totals = {name: 0 for name in LM_KERNELS}
    for name, n in phase_lm_prefill(torch, device, cfg, params).items():
        if name in totals:
            totals[name] += n
    for name, n in phase_lm_serve(torch, device, cfg, params).items():
        if name in totals:
            totals[name] += n
    return totals


# ------------------------------------------------------------ phase (l)
# Hybrid dispatch's CUDA-graph check: an (8, 48) tile grid, (1024 x 6144)
# x (6144 x 384), where the calibrated predicate routes the first buckets
# of `spike_matmul` to the event walk and the rest to kernel 10 (at the
# models' grids it picks kernel 10 in every bucket, PERF.md section 6).
HYBRID_GRAPH_SHAPE = (1024, 6144, 384)
HYBRID_MODELS = ("spikingformer", "vgg11", "resnet18")


@contextlib.contextmanager
def hybrid_calls(dispatch):
    """Records (op, map, attribution) of every hybrid resolution while
    active: references only, nothing is read on the host."""
    calls = []
    orig = dispatch._hybrid_resolution

    def record(spec, op, kwargs, reason_of):
        got = orig(spec, op, kwargs, reason_of)
        if got is not None:
            calls.append((op, kwargs["occupancy"], got[1]))
        return got
    dispatch._hybrid_resolution = record
    try:
        yield calls
    finally:
        dispatch._hybrid_resolution = orig


def hybrid_routes(calls) -> list:
    """Each recorded call's op, tile grid, occupied tiles, bucket,
    threshold and the route its flag picked (read from the maps on the
    host, after the run)."""
    from repro_torch.core import costmodel
    out = []
    for op, occ, attr in calls:
        mt, kt = occ.shape
        count = int((occ > 0).sum())
        bucket = costmodel.pow2_bucket(count)
        thresh = costmodel.hybrid_event_bucket_threshold(op, mt, kt)
        out.append(dict(op=op, grid=[mt, kt], occupied=count, bucket=bucket,
                        threshold=thresh, attribution=attr,
                        route="cuda" if bucket <= thresh else "cuda-pred"))
    return out


def route_summary(routes) -> dict:
    """Calls per (op, grid, route, bucket), in the order first seen."""
    summary: dict = {}
    for r in routes:
        key = f"{r['op']} {r['grid'][0]}x{r['grid'][1]} {r['route']} " \
              f"b{r['bucket']}/t{r['threshold']}"
        summary[key] = summary.get(key, 0) + 1
    return summary


def sync_count(torch, fn) -> int:
    """Host syncs `fn` makes (`torch.cuda.set_sync_debug_mode("warn")`)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in got)


def hybrid_model_forwards(torch, device):
    """(name, forward(hybrid) -> (logits, spikes)) of SpikingFormer-4-384
    on phase (c)'s first batch and VGG11 / ResNet18 on phase (h)'s."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.models import spikingformer as sf
    params = sf.spikingformer_init(
        DEPTH, DIM, generator=torch.Generator().manual_seed(SEED),
        device=device)
    x = torch.rand((B, 32, 32, 3),
                   generator=torch.Generator().manual_seed(SEED + 1)
                   ).to(device)

    def sf_forward(hybrid):
        cfg = SpikingConfig(t_steps=T, lif_vth=V_TH, hybrid=hybrid)
        with torch.inference_mode():
            return sf.spikingformer_apply(params, x, n_heads=HEADS,
                                          spiking_cfg=cfg,
                                          collect_stats=True)
    models = [("spikingformer", sf_forward)]
    for name in HYBRID_MODELS[1:]:
        _, forward, batch = cnn_setup(torch, name, device)
        xb = batch(0)

        def cnn_forward(hybrid, forward=forward, xb=xb):
            with torch.inference_mode():
                return forward(xb, collect_stats=True, hybrid=hybrid)
        models.append((name, cnn_forward))
    return models


def phase_hybrid_models(torch, device):
    """Each model under `SpikingConfig(hybrid=True)` against its automatic
    forward: logits and every layer's spikes bit for bit, the host syncs
    of each (equal), the launches, each call's route and bucket, and the
    two spans in turns."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    totals: dict = {}
    for name, forward in hybrid_model_forwards(torch, device):
        reset_launch_counts()
        torch.cuda.synchronize()
        auto = forward(False)
        torch.cuda.synchronize()
        auto_counts = launch_counts()
        reset_launch_counts()
        with hybrid_calls(dispatch) as calls:
            hyb = forward(True)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        check(torch.equal(hyb[0], auto[0]),
              f"{name}: hybrid logits differ from the automatic forward's")
        check(len(hyb[1]) == len(auto[1]) and all(
            torch.equal(a, b) for a, b in zip(hyb[1], auto[1])),
              f"{name}: hybrid spikes differ from the automatic forward's")
        syncs = {"auto": sync_count(torch, lambda: forward(False)),
                 "hybrid": sync_count(torch, lambda: forward(True))}
        check(syncs["hybrid"] == syncs["auto"],
              f"{name}: hybrid forward makes {syncs['hybrid']} host syncs, "
              f"the automatic one {syncs['auto']}")
        auto_ms, hybrid_ms = turns_ms(torch, lambda: forward(False),
                                      lambda: forward(True))
        routes = hybrid_routes(calls)
        emit("hybrid_forward", model=name, equal_bits=True,
             launches={k: v for k, v in counts.items() if v},
             auto_launches={k: v for k, v in auto_counts.items() if v},
             host_syncs=syncs, span_ms=hybrid_ms, auto_span_ms=auto_ms,
             hybrid_calls=len(routes), routes=route_summary(routes))
    return totals


def phase_hybrid_graph(torch, device):
    """One CUDA graph of a hybrid `spike_matmul` at HYBRID_GRAPH_SHAPE,
    replayed on a sparse map, a full map and the sparse map again: the
    device flags equal `event_route_wins` for each map and the output the
    plain version's within 1e-5 * max|ref| + 1e-5. Then the gated kernel
    11 alone at the same shape, gate on and off, in a CUDA graph each:
    the gated-off launch's device ms is what a hybrid call pays for the
    route it does not take."""
    from repro_torch.core import costmodel
    from repro_torch.core.spikes import build_csr
    from repro_torch.kernels import dispatch, ops, spike_matmul
    m, k, n = HYBRID_GRAPH_SHAPE
    mt, kt = -(-m // 128), -(-k // 128)
    thresh = costmodel.hybrid_event_bucket_threshold("spike_matmul", mt, kt)
    check(0 <= thresh < costmodel.num_buckets(mt * kt) - 1,
          f"spike_matmul's threshold {thresh} at {mt}x{kt} routes every "
          f"bucket one way")
    gen = torch.Generator().manual_seed(SEED + 27)
    w = torch.randn((k, n), generator=gen).to(device)

    def spikes(n_live):
        live = torch.zeros(mt * kt, dtype=torch.bool)
        live[torch.randperm(mt * kt, generator=gen)[:n_live]] = True
        mask = live.reshape(mt, kt).repeat_interleave(128, 0) \
            .repeat_interleave(128, 1)
        return (mask & (torch.rand((m, k), generator=gen) < 0.5)).float() \
            .to(device)
    maps = {"sparse": spikes(1), "full": spikes(mt * kt)}
    s = maps["sparse"].clone()
    occ = ops.padded_occupancy(s)
    with dispatch.use_hybrid():
        be, attr = dispatch.resolve_with_attribution("spike_matmul", s, w,
                                                     occupancy=occ)
    check(attr == f"{dispatch.HYBRID}[{dispatch.CUDA}|{dispatch.CUDA_PRED}"
          f"@b{thresh}]", f"hybrid graph call attributed {attr}")
    held = {}

    def call():
        held["flags"] = ops.hybrid_route(occ, thresh)
        held["out"] = be.fn(s, w, occupancy=occ)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph):
        call()
    replays = []
    for label in ("sparse", "full", "sparse"):
        src = maps[label]
        s.copy_(src)
        occ.copy_(ops.padded_occupancy(src))
        graph.replay()
        torch.cuda.synchronize()
        count = int((occ > 0).sum())
        bucket = costmodel.pow2_bucket(count)
        event = costmodel.event_route_wins(
            "spike_matmul", costmodel.bucket_representative(bucket, mt * kt),
            mt, kt)
        flags = held["flags"].tolist()
        check(flags == [int(event), int(not event)],
              f"graph replay on the {label} map: device flags {flags}, "
              f"host decision event={event}")
        ref = spike_matmul.spike_matmul_pred_plain(src, w, occ)
        err = (held["out"] - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item() + 1e-5
        check(err <= tol, f"graph replay on the {label} map off by {err}")
        replays.append(dict(map=label, occupied=count, bucket=bucket,
                            event_route=event, flags=flags,
                            max_abs_err=err, tolerance=tol))
    check(replays[0]["event_route"] != replays[1]["event_route"],
          "the graph's two maps take the same route")
    csr = build_csr(occ, 128, 128)
    out = torch.empty((m, n), device=device)
    gate = torch.tensor([1, 0], dtype=torch.int32, device=device)
    gated = {label: graph_ms(torch, functools.partial(
        spike_matmul.spike_matmul_csr, s, w, csr, route=gate[i:i + 1],
        out=out)) for i, label in enumerate(("on", "off"))}
    emit("hybrid_graph", shape=[m, k, n], grid=[mt, kt], threshold=thresh,
         attribution=attr, replays=replays,
         gated_on_device_ms=gated["on"], gated_off_device_ms=gated["off"])


def phase_hybrid_apec(torch, cap):
    """`core.apec.apec_matmul` under `use_hybrid` (g = 2) on phase (i)'s
    FFN inputs and stage-1 patch matrix with their carried maps: within
    1e-5 * max|ref| + 1e-5 of the CSR route (kernel 17) on the same
    spikes, with each call's route and bucket."""
    from repro_torch.core import apec
    from repro_torch.core.events import EventTensor
    from repro_torch.kernels import dispatch, launch_counts, ops, \
        reset_launch_counts
    (s1, w1, m1), (s2, w2, m2) = cap["spike_matmul"][:2]
    s_conv, w_conv, m_conv = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    patches = dispatch.econv_patches(s_conv, kh, kw, 1, "SAME")
    totals: dict = {}
    for label, s, occ, w in (
            ("ffn_fc1", s1, m1, w1), ("ffn_fc2", s2, m2, w2),
            ("econv_stage1", patches, m_conv,
             w_conv.permute(2, 0, 1, 3).reshape(ci * kh * kw, co)
             .contiguous())):
        reset_launch_counts()
        torch.cuda.synchronize()
        with torch.inference_mode(), dispatch.use_hybrid(), \
                hybrid_calls(dispatch) as calls:
            out = apec.apec_matmul(EventTensor(s, occ), w, g=2)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        with torch.inference_mode():
            ref = ops.apec_matmul_csr(s, w, 2, occupancy=occ)
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item() + 1e-5
        check(err <= tol, f"hybrid APEC at {label} off the CSR route by "
              f"{err} > {tol}")
        emit("hybrid_apec", case=label, shape=[*s.shape, w.shape[1]],
             max_abs_err=err, tolerance=tol,
             launches={k: v for k, v in counts.items() if v},
             routes=hybrid_routes(calls))
    return totals


def phase_hybrid_train(torch, device):
    """One SpikingFormer-4-384 training step under `hybrid=True` against
    the automatic step on the same parameters and batch (cuDNN
    deterministic): the loss and every gradient leaf bit for bit."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.optim import adamw
    batch = train_batch(torch, 0, device)
    steps = {}
    for hybrid in (False, True):
        params = fresh_params(torch, device)
        opt = adamw.init(params, adamw.AdamWConfig(lr=LR))
        cfg = SpikingConfig(t_steps=T, lif_vth=V_TH, hybrid=hybrid)
        loss, grads, _ = train_step(torch, params, opt, batch, cfg)
        torch.cuda.synchronize()
        steps[hybrid] = (loss, grads)
    (l_auto, g_auto), (l_hyb, g_hyb) = steps[False], steps[True]
    check(torch.equal(l_auto, l_hyb), f"hybrid step loss {l_hyb.item()} != "
          f"{l_auto.item()}")
    check(all(torch.equal(a, b) for a, b in zip(g_auto, g_hyb)),
          "hybrid step gradients differ from the automatic step's")
    emit("hybrid_train_step", loss=l_hyb.item(), equal_bits=True,
         leaves=len(g_hyb))


def phase_hybrid_kernel10(torch, cap):
    """Kernel 10 where hybrid sends the models' dense calls: the
    SpikingFormer-4-384 forward's FFN fc1 and fc2 inputs and its stage-1
    patch matrix with their carried maps (N = 1536, 384, 96: the wide
    path). Each: within 1e-5 * max|ref| + 1e-5 of its plain version and
    equal bit for bit to kernels 11 and 12 on the same spikes and
    `build_csr` of the map; device ms from a CUDA graph of kernels 10, 11
    and 12 and cuBLAS fp32 in turns (10, 11, 12, cuBLAS, then back), and
    the bound."""
    from repro_torch.core.spikes import build_csr
    from repro_torch.kernels import dispatch, spike_matmul
    (s1, w1, m1), (s2, w2, m2) = cap["spike_matmul"][:2]
    s_conv, w_conv, m_conv = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    patches = dispatch.econv_patches(s_conv, kh, kw, 1, "SAME")
    for label, s, occ, w in (
            ("ffn_fc1", s1, m1, w1), ("ffn_fc2", s2, m2, w2),
            ("econv_stage1", patches, m_conv,
             w_conv.permute(2, 0, 1, 3).reshape(ci * kh * kw, co)
             .contiguous())):
        s = s.reshape(-1, s.shape[-1]).float().contiguous()
        w = w.float().contiguous()
        occ = occ.to(torch.int32).contiguous()
        m, k = s.shape
        n = w.shape[1]
        csr = build_csr(occ, 128, 128)
        fns = {"k10": functools.partial(spike_matmul.spike_matmul_pred, s, w,
                                        occ),
               "k11": functools.partial(spike_matmul.spike_matmul_csr, s, w,
                                        csr),
               "k12": functools.partial(spike_matmul.spike_matmul_csr_pipe, s,
                                        w, csr),
               "cublas": functools.partial(torch.matmul, s, w)}
        out = fns["k10"]()
        ref = spike_matmul.spike_matmul_pred_plain(s, w, occ)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item() + 1e-5
        check(err <= tol, f"kernel 10 at {label} off by {err} > {tol}")
        check(torch.equal(out, fns["k11"]()) and torch.equal(out, fns["k12"]()),
              f"kernel 10 differs from kernels 11 / 12 at {label}")
        first = {name: graph_ms(torch, fn) for name, fn in fns.items()}
        second = {name: graph_ms(torch, fn)
                  for name, fn in reversed(list(fns.items()))}
        ms = {name: (first[name] + second[name]) / 2 for name in fns}
        flops, n_bytes = csr_work(torch, occ, m, k, n)
        n_bytes += occ.numel() * 4
        rec = dict(max_abs_err=err, tolerance=tol, ms=ms["k10"],
                   plain_ms=cuda_ms(torch, functools.partial(
                       spike_matmul.spike_matmul_pred_plain, s, w, occ),
                       reps=5),
                   **spike_bounds(n_bytes, live_nonzeros(torch, s, occ), n,
                                  flops),
                   library_ms=ms["cublas"], kernel11_ms=ms["k11"],
                   kernel12_ms=ms["k12"],
                   occupied_share=(occ > 0).float().mean().item(),
                   shape=[m, k, n])
        emit("kernel", name="spike_matmul_pred", case=f"{label}_model",
             **rec)


def phase_hybrid(torch, device):
    """(l) hybrid dispatch on the card: the models, the CUDA graph, APEC,
    one training step, and kernel 10 at the models' dense shapes."""
    totals = phase_hybrid_models(torch, device)
    phase_hybrid_graph(torch, device)
    cap = apec_capture(torch, device)
    for k, v in phase_hybrid_apec(torch, cap).items():
        totals[k] = totals.get(k, 0) + v
    phase_hybrid_kernel10(torch, cap)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        phase_hybrid_train(torch, device)
    finally:
        torch.backends.cudnn.deterministic = was
    return totals


# ------------------------------------------------------------ phase (m)
# The serve scheduler (`launch/serve.py`) at TinyLlama-1.1B width: 8
# requests of 5-16 `markov_tokens` prompt tokens, SERVE_NEW new tokens
# each, admitted in waves (submit n, then step s times) while earlier
# ones decode, then drained.
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_NEW = 8, 256, 16
SERVE_PROMPT_LENGTHS = (5, 16)
SERVE_WAVES = ((3, 2), (3, 1), (2, 0))     # (requests submitted, steps)
SERVE_SOLO = (0, 5)
SERVE_POISONED = 5
# Blockwise against one-block dense attention at the model's attention
# shape, bf16. The two forms round the softmax weights to bf16 at
# different points (each block's unnormalised weights, against the
# normalised row): 2^-9 relative on every weight, on bf16 outputs (2^-8)
# that then go through the 2048-wide output projection in bf16.
# BF16_TOL of tests/test_torch_lm.py (one bf16 rounding apart, after
# sums in other orders), of max|one block|.
DENSE_ATTN_SHAPE = (2, 2048)                # (B, N) at d 2048, 32 / 4 heads
DENSE_ATTN_TOL = 2e-2


def serve_requests(cfg):
    """(prompt, max_new) of the 8 requests, from SEED."""
    import numpy as np
    from repro_torch.data.synthetic import markov_tokens
    lo, hi = SERVE_PROMPT_LENGTHS
    lengths = np.random.default_rng(SEED).integers(lo, hi + 1, SERVE_SLOTS)
    toks = markov_tokens(SEED + 2, 0, 0, SERVE_SLOTS, hi, cfg.vocab)
    return [([int(t) for t in toks[i, :n]], SERVE_NEW)
            for i, n in enumerate(lengths)]


def instrument(torch, server, log: list) -> None:
    """Wrap the server's decode step and admission prefill: each call
    appends (kind, bucket, the launches it made, wall seconds to its
    result). Reads the counters only; the run's reset is the caller's."""
    from repro_torch.kernels import launch_counts

    def wrap(kind, fn):
        def run(params, *args):
            before = launch_counts()
            t0 = time.perf_counter()
            out = fn(params, *args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = launch_counts()
            bucket = int(args[0].shape[1]) if kind == "prefill" else None
            log.append((kind, bucket,
                        {k: after[k] - before[k] for k in after}, dt))
            return out
        return run
    server._step = wrap("step", server._step)
    server._prefill = wrap("prefill", server._prefill)


def drive(torch, server, reqs, poison=None, waves=SERVE_WAVES) -> float:
    """`waves`' staggered admission, then drain: wall seconds. With
    `poison` (a request index), that request's slot state is NaN'd after
    the second wave's steps, while it decodes."""
    from repro_torch.runtime import faults
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at = 0
    for n, steps in waves:
        for r in reqs[at:at + n]:
            server.submit(r)
        at += n
        for _ in range(steps):
            server.step()
        if poison is not None and poison < at and \
                reqs[poison] in server.slot_req:
            slot = server.slot_req.index(reqs[poison])
            server.state = faults.nan_decode_state(server.state, slot=slot)
            poison = None
    server.run_until_drained()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serve_run(torch, cfg, spiking, device, traffic, only=None, poison=None,
              backend=None, slots=SERVE_SLOTS, waves=SERVE_WAVES):
    """One Server of `slots` slots over `traffic` (or over the requests
    `only` of it, alone): (server, requests, call log, wall s, launches of
    the run). The launch counters are set to 0 just before the run and
    read just after it."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.launch.serve import Request, Server
    server = Server(cfg, n_slots=slots, max_seq=SERVE_MAX_SEQ,
                    spiking=spiking, seed=SEED, device=device)
    reqs = [Request(rid=i, prompt=list(p), max_new=m)
            for i, (p, m) in enumerate(traffic)]
    if only is not None:
        reqs = [reqs[i] for i in only]
    log: list = []
    instrument(torch, server, log)
    with contextlib.ExitStack() as stack:
        if backend is not None:
            stack.enter_context(dispatch.use_backend(backend))
        reset_launch_counts()
        if only is None:
            wall = drive(torch, server, reqs, poison, waves)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                server.submit(r)
            server.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launch_counts()
    return server, reqs, log, wall, counts


def clean_run_checks(server, reqs, log, counts, spiking, what,
                     per_step=None) -> None:
    """Every request done with its tokens, no retry and no cause; no slot
    or request left; one admission each; exactly the fire launches a
    decode step and an admission make (`per_step`, LM_DECODE_LAUNCHES
    unless given; none in dense mode), and none outside the server's
    calls."""
    for r in reqs:
        check(r.state == "done" and r.retries == 0 and
              r.failure_cause is None and len(r.generated) == r.max_new,
              f"{what}: request {r.rid} ended {r.state}, {r.retries} "
              f"retries, cause {r.failure_cause}, {len(r.generated)} tokens")
    check(all(s is None for s in server.slot_req) and not server.pending
          and not server.arrivals, f"{what}: a slot or request is left")
    check(server.prefills_executed == len(reqs),
          f"{what}: {server.prefills_executed} prefills for {len(reqs)}")
    per_step = (per_step or LM_DECODE_LAUNCHES) if spiking else {}
    for kind, bucket, delta, _ in log:
        want = per_step if kind == "step" else \
            {k: v * bucket for k, v in per_step.items()}
        lm_launch_check(delta, want, f"{what} {kind}")
    total = {k: sum(d[k] for _, _, d, _ in log) for k in counts}
    check(counts == total, f"{what}: launches outside the server's calls")
    if spiking:
        check(counts["lif_bf16"] > 0, f"{what}: the fire kernel never ran")


def spans(log) -> dict:
    """Mean decode-step and admission spans (wall ms to the result)."""
    steps = [dt for kind, _, _, dt in log if kind == "step"]
    by_bucket: dict = {}
    for kind, bucket, _, dt in log:
        if kind == "prefill":
            by_bucket.setdefault(str(bucket), []).append(dt * 1e3)
    return dict(decode_steps=len(steps),
                mean_decode_step_ms=sum(steps) / len(steps) * 1e3,
                admission_prefill_ms={b: sum(v) / len(v)
                                      for b, v in by_bucket.items()},
                admissions_by_bucket={b: len(v) for b, v in by_bucket.items()})


def phase_serve_mode(torch, cfg, device, traffic, spiking, card):
    """One mode of (m): the staggered traffic on the kernels (gated), the
    requests SERVE_SOLO each alone in a SERVE_SLOTS-slot server (its
    tokens bit for bit), and, spiking, the same traffic on `ref`
    (reported). Returns (pool server, its requests, launches)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    mode = "spiking" if spiking else "dense"
    server, reqs, log, wall, counts = serve_run(torch, cfg, spiking, device,
                                                traffic)
    clean_run_checks(server, reqs, log, counts, spiking, mode)
    for i in SERVE_SOLO:
        s, (r,), slog, _, scounts = serve_run(torch, cfg, spiking, device,
                                              traffic, only=(i,))
        clean_run_checks(s, [r], slog, scounts, spiking, f"{mode} solo {i}")
        check(r.generated == reqs[i].generated,
              f"{mode}: request {i} alone gives other tokens than in the "
              f"pool")
        counts = {k: counts[k] + scounts[k] for k in counts}
    ref_share = None
    if spiking:
        _, ref_reqs, _, _, _ = serve_run(torch, cfg, spiking, device,
                                         traffic, backend=dispatch.REF)
        same = [a == b for r, q in zip(reqs, ref_reqs)
                for a, b in zip(r.generated, q.generated)]
        ref_share = sum(same) / len(same)
    new_tokens = sum(len(r.generated) for r in reqs)
    step_launches = next(d for k, _, d, _ in log if k == "step")
    emit("serve_sched", card=card, mode=mode, slots=SERVE_SLOTS,
         max_seq=SERVE_MAX_SEQ, requests=len(reqs),
         prompt_lengths=[len(r.prompt) for r in reqs], new_tokens=new_tokens,
         wall_s=wall, tokens_per_s=new_tokens / wall, **spans(log),
         fire_launches_per_decode_step=step_launches["lif_bf16"],
         kv_cache_bytes=sum(t.numel() * t.element_size()
                            for st in server.state if st.kv is not None
                            for t in st.kv),
         solo_requests=list(SERVE_SOLO), solo_equal=True,
         tokens_equal_ref_share=ref_share,
         tokens=[r.generated for r in reqs])
    # One decode step of the drained pool (every slot at position 20):
    # device span against the host's enqueue.
    emit("serve_decode_breakdown", card=card, mode=mode,
         **forward_breakdown(torch, lambda: lm.decode_step(
             cfg, server.params, server.state,
             torch.zeros(SERVE_SLOTS, dtype=torch.long, device=device),
             torch.full((SERVE_SLOTS,), 20, device=device), spiking)))
    return server, reqs, counts


def phase_serve_quarantine(torch, cfg, device, traffic, clean, card):
    """Request SERVE_POISONED's slot NaN'd mid-stream: it retries and ends
    done with the tokens it gives alone (= in the clean pool); the other
    requests run with no retry."""
    server, reqs, _, wall, counts = serve_run(
        torch, cfg, True, device, traffic, poison=SERVE_POISONED)
    bad = reqs[SERVE_POISONED]
    want = clean[SERVE_POISONED].generated
    check(bad.retries >= 1 and bad.failure_cause == "nan_logits" and
          bad.state == "done" and bad.generated == want,
          f"quarantine: request {SERVE_POISONED} ended {bad.state} after "
          f"{bad.retries} retries ({bad.failure_cause}), its solo tokens: "
          f"{bad.generated == want}")
    for r in reqs:
        check(r.state == "done" and (r is bad or r.retries == 0),
              f"quarantine: request {r.rid} ended {r.state} after "
              f"{r.retries} retries")
    check(all(s is None for s in server.slot_req),
          "quarantine: a slot is left")
    emit("serve_quarantine", card=card, request=SERVE_POISONED,
         retries=bad.retries, cause=bad.failure_cause, wall_s=wall,
         prefills=server.prefills_executed,
         requests_equal_clean_share=sum(
             r.generated == c.generated for r, c in zip(reqs, clean))
         / len(reqs), fire_launches=counts["lif_bf16"])
    return counts


def phase_serve_replicas(torch, cfg, device, traffic, card):
    """Two replicas: replica 0 preloaded with two requests and stepped;
    the next request goes to replica 1; every request ends done."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import ReplicaPool, Request
    pool = ReplicaPool(cfg, n_replicas=2, n_slots=2, max_seq=SERVE_MAX_SEQ,
                       spiking=True, seed=SEED, device=device)
    reqs = [Request(rid=i, prompt=list(p), max_new=m)
            for i, (p, m) in enumerate(traffic[:3])]
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs[:2]:
        pool.replicas[0].submit(r)
    pool.replicas[0].step()
    loads = [dataclasses.asdict(r.occupancy_load()) for r in pool.replicas]
    idx = pool.submit(reqs[2])
    pool.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(idx == 1, f"replica pool sent the request to replica {idx}")
    check(len(pool.finished) == 3 and
          all(r.state == "done" for r in pool.finished),
          "replica pool: a request did not finish")
    check(counts["lif_bf16"] > 0, "replica pool: the fire kernel never ran")
    emit("serve_replicas", card=card, replicas=2, slots=2, steered_to=idx,
         loads_at_dispatch=loads,
         imbalance=pool.imbalance_log[-1].imbalance, wall_s=wall,
         fire_launches=counts["lif_bf16"])
    return counts


def phase_dense_attention(torch, cfg, params, device, card):
    """Blockwise (kv_block 1024) against one-block dense attention at the
    model's attention shape, causal, and with a 512 window that hides the
    first KV block from the last rows (the recurrence's -inf guard); then
    a dense prefill of 8 x 1024 tokens, in turns with the spiking one."""
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.models import lm, transformer as tfm
    from repro_torch.models.layers import rmsnorm
    b, n = DENSE_ATTN_SHAPE
    toks = torch.from_numpy(markov_tokens(SEED + 3, 0, 0, b, n, cfg.vocab)
                            [:, :n]).long().to(device)
    blk = lm._group(params["blocks"][0], 0)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
              rope_theta=cfg.rope_theta, causal=True)
    cases = []
    with torch.inference_mode():
        x = rmsnorm(blk["ln1"], params["embed"][toks])
        for window in (None, 512):
            def attend(kv_block):
                return tfm.attention_dense(blk["attn"], x, window=window,
                                           kv_block=kv_block, **kw)
            blockwise, one = attend(1024), attend(4096)
            torch.cuda.synchronize()
            diff = (blockwise.float() - one.float()).abs()
            scale = one.float().abs().max().item()
            err = diff.max().item()
            check(bool(torch.isfinite(blockwise).all()) and
                  err <= DENSE_ATTN_TOL * scale,
                  f"dense attention, window {window}: blockwise differs "
                  f"from one block by {err} (max|ref| {scale})")
            cases.append(dict(
                window=window, max_abs_err=err, max_abs_ref=scale,
                tol=DENSE_ATTN_TOL * scale, mean_abs_err=diff.mean().item(),
                blockwise_ms=cuda_ms(torch, lambda: attend(1024), reps=3,
                                     warmup=1),
                one_block_ms=cuda_ms(torch, lambda: attend(4096), reps=3,
                                     warmup=1)))
        emit("dense_attention", card=card, shape=[b, n, cfg.d_model],
             heads=[cfg.n_heads, cfg.n_kv_heads], dtype=str(x.dtype),
             kv_blocks=[1024, 4096], cases=cases)
        tokens = torch.from_numpy(markov_tokens(
            SEED, 0, 0, LM_BATCH, LM_PROMPT, cfg.vocab)[:, :LM_PROMPT]) \
            .long().to(device)
        logits = lm.prefill(cfg, params, tokens, False)
        torch.cuda.synchronize()
        check(tuple(logits.shape) == (LM_BATCH, cfg.vocab) and
              bool(torch.isfinite(logits).all()),
              "dense prefill logits not finite")

        def prefill_s(spiking):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.prefill(cfg, params, tokens, spiking)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        turns = [prefill_s(True), prefill_s(False), prefill_s(False),
                 prefill_s(True)]
    emit("lm_prefill_dense", card=card, batch=LM_BATCH, tokens=LM_PROMPT,
         dense_prefill_s=(turns[1] + turns[2]) / 2,
         spiking_prefill_s=(turns[0] + turns[3]) / 2, in_turns_s=turns,
         breakdown=forward_breakdown(
             torch, lambda: lm.prefill(cfg, params, tokens, False)))


def phase_serve(torch, device, card):
    """Phase (m): the serve scheduler at TinyLlama-1.1B width in both
    modes, quarantine, replicas, and dense attention at the model's
    shape. Returns the LM kernels' launches on the serve paths."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(LM_ARCH)
    traffic = serve_requests(cfg)
    totals = {name: 0 for name in LM_KERNELS}

    def add(counts):
        for name in totals:
            totals[name] += counts[name]
    _, clean, counts = phase_serve_mode(torch, cfg, device, traffic, True,
                                        card)
    add(counts)
    dense, _, counts = phase_serve_mode(torch, cfg, device, traffic, False,
                                        card)
    check(not any(counts.values()), f"dense serving launched {counts}")
    add(phase_serve_quarantine(torch, cfg, device, traffic, clean, card))
    add(phase_serve_replicas(torch, cfg, device, traffic, card))
    phase_dense_attention(torch, cfg, dense.params, device, card)
    return totals


# ------------------------------------------------------------ phase (n)
LM_TRAIN_KERNELS = ("lif_fwd_bf16", "lif_bwd_bf16")
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 128, 3
# (n4): the reduced config's resume check, steps and save interval.
LM_RESUME_STEPS, LM_RESUME_EVERY = 6, 2
# Same inputs and cotangent, one op's backward on the LM's bf16 fires:
# the kernel's dv and `ref`'s f32 autograd associate the reset term
# differently (SAME_INPUT_GRAD_TOL's 1e-5), then each rounds dx to bf16
# once, so where the two straddle a rounding boundary they land one bf16
# ulp apart: at most 2^-7 of the element (8 significant bits). causal
# SDSA's kernel backend replays `ref` itself.
LM_SAME_INPUT_GRAD_TOL = {"lif_scan": 2.0 ** -7 + 1e-5, "causal_sdsa": 0.0}
# The fire drives of rows 2 and 3 bf16 (T = 2): the training step's MLP
# hidden fire and a d-2048 fire (ln1, ln2) at B = 8, N = 128, (k1)'s
# prefill hidden drive, and a ragged P behind a 2-byte offset.
LM_TRAIN_DRIVES = (("train_hidden", LM_TRAIN_BATCH * LM_TRAIN_SEQ * 5632),
                   ("train_d2048", LM_TRAIN_BATCH * LM_TRAIN_SEQ * 2048),
                   ("prefill_hidden", LM_BATCH * LM_PROMPT * 5632),
                   ("ragged_offset1", 100003))


def lm_train_launches(cfg) -> dict:
    """Kernel launches a spiking training step makes, from the model's
    code: each layer fires FIRE_NAMES through the residual kernel and
    runs one causal SDSA; `remat` "full" or "dots" runs the forward again
    in the backward; every fire's surrogate backward runs once, SDSA's
    backward replays `ref` (no launch). No primal fire."""
    again = 1 if cfg.remat == "none" else 2
    fires = len(FIRE_NAMES) * cfg.n_layers
    return {"lif_fwd_bf16": again * fires, "lif_bwd_bf16": fires,
            "sdsa_causal": again * cfg.n_layers}


def phase_lm_train_kernels(torch, device, results):
    """(n1): rows 2 and 3 on bf16 drives against their plain versions,
    bit for bit (spikes, vres, dx), with times and byte bounds."""
    from repro_torch.kernels import lif_scan
    kw = dict(decay=0.5, v_th=1.0, soft_reset=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    for label, p in LM_TRAIN_DRIVES:
        off = 1 if label.startswith("ragged") else 0
        x = (torch.randn((2 * p + off,), generator=gen, device=device)
             * 0.8 + 0.6).bfloat16()[off:].view(2, p)
        g = torch.randn((2 * p + off,), generator=gen, device=device) \
            .bfloat16()[off:].view(2, p)
        s, vres = lif_scan.lif_fwd(x, **kw)
        dx = lif_scan.lif_bwd(vres, g, **kw)
        ps, pvres = lif_scan.lif_fwd_plain(x, **kw)
        pdx = lif_scan.lif_bwd_plain(pvres, g, **kw)
        torch.cuda.synchronize()
        check(s.dtype == dx.dtype == torch.bfloat16 and
              vres.dtype == torch.float32, f"{label}: dtypes {s.dtype}, "
              f"{vres.dtype}, {dx.dtype}")
        check(torch.equal(s, ps) and torch.equal(vres, pvres),
              f"lif_fwd_bf16 kernel disagrees with its plain version "
              f"({label})")
        check(torch.equal(dx, pdx),
              f"lif_bwd_bf16 kernel disagrees with its plain version "
              f"({label})")
        elems = x.numel()
        for name, fn, plain, flops in (
                ("lif_fwd_bf16", lambda: lif_scan.lif_fwd(x, **kw),
                 lambda: lif_scan.lif_fwd_plain(x, **kw), 5),
                ("lif_bwd_bf16", lambda: lif_scan.lif_bwd(vres, g, **kw),
                 lambda: lif_scan.lif_bwd_plain(vres, g, **kw), 11)):
            # 2 + 2 + 4 bytes an element: fwd reads x, writes s and vres;
            # bwd reads vres and g, writes dx.
            b_ms, by = bound_ms(8 * elems, flops * elems)
            rec = dict(max_abs_err=0.0, ms=cuda_ms(torch, fn),
                       device_ms=graph_ms(torch, fn),
                       plain_ms=cuda_ms(torch, plain, reps=3),
                       bound_ms=b_ms, bound_by=by, library_ms=None,
                       shape=[2, p])
            emit("kernel", name=name, case=label, **rec)
            if label == "train_hidden":
                results[name] = rec


@contextlib.contextmanager
def counted_steps(torch, steps_mod):
    """While active, every step function `make_train_step` returns
    records each call's launches (the counters read before and after
    it) and its metrics."""
    from repro_torch.kernels import launch_counts
    orig = steps_mod.make_train_step
    log: list = []

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def counted(*a):
            before = launch_counts()
            out = step(*a)
            after = launch_counts()
            log.append(({k: after[k] - before[k] for k in after}, out[-1]))
            return out
        return counted

    steps_mod.make_train_step = make
    try:
        yield log
    finally:
        steps_mod.make_train_step = orig


@contextlib.contextmanager
def captured_grads(adamw):
    """While active, the gradients each `adamw.update` call receives."""
    orig = adamw.update
    got: list = []

    def update(grads, *a, **k):
        got.append([g.detach().clone() for g in adamw.leaves(grads)])
        return orig(grads, *a, **k)

    adamw.update = update
    try:
        yield got
    finally:
        adamw.update = orig


def lm_train_step_breakdown(torch, cfg, params, opt, batch):
    """One spiking step as `make_train_step` runs it, its parts bracketed
    by CUDA events: device span, host enqueue, forward (loss) / backward
    (`autograd.grad`) / optimizer ms, and the peak of allocated memory."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    leaves = adamw.leaves(params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev[0].record()
    loss = lm.loss_fn(cfg, params, batch, True)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    adamw.update(list(grads), opt, leaves, adamw.AdamWConfig(lr=LR))
    ev[3].record()
    host_s = time.perf_counter() - t0
    ev[3].synchronize()
    return dict(device_span_ms=ev[0].elapsed_time(ev[3]),
                host_enqueue_ms=host_s * 1e3,
                forward_ms=ev[0].elapsed_time(ev[1]),
                backward_ms=ev[1].elapsed_time(ev[2]),
                optimizer_ms=ev[2].elapsed_time(ev[3]),
                max_memory_allocated=torch.cuda.max_memory_allocated())


def phase_lm_train_loop(torch, device, cfg, card):
    """(n2): `train_loop` at full width on the kernels, gated per step."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train
    from repro_torch.kernels import reset_launch_counts, launch_counts
    per_step = lm_train_launches(cfg)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counted_steps(torch, steps_mod) as log:
        out = train.train_loop(cfg, steps=LM_TRAIN_STEPS,
                               batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                               seed=SEED, log_every=1, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = launch_counts()
    check(len(log) == LM_TRAIN_STEPS, f"train_loop ran {len(log)} steps")
    for i, (counts, metrics) in enumerate(log):
        lm_launch_check(counts, per_step, f"training step {i}")
        check(bool(torch.isfinite(metrics["loss"])) and
              bool(torch.isfinite(metrics["grad_norm"])),
              f"training step {i}: loss {metrics['loss']}, grad norm "
              f"{metrics['grad_norm']}")
    emit("lm_train_loop", card=card, batch=LM_TRAIN_BATCH,
         seq=LM_TRAIN_SEQ, steps=LM_TRAIN_STEPS, remat=cfg.remat,
         wall_s=wall, seconds=out["seconds"], losses=out["losses"],
         grad_norms=[m["grad_norm"].item() for _, m in log],
         launches_per_step=per_step)
    return totals, out


def phase_lm_train_vs_ref(torch, device, cfg, card):
    """(n2): one `make_train_step` step from the same params on the
    kernels and on `ref`: step 0's loss bit for bit, no all-zero gradient
    leaf, the gradients' per-leaf relative L2 gap (printed); every
    registry call's backward against `ref`'s on the same inputs; the
    step's breakdown and the two ways of slicing the stacked layers."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    batch = pipeline.device_put_batch(synthetic.lm_batch(
        SEED, 0, 0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab), device)
    params = lm.init_params(cfg, seed=SEED, device=device)
    names = leaf_names(params)
    save_bytes = sum(t.numel() * t.element_size()
                     for t in adamw.leaves(params)) + \
        2 * 4 * sum(t.numel() for t in adamw.leaves(params)) + 4
    start = [t.clone() for t in adamw.leaves(params)]
    opt_cfg = adamw.AdamWConfig(lr=LR)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg)
    runs = {}
    for backend in (None, dispatch.REF):
        for p, s0 in zip(adamw.leaves(params), start):
            with torch.no_grad():
                p.copy_(s0)
        opt = adamw.init(params, opt_cfg)
        reset_launch_counts()
        with captured_grads(adamw) as grads, \
                (contextlib.nullcontext() if backend is None
                 else dispatch.use_backend(backend)):
            _, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        runs[backend] = (metrics["loss"], grads[0], counts)
        del opt
    loss, grads, counts = runs[None]
    ref_loss, ref_grads, ref_counts = runs[dispatch.REF]
    lm_launch_check(counts, lm_train_launches(cfg), "make_train_step")
    check(not any(ref_counts.values()), f"the ref step launched {ref_counts}")
    for name, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()), f"gradient of {name} not finite")
        check(bool((g != 0).any()), f"gradient of {name} is all zero")
    rel = {n: ((a.float() - r.float()).norm() / (r.float().norm() + 1e-30))
           .item() for n, a, r in zip(names, grads, ref_grads)}
    emit("lm_train_step_vs_ref", card=card, loss=loss.item(),
         ref_loss=ref_loss.item(), loss_equal=bool(torch.equal(loss,
                                                               ref_loss)),
         max_grad_rel_l2=max(rel.values()),
         worst_leaf=max(rel, key=rel.get), grad_rel_l2=rel)
    check(torch.equal(loss, ref_loss),
          f"step 0's loss on the kernels {loss.item()!r} != ref's "
          f"{ref_loss.item()!r}")
    del grads, ref_grads, runs

    for p, s0 in zip(adamw.leaves(params), start):
        with torch.no_grad():
            p.copy_(s0)
    with shadow_vjp(torch, dispatch) as calls:
        loss = lm.loss_fn(cfg, params, batch, True)
        torch.autograd.grad(loss, adamw.leaves(params))
    errs = same_input_vjp_errors(torch, dispatch, calls)
    emit("lm_train_same_input_vjp", card=card,
         calls=sum(1 for c in calls if c[3] is not None), errors=errs,
         limits=LM_SAME_INPUT_GRAD_TOL)
    check(set(errs) == set(LM_SAME_INPUT_GRAD_TOL),
          f"same-input backward check saw ops {sorted(errs)}")
    for op, err in errs.items():
        check(err <= LM_SAME_INPUT_GRAD_TOL[op],
              f"{op}'s backward on the kernels differs from ref's on the "
              f"same inputs by {err} > {LM_SAME_INPUT_GRAD_TOL[op]}")
    del calls, start

    # The step's breakdown, then one step with the stacked layers sliced
    # one by one (`_group`) in turns with `unbind` (`_layer_views`):
    # slicing adds a zero-filled full-size gradient a layer.
    opt = adamw.init(params, opt_cfg)
    emit("lm_train_breakdown", card=card, **lm_train_step_breakdown(
        torch, cfg, params, opt, batch))
    views = lm._layer_views

    def sliced(tree, n):
        return [lm._group(tree, g) for g in range(n)]

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    ms = {"unbind": [], "slice": []}
    for way in ("unbind", "slice", "slice", "unbind"):
        lm._layer_views = views if way == "unbind" else sliced
        try:
            ms[way].append(timed_step())
        finally:
            lm._layer_views = views
    emit("lm_train_layer_views", card=card, step_ms=ms,
         unbind_ms=sum(ms["unbind"]) / 2, slice_ms=sum(ms["slice"]) / 2)
    return save_bytes


def phase_lm_train_dense(torch, device, cfg, card):
    """(n3): one dense step (`spiking=False`) at full width: finite, no
    kernel launch."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    params = lm.init_params(cfg, seed=SEED, device=device)
    opt = adamw.init(params, adamw.AdamWConfig(lr=LR))
    batch = pipeline.device_put_batch(synthetic.lm_batch(
        SEED, 0, 0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab), device)
    step_fn = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                        spiking=False)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, metrics = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = launch_counts()
    check(not any(counts.values()), f"the dense step launched {counts}")
    check(bool(torch.isfinite(metrics["loss"])) and
          bool(torch.isfinite(metrics["grad_norm"])),
          f"dense step: loss {metrics['loss']}")
    emit("lm_train_dense", card=card, loss=metrics["loss"].item(),
         grad_norm=metrics["grad_norm"].item(), step_s=step_s)


def phase_lm_train_resume(torch, device, save_bytes, card):
    """(n4): the reduced config's `train_loop` saving every 2 steps, its
    newest checkpoint deleted, resumed: the resumed steps' losses equal
    the uninterrupted run's bit for bit."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_reduced
    from repro_torch.launch import train
    cfg = get_reduced(LM_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        kw = dict(steps=LM_RESUME_STEPS, batch=LM_TRAIN_BATCH,
                  seq=LM_TRAIN_SEQ, seed=SEED, ckpt_dir=tmp,
                  save_every=LM_RESUME_EVERY, log_every=LM_RESUME_STEPS,
                  device=device)
        full = train.train_loop(cfg, **kw)
        saved = sorted(os.listdir(tmp))
        newest = saved[-1]
        shutil.rmtree(os.path.join(tmp, newest))
        resumed = train.train_loop(cfg, resume=True, **kw)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    start = LM_RESUME_STEPS - len(resumed["losses"])
    emit("lm_train_resume", card=card, arch=cfg.name, checkpoints=saved,
         deleted=newest, resumed_from=start, losses=full["losses"],
         resumed_losses=resumed["losses"],
         full_width_save_bytes=save_bytes)
    check(start == LM_RESUME_STEPS - LM_RESUME_EVERY,
          f"resumed from step {start}")
    check(resumed["losses"] == full["losses"][start:],
          f"resumed losses {resumed['losses']} != "
          f"{full['losses'][start:]}")
    check(not os.path.exists(tmp), f"{tmp} left behind")


def phase_lm_train(torch, device, results, card):
    """Phase (n): LM training on the card. Returns the training kernels'
    launches of `train_loop`'s run."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(LM_ARCH)
    phase_lm_train_kernels(torch, device, results)
    totals, _ = phase_lm_train_loop(torch, device, cfg, card)
    save_bytes = phase_lm_train_vs_ref(torch, device, cfg, card)
    phase_lm_train_dense(torch, device, cfg, card)
    phase_lm_train_resume(torch, device, save_bytes, card)
    return {name: totals[name] for name in LM_TRAIN_KERNELS + LM_KERNELS}


# ------------------------------------------------------------ phase (o)
# qwen2-moe-a2.7b (arXiv:2407.10671's Qwen1.5-MoE-A2.7B: 24 layers, d 2048,
# 16 heads, 60 routed experts top-4 of width 1408 and 4 shared, vocab
# 151936; 14.32B parameters, 28.6 GB in bf16) at its full width and depth.
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_BATCH, MOE_PROMPT = 8, 128
# Fires a layer, in call order: ln1, q, k, v, ln2, the routed experts'
# hidden fire (T = 1 over the whole (E, C, F) bank) and the shared experts'
# (the step's flattened tokens as its time axis). Every layer is MoE.
MOE_FIRE_NAMES = ("ln1", "q", "k", "v", "ln2", "experts", "shared")
MOE_PREFILL_LAUNCHES = {"lif_bf16": 7 * 24, "sdsa_causal": 24}
MOE_DECODE_LAUNCHES = {"lif_bf16": 7 * 24}
# The scheduler's traffic: 4 requests of 5-16 prompt tokens, 8 new each,
# in two waves into 4 slots.
MOE_SERVE_SLOTS, MOE_SERVE_REQUESTS, MOE_SERVE_NEW = 4, 4, 8
MOE_SERVE_WAVES = ((2, 2), (2, 0))
MOE_SOLO = (0, 3)
# whisper-medium (arXiv:2212.04356): 24 encoder and 24 decoder layers, d
# 1024, 16 heads, 1500 stub frames. Encoder layer: 6 fires and one
# non-causal `sdsa` on the T-fold (B, H, T * 1500, 64); decoder layer: 6
# fires, one causal SDSA, and the cross-attention's 4 (k and v of the
# encoder output at T = 1, its q and the q heads).
WHISPER_ARCH = "whisper-medium"
WHISPER_BATCH, WHISPER_TOKENS = 2, 16
WHISPER_LAUNCHES = {"sdsa_or": 24, "sdsa_causal": 24,
                    "lif_bf16": 24 * 6 + 24 * 10}
# The other attention-family configs at their REDUCED sizes (2 layers, d
# 64): a prefill and 4 decode steps in each mode, on the kernels and on
# `ref`.
REDUCED_ARCHS = ("qwen3-4b", "internlm2-20b", "mistral-large-123b",
                 "mixtral-8x22b", "phi-3-vision-4.2b")
REDUCED_DECODE_STEPS = 4
O_KERNELS = ("lif_bf16", "sdsa_causal", "sdsa_or")


@contextlib.contextmanager
def first_calls(dispatch, keys):
    """While active, the args of the first registry call matching each
    `keys` entry (name -> predicate(op, args)) are kept, by name."""
    orig = dispatch.dispatch
    got: dict = {}

    def keep(op, *args, **kwargs):
        for name, pred in keys.items():
            if name not in got and pred(op, args):
                got[name] = args
        return orig(op, *args, **kwargs)

    dispatch.dispatch = keep
    try:
        yield got
    finally:
        dispatch.dispatch = orig


@contextlib.contextmanager
def moe_drops(torch):
    """While active, each `moe_apply` call records (dropped assignments,
    all assignments): a host read a call, outside timed runs."""
    from repro_torch.models import moe
    orig = moe.moe_apply
    rec: list = []

    def counted(p, x, **kw):
        rec.append((moe.dropped_assignments(
            p, x, top_k=kw["top_k"], capacity_factor=kw["capacity_factor"],
            dispatch_groups=kw.get("dispatch_groups", 1)),
            x.numel() // x.shape[-1] * kw["top_k"]))
        return orig(p, x, **kw)

    moe.moe_apply = counted
    try:
        yield rec
    finally:
        moe.moe_apply = orig


def free_card(torch):
    """Drop what earlier phases left in the caching allocator: (o) holds
    28.6 GB of weights."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def phase_moe_prefill(torch, device, card):
    """(o1): qwen2-moe-a2.7b at full width and depth, spiking prefill of
    MOE_BATCH x MOE_PROMPT tokens on the kernels, again (bit for bit), on
    `ref` (bit for bit), with exact launches; dropped assignments; the
    routed and shared expert fires and the causal SDSA on the prefill's
    own drives; a dense prefill. Returns the kernels' launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts, sdsa_kernel
    from repro_torch.models import lm, moe
    from repro_torch.optim import adamw
    cfg = get_config(MOE_ARCH)
    resident = free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in
                      adamw.leaves(params))
    emit("moe_setup", card=card, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, experts=cfg.moe.n_experts,
         top_k=cfg.moe.top_k, shared=cfg.moe.n_shared,
         params=lm.param_count(cfg), param_bytes=param_bytes, init_s=init_s,
         resident_before_bytes=resident,
         init_peak_bytes=torch.cuda.max_memory_allocated())
    tokens = torch.from_numpy(markov_tokens(
        SEED, 0, 0, MOE_BATCH, MOE_PROMPT, cfg.vocab)[:, :MOE_PROMPT]) \
        .long().to(device)
    keys = {"experts": lambda op, a: op == "lif_scan" and a[0].dim() == 4
            and a[0].shape[0] == 1,
            "shared": lambda op, a: op == "lif_scan" and a[0].dim() == 2,
            "sdsa": lambda op, a: op == "causal_sdsa"}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_fires(torch, dispatch) as fires, \
                first_calls(dispatch, keys) as drives:
            logits = lm.prefill(cfg, params, tokens, True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = launch_counts()
        lm_launch_check(counts, MOE_PREFILL_LAUNCHES, f"{cfg.name} prefill")
        check(tuple(logits.shape) == (MOE_BATCH, cfg.vocab) and
              bool(torch.isfinite(logits).all()),
              f"{cfg.name} prefill logits not finite")
        t0 = time.perf_counter()
        again = lm.prefill(cfg, params, tokens, True)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(torch.equal(again, logits),
              f"{cfg.name} prefill does not repeat bit for bit")
        t0 = time.perf_counter()
        with dispatch.use_backend(dispatch.REF), \
                capture_fires(torch, dispatch, against=fires) as drift:
            ref_logits = lm.prefill(cfg, params, tokens, True)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        with moe_drops(torch) as drops:
            lm.prefill(cfg, params, tokens, True)
        dense = lm.prefill(cfg, params, tokens, False)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(dense).all()),
              f"{cfg.name} dense prefill logits not finite")
    rates = per_layer([f.float().mean().item() for f in fires],
                      cfg.n_layers, MOE_FIRE_NAMES)
    diffs = per_layer(drift, cfg.n_layers, MOE_FIRE_NAMES)
    del fires
    emit("moe_prefill", card=card, arch=cfg.name, batch=MOE_BATCH,
         tokens=MOE_PROMPT, first_prefill_s=first_s,
         kernel_prefill_s=kernel_s, ref_prefill_s=ref_s,
         launches={k: n for k, n in counts.items() if n}, peak_bytes=peak, logits_equal_ref=bool(torch.equal(logits,
                                                            ref_logits)),
         max_abs_dlogits=(logits - ref_logits).abs().max().item(),
         logits_sha=tensor_sha(torch, logits),
         dropped_assignments=sum(d for d, _ in drops),
         assignments=sum(n for _, n in drops),
         dropped_by_layer=[d for d, _ in drops],
         capacity=moe.capacity_of(
             MOE_BATCH * MOE_PROMPT * cfg.spiking.t_steps, cfg.moe.top_k,
             cfg.moe.n_experts, cfg.moe.capacity_factor),
         dense_logits_finite=True,
         layers=[dict(layer=i, spike_rate=r, differing_share=max(d.values()))
                 for i, (r, d) in enumerate(zip(rates, diffs))])
    check(torch.equal(logits, ref_logits),
          f"{cfg.name} prefill: kernel logits differ from ref's by "
          f"{(logits - ref_logits).abs().max().item()}")
    emit("moe_prefill_breakdown", card=card, **forward_breakdown(
        torch, lambda: lm.prefill(cfg, params, tokens, True)))
    lif_case(torch, "moe_experts", drives["experts"][0])
    lif_case(torch, "moe_shared", drives["shared"][0], reps=3, plain_reps=1)
    q, k, v = drives["sdsa"][:3]
    kv = ((k != 0) & (v != 0)).any(0).to(torch.bfloat16)
    sdsa_spike_case(torch, "sdsa_causal", "moe_prefill",
                    sdsa_kernel.causal_sdsa_spikes,
                    sdsa_kernel.causal_sdsa_spikes_plain, (q, k, v),
                    library=lambda: torch.cummax(kv, dim=-2))
    del params, drives, q, k, v, kv
    free_card(torch)
    return {name: counts.get(name, 0) for name in O_KERNELS}


def tensor_sha(torch, t) -> str:
    """A digest of a tensor's bytes: two runs compare by it."""
    import hashlib
    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def moe_requests(cfg):
    """(prompt, max_new) of the MoE scheduler's requests, from SEED."""
    import numpy as np
    from repro_torch.data.synthetic import markov_tokens
    lo, hi = SERVE_PROMPT_LENGTHS
    lengths = np.random.default_rng(SEED + 4).integers(
        lo, hi + 1, MOE_SERVE_REQUESTS)
    toks = markov_tokens(SEED + 5, 0, 0, MOE_SERVE_REQUESTS, hi, cfg.vocab)
    return [([int(t) for t in toks[i, :n]], MOE_SERVE_NEW)
            for i, n in enumerate(lengths)]


def phase_moe_serve(torch, device, card):
    """(o2): the serve scheduler at qwen2-moe-a2.7b's full width, spiking:
    the staggered traffic on the kernels (clean, exact launches), on
    `ref` (its tokens equal), again on the kernels with the drops counted
    (its tokens equal); requests MOE_SOLO each alone, on the kernels and
    on `ref` (equal), against their tokens in the pool (reported: an MoE
    decode step routes its slots together). Returns the launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    cfg = get_config(MOE_ARCH)
    traffic = moe_requests(cfg)
    kw = dict(slots=MOE_SERVE_SLOTS, waves=MOE_SERVE_WAVES)
    totals = {name: 0 for name in O_KERNELS}

    def run(**extra):
        """One Server's run, checked clean on the kernels; the server (its
        28.6 GB of weights) is freed before the next."""
        server, reqs, log, wall, counts = serve_run(
            torch, cfg, True, device, traffic, **kw, **extra)
        if extra.get("backend") is None:
            clean_run_checks(server, reqs, log, counts, True,
                             f"{cfg.name} {extra or 'pool'}",
                             per_step=MOE_DECODE_LAUNCHES)
        del server
        free_card(torch)
        for name in totals:
            totals[name] += counts.get(name, 0)
        return dict(reqs=reqs, log=log, wall=wall)

    pool = run()
    tokens = [r.generated for r in pool["reqs"]]
    ref = run(backend=dispatch.REF)
    with moe_drops(torch) as drops:
        again = run()
    solo = {}
    for i in MOE_SOLO:
        k_run, r_run = run(only=(i,)), run(only=(i,), backend=dispatch.REF)
        solo[i] = (k_run["reqs"][0].generated, r_run["reqs"][0].generated)
    emit("moe_serve", card=card, arch=cfg.name, slots=MOE_SERVE_SLOTS,
         requests=len(tokens), prompt_lengths=[len(p) for p, _ in traffic],
         new_tokens=sum(len(t) for t in tokens), wall_s=pool["wall"],
         tokens_per_s=sum(len(t) for t in tokens) / pool["wall"],
         **spans(pool["log"]),
         fire_launches_per_decode_step=next(
             d for k, _, d, _ in pool["log"] if k == "step")["lif_bf16"],
         tokens_equal_ref=[r.generated for r in ref["reqs"]] == tokens,
         repeat_equal=[r.generated for r in again["reqs"]] == tokens,
         dropped_assignments=sum(d for d, _ in drops),
         assignments=sum(n for _, n in drops),
         solo_requests=list(MOE_SOLO),
         solo_equal_ref=[a == b for a, b in solo.values()],
         solo_equal_pool=[solo[i][0] == tokens[i] for i in MOE_SOLO],
         tokens=tokens)
    check([r.generated for r in ref["reqs"]] == tokens,
          "moe serve: the kernels' tokens differ from ref's")
    check([r.generated for r in again["reqs"]] == tokens,
          "moe serve: a second run gives other tokens")
    for i, (a, b) in solo.items():
        check(a == b, f"moe serve: request {i} alone differs from ref's")
    return totals


def phase_whisper(torch, device, card):
    """(o3): whisper-medium at full width, spiking: `forward_hidden` on
    WHISPER_TOKENS tokens with a seeded stub frontend of 1500 frames, on
    the kernels (exact launches: 24 encoder `sdsa`) and on `ref` (equal
    bit for bit); the encoder's `sdsa` on its own spikes against its
    plain version."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts, sdsa_kernel
    from repro_torch.models import lm
    cfg = get_config(WHISPER_ARCH)
    params = lm.init_params(cfg, seed=SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    frontend = torch.randn((WHISPER_BATCH, cfg.encoder_seq, cfg.d_model),
                           generator=gen, device=device).bfloat16()
    tokens = torch.from_numpy(markov_tokens(
        SEED + 7, 0, 0, WHISPER_BATCH, WHISPER_TOKENS, cfg.vocab)
        [:, :WHISPER_TOKENS]).long().to(device)
    with torch.inference_mode():
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with first_calls(dispatch, {"sdsa": lambda op, a: op == "sdsa"}) \
                as drives:
            out = lm.forward_hidden(cfg, params, tokens, True,
                                    frontend=frontend)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        counts = launch_counts()
        lm_launch_check(counts, WHISPER_LAUNCHES, f"{cfg.name} forward")
        check(tuple(out.shape) == (WHISPER_BATCH, WHISPER_TOKENS,
                                   cfg.d_model) and
              bool(torch.isfinite(out).all()),
              f"{cfg.name} hidden state not finite")
        with dispatch.use_backend(dispatch.REF):
            ref = lm.forward_hidden(cfg, params, tokens, True,
                                    frontend=frontend)
        torch.cuda.synchronize()
    emit("whisper_forward", card=card, arch=cfg.name, batch=WHISPER_BATCH,
         frames=cfg.encoder_seq, tokens=WHISPER_TOKENS,
         encoder_layers=cfg.n_encoder_layers, kernel_s=kernel_s,
         launches={k: n for k, n in counts.items() if n}, equal_ref=bool(torch.equal(out, ref)),
         max_abs_diff=(out.float() - ref.float()).abs().max().item(),
         sdsa_fold=list(drives["sdsa"][0].shape))
    check(torch.equal(out, ref),
          f"{cfg.name}: the kernels' hidden state differs from ref's")
    q, k, v = drives["sdsa"][:3]
    sdsa_spike_case(torch, "sdsa_or", "whisper_encoder",
                    sdsa_kernel.sdsa_or_spikes,
                    sdsa_kernel.sdsa_or_spikes_plain, (q, k, v))
    del params, drives, q, k, v
    free_card(torch)
    return {name: counts.get(name, 0) for name in O_KERNELS}


def phase_reduced_archs(torch, device, card, archs=REDUCED_ARCHS):
    """(o4): `archs` at their reduced sizes, both modes: a prefill
    (phi-3-vision with its stub patch embeddings) and REDUCED_DECODE_STEPS
    greedy decode steps after a chunked prefill, on the kernels and on
    `ref`: logits equal bit for bit, the fire launched in spiking mode,
    the causal SDSA exactly where the pattern has attention, and no
    kernel in dense mode."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.models import lm
    totals = {name: 0 for name in O_KERNELS}
    for arch in archs:
        cfg = get_reduced(arch)
        attends = any(b.kind == "attn" for b in lm.layer_pattern(cfg)[0])
        params = lm.init_params(cfg, seed=SEED, device=device)
        tokens = torch.from_numpy(markov_tokens(SEED, 0, 0, 2, 12, cfg.vocab)
                                  [:, :12]).long().to(device)
        frontend = None
        if cfg.n_frontend_tokens:
            frontend = torch.randn(
                (2, cfg.n_frontend_tokens, cfg.d_model),
                generator=torch.Generator(device=device).manual_seed(SEED),
                device=device).bfloat16()

        def run(spiking):
            logits = lm.prefill(cfg, params, tokens, spiking,
                                frontend=frontend)
            last, state = lm.prefill_chunked(
                cfg, params, tokens, torch.full((2,), 12, device=device),
                spiking, 12 + REDUCED_DECODE_STEPS)
            steps, token = [last], last.argmax(-1)
            pos = torch.full((2,), 12, device=device)
            for _ in range(REDUCED_DECODE_STEPS):
                last, state = lm.decode_step(cfg, params, state, token, pos,
                                             spiking)
                steps.append(last)
                token, pos = last.argmax(-1), pos + 1
            return logits, torch.stack(steps)

        for spiking in (True, False):
            with torch.inference_mode():
                reset_launch_counts()
                logits, steps = run(spiking)
                torch.cuda.synchronize()
                counts = launch_counts()
                with dispatch.use_backend(dispatch.REF):
                    ref_logits, ref_steps = run(spiking)
                torch.cuda.synchronize()
            mode = "spiking" if spiking else "dense"
            emit("reduced_arch", card=card, arch=arch, mode=mode,
                 launches={k: n for k, n in counts.items() if n},
                 finite=bool(torch.isfinite(logits).all() and
                              torch.isfinite(steps).all()),
                 prefill_equal_ref=bool(torch.equal(logits, ref_logits)),
                 decode_equal_ref=bool(torch.equal(steps, ref_steps)))
            check(bool(torch.isfinite(logits).all()) and
                  bool(torch.isfinite(steps).all()),
                  f"{arch} {mode}: logits not finite")
            check(torch.equal(logits, ref_logits) and
                  torch.equal(steps, ref_steps),
                  f"{arch} {mode}: the kernels' logits differ from ref's")
            if spiking:
                check(counts["lif_bf16"] > 0 and
                      (counts["sdsa_causal"] > 0) == attends,
                      f"{arch}: the LM kernels' launches {counts}")
            else:
                check(not any(counts.values()),
                      f"{arch} dense launched {counts}")
            for name in totals:
                totals[name] += counts.get(name, 0)
    return totals


def phase_archs(torch, device, card):
    """Phase (o): the attention-family architectures on the card. Returns
    the LM kernels' launches."""
    totals = {name: 0 for name in O_KERNELS}
    for name, fn in (("o1_moe_prefill", phase_moe_prefill),
                     ("o2_moe_serve", phase_moe_serve),
                     ("o3_whisper", phase_whisper),
                     ("o4_reduced", phase_reduced_archs)):
        t0 = time.perf_counter()
        for k, n in fn(torch, device, card).items():
            totals[k] += n
        emit("phase_time", name=name, seconds=time.perf_counter() - t0)
    return totals


# ------------------------------------------------------------ phase (p)
# The SSM families. xlstm-350m (arXiv:2405.04517: 24 layers, d 1024, 4
# heads of 256, an sLSTM every 8th block, vocab 50304; 222,763,264
# parameters, 0.45 GB in bf16) uncut. Spiking, each block fires its raw
# residual once (T = 1) and has no FFN and no attention: 24 fires a
# forward and a decode step. At the config's lif_vth = 1.0 the seeded
# stream never fires (a reference finding); XLSTM_FIRING_VTH is the
# variant that does.
XLSTM_ARCH = "xlstm-350m"
XLSTM_LAUNCHES = {"lif_bf16": 24}
XLSTM_FIRING_VTH = 0.02
XLSTM_DECODE_STEPS = 16
# jamba-1.5-large-398b (arXiv:2403.19887) at its full widths over one
# period: 8 layers, 7 Mamba and the attention layer at index 3, each with
# its 24576-wide MLP (d 8192, d_inner 16384, d_state 16, 64 heads with 8
# KV heads, vocab 65536; 8,998,805,504 parameters, 18.0 GB in bf16). The
# period's 4 MoE FFNs (38.7B parameters at this width) do not fit one
# card beside it. Spiking fires a layer: Mamba's input, ln2 and the MLP's
# hidden drive (3); attention's input, q, k, v, ln2 and the hidden drive
# (6); one causal SDSA a prefill.
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS = 8
JAMBA_PREFILL_LAUNCHES = {"lif_bf16": 7 * 3 + 6, "sdsa_causal": 1}
JAMBA_STEP_LAUNCHES = {"lif_bf16": 7 * 3 + 6}
JAMBA_DECODE_STEPS = 8
SSM_BATCH, SSM_PROMPT = 8, 128
# (p4): the two configs at their REDUCED sizes (2 layers, d 64; jamba's
# with its 4-expert MoE), in (o4)'s manner.
SSM_REDUCED_ARCHS = (JAMBA_ARCH, XLSTM_ARCH)
P_KERNELS = ("lif_bf16", "sdsa_causal")
CARD_MEMORY_BYTES = 80e9


def jamba_period_config():
    """jamba-1.5-large-398b over one period at full width, MLP FFNs."""
    from repro_torch.configs.registry import get_config
    return get_config(JAMBA_ARCH).replace(n_layers=JAMBA_LAYERS, moe=None)


def with_vth(cfg, v_th):
    return cfg.replace(spiking=dataclasses.replace(cfg.spiking, lif_vth=v_th))


@contextlib.contextmanager
def recurrence_timeline(torch):
    """While active, each SSM scan step (`models/ssm.py`'s
    `_mamba_scan_step`, `_mlstm_step`, `_slstm_step`) adds its host time
    and a pair of CUDA events: the loops' share of the host's enqueue
    and of the device span."""
    from repro_torch.models import ssm
    names = ("_mamba_scan_step", "_mlstm_step", "_slstm_step")
    orig = {n: getattr(ssm, n) for n in names}
    rec = dict(steps=0, host_s=0.0, marks=[])

    def timed(fn):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*args)
            stop.record()
            rec["host_s"] += time.perf_counter() - t0
            rec["steps"] += 1
            rec["marks"].append((start, stop))
            return out
        return run
    for n in names:
        setattr(ssm, n, timed(orig[n]))
    try:
        yield rec
    finally:
        for n in names:
            setattr(ssm, n, orig[n])


def ssm_breakdown(torch, forward) -> dict:
    """`forward_breakdown` of one call, plus its scan steps: how many,
    their host enqueue ms and their summed device ms."""
    with recurrence_timeline(torch) as rec:
        out = forward_breakdown(torch, forward)
    torch.cuda.synchronize()
    out.update(scan_steps=rec["steps"], scan_host_ms=rec["host_s"] * 1e3,
               scan_device_ms=sum(a.elapsed_time(b)
                                  for a, b in rec["marks"]))
    out["scan_host_share"] = out["scan_host_ms"] / out["host_enqueue_ms"]
    return out


def ssm_tokens(torch, cfg, device, seed):
    """SSM_BATCH prompts of SSM_PROMPT `markov_tokens`, and ragged lengths
    in (SSM_PROMPT / 2, SSM_PROMPT] for `prefill_chunked` (the tail of
    each prompt past its length is pad)."""
    import numpy as np
    from repro_torch.data.synthetic import markov_tokens
    toks = markov_tokens(seed, 0, 0, SSM_BATCH, SSM_PROMPT, cfg.vocab)
    lengths = np.random.default_rng(seed).integers(
        SSM_PROMPT // 2 + 1, SSM_PROMPT + 1, SSM_BATCH)
    return (torch.from_numpy(toks[:, :SSM_PROMPT]).long().to(device),
            torch.from_numpy(lengths).to(device))


def ssm_mode(torch, cfg, params, tokens, lengths, spiking, steps, launches,
             step_launches, what, card, drives=None):
    """One mode of an SSM config on the card: a `prefill` (first and
    again), `prefill_chunked` over the ragged lengths and `steps` greedy
    decode steps, on the kernels (launches exact: `launches` a prefill,
    `step_launches` a decode step and a chunked position, none in dense
    mode)
    and on `ref` (logits and tokens equal bit for bit); the first fire's
    spike rate on both routes; the prefill's and a decode step's (on the
    state after the chunked prefill) breakdowns with the scan steps' host
    time and their device span, idle gaps included; peak memory. With `drives`
    (name -> predicate), the first registry calls matching them are kept
    from the first prefill. Returns (launches, first fire's spike rate,
    kept calls)."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.models import lm
    mode = "spiking" if spiking else "dense"
    per_step = step_launches if spiking else {}
    pad = tokens.shape[1]
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_fires(torch, dispatch) as fires, \
                first_calls(dispatch, drives or {}) as kept:
            logits = lm.prefill(cfg, params, tokens, spiking)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = launch_counts()
        lm_launch_check(counts, launches if spiking else {},
                        f"{what} {mode} prefill")
        check(tuple(logits.shape) == (tokens.shape[0], cfg.vocab) and
              bool(torch.isfinite(logits).all()),
              f"{what} {mode}: prefill logits not finite")
        t0 = time.perf_counter()
        again = lm.prefill(cfg, params, tokens, spiking)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(torch.equal(again, logits),
              f"{what} {mode}: prefill does not repeat bit for bit")
        reset_launch_counts()
        last, state = lm.prefill_chunked(cfg, params, tokens, lengths,
                                         spiking, pad + steps)
        served = [launch_counts()]
        gen, per = lm_decode(torch, cfg, params, state, last.argmax(-1),
                             lengths.clone(), True, spiking, steps)
        lm_launch_check(served[0], {k: v * pad for k, v in per_step.items()},
                        f"{what} {mode} prefill_chunked")
        for c in per:
            lm_launch_check(c, per_step, f"{what} {mode} decode step")
        for c in served + per:
            counts = {k: counts[k] + c[k] for k in counts}
        t0 = time.perf_counter()
        with dispatch.use_backend(dispatch.REF), \
                capture_fires(torch, dispatch) as ref_fires:
            ref_logits = lm.prefill(cfg, params, tokens, spiking)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        with dispatch.use_backend(dispatch.REF):
            ref_gen, _ = lm_serve(torch, cfg, params, tokens, lengths, False,
                                  spiking, steps, pad + steps)
        torch.cuda.synchronize()
    rate = fires[0].float().mean().item() if fires else None
    ref_rate = ref_fires[0].float().mean().item() if ref_fires else None
    emit("ssm_prefill", card=card, arch=cfg.name, mode=mode,
         layers=cfg.n_layers, d_model=cfg.d_model, lif_vth=cfg.spiking.lif_vth
         if spiking else None, batch=tokens.shape[0], tokens=pad,
         first_prefill_s=first_s, kernel_prefill_s=kernel_s,
         ref_prefill_s=ref_s, peak_bytes=peak,
         launches={k: n for k, n in counts.items() if n},
         first_fire_spike_rate=rate, ref_first_fire_spike_rate=ref_rate,
         spike_rates=[f.float().mean().item() for f in fires],
         logits_equal_ref=bool(torch.equal(logits, ref_logits)),
         tokens_equal_ref=bool(torch.equal(gen, ref_gen)),
         prompt_lengths=lengths.tolist(), decode_steps=steps,
         served=gen.tolist())
    check(torch.equal(logits, ref_logits),
          f"{what} {mode}: the kernels' prefill logits differ from ref's by "
          f"{(logits - ref_logits).abs().max().item()}")
    check(torch.equal(gen, ref_gen),
          f"{what} {mode}: the kernels' served tokens differ from ref's")
    check(rate == ref_rate, f"{what} {mode}: first fire's spike rate "
          f"{rate} on the kernels, {ref_rate} on ref")
    if spiking:
        check(counts["lif_bf16"] > 0, f"{what}: the fire kernel never ran")
    else:
        check(not any(counts.values()), f"{what} dense launched {counts}")
    del fires, ref_fires
    emit("ssm_prefill_breakdown", card=card, arch=cfg.name, mode=mode,
         **ssm_breakdown(torch, lambda: lm.prefill(cfg, params, tokens,
                                                   spiking)))
    pos = lengths.clone()
    emit("ssm_decode_breakdown", card=card, arch=cfg.name, mode=mode,
         **ssm_breakdown(torch, lambda: lm.decode_step(
             cfg, params, state, last.argmax(-1), pos, spiking)))
    return counts, rate, kept


def phase_xlstm(torch, device, card):
    """(p1): xlstm-350m uncut, dense, spiking at lif_vth = 1.0 (silent:
    its first fire's rate is printed and must agree between the routes)
    and spiking at XLSTM_FIRING_VTH (must fire); the bf16 fire on that
    variant's first drive against its plain version. Returns the
    launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = get_config(XLSTM_ARCH)
    free_card(torch)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    emit("ssm_setup", card=card, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, params=lm.param_count(cfg),
         param_bytes=sum(t.numel() * t.element_size()
                         for t in adamw.leaves(params)),
         init_s=time.perf_counter() - t0)
    tokens, lengths = ssm_tokens(torch, cfg, device, SEED + 8)
    totals = {name: 0 for name in P_KERNELS}
    fire = {"fire": lambda op, a: op == "lif_scan"}
    for mode_cfg, spiking in ((cfg, False), (cfg, True),
                              (with_vth(cfg, XLSTM_FIRING_VTH), True)):
        counts, rate, kept = ssm_mode(
            torch, mode_cfg, params, tokens, lengths, spiking,
            XLSTM_DECODE_STEPS, XLSTM_LAUNCHES, XLSTM_LAUNCHES, "xlstm-350m",
            card, drives=fire)
        if spiking and mode_cfg.spiking.lif_vth == XLSTM_FIRING_VTH:
            check(rate > 0, f"xlstm-350m at lif_vth {XLSTM_FIRING_VTH}: "
                  f"the first fire is silent")
            lif_case(torch, "xlstm_first_fire", kept["fire"][0],
                     v_th=XLSTM_FIRING_VTH)
        for name in totals:
            totals[name] += counts.get(name, 0)
    del params
    free_card(torch)
    return totals


def phase_xlstm_serve(torch, device, card):
    """(p2): a `Server` of SERVE_SLOTS slots over full-width xlstm-350m,
    dense and spiking at XLSTM_FIRING_VTH: (m)'s traffic clean on the
    kernels (exact launches), its tokens equal on `ref`, and every
    request served alone in an 8-slot server decoding its pool tokens.
    Returns the launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    base = get_config(XLSTM_ARCH)
    traffic = serve_requests(base)
    totals = {name: 0 for name in P_KERNELS}
    for cfg, spiking in ((base, False),
                         (with_vth(base, XLSTM_FIRING_VTH), True)):
        mode = "spiking" if spiking else "dense"
        server, reqs, log, wall, counts = serve_run(torch, cfg, spiking,
                                                    device, traffic)
        clean_run_checks(server, reqs, log, counts, spiking,
                         f"xlstm {mode}", per_step=XLSTM_LAUNCHES)
        tokens = [r.generated for r in reqs]
        del server
        _, ref_reqs, _, _, _ = serve_run(torch, cfg, spiking, device,
                                         traffic, backend=dispatch.REF)
        solo = []
        for i in range(len(reqs)):
            s, (r,), slog, _, scounts = serve_run(torch, cfg, spiking,
                                                  device, traffic, only=(i,))
            clean_run_checks(s, [r], slog, scounts, spiking,
                             f"xlstm {mode} solo {i}",
                             per_step=XLSTM_LAUNCHES)
            solo.append(r.generated)
            counts = {k: counts[k] + scounts[k] for k in counts}
        free_card(torch)
        new_tokens = sum(len(t) for t in tokens)
        emit("ssm_serve", card=card, arch=cfg.name, mode=mode,
             lif_vth=cfg.spiking.lif_vth if spiking else None,
             slots=SERVE_SLOTS, requests=len(reqs),
             prompt_lengths=[len(r.prompt) for r in reqs],
             new_tokens=new_tokens, wall_s=wall,
             tokens_per_s=new_tokens / wall, **spans(log),
             launches={k: n for k, n in counts.items() if n},
             tokens_equal_ref=[r.generated for r in ref_reqs] == tokens,
             solo_equal_pool=[a == b for a, b in zip(solo, tokens)],
             tokens=tokens)
        check([r.generated for r in ref_reqs] == tokens,
              f"xlstm serve {mode}: the kernels' tokens differ from ref's")
        for i, (a, b) in enumerate(zip(solo, tokens)):
            check(a == b, f"xlstm serve {mode}: request {i} alone decodes "
                  f"other tokens than in the pool")
        for name in totals:
            totals[name] += counts.get(name, 0)
    return totals


def phase_jamba(torch, device, card):
    """(p3): jamba-1.5-large-398b at full width over one period, dense and
    spiking (`ssm_mode`), peak memory under the card's 80 GB; the bf16
    fire on a Mamba layer's input drive and the causal SDSA on the
    attention layer's spikes against their plain versions. Returns the
    launches."""
    from repro_torch.kernels import sdsa_kernel
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = jamba_period_config()
    resident = free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    emit("ssm_setup", card=card, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, d_inner=cfg.hybrid.expand * cfg.d_model,
         d_state=cfg.hybrid.d_state, params=lm.param_count(cfg),
         param_bytes=sum(t.numel() * t.element_size()
                         for t in adamw.leaves(params)),
         init_s=time.perf_counter() - t0, resident_before_bytes=resident,
         init_peak_bytes=torch.cuda.max_memory_allocated())
    tokens, lengths = ssm_tokens(torch, cfg, device, SEED + 9)
    totals = {name: 0 for name in P_KERNELS}
    keys = {"mamba_in": lambda op, a: op == "lif_scan",
            "sdsa": lambda op, a: op == "causal_sdsa"}
    for spiking in (False, True):
        counts, _, kept = ssm_mode(
            torch, cfg, params, tokens, lengths, spiking,
            JAMBA_DECODE_STEPS, JAMBA_PREFILL_LAUNCHES, JAMBA_STEP_LAUNCHES,
            "jamba period", card, drives=keys)
        for name in totals:
            totals[name] += counts.get(name, 0)
    peak = torch.cuda.max_memory_allocated()
    check(peak < CARD_MEMORY_BYTES,
          f"jamba period: peak {peak} bytes is not under the card's")
    lif_case(torch, "jamba_mamba_input", kept["mamba_in"][0])
    q, k, v = kept["sdsa"][:3]
    kv = ((k != 0) & (v != 0)).any(0).to(torch.bfloat16)
    sdsa_spike_case(torch, "sdsa_causal", "jamba_prefill",
                    sdsa_kernel.causal_sdsa_spikes,
                    sdsa_kernel.causal_sdsa_spikes_plain, (q, k, v),
                    library=lambda: torch.cummax(kv, dim=-2))
    del params, kept, q, k, v, kv
    free_card(torch)
    return totals


def phase_ssm(torch, device, card):
    """Phase (p): the SSM families on the card. Returns the LM kernels'
    launches."""
    totals = {name: 0 for name in O_KERNELS}
    for name, fn in (("p1_xlstm", phase_xlstm),
                     ("p2_xlstm_serve", phase_xlstm_serve),
                     ("p3_jamba", phase_jamba),
                     ("p4_reduced", functools.partial(
                         phase_reduced_archs, archs=SSM_REDUCED_ARCHS))):
        t0 = time.perf_counter()
        for k, n in fn(torch, device, card).items():
            totals[k] += n
        emit("phase_time", name=name, seconds=time.perf_counter() - t0)
    return totals


# ------------------------------------------------------------ phase (q)
# Guarded execution on the card (`dispatch.use_guard`): the maps live on
# the card, so audit poisons and repair launches kernel 10 behind a flag
# computed there, with no host read unless a watcher is open.
GUARD_MODELS = ("spikingformer", "vgg11", "resnet18", "segnet")
GUARD_OPS = ("spike_matmul", "apec_matmul")
GUARD_APEC_G = 2
# The FFN call of the training step whose carried map is undercounted:
# block 0's fc1 (the first `spike_matmul` with a map in the forward).
GUARD_PLANT_CALL = 0
GUARD_TIMING_REPS = 5


@contextlib.contextmanager
def guarded_calls(dispatch):
    """Counts the calls of `dispatch.dispatch` that the guard wraps while
    active (an op of `GUARDED_OPS` with a 2-D carried map): yields
    {"guarded": n, "audited": n}, "audited" the `spike_matmul` /
    `apec_matmul` ones, whose support the guard checks (one gated kernel-10
    launch each under repair)."""
    held = {"guarded": 0, "audited": 0}
    orig = dispatch.dispatch

    def counted(op, *args, **kwargs):
        occ = kwargs.get("occupancy")
        if op in dispatch.GUARDED_OPS and getattr(occ, "ndim", 0) == 2:
            held["guarded"] += 1
            held["audited"] += op in GUARD_OPS
        return orig(op, *args, **kwargs)
    dispatch.dispatch = counted
    try:
        yield held
    finally:
        dispatch.dispatch = orig


def raises(exc, fn) -> bool:
    """Whether `fn()` raises `exc` (any other error propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def guard_model_forwards(torch, device):
    """(name, forward(packed) -> (logits, spikes)) of SpikingFormer-4-384
    on phase (c)'s first batch and VGG11 / ResNet18 / SegNet-64 on phase
    (h)'s, under `torch.inference_mode()`."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.models import spikingformer as sf
    params = sf.spikingformer_init(
        DEPTH, DIM, generator=torch.Generator().manual_seed(SEED),
        device=device)
    x = torch.rand((B, 32, 32, 3),
                   generator=torch.Generator().manual_seed(SEED + 1)
                   ).to(device)

    def sf_forward(packed):
        cfg = SpikingConfig(t_steps=T, lif_vth=V_TH, packed=packed)
        with torch.inference_mode():
            return sf.spikingformer_apply(params, x, n_heads=HEADS,
                                          spiking_cfg=cfg,
                                          collect_stats=True)
    models = [("spikingformer", sf_forward)]
    for name in GUARD_MODELS[1:]:
        _, forward, batch = cnn_setup(torch, name, device)
        xb = batch(0)

        def cnn_forward(packed, forward=forward, xb=xb):
            with torch.inference_mode():
                return forward(xb, collect_stats=True, packed=packed)
        models.append((name, cnn_forward))
    return models


def same_forward(torch, got, want) -> bool:
    """Logits and every layer's spikes (or words) bit for bit."""
    return torch.equal(got[0], want[0]) and len(got[1]) == len(want[1]) \
        and all(torch.equal(as_int32(a), as_int32(b))
                for a, b in zip(got[1], want[1]))


def phase_guard_models(torch, device, card):
    """(q1) Each model, dense and packed, under `off`, `audit` and `repair`
    against its unguarded forward: logits and every layer's spikes bit for
    bit, no watcher record, the unguarded launches plus one gated kernel-10
    launch a support audit under repair (none under audit), the host syncs
    equal, and the audit's and repair's spans in turns with the unguarded
    one."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    totals: dict = {}

    def counted(fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return out, {k: v for k, v in counts.items() if v}

    def guarded(mode, forward, packed):
        def run():
            with dispatch.use_guard(mode):
                return forward(packed)
        return run

    for name, forward in guard_model_forwards(torch, device):
        for packed in (False, True):
            base, launches = counted(lambda: forward(packed))
            runs = {}
            for mode in dispatch.GUARD_MODES:
                with guarded_calls(dispatch) as held, \
                        dispatch.watch_guard_events() as events:
                    out, counts = counted(guarded(mode, forward, packed))
                check(held["guarded"] > 0,
                      f"{name} packed={packed}: no guarded call under {mode}")
                check(same_forward(torch, out, base),
                      f"{name} packed={packed}: the forward under {mode} "
                      f"differs from the unguarded one")
                check(events == [], f"{name} packed={packed}: {mode} "
                      f"recorded {events}")
                want = dict(launches)
                if mode == "repair" and held["audited"]:
                    want["spike_matmul_pred"] = \
                        want.get("spike_matmul_pred", 0) + held["audited"]
                check(counts == want, f"{name} packed={packed}: launches "
                      f"under {mode} {counts} != {want}")
                runs[mode] = dict(guarded_calls=held["guarded"],
                                  support_audits=held["audited"],
                                  launches=counts)
            syncs = {"unguarded": sync_count(torch, lambda: forward(packed))}
            for mode in dispatch.GUARD_MODES[1:]:
                syncs[mode] = sync_count(torch, guarded(mode, forward,
                                                        packed))
                check(syncs[mode] == syncs["unguarded"],
                      f"{name} packed={packed}: {syncs[mode]} host syncs "
                      f"under {mode}, {syncs['unguarded']} unguarded")
            spans = {}
            for mode in dispatch.GUARD_MODES[1:]:
                base_ms, mode_ms = turns_ms(
                    torch, lambda: forward(packed),
                    guarded(mode, forward, packed), reps=GUARD_TIMING_REPS)
                spans[mode] = dict(unguarded_ms=base_ms, ms=mode_ms,
                                   added_ms=mode_ms - base_ms)
            emit("guard_forward", model=name, packed=packed, equal_bits=True,
                 records=0, launches=launches, modes=runs, host_syncs=syncs,
                 spans=spans, card=card)
    return totals


def undercount_on(torch, occ, seed=SEED):
    """`faults.undercount_occupancy` of a card map (a host copy), back on
    the card, with its coordinates."""
    from repro_torch.runtime import faults
    bad, coords = faults.undercount_occupancy(occ, 1, seed=seed)
    return torch.from_numpy(bad).to(occ.device), coords


def flipped_in_empty_tile(torch, words, occ, seed=SEED):
    """`faults.flip_packed_bits` inside the first tile the map claims
    empty (a host copy of its 128 x 4 words), the rest of the words as
    they were: the payload gains support the map never counted."""
    import numpy as np
    from repro_torch.runtime import faults
    empty = (occ == 0).nonzero()
    check(empty.shape[0] > 0, "no empty tile to flip bits in")
    mt, kt = (int(v) for v in empty[0])
    rows = slice(mt * 128, mt * 128 + 128)
    cols = slice(kt * 4, min(kt * 4 + 4, words.shape[1]))
    sub, flips = faults.flip_packed_bits(words[rows, cols], 4, seed=seed)
    bad = words.clone()
    bad[rows, cols] = torch.from_numpy(sub.view(np.int32)).view(
        torch.uint32).to(words.device)
    return bad, (mt, kt), flips


def word_bits(torch, words):
    """(rows, 32 * words) int32 0/1: every bit of uint32 words, bit i of
    word j at column 32 j + i (the pack layout), the pad bits included."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.view(torch.int32).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(words.shape[0], -1)


def tile_nonzeros(torch, s):
    """Nonzeros per 128 x 128 tile of a 2-D payload, zero-padded to the
    grid: a count independent of `ops.support_map`'s."""
    m, k = s.shape
    mt, kt = -(-m // 128), -(-k // 128)
    padded = torch.zeros((mt * 128, kt * 128), dtype=torch.int32,
                         device=s.device)
    padded[:m, :k] = (s != 0).to(torch.int32)
    return padded.reshape(mt, 128, kt, 128).sum((1, 3), dtype=torch.int32)


def f64_err(got, want) -> tuple:
    """(max |got - want|, its bound 1e-5 * max|want| + 1e-5) against an
    f64 product."""
    return ((got.double() - want).abs().max().item(),
            1e-5 * want.abs().max().item() + 1e-5)


def phase_guard_kernels(torch, device, card):
    """(q2) At phase (b)'s stage-1 / fc1 / fc2 shapes, on data with 50%
    occupied tiles, dense and packed, `spike_matmul` and `apec_matmul`
    (g = 2) on their automatic routes (kernels 12 / 14, 18 / 16): an
    undercount under audit all NaN with one record under a watcher;
    under repair equal to the clean call bit for bit (`spike_matmul`) or
    within 1e-5 * max|ref| + 1e-5 (`apec_matmul`), where the unguarded
    call on the undercount differs; a bit flip in an empty tile (packed)
    flagged by audit and repaired to the corrupted payload's product; the
    repaired products also within 1e-5 * max|ref| + 1e-5 of an f64 dense
    product of the payload's bits, and `ops.support_map` equal to a plain
    per-tile count of those bits (witnesses independent of the guard); an
    overcount never flagged and equal to the clean call; a wrong grid
    raising GuardViolationError, econv included. The clean call's ms
    under each mode in turns with the unguarded one (back-to-back calls,
    the host's enqueue included), and its `device_ms` under each (a CUDA
    graph of 10 calls)."""
    from repro_torch.core.spikes import pack_spikes_padded
    from repro_torch.kernels import dispatch, launch_counts, ops, \
        reset_launch_counts
    from repro_torch.runtime import faults
    totals: dict = {}
    gen = torch.Generator().manual_seed(SEED + 32)
    for label, (m, k, n) in CSR_SHAPES:
        s = clustered_spikes(torch, m, k, gen, device)
        w = torch.randn((k, n), generator=gen).to(device)
        occ = ops.padded_occupancy(s)
        bad, coords = undercount_on(torch, occ)
        over = torch.from_numpy(faults.overcount_occupancy(
            occ, 2, seed=SEED)[0]).to(device)
        words = pack_spikes_padded(s)
        flipped, flip_tile, flips = flipped_in_empty_tile(torch, words, occ)
        bits, flip_bits = word_bits(torch, words), word_bits(torch, flipped)
        check(torch.equal(bits[:, :k], s.to(torch.int32)),
              f"{label}: the words' bits are not the spikes")
        check(torch.equal(ops.support_map(s), tile_nonzeros(torch, s)) and
              torch.equal(ops.support_map(words, k),
                          tile_nonzeros(torch, bits)) and
              torch.equal(ops.support_map(flipped, k),
                          tile_nonzeros(torch, flip_bits)),
              f"{label}: support_map off the per-tile count of the payload")
        dense_ref = s.double() @ w.double()
        flip_dense = flip_bits[:, :k].double() @ w.double()
        for op in GUARD_OPS:
            static = {"g": GUARD_APEC_G} if op == "apec_matmul" else {}
            for packed in (False, True):
                payload = words if packed else s
                kw = dict(static, packed_k=k) if packed else static

                def call(o, p=payload, kw=kw, op=op):
                    with torch.inference_mode():
                        return dispatch.dispatch(op, p, w, occupancy=o, **kw)

                def modal(mode, o, p=payload, call=call):
                    with dispatch.use_guard(mode), \
                            dispatch.watch_guard_events() as events:
                        out = call(o, p)
                    torch.cuda.synchronize()
                    return out, [(e["kind"], e["action"],
                                  e.get("traced", False)) for e in events]

                def close(got, want, op=op):
                    if op == "spike_matmul":
                        return torch.equal(got, want)
                    err = (got - want).abs().max().item()
                    return err <= 1e-5 * want.abs().max().item() + 1e-5

                what = f"{label} {op} packed={packed}"
                attr = dispatch.resolve_attribution(op, payload, w,
                                                    occupancy=occ, **kw)
                clean = call(occ)
                unguarded = call(bad)
                check(not torch.equal(unguarded, clean),
                      f"{what}: the undercount changes nothing unguarded")
                poisoned, rec = modal("audit", bad)
                check(bool(poisoned.isnan().all()),
                      f"{what}: audit of an undercount not all NaN")
                check(rec == [("undercount", "record", True)],
                      f"{what}: audit records {rec}")
                reset_launch_counts()
                repaired, rec_r = modal("repair", bad)
                counts = {k: v for k, v in launch_counts().items() if v}
                for name, v in counts.items():
                    totals[name] = totals.get(name, 0) + v
                check(rec_r == [("undercount", "repair", True)],
                      f"{what}: repair records {rec_r}")
                check(counts.get("spike_matmul_pred") == 1,
                      f"{what}: repair launches {counts}")
                check(close(repaired, clean), f"{what}: the repaired call "
                      f"is off the clean call")
                err64, bound64 = f64_err(repaired, dense_ref)
                check(err64 <= bound64, f"{what}: the repaired call is "
                      f"{err64} off the f64 product (bound {bound64})")
                overcounted, rec_o = modal("audit", over)
                check(rec_o == [] and close(overcounted, clean),
                      f"{what}: an overcount flagged ({rec_o}) or moved "
                      f"the output")
                fields = {}
                if packed:
                    flip_ref = call(ops.support_map(flipped, k), flipped)
                    check(not close(flip_ref, clean),
                          f"{what}: the bit flip changes nothing")
                    flip_audit, rec_fa = modal("audit", occ, flipped)
                    check(bool(flip_audit.isnan().all()) and rec_fa == [
                        ("undercount", "record", True)],
                          f"{what}: a bit flip not flagged ({rec_fa})")
                    flip_rep, rec_fr = modal("repair", occ, flipped)
                    check(rec_fr == [("undercount", "repair", True)] and
                          close(flip_rep, flip_ref),
                          f"{what}: a bit flip not repaired to the "
                          f"corrupted payload's product")
                    flip_err, flip_bound = f64_err(flip_rep, flip_dense)
                    check(flip_err <= flip_bound, f"{what}: the repaired bit "
                          f"flip is {flip_err} off the f64 product of the "
                          f"corrupted payload (bound {flip_bound})")
                    fields = dict(flip_tile=list(flip_tile),
                                  flips=[list(f) for f in flips],
                                  flip_f64_err=flip_err)
                stale = torch.zeros((occ.shape[0] + 1, occ.shape[1]),
                                    dtype=torch.int32, device=device)
                with dispatch.use_guard("audit"):
                    check(raises(dispatch.GuardViolationError,
                                 lambda: call(stale)),
                          f"{what}: a wrong grid did not raise")
                ms, device_ms = {}, {"unguarded": graph_ms(
                    torch, lambda: call(occ), reps=10)}
                for mode in ("audit", "repair"):
                    def timed_call(mode=mode):
                        with dispatch.use_guard(mode):
                            return call(occ)
                    ms[f"unguarded_{mode}"], ms[mode] = turns_ms(
                        torch, lambda: call(occ), timed_call, reps=10)
                    device_ms[mode] = graph_ms(torch, timed_call, reps=10)
                rel = 0.0 if op == "spike_matmul" else \
                    (repaired - clean).abs().max().item()
                emit("guard_fault", case=label, op=op, packed=packed,
                     shape=[m, k, n], attribution=attr,
                     undercount_tile=[list(c) for c in coords],
                     occupied_share=(occ > 0).float().mean().item(),
                     repaired_equal_bits=torch.equal(repaired, clean),
                     repaired_max_abs_err=rel, repaired_f64_err=err64,
                     repaired_f64_bound=bound64,
                     overcount_equal_bits=torch.equal(overcounted, clean),
                     repair_launches=counts, ms=ms, device_ms=device_ms,
                     audit_added_ms=ms["audit"] - ms["unguarded_audit"],
                     repair_added_ms=ms["repair"] - ms["unguarded_repair"],
                     card=card, **fields)
    # econv: the static grid check only (its map tiles the patch matrix,
    # here a (1, 1) grid).
    x = (torch.rand((2, 8, 8, 6), generator=gen) < 0.3).float().to(device)
    wc = torch.randn((3, 3, 6, 10), generator=gen).to(device)
    with dispatch.use_guard("audit"):
        check(raises(dispatch.GuardViolationError, lambda: dispatch.dispatch(
            "econv", x, wc, occupancy=torch.zeros(
                (2, 1), dtype=torch.int32, device=device))),
              "econv: a wrong grid did not raise")
    emit("guard_grid", op="econv", raised=True, card=card)
    return totals


def phase_guard_graph(torch, device, card):
    """(q3) One CUDA graph of a repaired `spike_matmul` at fc1's shape,
    replayed on the clean map, an undercounted one copied into the same
    buffer and the clean one again: the clean call's output bit for bit
    each time (kernel 12 clean, kernel 10 repaired), where the unguarded
    call on the undercount differs, so the replay on the undercount was
    repaired. Then kernel 10's gated launch on and off in device ms (a
    CUDA graph each)."""
    from repro_torch.kernels import dispatch, ops, spike_matmul
    m, k, n = CSR_SHAPES[1][1]
    gen = torch.Generator().manual_seed(SEED + 33)
    s = clustered_spikes(torch, m, k, gen, device)
    w = torch.randn((k, n), generator=gen).to(device)
    clean_map = ops.padded_occupancy(s)
    bad, _ = undercount_on(torch, clean_map)
    occ = clean_map.clone()
    with torch.inference_mode():
        clean = dispatch.dispatch("spike_matmul", s, w, occupancy=clean_map)
        dropped = dispatch.dispatch("spike_matmul", s, w, occupancy=bad)
    check(not torch.equal(dropped, clean),
          "graph case: the undercount changes nothing unguarded")
    with dispatch.use_guard("repair"):
        be, attr = dispatch.resolve_with_attribution("spike_matmul", s, w,
                                                     occupancy=occ)
    held = {}

    def call():
        held["out"] = be.fn(s, w, occupancy=occ)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph):
        call()
    replays = []
    for label, src in (("clean", clean_map), ("undercount", bad),
                       ("clean", clean_map)):
        occ.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(held["out"], clean),
              f"graph replay on the {label} map: output off the clean call")
        replays.append(dict(map=label, equal_bits=True,
                            repaired=label == "undercount"))
    s2 = s.reshape(-1, k).contiguous()
    support = ops.support_map(s2)
    out = torch.empty((m, n), device=device)
    gate = torch.tensor([1, 0], dtype=torch.int32, device=device)
    gated = {label: graph_ms(torch, functools.partial(
        spike_matmul.spike_matmul_pred, s2, w, support, route=gate[i:i + 1],
        out=out)) for i, label in enumerate(("on", "off"))}
    ungated = graph_ms(torch, functools.partial(
        dispatch.dispatch, "spike_matmul", s, w, occupancy=clean_map))
    emit("guard_graph", shape=[m, k, n], attribution=attr, replays=replays,
         gated_on_device_ms=gated["on"], gated_off_device_ms=gated["off"],
         unguarded_call_device_ms=ungated, card=card)


@contextlib.contextmanager
def planted_undercount(torch, dispatch, index):
    """The `index`-th `spike_matmul` call with a carried map gets an
    undercount of its map (`faults.undercount_occupancy` of a host copy);
    yields the planted tiles."""
    orig = dispatch.dispatch
    seen, planted = [0], []

    def plant(op, *args, **kwargs):
        if op == "spike_matmul" and kwargs.get("occupancy") is not None:
            if seen[0] == index:
                kwargs["occupancy"], coords = undercount_on(
                    torch, kwargs["occupancy"])
                planted.append(coords)
            seen[0] += 1
        return orig(op, *args, **kwargs)
    dispatch.dispatch = plant
    try:
        yield planted
    finally:
        dispatch.dispatch = orig


def phase_guard_train(torch, device, card):
    """(q4) One SpikingFormer-4-384 training step under `repair` with an
    undercount planted in one FFN call against the same step on the clean
    maps (cuDNN deterministic): the loss and every gradient leaf within
    1e-5 * max|ref| + 1e-5, one repair recorded."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.kernels import dispatch
    from repro_torch.optim import adamw
    batch = train_batch(torch, 0, device)
    cfg = SpikingConfig(t_steps=T, lif_vth=V_TH)
    steps, planted, events = {}, [], []
    for plant in (False, True):
        params = fresh_params(torch, device)
        opt = adamw.init(params, adamw.AdamWConfig(lr=LR))
        with contextlib.ExitStack() as stack:
            if plant:
                planted = stack.enter_context(planted_undercount(
                    torch, dispatch, GUARD_PLANT_CALL))
                stack.enter_context(dispatch.use_guard("repair"))
                events = stack.enter_context(dispatch.watch_guard_events())
            loss, grads, _ = train_step(torch, params, opt, batch, cfg)
        torch.cuda.synchronize()
        steps[plant] = (loss, grads)
    (l_clean, g_clean), (l_rep, g_rep) = steps[False], steps[True]
    check(len(planted) == 1 and [e["action"] for e in events] == ["repair"],
          f"planted {planted}, recorded {events}")
    loss_err = (l_rep - l_clean).abs().item()
    check(loss_err <= 1e-5 * l_clean.abs().item() + 1e-5,
          f"repaired step loss {l_rep.item()} != {l_clean.item()}")
    errs = [(a - b).abs().max().item() for a, b in zip(g_rep, g_clean)]
    check(all(e <= 1e-5 * b.abs().max().item() + 1e-5
              for e, b in zip(errs, g_clean)),
          f"repaired step gradients off the clean step's by {max(errs)}")
    emit("guard_train_step", loss=l_rep.item(), clean_loss=l_clean.item(),
         planted_tile=[list(c) for c in planted[0]],
         loss_equal_bits=torch.equal(l_rep, l_clean),
         grads_equal_bits=all(torch.equal(a, b)
                              for a, b in zip(g_rep, g_clean)),
         max_abs_grad_err=max(errs), leaves=len(g_rep), card=card)


def phase_guard(torch, device, card):
    """(q) guarded execution on the card: the models under each mode, the
    fault classes at the CSR shapes, one CUDA graph, one training step."""
    totals = phase_guard_models(torch, device, card)
    for k, v in phase_guard_kernels(torch, device, card).items():
        totals[k] = totals.get(k, 0) + v
    phase_guard_graph(torch, device, card)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        phase_guard_train(torch, device, card)
    finally:
        torch.backends.cudnn.deterministic = was
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 yardsticks
    device = torch.device("cuda", 0)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        emit("phase_time", name=name, seconds=time.perf_counter() - t0)
        return out

    t_start = time.perf_counter()
    card = timed("a_device", phase_device, torch)
    timed("a_build", phase_build)
    gen = torch.Generator().manual_seed(SEED)
    results: dict = {}
    timed("b_lif", phase_lif, torch, gen, device, results)
    timed("b_sdsa", phase_sdsa, torch, gen, device, results)
    timed("b_csr", phase_csr, torch, gen, device, results)
    timed("e_train_kernels", phase_train_kernels, torch, gen, device, results)
    timed("g_pred", phase_pred, torch, gen, device, results)
    totals = timed("c_end_to_end", phase_end_to_end, torch, device)
    for name, n in timed("h_cnn", phase_cnn, torch, device).items():
        totals[name] = totals.get(name, 0) + n
    # cuDNN's SPS-conv backward picks its algorithm per call and may sum
    # in another order from run to run; deterministic algorithms make
    # the three training steps' losses one value in every run.
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        totals.update(timed("f_train", phase_train, torch, device))
    finally:
        torch.backends.cudnn.deterministic = was
    # Row 19's word entry launches on the packed APEC route of (j), its
    # spike entry on the dense route of (i).
    for name, n in (*timed("i_apec", phase_apec, torch, gen, device,
                           results).items(),
                    *timed("j_packed", phase_packed, torch, gen, device,
                           results).items()):
        totals[name] = totals.get(name, 0) + n
    totals.update(timed("k_lm", phase_lm, torch, device, results))
    # Hybrid dispatch's forwards launch kernels 10, 11 and 17 (rows 10, 11
    # and 17) where the carried maps send them.
    for name, n in timed("l_hybrid", phase_hybrid, torch, device).items():
        totals[name] = totals.get(name, 0) + n
    # The serve scheduler's decode steps and admissions launch the bf16
    # fire (row 1's bf16 line).
    for name, n in timed("m_serve", phase_serve, torch, device,
                         card).items():
        totals[name] = totals.get(name, 0) + n
    # The LM's training loop launches rows 2 and 3 bf16 and, forward and
    # recompute, the causal SDSA (row 9).
    for name, n in timed("n_lm_train", phase_lm_train, torch, device,
                         results, card).items():
        totals[name] = totals.get(name, 0) + n
    # The attention-family configs launch the bf16 fire (row 1's bf16
    # line), the causal SDSA (row 9) and, in whisper's encoder, the
    # non-causal SDSA (rows 7-8).
    for name, n in timed("o_archs", phase_archs, torch, device,
                         card).items():
        totals[name] = totals.get(name, 0) + n
    # The SSM configs launch the bf16 fire (row 1's bf16 line) and, in
    # jamba's attention layer, the causal SDSA (row 9).
    for name, n in timed("p_ssm", phase_ssm, torch, device, card).items():
        totals[name] = totals.get(name, 0) + n
    # Guarded execution: the models under each mode and the fault classes
    # on the automatic kernels, kernel 10 behind the repair flag.
    for name, n in timed("q_guard", phase_guard, torch, device, card).items():
        totals[name] = totals.get(name, 0) + n
    emit("phase_time", name="total", seconds=time.perf_counter() - t_start)
    kernels = []
    for name in INFERENCE_KERNELS + TRAINING_KERNELS + APEC_KERNELS + \
            PACKED_KERNELS + LM_KERNELS + LM_TRAIN_KERNELS:
        r = results[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": totals[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
