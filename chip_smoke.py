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
      their plain versions bit for bit, with the same times; the
      backward also with the hard reset and at long T on few neurons
      (LONG_T_DRIVE, on the slab ring), each with the layout it took;
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
      dense step, a resume); the two routes' gradients within
      GRAD_GAP_LIMITS of each other per leaf, each route's distance to
      an f32 yardstick (the same step on an f32 copy of the params on
      `ref`) printed beside it (`grad_yardstick` lines); the kernel
      route with `ref`'s fire backward within WITNESS_LIMIT of `ref`'s
      gradients (`grad_fire_witness`);
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
      spikes against its plain version, and 4 greedy decode steps after
      a chunked prefill, tokens equal to `ref`'s (its decode reads a zero
      cross state, as the reference's); (o4) REDUCED_ARCHS' prefill and
      decode steps in both modes, equal to `ref`; (o5) qwen3-4b,
      phi-3-vision-4.2b (with its stub patch embeddings) and
      internlm2-20b at full width, 4 layers each (O5_LAYERS), one after
      another: a spiking prefill of 8 x
      128 and 4 greedy decode steps after a chunked prefill, on the
      kernels and on `ref`, logits and tokens bit for bit, exact
      launches, peak under 80 GB;
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
  (r) the mesh and sharded event execution on a logical mesh of 8 `data`
      positions on the one card: (r1) the card's host mesh
      (`make_host_mesh(device="cuda:0")`) resolves as no mesh;
      SpikingFormer-4-384 (c's first batch) under `use_mesh(8 positions)`
      keeps every kernel route, its logits and spikes bit for bit with
      the meshless forward; VGG11 / ResNet18 / SegNet-64 print each call
      whose per-shard rows are ragged with its `chosen<-requested`
      attribution, each degrade warned once, spike drift within
      FREE_RUNNING_SPIKE_TOL; (r2) `event_op_sharded` at fc1, fc2 and
      stage 1 on the model's maps and on 50% clustered data with a hot
      band: `spike_matmul` dense (kernel 12) and packed (14), APEC dense
      (19 + 18) and packed (19 + 16), static, rebalanced and (CSR) on a
      caller's `csr_stack`, each equal to the unsharded call (12 / 14 bit
      for bit, APEC within 1e-5·max|ref| + 1e-5), one launch of the
      route's kernels a shard, no pre-pass, `spike_matmul`'s rebalanced
      run (``rebalance=True``: one host read of the card's map, the
      static run none) strictly below the static imbalance on the hot
      band and APEC's equal to it (only the work-list route rebalances),
      host syncs and device ms beside the unsharded call's; 7680 rows
      walking the chain to kernel 10 (`cuda-pred<-cuda-pipe`); the weight
      gradient within 1e-5 of max|ref|; (r3) TinyLlama-1.1B's `Server`
      under both meshes with (m)'s traffic, the meshless tokens and
      launches exactly, and `python -m repro_torch.launch.serve --mesh`;
      (r4) `train_loop(mesh=make_host_mesh(device="cuda:0"))` at
      TinyLlama width, 2 steps, the meshless losses bit for bit; (r5) the
      reference's elastic drill at its `drill` config: saves at 3, 6, 9,
      the newest torn, (4, 2) shrunk to (2, 2), restored at step 6,
      resumed within 0.05 of the healthy run;
  (s) LM training across the families: (s1) xlstm-350m uncut (24
      layers, d 1024; `remat="full"` with a checkpoint a block nested in
      each 8-block group's) at 8 x XLSTM_TRAIN_SEQ tokens: `train_loop`
      for 3 steps dense and spiking at XLSTM_FIRING_VTH, exact launches
      (`lm_train_launches`); one `make_train_step` step on the kernels
      and on `ref`, step 0's loss bit for bit, every gradient finite and
      non-zero except the sLSTM's unread `ln2` / `mlp` (zero), the
      gradient gap and the f32 yardstick as (n); the step's span, host
      enqueue and peak; `loss_fn`'s backward under remat "full" and
      "none", bit for bit, both peaks; (s2) qwen2-moe-a2.7b at full
      width, its depth cut to MOE_TRAIN_LAYERS = 4 (2,904,541,184
      parameters; the full 14.32B with f32 AdamW moments needs about
      172 GB): `train_loop` for 3 steps, its peak under 70 GB; step 0 on
      the kernels (twice: gradients bit for bit) and on `ref` (loss bit
      for bit, the gap, the yardstick and the fire witness as (n)),
      dropped assignments, launches,
      span, enqueue and peak; rows 2 and 3 bf16 on the shared experts'
      training drive; (s3) jamba-1.5-large-398b's full-width period as
      (p3) builds it: `loss_fn`'s backward under remat "full" (nested)
      and "none" at JAMBA_TRAIN_BATCH x 128, bit for bit, peaks under 80
      GB; the reduced jamba with its MoE through `train_loop` and a step
      against `ref` (loss bit for bit); (s4) each timed step of (n) and
      (s) priced by `launch.flops.step_cost`: `flops` (the reference's
      count), `executed_flops` (`executed_train_flops`: with the nested
      remat's second recompute), `model_flops_6nd`, `train_mfu` and
      `train_hw_flops_share` (over `executed_flops`) at the H100 SXM's
      dense bf16 tensor-core peak (989 TFLOP/s);
  (t) (t1) VGG11 and ResNet18 (32x32, cross-entropy) and SegNet (64x64,
      the weighted pixel loss) trained through `launch.cnn_train` at
      (h)'s configuration: 3 AdamW steps each on the kernels and on
      `ref` (printed beside), exact launches a step (CNN_TRAIN_LAUNCHES:
      row 5 and row 3 a fire, kernel 12 an econv, SegNet's two tconvs on
      kernel 10), finite losses and gradients, no all-zero float leaf
      (CNN_SILENT_LEAVES names any model-silent one), each op's backward
      (fire, econv, tconv) on the step's own inputs and cotangent within
      1e-5 * max|ref| + 1e-12 of `ref`'s and each max-pool's within it of
      the plain first-maximum rule, the training forward's spike drift
      within FREE_RUNNING_SPIKE_TOL; the step-0 losses printed and the
      per-leaf gradient gap between the routes gated at
      CNN_ROUTE_GAP_LIMITS; the flip witness (`ref` with the kernel
      route's spikes planted at every fire) within CNN_WITNESS_LIMITS of
      the kernel route's gradients; a breakdown (step span, host
      enqueue, forward, backward, AdamW, per op, peak memory);
      (t2) `ops.sdsa_status` (TPU row 7's status-only entry, its own
      instance of `csrc/sdsa.cu`) at SpikingFormer-4-384's attention
      (f32) and whisper's encoder fold (bf16), on the spikes and on their
      words: one launch a call, bit for bit with the plain versions,
      times and the byte bound; the OR form on the same views, bit for
      bit with its plain version, timed beside it; (t3) `mlp_apply` on a dense and a packed
      EventTensor at block 0's FFN shapes: exact launches (MLP_LAUNCHES),
      every registry call equal to `ref` on the same inputs, the output
      within 1e-5 * max|ref| + 1e-5 of the dense spiking form on `ref`
      (of the down-projection of its own hidden spikes where a hidden
      spike differs, their share within FREE_RUNNING_SPIKE_TOL); (t4) the
      five `repro_torch.examples` mains on the card, cut (EXAMPLE_ARGS):
      clean exits and finite numbers;
  (u) ranks of a process group on the card under `gloo` (phase_u's
      doc): data-parallel TinyLlama, the expert-parallel qwen2-moe
      prefill, the elastic drill across ranks, one `nccl` rank;
  (v) every leaf placed on ranks by `param_specs` (phase_v's doc):
      (v1) TinyLlama-1.1B uncut on a (1, 2) tensor-parallel rank mesh, a
      prefill and three steps beside the one-process run and its witness
      (`placement.witness`), the fire split over the hidden width bit
      for bit; (v2) the same with `pure_fsdp` on (2, 1), each rank's
      peak beside (u1)'s; (v3) qwen3-4b on (1, 2), a prefill and decode
      steps bit for bit with the witness; (v4) a TP / FSDP state saved
      on (2, 2) and restored onto (1, 4); per rank the params held, the
      all-gathers, reduce-scatters and all-reduces a step (calls, bytes,
      ms), exact launches; each line with the card's name and power
      limit;
  (w) the MoE configs on rank meshes as configured (phase_w's doc):
      (w1) qwen2-moe-a2.7b uncut (`moe_apply`, T = 2, four shared
      experts) on a (2, 2) rank mesh, a prefill of 8 x 128 and four
      decode steps, every layer's drops, the first MoE layer, logits
      and tokens bit for bit with the one-process witness; (w2) its
      full width at the depth reckoned from (s2), three steps on (2, 2);
      (w3) the same with `pure_fsdp` on (1, 2); step 0's gaps within
      twice their readings, the step's forward bit for bit with the
      witness, each leaf's blocks equal across ranks; per rank the
      params held, peaks, collectives (calls, bytes, ms), exact
      launches;
  (x) the data-parallel side on ranks (phase_x's doc): (x1)
      `event_op_sharded` with one shard a rank on four `gloo` ranks at
      SpikingFormer-4-384's fc1 / fc2 / stage-1 shapes, kernels 12, 14,
      19 + 18, 19 + 16, one rebalanced call and a ragged grid (kernel 10
      by the chain): each rank's rows and report equal to the one-process
      call's, one launch a rank, the summed dw; (x2) TinyLlama-1.1B on
      the multi-pod (pod 2, data 1, model 2) mesh with compressed
      gradients, bit for bit with (data 2, model 2) in the same world,
      wire, scales and EF equal to one-process compression of the
      gathered sum, exact launches, peaks;
  (d) one JSON line listing every kernel with its launches on the main
      paths ((c) and (h) for inference kernels, (f) for the training
      ones, (t2) for the status entry, (t1) and (t3) adding theirs, (i) for the APEC ones, (j) for the packed ones, (k), (m) and
      (o) and (p) for the LM ones, (l) adding its hybrid forwards' and APEC
      calls', (n) the training fires', (q) its guarded forwards' and
      fault calls', (r) its mesh forwards', sharded calls', serving and
      training, (s) its training loops' and steps' fires and SDSA, (o5)
      and whisper's decode the bf16 fire, (u), (v), (w) and (x) their
      ranks' fires, SDSA and sharded event kernels; the serial kernels
      11, 13, 15
      and 17 by their override
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

try:
    # The card's data-sheet rates (H100 SXM: HBM3, fp32 on the CUDA cores,
    # bf16 / TF32 on the tensor cores, dense): the port's one source.
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_TC_FLOPS
    from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_FLOPS
    from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_FLOPS
except ImportError:     # the script without the repo: main() refuses
    HBM_BYTES_PER_S = FP32_FLOPS = BF16_TC_FLOPS = TF32_FLOPS = None
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
           "sdsa_status": "src/repro_torch/csrc/sdsa.cu",
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
            "sdsa_status": "src/repro/kernels/sdsa_kernel.py:29",
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
# Row 3 at long T on few neurons in f32: qwen2-moe's shared-expert shape
# (the step's 2048 tokens as the time axis, 5632 neurons).
LONG_T_DRIVE = (2048, 5632)


def phase_train_kernels(torch, gen, device, results):
    """The training kernels at the stage-1 drive (T, B*32*32, 96): each
    must equal its plain version bit for bit (both round every operation
    on its own, in the same order). Row 3 also on the hard reset and at
    LONG_T_DRIVE, each `kernel` line with the layout the backward's
    switch took (`lif_scan.bwd_launch`)."""
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
        if name == "lif_bwd":
            results[name]["launch"] = lif_scan.bwd_launch(*x2.shape, False)
        emit("kernel", name=name, **results[name])
    # Row 3 beyond the stage-1 case: the hard reset on the same drive, and
    # long T on few neurons (qwen2-moe's shared-expert shape in f32), where
    # the switch takes the slab ring.
    hard = dict(kw, soft_reset=False)
    _, vres_h = lif_scan.lif_fwd_plain(x2, **hard)
    xl = (0.6 * torch.randn(LONG_T_DRIVE, generator=gen) + 0.2).to(device)
    gl = torch.randn(LONG_T_DRIVE, generator=gen).to(device)
    _, vres_l = lif_scan.lif_fwd_plain(xl, **kw)
    for label, vr, gc, ckw, reps in (
            ("stage1_hard", vres_h, g.reshape(T, -1), hard, 5),
            ("long_t", vres_l, gl, kw, 1)):
        dx = lif_scan.lif_bwd(vr, gc, **ckw)
        want = lif_scan.lif_bwd_plain(vr, gc, **ckw)
        torch.cuda.synchronize()
        err = (dx - want).abs().max().item()
        check(torch.equal(dx, want), f"lif_bwd kernel disagrees with its "
              f"plain version ({label}, max |d| {err})")
        b_ms, by = bound_ms(3 * 4 * gc.numel(), 11 * gc.numel())
        emit("kernel", name="lif_bwd", case=label, max_abs_err=err,
             ms=cuda_ms(torch, lambda: lif_scan.lif_bwd(vr, gc, **ckw)),
             device_ms=graph_ms(torch, lambda: lif_scan.lif_bwd(vr, gc,
                                                                **ckw)),
             plain_ms=cuda_ms(torch, lambda: lif_scan.lif_bwd_plain(
                 vr, gc, **ckw), reps=reps, warmup=1),
             bound_ms=b_ms, bound_by=by, library_ms=None,
             shape=list(gc.shape),
             launch=lif_scan.bwd_launch(*gc.shape, False))


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


def step_breakdown(torch, leaves, loss_of, opt) -> dict:
    """One training step on the kernels (`loss_of()`, its gradients over
    `leaves`, AdamW): device span, host time, forward, backward and
    optimizer device ms, per-op forward and backward device time, peak
    memory."""
    from repro_torch.kernels import dispatch
    from repro_torch.optim import adamw, schedule
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev[0].record()
    with step_timeline(torch, dispatch) as (fwd, bwd, recorded):
        loss = loss_of()
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
    return dict(device_span_ms=span, host_ms=host_s * 1e3,
                forward_ms=ev[0].elapsed_time(ev[1]),
                backward_ms=ev[1].elapsed_time(ev[2]),
                optimizer_ms=ev[2].elapsed_time(ev[3]),
                per_op_forward_ms=per_fwd, per_op_backward_ms=per_bwd,
                rest_ms=span - sum(per_fwd.values()) -
                sum(per_bwd.values()) - ev[2].elapsed_time(ev[3]),
                calls=len(fwd),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_train_breakdown(torch, params, opt, cfg, device):
    """One training step of SpikingFormer on the kernels, broken down."""
    from repro_torch.optim import adamw
    batch = train_batch(torch, TRAIN_STEPS, device)
    emit("train_breakdown", **step_breakdown(
        torch, adamw.leaves(params),
        lambda: train_loss(torch, params, batch, cfg), opt))


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

    def record(spec, op, kwargs, *rest):
        got = orig(spec, op, kwargs, *rest)
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


def kernel10_wide_cases(torch, cap, gen, device):
    """Kernel 10's wide shapes (N > 16), where hybrid sends the models'
    dense calls: the SpikingFormer-4-384 forward's FFN fc1 and fc2 inputs
    and its stage-1 patch matrix with their carried maps (`cap`, one
    forward), clustered data with 50% occupied tiles and an all-empty
    m-tile row at the same shapes, fc1's spikes at a ragged M, and the
    CNNs' coded first conv (K = 27, N = 64, a multi-bit drive) at a ragged
    M: (label, data, s, w, occ)."""
    from repro_torch.kernels import dispatch, ops
    (s1, w1, m1), (s2, w2, m2) = cap["spike_matmul"][:2]
    s_conv, w_conv, m_conv = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    cases = []
    for label, s, w, occ in (
            ("ffn_fc1", s1, w1, m1), ("ffn_fc2", s2, w2, m2),
            ("econv_stage1", dispatch.econv_patches(s_conv, kh, kw, 1, "SAME"),
             w_conv.permute(2, 0, 1, 3).reshape(ci * kh * kw, co), m_conv)):
        s = s.reshape(-1, s.shape[-1]).float().contiguous()
        w = w.float().contiguous()
        cases.append((label, "model", s, w, occ.to(torch.int32).contiguous()))
        syn = clustered_spikes(torch, *s.shape, gen, device)
        syn[:128] = 0                              # an all-empty m-tile row
        cases.append((label, "clustered50", syn, w,
                      ops.padded_occupancy(syn).to(torch.int32)))
    s, w = cases[0][2], cases[0][3]
    ragged = s[:s.shape[0] - 37]
    cases.append(("ffn_fc1", "ragged_m", ragged, w,
                  ops.padded_occupancy(ragged).to(torch.int32)))
    m = T * B * 1024 - 37
    coded = (torch.randint(-128, 128, (m, 27), generator=gen).float() / 127
             * (torch.rand((m, 27), generator=gen) < 0.5)).to(device)
    cases.append(("coded_conv", "ragged_k27", coded,
                  (torch.randn((27, 64), generator=gen) / 27 ** 0.5)
                  .to(device), ops.padded_occupancy(coded).to(torch.int32)))
    return cases


def phase_hybrid_kernel10(torch, cap):
    """Kernel 10 where hybrid sends the models' dense calls, its wide path
    (N > 16), at `kernel10_wide_cases`: the models' maps (every tile
    occupied), 50% clustered maps with an empty m-tile row, a ragged M
    and the coded conv's K = 27. Each: within 1e-5 * max|ref| + 1e-5 of
    its plain version, equal bit for bit to kernels 11 and 12 on the same
    spikes and `build_csr` of the map, a gated-off launch (`route` 0)
    leaving `out` untouched and a gated-on one writing the same bits;
    device ms from a CUDA graph of kernels 10, 11 and 12 and cuBLAS fp32
    in turns (10, 11, 12, cuBLAS, then back), the bound, and the launch
    the C library reports (form, n-tile width, thread tile, grid)."""
    from repro_torch.core.spikes import build_csr
    from repro_torch.kernels import spike_matmul
    gen = torch.Generator().manual_seed(SEED + 10)
    device = cap["econv"][0][1].device
    for label, data, s, w, occ in kernel10_wide_cases(torch, cap, gen,
                                                      device):
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
        case = f"{label}_{data}"
        check(err <= tol, f"kernel 10 at {case} off by {err} > {tol}")
        check(torch.equal(out, fns["k11"]())
              and torch.equal(out, fns["k12"]()),
              f"kernel 10 differs from kernels 11 / 12 at {case}")
        if data == "clustered50":
            check(torch.all(out[:128] == 0).item(),
                  f"kernel 10's empty m-tile row not zero at {case}")
        gated = torch.full_like(out, 7.0)
        off = torch.zeros(1, dtype=torch.int32, device=device)
        spike_matmul.spike_matmul_pred(s, w, occ, route=off, out=gated)
        torch.cuda.synchronize()
        check(torch.all(gated == 7.0).item(),
              f"kernel 10 gated off wrote `out` at {case}")
        spike_matmul.spike_matmul_pred(s, w, occ, route=off + 1, out=gated)
        check(torch.equal(gated, out),
              f"kernel 10 gated on differs at {case}")
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
                   launch=spike_matmul.pred_launch(
                       m, k, n, aligned=s.data_ptr() % 16 == 0
                       and w.data_ptr() % 16 == 0),
                   occupied_share=(occ > 0).float().mean().item(),
                   shape=[m, k, n])
        emit("kernel", name="spike_matmul_pred", case=case, **rec)


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
              backend=None, slots=SERVE_SLOTS, waves=SERVE_WAVES, mesh=None):
    """One Server of `slots` slots (under `mesh`, if given) over `traffic`
    (or over the requests `only` of it, alone): (server, requests, call
    log, wall s, launches of the run). The launch counters are set to 0
    just before the run and read just after it."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.launch.serve import Request, Server
    server = Server(cfg, n_slots=slots, max_seq=SERVE_MAX_SEQ,
                    spiking=spiking, seed=SEED, device=device, mesh=mesh)
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


def block_fires(cfg, spec) -> int:
    """LIF fires one spiking block makes in a forward, from the model's
    code: an attention block fires its input, q, k and v; Mamba its
    input; mLSTM and sLSTM their raw residual; an MLP FFN its input and
    hidden drive; an MoE FFN its input, the routed experts' hidden drive
    and, with shared experts, theirs."""
    n = 4 if spec.kind == "attn" else 1
    if spec.ffn == "mlp":
        n += 2
    elif spec.ffn == "moe":
        n += 2 + (1 if cfg.moe.n_shared else 0)
    return n


# The whole-model gradient gap between the two bf16 routes
# (`gradient_gap`), gated per config at twice the worst leaf read on an
# NVIDIA H100 80GB HBM3 at 700 W: TinyLlama's steps 1.263% apart
# at `embed`, qwen2-moe's 0.650% at `blocks.0.attn.w_v`; xlstm-350m's
# routes agree bit for bit, and must go on doing so. The forward is bit
# for bit and each fire's backward on the same inputs lies within one
# bf16 ulp of `ref`'s (`lm_train_same_input_vjp`); `fire_witness` runs
# the kernel route with `ref`'s fire backward on the kernel forward's
# own drives and holds it to `ref`'s gradients within WITNESS_LIMIT: it
# gave them bit for bit on every leaf, TinyLlama and qwen2-moe,
# so the routes part only in the fires' backward, whose one-ulp
# differences the whole-model backward carries to the gaps above.
# The distances of both routes to an f32 yardstick are printed only:
# each route sits 0.41-19 from it (the f32 forward rounds its drives
# elsewhere and spikes differently), too far for a gap of a few percent
# between the routes to show.
GRAD_GAP_LIMITS = {"tinyllama": 2 * 0.01263, "qwen2-moe": 2 * 0.00650,
                   "xlstm-350m": 0.0}
WITNESS_LIMIT = 0.0
# (what, config, batch, seq, spiking, [step seconds]) of the training
# steps (n) and (s) time, priced by (s4).
STEP_COSTS: list = []


def lm_train_launches(cfg) -> dict:
    """Kernel launches a spiking training step makes, from the model's
    code: each block's fires (`block_fires`) through the residual kernel
    and one causal SDSA an attention block. `remat` "dots", and "full"
    on a one-block pattern, run the forward again in the backward; "full"
    on a longer pattern nests a checkpoint a block inside the group's,
    and the group's recompute stops at its last block's input (a
    non-reentrant checkpoint stops once it has what it saved), after
    which each block recomputes itself: every block but the last runs
    three times, the last twice. Every fire's surrogate backward runs
    once, SDSA's backward replays `ref` (no launch). No primal fire."""
    from repro_torch.models import lm
    pattern, n_groups = lm.layer_pattern(cfg)
    fires = [block_fires(cfg, spec) for spec in pattern]
    attn = [int(spec.kind == "attn") for spec in pattern]

    def runs(per_block):
        if cfg.remat == "none":
            return sum(per_block)
        if cfg.remat == "full" and len(pattern) > 1:
            return 3 * sum(per_block) - per_block[-1]
        return 2 * sum(per_block)
    return {"lif_fwd_bf16": n_groups * runs(fires),
            "lif_bwd_bf16": n_groups * sum(fires),
            "sdsa_causal": n_groups * runs(attn)}


def train_fire_case(torch, label, x, g, plain_reps=3):
    """Rows 2 and 3 bf16 on the drive `x` (T, P) and cotangent `g` against
    their plain versions, bit for bit (spikes, vres, dx): the `kernel`
    lines' records by name, with times and byte bounds."""
    from repro_torch.kernels import lif_scan
    kw = dict(decay=0.5, v_th=1.0, soft_reset=True)
    s, vres = lif_scan.lif_fwd(x, **kw)
    dx = lif_scan.lif_bwd(vres, g, **kw)
    ps, pvres = lif_scan.lif_fwd_plain(x, **kw)
    pdx = lif_scan.lif_bwd_plain(pvres, g, **kw)
    torch.cuda.synchronize()
    check(s.dtype == dx.dtype == torch.bfloat16 and
          vres.dtype == torch.float32, f"{label}: dtypes {s.dtype}, "
          f"{vres.dtype}, {dx.dtype}")
    check(torch.equal(s, ps) and torch.equal(vres, pvres),
          f"lif_fwd_bf16 kernel disagrees with its plain version ({label})")
    check(torch.equal(dx, pdx),
          f"lif_bwd_bf16 kernel disagrees with its plain version ({label})")
    elems = x.numel()
    recs = {}
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
                   plain_ms=cuda_ms(torch, plain, reps=plain_reps),
                   bound_ms=b_ms, bound_by=by, library_ms=None,
                   shape=list(x.shape))
        if name == "lif_bwd_bf16":
            rec["launch"] = lif_scan.bwd_launch(
                x.shape[0], elems // x.shape[0], True)
        emit("kernel", name=name, case=label, **rec)
        recs[name] = rec
    return recs


def phase_lm_train_kernels(torch, device, results):
    """(n1): rows 2 and 3 on bf16 drives against their plain versions,
    bit for bit (spikes, vres, dx), with times and byte bounds."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    for label, p in LM_TRAIN_DRIVES:
        off = 1 if label.startswith("ragged") else 0
        x = (torch.randn((2 * p + off,), generator=gen, device=device)
             * 0.8 + 0.6).bfloat16()[off:].view(2, p)
        g = torch.randn((2 * p + off,), generator=gen, device=device) \
            .bfloat16()[off:].view(2, p)
        recs = train_fire_case(torch, label, x, g)
        if label == "train_hidden":
            results.update(recs)


@contextlib.contextmanager
def counted_steps(torch, steps_mod):
    """While active, every step function `make_train_step` returns
    records each call's launches (the counters read before and after
    it), its metrics and its wall seconds (the card synchronised before
    and after)."""
    from repro_torch.kernels import launch_counts
    orig = steps_mod.make_train_step
    log: list = []

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def counted(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = launch_counts()
            out = step(*a)
            after = launch_counts()
            torch.cuda.synchronize()
            log.append(({k: after[k] - before[k] for k in after}, out[-1],
                        time.perf_counter() - t0))
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


def lm_train_step_breakdown(torch, cfg, params, opt, batch, spiking=True):
    """One step as `make_train_step` runs it, its parts bracketed by CUDA
    events: device span, host enqueue, forward (loss) / backward
    (`autograd.grad`, zeros for a leaf the loss never reads) / optimizer
    ms, and the peak of allocated memory."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    leaves = adamw.leaves(params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev[0].record()
    loss = lm.loss_fn(cfg, params, batch, spiking)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
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


def train_loop_checked(torch, device, cfg, card, what, spiking=True,
                       batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                       steps=LM_TRAIN_STEPS):
    """`train_loop` for `steps` steps on the kernels, each step's launches
    exact (`lm_train_launches`; none dense) and its loss and gradient
    norm finite; its peak memory. Returns (launch totals, the loop's
    output, each step's wall seconds)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train
    from repro_torch.kernels import reset_launch_counts, launch_counts
    per_step = lm_train_launches(cfg) if spiking else {}
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_steps(torch, steps_mod) as log:
        out = train.train_loop(cfg, steps=steps, batch=batch, seq=seq,
                               seed=SEED, log_every=1, spiking=spiking,
                               device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = launch_counts()
    check(len(log) == steps, f"{what}: train_loop ran {len(log)} steps")
    for i, (counts, metrics, _) in enumerate(log):
        lm_launch_check(counts, per_step, f"{what} training step {i}")
        check(bool(torch.isfinite(metrics["loss"])) and
              bool(torch.isfinite(metrics["grad_norm"])),
              f"{what} training step {i}: loss {metrics['loss']}, grad "
              f"norm {metrics['grad_norm']}")
    step_s = [t for _, _, t in log]
    emit("lm_train_loop", card=card, arch=cfg.name, what=what,
         mode="spiking" if spiking else "dense", layers=cfg.n_layers,
         batch=batch, seq=seq, steps=steps, remat=cfg.remat,
         opt_state_dtype=cfg.opt_state_dtype,
         microbatches=cfg.microbatches, wall_s=wall,
         seconds=out["seconds"], step_s=step_s, losses=out["losses"],
         grad_norms=[m["grad_norm"].item() for _, m, _ in log],
         launches_per_step=per_step,
         peak_bytes=torch.cuda.max_memory_allocated())
    return totals, out, step_s


def phase_lm_train_loop(torch, device, cfg, card):
    """(n2): `train_loop` at full width on the kernels, gated per step."""
    totals, out, step_s = train_loop_checked(torch, device, cfg, card,
                                             "tinyllama")
    STEP_COSTS.append(("n_train_loop", cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                       True, step_s))
    return totals, out


def rel_l2(torch, names, got, want) -> dict:
    """Per-leaf relative L2 gap |got - want| / |want|, in f32."""
    return {n: ((a.float() - r.float()).norm() / (r.float().norm() + 1e-30))
            .item() for n, a, r in zip(names, got, want)}


def f32_yardstick(torch, cfg, params, batch, spiking):
    """The gradients of one loss on an f32 copy of `params` on `ref`: the
    yardstick both bf16 routes' gradients are measured against. Returns
    (loss, f32 gradients in `adamw.leaves` order)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    p32 = lm._tree_map(lambda t: t.detach().float().requires_grad_(True),
                       params)
    leaves = adamw.leaves(p32)
    with dispatch.use_backend(dispatch.REF):
        loss = lm.loss_fn(cfg, p32, batch, spiking)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    del p32, leaves
    return loss.detach(), grads


def gradient_gap(torch, cfg, params, batch, spiking, names, grads,
                 ref_grads, what, card, unread=()):
    """The two bf16 routes' gradients against each other, per leaf, gated
    at GRAD_GAP_LIMITS[what]; each route's distance to the f32 yardstick
    (`f32_yardstick`) printed beside it. Leaves the loss never reads
    (`unread`, zero in every route) are left out."""
    y_loss, y_grads = f32_yardstick(torch, cfg, params, batch, spiking)
    keep = [i for i, n in enumerate(names) if n not in unread]
    pick = [names[i] for i in keep]

    def sel(gs):
        return [gs[i] for i in keep]
    inter = rel_l2(torch, pick, sel(grads), sel(ref_grads))
    kernel = rel_l2(torch, pick, sel(grads), sel(y_grads))
    ref = rel_l2(torch, pick, sel(ref_grads), sel(y_grads))
    del y_grads
    limit = GRAD_GAP_LIMITS[what]
    worst = {k: max(v, key=v.get) for k, v in
             (("inter", inter), ("kernel", kernel), ("ref", ref))}
    out = dict(inter_route_max=max(inter.values()), limit=limit,
               kernel_to_f32_max=max(kernel.values()),
               ref_to_f32_max=max(ref.values()),
               worst_leaf=worst, f32_loss=y_loss.item(),
               kernel_to_f32=kernel, ref_to_f32=ref, inter_route=inter)
    emit("grad_yardstick", card=card, what=what, arch=cfg.name,
         mode="spiking" if spiking else "dense", **out)
    for n in pick:
        check(inter[n] <= limit,
              f"{what}: the routes' gradients of {n} are {inter[n]} apart, "
              f"over the limit {limit} (GRAD_GAP_LIMITS: twice the gap "
              f"measured for this step)")
    return out


@contextlib.contextmanager
def ref_fire_backward(torch):
    """While active, the card route's differentiable fire (`ops.lif`, what
    the registry's `lif_scan` runs on the card) fires on the residual
    kernel as before but pulls its cotangent back through `ref`'s fire
    (`lif_scan_ref` under autograd) on the same drive."""
    from repro_torch.kernels import lif_scan, ops
    from repro_torch.kernels.ref import lif_scan_ref

    class KernelFireRefBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, kw):
            ctx.save_for_backward(x)
            ctx.kw = kw
            return lif_scan.lif_fwd(x, decay=kw["decay"], v_th=kw["v_th"],
                                    soft_reset=kw["soft_reset"])[0]

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                (dx,) = torch.autograd.grad(lif_scan_ref(xr, **ctx.kw), xr,
                                            g)
            return dx, None

    def fire(x, decay=0.5, v_th=1.0, soft_reset=True, surrogate_alpha=2.0):
        kw = dict(decay=decay, v_th=v_th, soft_reset=soft_reset,
                  surrogate_alpha=surrogate_alpha)
        flat = x.reshape(x.shape[0], -1).contiguous()
        return KernelFireRefBackward.apply(flat, kw).reshape(x.shape)
    orig = ops.lif
    ops.lif = fire
    try:
        yield
    finally:
        ops.lif = orig


def fire_witness(torch, cfg, params, batch, spiking, names, what, card,
                 grads, ref_grads=None):
    """The kernel route's `loss_fn` gradients with `ref`'s fire backward
    (`ref_fire_backward`) against `ref`'s (computed here unless given)
    and against the kernel route's own (`grads`), per leaf: if the fires'
    backward is where the routes part, the first gap is WITNESS_LIMIT and
    the second the routes' gap. Printed and gated."""
    from repro_torch.kernels import dispatch
    if ref_grads is None:
        _, ref_grads, counts, _ = loss_grads(torch, cfg, params, batch,
                                             spiking, dispatch.REF)
        check(not any(counts.values()), f"the ref pass launched {counts}")
    with ref_fire_backward(torch):
        loss, mixed, counts, _ = loss_grads(torch, cfg, params, batch,
                                            spiking)
    check(counts["lif_fwd_bf16"] > 0 and not counts["lif_bwd_bf16"],
          f"{what}: the witness pass launched {counts}")
    to_ref = rel_l2(torch, names, mixed, ref_grads)
    to_kernel = rel_l2(torch, names, mixed, grads)
    equal = [n for n, a, b in zip(names, mixed, ref_grads)
             if torch.equal(a, b)]
    emit("grad_fire_witness", card=card, what=what, arch=cfg.name,
         leaves=len(names), leaves_equal_to_ref=len(equal),
         to_ref_max=max(to_ref.values()),
         to_ref_worst_leaf=max(to_ref, key=to_ref.get),
         to_kernel_max=max(to_kernel.values()),
         to_kernel_worst_leaf=max(to_kernel, key=to_kernel.get),
         limit=WITNESS_LIMIT, to_ref=to_ref)
    check(max(to_ref.values()) <= WITNESS_LIMIT,
          f"{what}: with ref's fire backward the kernel route's gradients "
          f"are {max(to_ref.values())} from ref's (over {WITNESS_LIMIT})")
    del mixed, ref_grads


def step_runs(torch, cfg, params, batch, spiking, routes):
    """One `make_train_step` step from the same params for each route of
    `routes` (None: the kernels, or a registry backend name), the params
    restored between them: route -> (loss, gradients as the optimizer
    received them, launches). The params are left as they started."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw
    start = [t.detach().clone() for t in adamw.leaves(params)]
    opt_cfg = adamw.AdamWConfig(lr=LR, state_dtype=cfg.opt_state_dtype)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, spiking=spiking)
    runs = {}
    for route in routes:
        opt = adamw.init(params, opt_cfg)
        reset_launch_counts()
        with captured_grads(adamw) as grads, \
                (contextlib.nullcontext() if route is None
                 else dispatch.use_backend(route)):
            _, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        runs[route] = (metrics["loss"], grads[0], launch_counts())
        del opt
        for p, s0 in zip(adamw.leaves(params), start):
            with torch.no_grad():
                p.copy_(s0)
    del start
    return runs


def check_step_grads(torch, names, grads, what, unread=()):
    """Every gradient leaf finite; non-zero, except the leaves the loss
    never reads (`unread`), which must be zero."""
    for name, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()),
              f"{what}: gradient of {name} not finite")
        if name in unread:
            check(not bool(g.any()), f"{what}: gradient of {name}, which "
                  f"the loss never reads, is not zero")
        else:
            check(bool(g.any()), f"{what}: gradient of {name} is all zero")


def phase_lm_train_vs_ref(torch, device, cfg, card):
    """(n2): one `make_train_step` step from the same params on the
    kernels and on `ref`: step 0's loss bit for bit, no all-zero gradient
    leaf, the gradients' per-leaf relative L2 gap to each other and to an
    f32 yardstick (`gradient_gap`); every registry call's backward
    against `ref`'s on the same inputs; the step's breakdown and the two
    ways of slicing the stacked layers."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import dispatch
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
    opt_cfg = adamw.AdamWConfig(lr=LR)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg)
    runs = step_runs(torch, cfg, params, batch, True, (None, dispatch.REF))
    loss, grads, counts = runs[None]
    ref_loss, ref_grads, ref_counts = runs[dispatch.REF]
    lm_launch_check(counts, lm_train_launches(cfg), "make_train_step")
    check(not any(ref_counts.values()), f"the ref step launched {ref_counts}")
    check_step_grads(torch, names, grads, "tinyllama step")
    rel = rel_l2(torch, names, grads, ref_grads)
    emit("lm_train_step_vs_ref", card=card, loss=loss.item(),
         ref_loss=ref_loss.item(), loss_equal=bool(torch.equal(loss,
                                                               ref_loss)),
         max_grad_rel_l2=max(rel.values()),
         worst_leaf=max(rel, key=rel.get), grad_rel_l2=rel)
    check(torch.equal(loss, ref_loss),
          f"step 0's loss on the kernels {loss.item()!r} != ref's "
          f"{ref_loss.item()!r}")
    gradient_gap(torch, cfg, params, batch, True, names, grads, ref_grads,
                 "tinyllama", card)
    fire_witness(torch, cfg, params, batch, True, names, "tinyllama", card,
                 grads)
    del grads, ref_grads, runs

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
    del calls

    # The step's breakdown, then one step with the stacked layers sliced
    # one by one (`_group`) in turns with `unbind` (`_layer_views`):
    # slicing adds a zero-filled full-size gradient a layer.
    opt = adamw.init(params, opt_cfg)
    split = lm_train_step_breakdown(torch, cfg, params, opt, batch)
    emit("lm_train_breakdown", card=card, **split)
    STEP_COSTS.append(("n_step", cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, True,
                       [split["device_span_ms"] / 1e3]))
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
# The scheduler's traffic: 4 requests of 5-16 prompt tokens, 4 new each
# (the script's time), in two waves into 4 slots.
MOE_SERVE_SLOTS, MOE_SERVE_REQUESTS, MOE_SERVE_NEW = 4, 4, 4
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
# A decode step (and each position of the chunked prefill): a decoder
# layer fires ln1, q, k, v, the cross-attention's q and q heads, ln2 and
# the MLP's hidden drive; 4 greedy steps after the chunked prefill.
WHISPER_STEP_LAUNCHES = {"lif_bf16": 24 * 8}
WHISPER_DECODE_STEPS = 4
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
    plain version; WHISPER_DECODE_STEPS greedy decode steps after a
    chunked prefill (`prefill_and_decode`), launches exact, tokens equal
    to `ref`'s."""
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
    del drives, q, k, v
    totals = {name: counts.get(name, 0) for name in O_KERNELS}
    # Decoding: the prefill runs the encoder, the chunked prefill and the
    # decode steps read the zero cross state (a reference finding).
    want = [WHISPER_LAUNCHES,
            {k: n * WHISPER_TOKENS for k, n in WHISPER_STEP_LAUNCHES.items()}
            ] + [WHISPER_STEP_LAUNCHES] * WHISPER_DECODE_STEPS
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, steps, toks, parts = prefill_and_decode(
            torch, cfg, params, tokens, frontend, True, WHISPER_DECODE_STEPS,
            counted=True)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        with dispatch.use_backend(dispatch.REF):
            ref_logits, ref_steps, ref_toks, _ = prefill_and_decode(
                torch, cfg, params, tokens, frontend, True,
                WHISPER_DECODE_STEPS)
        torch.cuda.synchronize()
    for part, (c, w) in enumerate(zip(parts, want)):
        lm_launch_check(c, w, f"{cfg.name} decode part {part}")
        for name in O_KERNELS:
            totals[name] += c.get(name, 0)
    emit("whisper_decode", card=card, arch=cfg.name, batch=WHISPER_BATCH,
         tokens=WHISPER_TOKENS, decode_steps=WHISPER_DECODE_STEPS,
         kernel_s=kernel_s,
         launches=[{k: n for k, n in c.items() if n} for c in parts],
         prefill_equal_ref=bool(torch.equal(logits, ref_logits)),
         decode_equal_ref=bool(torch.equal(steps, ref_steps)),
         tokens_equal_ref=bool(torch.equal(toks, ref_toks)),
         decoded=toks.tolist())
    check(bool(torch.isfinite(steps).all()),
          f"{cfg.name}: decode logits not finite")
    check(torch.equal(toks, ref_toks),
          f"{cfg.name}: the kernels' decoded tokens differ from ref's")
    del params, logits, steps, ref_logits, ref_steps
    free_card(torch)
    return totals


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
            return prefill_and_decode(torch, cfg, params, tokens, frontend,
                                      spiking, REDUCED_DECODE_STEPS)[:2]

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


def prefill_and_decode(torch, cfg, params, tokens, frontend, spiking, steps,
                       counted=False):
    """A `prefill` of `tokens` (with the stub `frontend` where given),
    then `prefill_chunked` over the same tokens and `steps` greedy decode
    steps from its state (which, as in the reference, never reads the
    frontend): (prefill logits, the chunked prefill's and each step's
    logits stacked, the greedy tokens, [launches of the prefill, the
    chunked prefill and each decode step] when `counted`)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    b, n = tokens.shape
    device = tokens.device
    counts = []

    def mark():
        if counted:
            counts.append(launch_counts())
            reset_launch_counts()
    reset_launch_counts()
    logits = lm.prefill(cfg, params, tokens, spiking, frontend=frontend)
    mark()
    last, state = lm.prefill_chunked(cfg, params, tokens,
                                     torch.full((b,), n, device=device),
                                     spiking, n + steps)
    mark()
    outs, token = [last], last.argmax(-1)
    toks = [token]
    pos = torch.full((b,), n, device=device)
    for _ in range(steps):
        last, state = lm.decode_step(cfg, params, state, token, pos, spiking)
        mark()
        outs.append(last)
        token, pos = last.argmax(-1), pos + 1
        toks.append(token)
    return logits, torch.stack(outs), torch.stack(toks, 1), counts


# (o5): the one-card attention-family configs at full width, their depth
# cut to O5_LAYERS layers (the script's time; (v3) serves qwen3-4b at its
# full 36), bf16 weights from SEED: qwen3-4b (d 2560; 4,411,424,256
# parameters at 36 layers), phi-3-vision-4.2b (d 3072, 1024 stub patch
# embeddings prepended; 3,830,516,736 at 32) and internlm2-20b (d 6144;
# 19,861,149,696 at 48), one after another with the card freed between
# them. Each layer of a spiking prefill fires ln1, q, k, v, ln2 and the
# MLP's hidden drive and runs one causal SDSA; a decode step (and each
# position of the chunked prefill) fires the same six.
O5_ARCHS = ("qwen3-4b", "phi-3-vision-4.2b", "internlm2-20b")
O5_BATCH, O5_PROMPT, O5_DECODE_STEPS = 8, 128, 4
O5_LAYERS = 4


def phase_full_archs(torch, device, card, archs=O5_ARCHS):
    """(o5): `archs` at full width and O5_LAYERS layers, spiking: a
    `prefill` of O5_BATCH x O5_PROMPT tokens and O5_DECODE_STEPS greedy
    decode steps after a chunked prefill (`prefill_and_decode`) on the
    kernels and on `ref`: logits and tokens bit for bit, launches exact,
    peak under the card's memory. Returns the launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    totals = {name: 0 for name in O_KERNELS}
    for arch in archs:
        cfg = get_config(arch).replace(n_layers=O5_LAYERS)
        resident = free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=SEED, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.from_numpy(markov_tokens(
            SEED + 11, 0, 0, O5_BATCH, O5_PROMPT, cfg.vocab)
            [:, :O5_PROMPT]).long().to(device)
        frontend = None
        if cfg.n_frontend_tokens:
            frontend = torch.randn(
                (O5_BATCH, cfg.n_frontend_tokens, cfg.d_model),
                generator=torch.Generator(device=device).manual_seed(SEED),
                device=device).bfloat16()
        fires = 6 * cfg.n_layers
        want = [{"lif_bf16": fires, "sdsa_causal": cfg.n_layers},
                {"lif_bf16": fires * O5_PROMPT}] + \
            [{"lif_bf16": fires}] * O5_DECODE_STEPS
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, steps, toks, counts = prefill_and_decode(
                torch, cfg, params, tokens, frontend, True,
                O5_DECODE_STEPS, counted=True)
            torch.cuda.synchronize()
            kernel_s = time.perf_counter() - t0
            with dispatch.use_backend(dispatch.REF):
                t0 = time.perf_counter()
                ref_logits, ref_steps, ref_toks, _ = prefill_and_decode(
                    torch, cfg, params, tokens, frontend, True,
                    O5_DECODE_STEPS)
                torch.cuda.synchronize()
                ref_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for part, (c, w) in enumerate(zip(counts, want)):
            lm_launch_check(c, w, f"{arch} part {part}")
            for name in O_KERNELS:
                totals[name] += c.get(name, 0)
        emit("full_arch", card=card, arch=arch, layers=cfg.n_layers,
             d_model=cfg.d_model, params=lm.param_count(cfg),
             batch=O5_BATCH, tokens=O5_PROMPT,
             frontend_tokens=cfg.n_frontend_tokens,
             decode_steps=O5_DECODE_STEPS, init_s=init_s,
             kernel_s=kernel_s, ref_s=ref_s, resident_before_bytes=resident,
             peak_bytes=peak,
             launches=[{k: n for k, n in c.items() if n} for c in counts],
             finite=bool(torch.isfinite(logits).all() and
                         torch.isfinite(steps).all()),
             prefill_equal_ref=bool(torch.equal(logits, ref_logits)),
             decode_equal_ref=bool(torch.equal(steps, ref_steps)),
             tokens_equal_ref=bool(torch.equal(toks, ref_toks)),
             decoded=toks.tolist())
        check(bool(torch.isfinite(logits).all()) and
              bool(torch.isfinite(steps).all()),
              f"{arch}: logits not finite")
        check(torch.equal(logits, ref_logits) and
              torch.equal(steps, ref_steps) and torch.equal(toks, ref_toks),
              f"{arch}: the kernels' logits or tokens differ from ref's")
        check(peak < CARD_MEMORY_BYTES, f"{arch}: peak {peak} bytes")
        del params, logits, steps, ref_logits, ref_steps
    free_card(torch)
    return totals


def phase_archs(torch, device, card):
    """Phase (o): the attention-family architectures on the card. Returns
    the LM kernels' launches."""
    totals = {name: 0 for name in O_KERNELS}
    for name, fn in (("o1_moe_prefill", phase_moe_prefill),
                     ("o2_moe_serve", phase_moe_serve),
                     ("o3_whisper", phase_whisper),
                     ("o4_reduced", phase_reduced_archs),
                     ("o5_full_archs", phase_full_archs)):
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
# Each of (p1)'s six runs (three variants on two routes) decodes this
# many host-bound steps; 8 since (v) joined the script (16 before).
XLSTM_DECODE_STEPS = 8
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


# ------------------------------------------------------------ phase (r)
# Mesh-aware resolution and sharded event execution on a logical mesh of
# MESH_SHARDS `data` positions on the one card: each shard's rows, work
# list and kernel launch, not placement across cards.
MESH_SHARDS = 8
MESH_APEC_G = 2
# 7680 rows over 8 shards: 960 a shard, not a multiple of 128.
MESH_RAGGED_ROWS = 7680
MESH_REPS = 5
# Sharded against unsharded where the route is not bit for bit (APEC's
# tensor-core kernels, the ragged grid's kernel 10): of max|ref|, + 1e-5.
MESH_TOL = 1e-5
# The kernels one shard of each sharded route launches.
MESH_SHARD_LAUNCHES = {
    ("spike_matmul", False): {"spike_matmul_csr_pipe": 1},
    ("spike_matmul", True): {"spike_matmul_packed_csr_pipe": 1},
    ("apec_matmul", False): {"apec_decompose_spikes": 1,
                             "apec_matmul_csr_pipe": 1},
    ("apec_matmul", True): {"apec_decompose": 1,
                            "apec_matmul_packed_csr_pipe": 1}}
MESH_TRAIN_STEPS = 2
# The reference's elastic drill (tests/conftest.py `elastic_drill`): its
# `drill` config, 10 steps saving every 3, two of four data groups lost.
DRILL_STEPS, DRILL_SAVE_EVERY, DRILL_TOL = 10, 3, 0.05


def add_counts(totals: dict, counts: dict) -> None:
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def mesh8(device):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((MESH_SHARDS, 1), ("data", "model"), devices=device)


def mesh_forward(torch, forward, mesh):
    """One forward (`forward()` -> (out, spikes)) under `use_mesh(mesh)`
    (none for None), with fresh warn-once edges: its outputs, each
    registry call's (op, attribution, per-shard rows of its first
    operand), the degrade warnings and the launches."""
    import warnings
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    shapes = []
    orig = dispatch.dispatch

    def record(op, *args, **kwargs):
        shapes.append(tuple(args[0].shape))
        return orig(op, *args, **kwargs)
    dispatch.reset_fallback_warnings()
    reset_launch_counts()
    dispatch.dispatch = record
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            seen = stack.enter_context(dispatch.watch_resolutions())
            warned = stack.enter_context(
                warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            if mesh is not None:
                stack.enter_context(dispatch.use_mesh(mesh))
            out, stats = forward()
    finally:
        dispatch.dispatch = orig
    torch.cuda.synchronize()
    check(len(seen) == len(shapes), "a registry call resolved twice")
    n = dispatch.data_shard_count(mesh)
    calls = [(r["op"], r["attribution"],
              -(-shape[0] // n) * math.prod(shape[1:-1]))
             for r, shape in zip(seen, shapes)]
    return dict(out=out, stats=stats, calls=calls,
                launches=launch_counts(),
                warnings=[str(w.message) for w in warned
                          if issubclass(w.category, RuntimeWarning)])


def phase_mesh_resolution(torch, device, card):
    """(r1): resolution on the host mesh is the meshless one;
    SpikingFormer-4-384 under an 8-position data mesh keeps every kernel
    route, bit for bit; the CNNs print their ragged per-shard calls, each
    degrade warned once, outputs within the drift gate."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import spikingformer as sf
    host = make_host_mesh(device=device)
    check(dispatch.data_shard_count(host) == 1,
          f"the host mesh {host} splits rows")
    for packed in (False, True):
        flat = dispatch.resolved_backends(device, packed=packed)
        on_host = dispatch.resolved_backends(device, packed=packed,
                                             mesh=host)
        check(on_host == flat, f"host-mesh resolution {on_host} != {flat}")
    mesh = mesh8(device)
    emit("mesh_resolution", card=card, host_mesh=repr(host),
         host_resolution=dispatch.resolved_backends(device, mesh=host),
         mesh8_resolution=dispatch.resolved_backends(device, mesh=mesh))
    totals: dict = {}
    params = sf.spikingformer_init(
        DEPTH, DIM, generator=torch.Generator().manual_seed(SEED),
        device=device)
    x = torch.rand((B, 32, 32, 3),
                   generator=torch.Generator().manual_seed(SEED + 1)
                   ).to(device)
    cfg = SpikingConfig(t_steps=T, lif_vth=V_TH)

    def sf_forward():
        return sf.spikingformer_apply(params, x, n_heads=HEADS,
                                      spiking_cfg=cfg, collect_stats=True)
    models = [("spikingformer", sf_forward)]
    for name in ("vgg11", "resnet18", "segnet"):
        _, forward, batch = cnn_setup(torch, name, device)
        models.append((name, functools.partial(
            lambda f, xb: f(xb, collect_stats=True), forward, batch(0))))
    for name, forward in models:
        flat = mesh_forward(torch, forward, None)
        under = mesh_forward(torch, forward, mesh)
        ragged = [dict(call=i, op=op, attribution=a, shard_rows=rows)
                  for i, ((op, a, rows), (_, a0, _)) in
                  enumerate(zip(under["calls"], flat["calls"])) if a != a0]
        drift = [(a != b).float().mean().item()
                 for a, b in zip(under["stats"], flat["stats"])]
        emit("mesh_forward", card=card, model=name, shards=MESH_SHARDS,
             calls=len(under["calls"]), ragged_calls=ragged,
             warnings=under["warnings"], launches=under["launches"],
             meshless_launches=flat["launches"],
             max_abs_dout=(under["out"] - flat["out"]).abs().max().item(),
             layer_differing_share=drift)
        check(len(under["calls"]) == len(flat["calls"]),
              f"{name}: {len(under['calls'])} registry calls under the "
              f"mesh, {len(flat['calls'])} without")
        check(bool(torch.isfinite(under["out"]).all()),
              f"{name}: outputs under the mesh not finite")
        for r in ragged:
            check("<-" in r["attribution"] and r["shard_rows"] % 128,
                  f"{name}: call {r} moved without a ragged shard grid")
        check(len(set(under["warnings"])) == len(under["warnings"]),
              f"{name}: a degrade warned twice: {under['warnings']}")
        check({r["op"] for r in ragged} == {
            m.split("for op '")[1].split("'")[0] for m in under["warnings"]
            if "for op '" in m},
              f"{name}: the warned ops are not the degraded ones")
        if name == "spikingformer":
            check(not ragged and torch.equal(under["out"], flat["out"])
                  and all(torch.equal(a, b) for a, b in
                          zip(under["stats"], flat["stats"]))
                  and under["launches"] == flat["launches"],
                  "spikingformer under the mesh is not the meshless "
                  "forward bit for bit")
        check(max(drift) <= FREE_RUNNING_SPIKE_TOL,
              f"{name}: spikes under the mesh drift by {max(drift)}")
        add_counts(totals, under["launches"])
    return totals


def hot_band_spikes(torch, m, k, gen, device):
    """50% clustered spikes (`clustered_spikes`) whose first eighth of
    row tiles is fully occupied: the static split loads shard 0 most."""
    s = clustered_spikes(torch, m, k, gen, device)
    band = -(-m // 128) // MESH_SHARDS * 128
    s[:band] = (torch.rand((band, k), generator=gen) < 0.2).float().to(
        device)
    return s


def mesh_operands(torch, device):
    """(label, data, spikes, weights, carried map) at fc1, fc2 and stage 1
    on the model's own maps (one captured forward) and on 50% clustered
    data with a hot band."""
    from repro_torch.kernels import dispatch, ops
    cap = apec_capture(torch, device)
    (s1, w1, m1), (s2, w2, m2) = cap["spike_matmul"][:2]
    s_conv, w_conv, m_conv = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    cases = (("ffn_fc1", s1.reshape(-1, s1.shape[-1]), w1, m1),
             ("ffn_fc2", s2.reshape(-1, s2.shape[-1]), w2, m2),
             ("econv_stage1",
              dispatch.econv_patches(s_conv, kh, kw, 1, "SAME"),
              w_conv.permute(2, 0, 1, 3).reshape(ci * kh * kw, co), m_conv))
    gen = torch.Generator().manual_seed(SEED + 7)
    out = []
    for label, s, w, occ in cases:
        w = w.float().contiguous()
        hot = hot_band_spikes(torch, s.shape[0], s.shape[1], gen, device)
        out.append((label, "model", s.contiguous(), w, occ))
        out.append((label, "clustered50_hotband", hot, w,
                    ops.padded_occupancy(hot)))
    return out


def sharded_call_check(torch, mesh, op, packed, label, data, s, w, occ,
                       card, totals):
    """One op and payload at one shape: the unsharded call, then
    `event_op_sharded` static, rebalanced and (spike_matmul) on a
    caller's `csr_stack`, each gated: equal to the unsharded output (bit
    for bit for kernels 12 / 14, APEC within 1e-5·max|ref| + 1e-5), one
    launch of the route's kernels a shard, no pre-pass; host syncs and
    device ms beside the unsharded call's."""
    from repro_torch.core.spikes import (pack_spikes_padded,
                                         shard_occupancy_to_csr,
                                         stack_shard_csrs,
                                         watch_occupancy_prepasses,
                                         watch_word_prepasses)
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.runtime import sharding
    payload = pack_spikes_padded(s) if packed else s
    kw = {"packed_k": s.shape[-1]} if packed else {}
    if op == "apec_matmul":
        kw["g"] = MESH_APEC_G
    want = {k: n * MESH_SHARDS
            for k, n in MESH_SHARD_LAUNCHES[(op, packed)].items()}

    def unsharded():
        with torch.inference_mode():
            return dispatch.dispatch(op, payload, w, occupancy=occ, **kw)
    flat = unsharded()
    torch.cuda.synchronize()
    tol = MESH_TOL * flat.abs().max().item() + MESH_TOL
    variants = [("static", {"occupancy": occ, "rebalance": False}),
                ("rebalanced", {"occupancy": occ, "rebalance": True})]
    if op == "spike_matmul":
        # The caller's own work lists: its one explicit read of the map.
        variants.append(("csr_stack", {"csr_stack": stack_shard_csrs(
            shard_occupancy_to_csr(occ.cpu(), MESH_SHARDS,
                                   tiling=(128, 128), device=s.device))}))
    else:
        check(raises(ValueError, lambda: sharding.event_op_sharded(
            mesh, op, payload, w, csr_stack=object(), **kw)),
              f"{op}: csr_stack not refused")
    reports = {}
    for variant, extra in variants:
        def sharded(extra=extra, report=False):
            with torch.inference_mode():
                return sharding.event_op_sharded(mesh, op, payload, w,
                                                 with_report=report,
                                                 **extra, **kw)
        reset_launch_counts()
        torch.cuda.synchronize()
        with watch_occupancy_prepasses() as pre, \
                watch_word_prepasses() as words:
            out = sharded()
        torch.cuda.synchronize()
        counts = launch_counts()
        # The report's per-shard counts run each shard's own pre-pass of
        # its spikes (as `repro`'s report does): a call apart, uncounted.
        _, rep = sharded(report=True)
        what = f"{op} {'packed' if packed else 'dense'} {label} {data} " \
               f"{variant}"
        check(counts == {k: want.get(k, 0) for k in counts},
              f"{what}: launches {counts} != {want}")
        check(pre["calls"] == 0 and words["calls"] == 0,
              f"{what}: {pre['calls']} dense and {words['calls']} word "
              f"pre-passes")
        err = (out - flat).abs().max().item()
        same = torch.equal(out, flat)
        check(same if op == "spike_matmul" else err <= tol,
              f"{what}: off the unsharded call by {err}")
        add_counts(totals, counts)
        syncs = sync_count(torch, sharded)
        ms, flat_ms = turns_ms(torch, sharded, unsharded, reps=MESH_REPS)
        imb = rep["occupancy"]
        reports[variant] = imb
        rebalances = variant == "rebalanced" and op == "spike_matmul"
        check(rep["host_reads"] == int(rebalances),
              f"{what}: {rep['host_reads']} host reads of the map")
        emit("mesh_sharded", card=card, op=op, packed=packed, case=label,
             data=data, variant=variant, shards=rep["n_shards"],
             attribution=rep["attribution"],
             occupancy_source=rep["occupancy_source"],
             host_reads=rep["host_reads"], host_syncs=syncs,
             per_shard=list(imb.per_shard), imbalance=imb.imbalance,
             pre_per_shard=list(imb.pre_per_shard),
             pre_imbalance=imb.pre_imbalance, bit_for_bit=same,
             max_abs_err=err, tolerance=tol, ms=ms, unsharded_ms=flat_ms,
             launches=counts)
        check(rep["attribution"] == dispatch.resolve_attribution(
            op, payload, w, occupancy=occ, **kw),
              f"{what}: attribution {rep['attribution']}")
    reb, sta = reports["rebalanced"], reports["static"]
    if op != "spike_matmul":
        # Only the work-list route rebalances (as in `repro`).
        check(not reb.pre_per_shard and reb.imbalance == sta.imbalance,
              f"{op} {label}: APEC rebalanced ({reb})")
    elif data != "model":
        # The hot band: the plan must engage and strictly win.
        check(bool(reb.pre_per_shard) and reb.imbalance < sta.imbalance
              and reb.pre_imbalance == sta.imbalance,
              f"{op} {label}: rebalanced imbalance {reb.imbalance} "
              f"(pre {reb.pre_per_shard}) not below static "
              f"{sta.imbalance}")



def phase_mesh_sharded(torch, device, card):
    """(r2): `event_op_sharded` at SpikingFormer-4-384's fc1, fc2 and
    stage-1 shapes over 8 shards: dense (kernel 12), packed (14), APEC
    dense (19 + 18) and packed (19 + 16), on the model's maps and on a hot
    band; the ragged 7680-row case; the weight gradient."""
    import warnings
    from repro_torch.kernels import dispatch, launch_counts, ops, \
        reset_launch_counts
    from repro_torch.runtime import sharding
    mesh = mesh8(device)
    totals: dict = {}
    operands = mesh_operands(torch, device)
    for label, data, s, w, occ in operands:
        for op in ("spike_matmul", "apec_matmul"):
            for packed in (False, True):
                sharded_call_check(torch, mesh, op, packed, label, data, s,
                                   w, occ, card, totals)
    # The ragged grid: 960 rows a shard walk the chain to kernel 10.
    _, _, s, w, _ = operands[0]
    s = s[:MESH_RAGGED_ROWS].contiguous()
    occ = ops.padded_occupancy(s)
    with torch.inference_mode():
        flat = dispatch.dispatch("spike_matmul", s, w, occupancy=occ)
    dispatch.reset_fallback_warnings()
    reset_launch_counts()
    with torch.inference_mode(), warnings.catch_warnings(record=True) as \
            warned:
        warnings.simplefilter("always")
        out, rep = sharding.event_op_sharded(mesh, "spike_matmul", s, w,
                                             occupancy=occ, with_report=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    err = (out - flat).abs().max().item()
    tol = MESH_TOL * flat.abs().max().item() + MESH_TOL
    emit("mesh_ragged", card=card, rows=MESH_RAGGED_ROWS,
         attribution=rep["attribution"],
         occupancy_source=rep["occupancy_source"], launches=counts,
         warnings=[str(x.message) for x in warned], max_abs_err=err,
         bit_for_bit=torch.equal(out, flat), tolerance=tol)
    check(rep["attribution"] == "cuda-pred<-cuda-pipe" and err <= tol,
          f"ragged shards: {rep['attribution']}, off by {err}")
    check(counts == {k: MESH_SHARDS if k == "spike_matmul_pred" else 0
                     for k in counts}, f"ragged shards launched {counts}")
    add_counts(totals, counts)
    # The weight gradient through the shards against the unsharded one.
    for op in ("spike_matmul", "apec_matmul"):
        # Clones: the captured forward made inference tensors, which
        # autograd does not save.
        s, w, occ = (t.clone() for t in operands[0][2:])
        kw = {"g": MESH_APEC_G} if op == "apec_matmul" else {}
        g = torch.randn((s.shape[0], w.shape[1]),
                        generator=torch.Generator().manual_seed(SEED)
                        ).to(device)
        grads = []
        for sharded in (True, False):
            wr = w.clone().requires_grad_(True)
            out = sharding.event_op_sharded(mesh, op, s, wr, occupancy=occ,
                                            **kw) if sharded else \
                dispatch.dispatch(op, s, wr, occupancy=occ, **kw)
            grads.append(torch.autograd.grad((out * g).sum(), wr)[0])
        rel = ((grads[0] - grads[1]).abs().max()
               / grads[1].abs().max()).item()
        emit("mesh_grad", card=card, op=op, case="ffn_fc1_model",
             max_rel_dw=rel)
        check(rel <= MESH_TOL, f"{op}: sharded dw off by {rel}")
    return totals


def phase_mesh_serve(torch, device, card):
    """(r3): TinyLlama-1.1B uncut through `Server(mesh=...)` with (m)'s
    staggered traffic, on the 8-position data mesh and the host mesh:
    clean, the meshless Server's tokens and launches exactly; the CLI with
    `--mesh`."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(LM_ARCH)
    traffic = serve_requests(cfg)
    totals: dict = {}
    _, flat_reqs, log, _, flat_counts = serve_run(torch, cfg, True, device,
                                                  traffic)
    add_counts(totals, flat_counts)
    for name, mesh in (("mesh8", mesh8(device)),
                       ("host", make_host_mesh(device=device))):
        server, reqs, log, wall, counts = serve_run(torch, cfg, True, device,
                                                    traffic, mesh=mesh)
        clean_run_checks(server, reqs, log, counts, True, f"mesh {name}")
        same = [r.generated == q.generated for r, q in zip(reqs, flat_reqs)]
        emit("mesh_serve", card=card, mesh=name,
             resolved=dispatch.resolved_backends(device, mesh=mesh),
             wall_s=wall, tokens_equal=all(same), launches=counts,
             meshless_launches=flat_counts)
        check(all(same), f"mesh {name}: tokens differ from the meshless "
              f"Server's")
        check(counts == flat_counts, f"mesh {name}: launches {counts} != "
              f"{flat_counts}")
        add_counts(totals, counts)
        free_card(torch)
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH,
         "--reduced", "--mesh", "--requests", "2", "--max-new", "4"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = cli.stdout.splitlines()
    emit("mesh_serve_cli", card=card, rc=cli.returncode,
         first_line=lines[0] if lines else "", stderr=cli.stderr[-2000:])
    check(cli.returncode == 0 and lines and "(mesh-aware)" in lines[0],
          f"serve --mesh exited {cli.returncode}")
    return totals


def meshless_train(torch, cfg, device, steps):
    """`train_loop`'s run without a mesh: the same init, optimizer,
    schedule and batches through `make_train_step` with no mesh."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw, schedule as sched
    params = lm.init_params(cfg, SEED, device=device)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, state_dtype=cfg.opt_state_dtype)
    opt = adamw.init(params, opt_cfg)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, functools.partial(
        sched.warmup_cosine, warmup_steps=max(2, steps // 20),
        total_steps=steps), spiking=cfg.spiking.enabled)
    losses = []
    for step in range(steps):
        batch = pipeline.device_put_batch(synthetic.lm_batch(
            SEED, 0, step, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab), device)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses


def phase_mesh_train(torch, device, card):
    """(r4): `train_loop(mesh=make_host_mesh(device=device))` (the card's
    host mesh) at TinyLlama-1.1B width,
    MESH_TRAIN_STEPS steps: the losses of the meshless steps bit for
    bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(LM_ARCH)
    reset_launch_counts()
    out = train.train_loop(cfg, steps=MESH_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
                           seq=LM_TRAIN_SEQ, seed=SEED, log_every=1,
                           device=device,
                           mesh=make_host_mesh(device=device))
    torch.cuda.synchronize()
    counts = launch_counts()
    del out["params"], out["opt_state"]
    free_card(torch)
    flat = meshless_train(torch, cfg, device, MESH_TRAIN_STEPS)
    free_card(torch)
    emit("mesh_train", card=card, losses=out["losses"],
         meshless_losses=flat, launches=counts)
    check(out["losses"] == flat, f"train_loop on the host mesh: losses "
          f"{out['losses']} != meshless {flat}")
    return counts


def drill_loop(torch, cfg, mesh, params, opt, batches, start, stop,
               mgr=None):
    """The reference's `_drill_loop`: the same global batches whatever the
    mesh, a warmup-cosine AdamW step resolved under `mesh`, a save after
    every `save_every`-th update (labelled with the updates taken)."""
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw, schedule as sched
    step_fn = steps_mod.make_train_step(
        cfg, adamw.AdamWConfig(lr=1e-2), functools.partial(
            sched.warmup_cosine, warmup_steps=2, total_steps=DRILL_STEPS),
        spiking=False, mesh=mesh)
    dev = mesh.distinct_devices()[0]
    losses = []
    for t in range(start, stop):
        params, opt, metrics = step_fn(
            params, opt, pipeline.device_put_batch(batches[t], dev))
        losses.append(float(metrics["loss"]))
        if mgr and mgr.should_save(t + 1):
            mgr.save(t + 1, (params, opt))
    if mgr:
        mgr.wait()
    return losses


def phase_mesh_drill(torch, device, card):
    """(r5): the elastic drill on the card at the reference's `drill`
    config (the `dropped_shard` fault class): train on a (4, 2) mesh
    saving at 3, 6 and 9, tear the newest snapshot, shrink to (2, 2),
    restore walking back to step 6 and resume within 0.05 of the healthy
    run."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import LMConfig, SpikingConfig
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic, faults
    cfg = LMConfig(name="drill", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                   spiking=SpikingConfig(t_steps=1), remat="none",
                   loss_chunk=16)
    batches = [synthetic.lm_batch(0, 0, t, 8, 16, cfg.vocab)
               for t in range(DRILL_STEPS)]

    def fresh():
        params = lm.init_params(cfg, seed=0, device=device)
        return params, adamw.init(params, adamw.AdamWConfig(lr=1e-2))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    try:
        mgr = CheckpointManager(tmp, save_every=DRILL_SAVE_EVERY)
        mesh_a = make_mesh((4, 2), ("data", "model"), devices=device)
        healthy = drill_loop(torch, cfg, mesh_a, *fresh(), batches, 0,
                             DRILL_STEPS, mgr)
        saved = mgr.steps()
        faults.truncate_checkpoint(os.path.join(tmp, "step_000000009"))
        plan = elastic.shrunk_mesh((4, 2), ("data", "model"),
                                   n_failed_data_groups=2)
        mesh_b = make_mesh(plan.mesh_shape, plan.axis_names, devices=device)
        step, (p, o) = elastic.reshard_restore(cfg, mgr, fresh(), mesh_b)
        resumed = drill_loop(torch, cfg, mesh_b, p, o, batches, step,
                             DRILL_STEPS) if step is not None else []
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("mesh_drill", card=card, saved=saved, shrunk=plan.mesh_shape,
         microbatch_scale=plan.microbatch_scale, restored_step=step,
         healthy=healthy, resumed=resumed)
    check(saved == [3, 6, 9] and plan.mesh_shape == (2, 2) and step == 6,
          f"drill: saved {saved}, shrunk {plan.mesh_shape}, restored {step}")
    check(all(math.isfinite(v) and abs(v - h) <= DRILL_TOL * (1 + abs(h))
              for v, h in zip(resumed, healthy[6:])),
          f"drill: resumed {resumed} off healthy {healthy[6:]}")


def phase_mesh(torch, device, card):
    """Phase (r): the mesh and sharded event execution. Returns the
    launches of its gated runs."""
    totals: dict = {}
    for fn in (phase_mesh_resolution, phase_mesh_sharded, phase_mesh_serve,
               phase_mesh_train):
        add_counts(totals, fn(torch, device, card))
        free_card(torch)
    phase_mesh_drill(torch, device, card)
    return totals


# ------------------------------------------------------------ phase (s)
# LM training across the families, each block's fires on rows 2 and 3
# bf16 and each attention block's SDSA on row 9.
# (s1) xlstm-350m uncut (24 layers, d 1024, 222,763,264 parameters) with
# its config's remat "full": each 8-block period one checkpoint with one
# a block nested inside it, as the reference nests them; dense and
# spiking at XLSTM_FIRING_VTH (at the config's 1.0 the stream is silent).
# (s2) qwen2-moe-a2.7b at full width (d 2048, 60 routed experts top-4 of
# 1408 and 4 shared, vocab 151,936) with its depth cut from 24 to
# MOE_TRAIN_LAYERS layers, 2,904,541,184 parameters, so that AdamW's f32
# moments fit one card: the full 14.32B would need about 172 GB for
# params, gradients and moments (`train.train_state_bytes`). Its step is
# compared by `loss_fn` and its gradients, what `make_train_step`
# computes before AdamW, to keep the moments off the card meanwhile.
# (s3) jamba-1.5-large-398b's full-width period as (p3) builds it (8
# layers, MLP FFNs, 8,998,805,504 parameters, 18.0 GB): AdamW does not
# fit beside it, so `loss_fn` and its backward only, at
# JAMBA_TRAIN_BATCH; then the reduced jamba with its MoE FFNs through
# `train_loop`. (s2) and (s3) at S_TRAIN_SEQ tokens a sequence, (s1) at
# XLSTM_TRAIN_SEQ.
S_TRAIN_BATCH, S_TRAIN_SEQ = 8, 128
# The xLSTM's recurrences are host-bound Python loops whose time goes
# with the steps over time, not the batch: (s1) trains on 16 tokens a
# sequence, for the script's time (a step at 128 took 11.5-14.3 s, at 32
# 3.8-6.0 s, on an NVIDIA H100 80GB HBM3, 700 W).
XLSTM_TRAIN_SEQ = 16
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_PEAK_LIMIT = 70e9
JAMBA_TRAIN_BATCH = 4
S_KERNELS = ("lif_fwd_bf16", "lif_bwd_bf16", "sdsa_causal")


def loss_grads(torch, cfg, params, batch, spiking, route=None):
    """`loss_fn` and its gradients over every leaf (zeros where it never
    reads one), what `make_train_step` computes before AdamW, on `route`
    (None: the kernels): (loss, gradients, launches, peak bytes)."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    leaves = adamw.leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with (contextlib.nullcontext() if route is None
          else dispatch.use_backend(route)):
        loss = lm.loss_fn(cfg, params, batch, spiking)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    torch.cuda.synchronize()
    return (loss.detach(), grads, launch_counts(),
            torch.cuda.max_memory_allocated())


def remat_peaks(torch, cfg, params, batch, spiking, what, card,
                remats=("full", "none")):
    """`loss_fn`'s backward under each of `remats`, in order: the loss and
    every gradient bit for bit, the launches exact, each run's peak
    (absolute, and above what was held before it: the earlier runs'
    gradients) under the card's memory. Returns the kernels' launches."""
    from repro_torch.models import lm
    totals = {name: 0 for name in S_KERNELS}
    runs = {}
    for remat in remats:
        c = cfg.replace(remat=remat)
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads, counts, peak = loss_grads(torch, c, params, batch,
                                               spiking)
        seconds = time.perf_counter() - t0
        lm_launch_check(counts, lm_train_launches(c) if spiking else {},
                        f"{what} remat {remat} backward")
        add_counts(totals, counts)
        runs[remat] = dict(loss=loss, grads=grads, peak=peak, held=held,
                           seconds=seconds, launches={
                               k: n for k, n in counts.items() if n})
    first = runs[remats[0]]
    same = {r: bool(torch.equal(v["loss"], first["loss"]) and all(
        torch.equal(a, b) for a, b in zip(v["grads"], first["grads"])))
        for r, v in runs.items()}
    emit("remat_peaks", card=card, what=what, arch=cfg.name,
         mode="spiking" if spiking else "dense", layers=cfg.n_layers,
         batch=batch["tokens"].shape[0], seq=batch["tokens"].shape[1],
         pattern=len(lm.layer_pattern(cfg)[0]),
         runs={r: {k: v[k] for k in ("peak", "held", "seconds", "launches")}
               | {"own_peak": v["peak"] - v["held"]}
               for r, v in runs.items()}, equal=same)
    for remat, v in runs.items():
        check(same[remat], f"{what}: remat {remat}'s loss or gradients "
              f"differ from remat {remats[0]}'s")
        check(v["peak"] < CARD_MEMORY_BYTES,
              f"{what} remat {remat}: peak {v['peak']} bytes")
    del runs, first
    return totals


def train_batch_lm(torch, cfg, batch, seq, device, step=0):
    from repro_torch.data import pipeline, synthetic
    return pipeline.device_put_batch(synthetic.lm_batch(
        SEED, 0, step, batch, seq, cfg.vocab), device)


def phase_xlstm_train(torch, device, card):
    """(s1): xlstm-350m uncut: `train_loop` dense and spiking; one
    `make_train_step` step on the kernels and on `ref` (loss bit for bit,
    every gradient finite and non-zero except the sLSTM's unread `ln2` /
    `mlp`, which are zero; the gap to each other and to the f32
    yardstick); the step's breakdown; remat "full" (nested) against
    "none". Returns the launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    base = get_config(XLSTM_ARCH)
    cfg = with_vth(base, XLSTM_FIRING_VTH)
    totals = {name: 0 for name in S_KERNELS}
    for mode_cfg, spiking in ((base, False), (cfg, True)):
        free_card(torch)
        counts, out, step_s = train_loop_checked(
            torch, device, mode_cfg, card, "xlstm-350m", spiking,
            S_TRAIN_BATCH, XLSTM_TRAIN_SEQ)
        add_counts(totals, counts)
        mode = "spiking" if spiking else "dense"
        STEP_COSTS.append((f"s1_train_loop_{mode}", mode_cfg, S_TRAIN_BATCH,
                           XLSTM_TRAIN_SEQ, spiking, step_s))
        del out
    free_card(torch)
    params = lm.init_params(cfg, seed=SEED, device=device)
    names = leaf_names(params)
    unread = {n for n in names if n.split(".")[:3] in (
        ["blocks", str(cfg.xlstm.slstm_index), "ln2"],
        ["blocks", str(cfg.xlstm.slstm_index), "mlp"])}
    check(len(unread) == 4, f"xlstm-350m: unread leaves {sorted(unread)}")
    batch = train_batch_lm(torch, cfg, S_TRAIN_BATCH, XLSTM_TRAIN_SEQ,
                           device)
    runs = step_runs(torch, cfg, params, batch, True, (None, dispatch.REF))
    loss, grads, counts = runs[None]
    ref_loss, ref_grads, ref_counts = runs[dispatch.REF]
    per_step = lm_train_launches(cfg)
    lm_launch_check(counts, per_step, "xlstm-350m make_train_step")
    add_counts(totals, counts)
    check(not any(ref_counts.values()), f"the ref step launched {ref_counts}")
    check_step_grads(torch, names, grads, "xlstm-350m step", unread)
    check_step_grads(torch, names, ref_grads, "xlstm-350m ref step", unread)
    rel = rel_l2(torch, names, grads, ref_grads)
    emit("ssm_train_step_vs_ref", card=card, arch=cfg.name,
         lif_vth=cfg.spiking.lif_vth, batch=S_TRAIN_BATCH,
         seq=XLSTM_TRAIN_SEQ,
         remat=cfg.remat, loss=loss.item(), ref_loss=ref_loss.item(),
         loss_equal=bool(torch.equal(loss, ref_loss)),
         launches_per_step=per_step, unread_leaves=sorted(unread),
         unread_params=sum(t.numel() for n, t in zip(
             names, adamw.leaves(params)) if n in unread),
         max_grad_rel_l2=max(rel.values()),
         worst_leaf=max(rel, key=rel.get), grad_rel_l2=rel)
    check(torch.equal(loss, ref_loss),
          f"xlstm-350m step 0's loss on the kernels {loss.item()!r} != "
          f"ref's {ref_loss.item()!r}")
    gradient_gap(torch, cfg, params, batch, True, names, grads, ref_grads,
                 "xlstm-350m", card, unread)
    del runs, grads, ref_grads
    opt = adamw.init(params, adamw.AdamWConfig(lr=LR))
    split = lm_train_step_breakdown(torch, cfg, params, opt, batch)
    emit("ssm_train_breakdown", card=card, arch=cfg.name, **split)
    STEP_COSTS.append(("s1_step", cfg, S_TRAIN_BATCH, XLSTM_TRAIN_SEQ,
                       True, [split["device_span_ms"] / 1e3]))
    del opt
    free_card(torch)
    add_counts(totals, remat_peaks(torch, cfg, params, batch, True,
                                     "xlstm-350m", card))
    del params
    free_card(torch)
    return totals


def phase_moe_train(torch, device, card):
    """(s2): qwen2-moe-a2.7b at full width, MOE_TRAIN_LAYERS layers:
    `train_loop` spiking, its peak under MOE_TRAIN_PEAK_LIMIT; step 0's
    `loss_fn` and gradients on the kernels twice (bit for bit) and on
    `ref` (loss bit for bit, the gap printed and against the f32
    yardstick), with launches, dropped assignments, span, enqueue and
    peak; rows 2 and 3 bf16 on the shared experts' training drive, whose
    time axis is the step's flattened tokens. Returns the launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm, moe
    from repro_torch.optim import adamw
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    totals = {name: 0 for name in S_KERNELS}
    free_card(torch)
    counts, out, step_s = train_loop_checked(
        torch, device, cfg, card, "qwen2-moe", True, S_TRAIN_BATCH,
        S_TRAIN_SEQ)
    loop_peak = torch.cuda.max_memory_allocated()
    add_counts(totals, counts)
    STEP_COSTS.append(("s2_train_loop", cfg, S_TRAIN_BATCH, S_TRAIN_SEQ,
                       True, step_s))
    del out
    check(loop_peak < MOE_TRAIN_PEAK_LIMIT,
          f"qwen2-moe at {cfg.n_layers} layers: train_loop's peak "
          f"{loop_peak} bytes is not under {MOE_TRAIN_PEAK_LIMIT}")
    free_card(torch)
    params = lm.init_params(cfg, seed=SEED, device=device)
    names = leaf_names(params)
    batch = train_batch_lm(torch, cfg, S_TRAIN_BATCH, S_TRAIN_SEQ, device)
    keys = {"shared": lambda op, a: op == "lif_scan" and a[0].dim() == 2}
    per_step = lm_train_launches(cfg)
    t0 = time.perf_counter()
    with first_calls(dispatch, keys) as drives:
        loss, grads, counts, peak = loss_grads(torch, cfg, params, batch,
                                               True)
    kernel_s = time.perf_counter() - t0
    lm_launch_check(counts, per_step, "qwen2-moe training step")
    add_counts(totals, counts)
    loss2, grads2, _, _ = loss_grads(torch, cfg, params, batch, True)
    repeat = bool(torch.equal(loss, loss2)) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2))
    differing = [n for n, a, b in zip(names, grads, grads2)
                 if not torch.equal(a, b)]
    del grads2
    ref_loss, ref_grads, ref_counts, _ = loss_grads(
        torch, cfg, params, batch, True, dispatch.REF)
    check(not any(ref_counts.values()), f"the ref step launched {ref_counts}")
    check_step_grads(torch, names, grads, "qwen2-moe step")
    rel = rel_l2(torch, names, grads, ref_grads)
    with torch.no_grad(), moe_drops(torch) as drops:
        lm.loss_fn(cfg, params, batch, True)
    emit("moe_train_step_vs_ref", card=card, arch=cfg.name,
         layers=cfg.n_layers, params=lm.param_count(cfg),
         batch=S_TRAIN_BATCH, seq=S_TRAIN_SEQ, remat=cfg.remat,
         loss=loss.item(), ref_loss=ref_loss.item(),
         loss_equal=bool(torch.equal(loss, ref_loss)),
         repeat_equal=repeat, repeat_differing_leaves=differing,
         launches_per_step=per_step, kernel_step_s=kernel_s,
         step_peak_bytes=peak, train_loop_peak_bytes=loop_peak,
         dropped_assignments=sum(d for d, _ in drops),
         assignments=sum(n for _, n in drops),
         dropped_by_layer=[d for d, _ in drops],
         max_grad_rel_l2=max(rel.values()),
         worst_leaf=max(rel, key=rel.get), grad_rel_l2=rel)
    check(torch.equal(loss, ref_loss),
          f"qwen2-moe step 0's loss on the kernels {loss.item()!r} != "
          f"ref's {ref_loss.item()!r}")
    check(repeat, f"qwen2-moe: two kernel-route steps from the same start "
          f"give other gradients ({differing})")
    gradient_gap(torch, cfg, params, batch, True, names, grads, ref_grads,
                 "qwen2-moe", card)
    fire_witness(torch, cfg, params, batch, True, names, "qwen2-moe", card,
                 grads, ref_grads)
    del grads, ref_grads
    free_card(torch)
    opt = adamw.init(params, adamw.AdamWConfig(lr=LR))
    split = lm_train_step_breakdown(torch, cfg, params, opt, batch)
    emit("moe_train_breakdown", card=card, arch=cfg.name, **split)
    STEP_COSTS.append(("s2_step", cfg, S_TRAIN_BATCH, S_TRAIN_SEQ, True,
                       [split["device_span_ms"] / 1e3]))
    del opt, params
    free_card(torch)
    x = drives["shared"][0].detach()
    g = torch.randn(x.shape, generator=torch.Generator(
        device=device).manual_seed(SEED + 10), device=device).bfloat16()
    train_fire_case(torch, "moe_shared_train", x, g, plain_reps=1)
    del drives, x, g
    return totals


def phase_jamba_train(torch, device, card):
    """(s3): jamba-1.5-large-398b's full-width period, spiking: `loss_fn`'s
    backward under remat "full" (nested) and "none", bit for bit, peaks
    under the card's memory; the reduced jamba with its MoE FFNs through
    `train_loop` and one step on the kernels and on `ref` (step 0's loss
    bit for bit, gradients finite). Returns the launches."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    cfg = jamba_period_config()
    totals = {name: 0 for name in S_KERNELS}
    free_card(torch)
    params = lm.init_params(cfg, seed=SEED, device=device)
    batch = train_batch_lm(torch, cfg, JAMBA_TRAIN_BATCH, S_TRAIN_SEQ,
                           device)
    add_counts(totals, remat_peaks(torch, cfg, params, batch, True,
                                     "jamba period", card))
    del params
    free_card(torch)
    red = get_reduced(JAMBA_ARCH)
    counts, out, _ = train_loop_checked(torch, device, red, card,
                                        "jamba reduced", True,
                                        S_TRAIN_BATCH, S_TRAIN_SEQ)
    add_counts(totals, counts)
    del out
    params = lm.init_params(red, seed=SEED, device=device)
    names = leaf_names(params)
    batch = train_batch_lm(torch, red, S_TRAIN_BATCH, S_TRAIN_SEQ, device)
    runs = step_runs(torch, red, params, batch, True, (None, dispatch.REF))
    loss, grads, counts = runs[None]
    ref_loss, ref_grads, ref_counts = runs[dispatch.REF]
    lm_launch_check(counts, lm_train_launches(red),
                    "jamba reduced make_train_step")
    add_counts(totals, counts)
    check(not any(ref_counts.values()), f"the ref step launched {ref_counts}")
    for name, a in zip(names, grads):
        check(bool(torch.isfinite(a).all()),
              f"jamba reduced: gradient of {name} not finite")
    rel = rel_l2(torch, names, grads, ref_grads)
    emit("ssm_train_step_vs_ref", card=card, arch=red.name,
         layers=red.n_layers, batch=S_TRAIN_BATCH, seq=S_TRAIN_SEQ,
         remat=red.remat, loss=loss.item(), ref_loss=ref_loss.item(),
         loss_equal=bool(torch.equal(loss, ref_loss)),
         max_grad_rel_l2=max(rel.values()),
         worst_leaf=max(rel, key=rel.get))
    check(torch.equal(loss, ref_loss),
          f"jamba reduced step 0's loss on the kernels {loss.item()!r} != "
          f"ref's {ref_loss.item()!r}")
    del runs, grads, ref_grads, params
    free_card(torch)
    return totals


def phase_step_cost(torch, card):
    """(s4): each timed training step of (n) and (s) priced by
    `launch.flops.step_cost` (the reference's analytic step cost):
    `flops` (the reference's count, one recompute under remat "full"),
    `executed_flops` (`executed_train_flops`: also the nested remat's
    second recompute of every block but its group's last) and
    `model_flops_6nd`, and over each step's seconds at the card's dense
    bf16 tensor-core peak, `train_mfu` (6ND) and `train_hw_flops_share`
    (`executed_flops`, all the step's FLOPs)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import flops
    seen = set()
    for what, cfg, batch, seq, spiking, secs in STEP_COSTS:
        shape = ShapeSpec(what, seq, batch, "train")
        cost = flops.step_cost(cfg, shape, spiking)
        executed = flops.executed_train_flops(cfg, shape, spiking)
        emit("step_cost", card=card, what=what, arch=cfg.name,
             layers=cfg.n_layers, batch=batch, seq=seq,
             mode="spiking" if spiking else "dense", remat=cfg.remat,
             flops=cost.flops, executed_flops=executed,
             model_flops_6nd=cost.model_flops_6nd,
             hbm_bytes=cost.hbm_bytes, step_s=secs,
             train_mfu=[cost.model_flops_6nd / (t * BF16_TC_FLOPS)
                        for t in secs],
             train_hw_flops_share=[executed / (t * BF16_TC_FLOPS)
                                   for t in secs],
             peak_flops_per_s=BF16_TC_FLOPS,
             peak="H100 SXM dense bf16 tensor cores (data sheet)")
        seen.add(what.split("_")[0])
    check({"n", "s1", "s2"} <= seen, f"step costs for {sorted(seen)} only")


def phase_train_families(torch, device, card):
    """Phase (s): LM training across the families. Returns the training
    kernels' and the causal SDSA's launches."""
    totals = {name: 0 for name in S_KERNELS}
    for name, fn in (("s1_xlstm_train", phase_xlstm_train),
                     ("s2_moe_train", phase_moe_train),
                     ("s3_jamba_train", phase_jamba_train)):
        t0 = time.perf_counter()
        add_counts(totals, fn(torch, device, card))
        emit("phase_time", name=name, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_step_cost(torch, card)
    emit("phase_time", name="s4_step_cost", seconds=time.perf_counter() - t0)
    return totals


# ------------------------------------------------------------ phase (t)
# (t1) The paper's CNNs trained on the card through `launch.cnn_train`
# (autograd over the float leaves, then AdamW), at (h)'s configuration:
# T = 4, B = 32, v_th = 0.5, VGG11 and ResNet18 on 32x32 `class_images`
# with cross-entropy, SegNet on 64x64 `seg_batch` with the weighted pixel
# loss. Per step every fire runs row 5 (`lif_counts_fwd`: the counts fire
# with its residual) and, backward, row 3 (`lif_bwd`); every econv kernel
# 12; SegNet's two transposed convs kernel 10; the convs' backward replays
# cuDNN in fp32 (`vjp="ref"`) and max-pooling sends each window's
# cotangent to its first maximum. Every kernel not named launches 0 times.
CNN_TRAIN_LAUNCHES = {
    "vgg11": {"lif_counts_fwd": 8, "lif_bwd": 8, "spike_matmul_csr_pipe": 8},
    "resnet18": {"lif_counts_fwd": 17, "lif_bwd": 17,
                 "spike_matmul_csr_pipe": 20},
    "segnet": {"lif_counts_fwd": 5, "lif_bwd": 5, "spike_matmul_csr_pipe": 4,
               "spike_matmul_pred": 2},
}
# Float leaves whose gradient may be all zero on both routes because the
# model is silent there, with the reason: none (every fire of the three
# models spikes at this configuration, (h)'s `layers` lines).
CNN_SILENT_LEAVES: dict = {}
# Same inputs and cotangent, one op's backward, kernel route against `ref`:
# max |delta| <= CNN_GRAD_TOL * max|ref| + CNN_GRAD_FLOOR. The floor only
# keeps an all-zero reference from needing exact zeros: these cotangents
# are small (max|ref| of the fires' backward 3.8e-6 on SegNet), so a floor
# of CNN_GRAD_TOL would let a kernel returning zeros pass. The fires'
# backward kernel and `ref`'s autograd associate the reset term
# differently (at most 2.9e-11 apart on the H100, about 2e-7 of max|ref|).
# `econv` and `tconv` carry `ref`'s backward (`vjp="ref"`), so their rows
# check only that the card route's backward reaches it; max-pooling is a
# routing of the cotangent, held to a plain first-maximum rule.
CNN_GRAD_TOL = 1e-5
CNN_GRAD_FLOOR = 1e-12
# Step 0 (the same params and batch on both routes): per leaf, the
# relative L2 gap between the kernel route's gradients and `ref`'s, gated
# at twice the gap measured on the H100 (NVIDIA H100 80GB HBM3, 700 W:
# VGG11 3.39e-6, ResNet18 0.2293, SegNet 5.00e-7). The routes' forwards
# sum the convs in other orders, so a membrane at the threshold can fire
# on one route and not the other: ResNet18's first fire parts in one
# spike of 8.4M and its last in 0.72%, through the residual adds, and
# every gradient below moves with them. `flip_witness` shows that these
# flips are the whole gap.
CNN_ROUTE_GAP_LIMITS = {"vgg11": 2 * 3.394e-6, "resnet18": 2 * 0.2294,
                        "segnet": 2 * 5.00e-7}
# `flip_witness`: `ref`'s forward and backward with the kernel route's
# spikes planted at every fire (the values the kernel fired, the gradient
# through `ref`'s own fire), against the kernel route's gradients, per
# leaf in relative L2: what is left once the flips are gone. Gated at
# twice the reading on the H100 (NVIDIA H100 80GB HBM3, 700 W: VGG11
# 3.39e-6, ResNet18 1.033e-5, SegNet 5.00e-7, against ResNet18's route
# gap of 0.2293; planted in `ref`, the kernel route's spikes move `ref`'s
# ResNet18 gradients by 0.2293 and VGG11's and SegNet's by nothing).
CNN_WITNESS_LIMITS = {"vgg11": 2 * 3.394e-6, "resnet18": 2 * 1.033e-5,
                      "segnet": 2 * 5.00e-7}
# (t2) The status-only SDSA entry (TPU row 7's `sdsa_status_pallas`) at
# SpikingFormer-4-384's attention (T, B, H, N, dh) = (4, 32, 8, 64, 48),
# f32, a head-transposed view whose heads join the channel axis; and at
# whisper-medium's encoder fold (B, H, T * 1500, dh) = (2, 16, 3000, 64),
# bf16, both contiguous, as the encoder's fold copies it, and as a
# head-transposed view (2 rows of 16 heads' channels over 3000 tokens).
# K and V fire at rate STATUS_RATE (their AND then covers part of the
# channels, not all). (label, the fires' shape, dtype, transposed).
STATUS_CASES = (("spikingformer", (T, B, 64, HEADS, DIM // HEADS),
                 "float32", True),
                ("whisper_fold_heads_joined", (2, 3000, 16, 64), "bfloat16",
                 True),
                ("whisper_fold", (2, 16, 3000, 64), "bfloat16", False))
STATUS_RATE = 0.02
T_KERNELS = ("sdsa_status",)
# (t3) `mlp_apply` on an EventTensor at SpikingFormer-4-384 block 0's FFN
# shapes ((T, B, 64, 384) spikes, 384 -> 1536 -> 384, f32): both
# up-projections and the down-projection on the pipelined CSR kernel (12,
# or 14 on words), the hidden fire on row 4 (or 6 packed).
MLP_LAUNCHES = {False: {"spike_matmul_csr_pipe": 3, "lif_counts": 1},
                True: {"spike_matmul_packed_csr_pipe": 3,
                       "lif_counts_packed": 1}}
# (t4) The port's examples on the card, cut: segmentation 10 steps, the
# LM trainer's 12M variant 20 steps, serving 4 requests of 8 tokens,
# long-context 8 decode steps at 524,288-token positions.
EXAMPLE_ARGS = {
    "quickstart": [],
    "segmentation": ["--steps", "10"],
    "train_spiking_lm": ["--small", "--steps", "20", "--batch", "4",
                         "--seq", "64", "--ckpt-dir",
                         str(ROOT / "build" / "example_lm_ckpt")],
    "serve_spiking_lm": ["--requests", "4", "--max-new", "8"],
    "long_context": ["--tokens", "8"],
}


def float_names(torch, params) -> list:
    """`leaf_names` of the float leaves, in `cnn_train.float_leaves`
    order."""
    from repro_torch.optim import adamw
    return [n for n, x in zip(leaf_names(params), adamw.leaves(params))
            if isinstance(x, torch.Tensor)]


@contextlib.contextmanager
def record_pools(torch):
    """While active, each `max_pool_events` of the CNNs records its input
    spikes and, when the backward reaches it, its output cotangent."""
    from repro_torch.core.events import EventTensor, as_spikes
    from repro_torch.models import cnn
    orig = cnn.max_pool_events
    calls: list = []

    def rec(et, pool):
        out = orig(et, pool)
        s = out.spikes if isinstance(out, EventTensor) else out
        if s.requires_grad:
            entry = [as_spikes(et).detach(), pool, None]
            calls.append(entry)

            def hook(g, entry=entry):
                entry[2] = g.detach().clone()
            s.register_hook(hook)
        return out

    cnn.max_pool_events = rec
    try:
        yield calls
    finally:
        cnn.max_pool_events = orig


def first_max_grad(torch, x, g, pool):
    """Plain first-maximum rule of a VALID max-pool's backward: each
    window's cotangent to the first element, in row-major window order,
    that equals the window's maximum."""
    h, w, c = x.shape[-3:]
    ho, wo = h // pool, w // pool
    lead = x.ndim - 3
    win = x[..., :ho * pool, :wo * pool, :].reshape(
        x.shape[:-3] + (ho, pool, wo, pool, c))
    win = win.permute(*range(lead), lead, lead + 2, lead + 4, lead + 1,
                      lead + 3).reshape(x.shape[:-3] + (ho, wo, c, -1))
    hit = win == win.amax(dim=-1, keepdim=True)
    first = hit & (hit.int().cumsum(dim=-1) == 1)
    d = (first.to(g.dtype) * g[..., None]).reshape(
        x.shape[:-3] + (ho, wo, c, pool, pool))
    d = d.permute(*range(lead), lead, lead + 3, lead + 1, lead + 4,
                  lead + 2).reshape(x.shape[:-3] + (ho * pool, wo * pool, c))
    out = torch.zeros_like(x)
    out[..., :ho * pool, :wo * pool, :] = d
    return out


def grad_gap(a, r) -> tuple:
    """(max |a - r|, max |r|) in f32."""
    return ((a.float() - r.float()).abs().max().item(),
            r.float().abs().max().item())


def cnn_grad_bound(scale: float) -> float:
    """The same-input backward bound at max|ref| = `scale`."""
    return CNN_GRAD_TOL * scale + CNN_GRAD_FLOOR


def worse(gaps: dict, op: str, gap: tuple) -> None:
    """Keep, per op, the gap that uses most of its `cnn_grad_bound`."""
    old = gaps.get(op)
    if old is None or gap[0] / cnn_grad_bound(gap[1]) > \
            old[0] / cnn_grad_bound(old[1]):
        gaps[op] = gap


def cnn_vjp_gaps(torch, dispatch, calls, pools) -> dict:
    """op -> the worst (max |d_kernel - d_ref|, max |d_ref|) over its
    recorded calls and differentiated inputs: each registry call's
    backward replayed on its card backend and on `ref` with the recorded
    inputs and cotangent; each max-pool's card backward against the plain
    first-maximum rule."""
    from repro_torch.core.events import max_pool_events
    gaps: dict = {}
    for op, args, kwargs, g in calls:
        if g is None:
            continue
        kernel = dispatch.resolve(op, *args, **kwargs)
        check(kernel.name == card_routes(dispatch)[op],
              f"(t1) {op} resolved to {kernel.name}")
        pulled = []
        for be in (kernel, dispatch.get_backend(op, dispatch.REF)):
            xs = [a.clone().requires_grad_(a.is_floating_point())
                  for a in args]
            with torch.enable_grad():
                out = be.fn(*xs, **kwargs)
                out = out[0] if isinstance(out, tuple) else out
                pulled.append(torch.autograd.grad(
                    out, [x for x in xs if x.requires_grad], g))
        for a, r in zip(*pulled):
            worse(gaps, op, grad_gap(a, r))
    for x, pool, g in pools:
        if g is None:
            continue
        xs = x.clone().requires_grad_(True)
        with torch.enable_grad():
            (d,) = torch.autograd.grad(max_pool_events(xs, pool), xs, g)
        worse(gaps, "max_pool_events", grad_gap(d, first_max_grad(
            torch, x, g, pool)))
    return gaps


@contextlib.contextmanager
def fire_spikes(dispatch, planted=None):
    """While active, each `lif_scan_occ` call's spikes are kept in call
    order and yielded; with `planted`, the i-th call's spikes take the
    values of `planted[i]` while their gradient still flows through the
    route's own fire."""
    orig = dispatch.dispatch
    seen: list = []

    def fire(op, *args, **kwargs):
        out = orig(op, *args, **kwargs)
        if op != "lif_scan_occ":
            return out
        s, occ, chunks = out
        if planted is not None:
            s = s + (planted[len(seen)] - s).detach()
        seen.append(s.detach())
        return s, occ, chunks

    dispatch.dispatch = fire
    try:
        yield seen
    finally:
        dispatch.dispatch = orig


def flip_witness(torch, name, cfg, params, data, names, grads, ref_grads,
                 spikes, card) -> dict:
    """`ref`'s loss gradients with the kernel route's fired `spikes`
    planted at every fire, per leaf in relative L2 against the kernel
    route's `grads` (gated at CNN_WITNESS_LIMITS) and against `ref`'s own
    `ref_grads` (printed): if the forward's flips are where the routes
    part, the first is at rounding level and the second near the routes'
    gap."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.launch import cnn_train
    reset_launch_counts()
    with dispatch.use_backend(dispatch.REF), \
            fire_spikes(dispatch, planted=spikes) as seen:
        loss = cnn_train.loss_fn(name, cfg, params, data)
        mixed = torch.autograd.grad(loss, cnn_train.float_leaves(params))
    counts = {k: v for k, v in launch_counts().items() if v}
    check(not counts and len(seen) == len(spikes),
          f"(t1) {name}: the witness launched {counts} and planted "
          f"{len(seen)} of {len(spikes)} fires")
    to_kernel = rel_l2(torch, names, mixed, grads)
    to_ref = rel_l2(torch, names, mixed, ref_grads)
    limit = CNN_WITNESS_LIMITS[name]
    out = dict(to_kernel_max=max(to_kernel.values()),
               to_kernel_worst_leaf=max(to_kernel, key=to_kernel.get),
               to_ref_max=max(to_ref.values()), limit=limit,
               loss=loss.item(), to_kernel=to_kernel, to_ref=to_ref)
    emit("cnn_train_flip_witness", model=name, card=card, **out)
    for n in names:
        check(to_kernel[n] <= limit,
              f"(t1) {name}: with the kernel route's spikes planted, ref's "
              f"gradient of {n} is {to_kernel[n]} from the kernel route's "
              f"(over {limit}, CNN_WITNESS_LIMITS)")
    return out


def cnn_train_steps(torch, name, cfg, batches, device, backend):
    """TRAIN_STEPS AdamW steps from fresh params on `backend` (None: the
    automatic card routes): per step the loss, gradients, seconds and
    launches; the final params and optimizer state."""
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.launch import cnn_train
    from repro_torch.optim import adamw
    ocfg = adamw.AdamWConfig(lr=LR)
    params = cnn_train.init_params(name, cfg, SEED, device)
    opt = adamw.init(cnn_train.float_leaves(params), ocfg)
    run = dict(losses=[], grads=[], seconds=[], counts=[])
    for data in batches:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if backend is None else \
                dispatch.use_backend(backend):
            loss, grads, opt = cnn_train.train_step(name, cfg, params, opt,
                                                    data, ocfg)
        torch.cuda.synchronize()
        run["seconds"].append(time.perf_counter() - t0)
        run["counts"].append(launch_counts())
        run["losses"].append(loss.item())
        run["grads"].append(grads)
    return dict(run, params=params, opt=opt)


def phase_cnn_train(torch, device, card):
    """(t1): 3 AdamW steps of each paper CNN on the kernels, gated, and on
    `ref`, printed; each op's backward on the step's own inputs; the
    training forward's spike drift; a breakdown."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import cnn_train
    from repro_torch.models import cnn
    totals: dict = {}
    for name, expected in CNN_TRAIN_LAUNCHES.items():
        cfg = cnn_train.config(name, T, V_TH)
        batches = [cnn_train.batch(name, cfg, SEED, i, B, device)
                   for i in range(TRAIN_STEPS)]
        kern = cnn_train_steps(torch, name, cfg, batches, device, None)
        ref = cnn_train_steps(torch, name, cfg, batches, device, dispatch.REF)
        names = float_names(torch, kern["params"])
        for i in range(TRAIN_STEPS):
            counts = kern["counts"][i]
            want = {k: expected.get(k, 0) for k in counts}
            check(counts == want, f"(t1) {name} step {i}: launches {counts} "
                  f"!= {want}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            check(math.isfinite(kern["losses"][i]),
                  f"(t1) {name} step {i}: loss {kern['losses'][i]}")
            for leaf, g, r in zip(names, kern["grads"][i], ref["grads"][i]):
                check(bool(torch.isfinite(g).all()),
                      f"(t1) {name} step {i}: gradient of {leaf} not finite")
                if not bool((g != 0).any()):
                    check(leaf in CNN_SILENT_LEAVES.get(name, {}) and
                          not bool((r != 0).any()),
                          f"(t1) {name} step {i}: gradient of {leaf} is all "
                          f"zero")
            rel = rel_l2(torch, names, kern["grads"][i], ref["grads"][i])
            if i == 0:
                for n in names:
                    check(rel[n] <= CNN_ROUTE_GAP_LIMITS[name],
                          f"(t1) {name} step 0: the routes' gradients of "
                          f"{n} are {rel[n]} apart, over "
                          f"{CNN_ROUTE_GAP_LIMITS[name]} "
                          f"(CNN_ROUTE_GAP_LIMITS: twice the gap measured)")
            emit("cnn_train_step", model=name, step=i,
                 loss=kern["losses"][i], ref_loss=ref["losses"][i],
                 step_s=kern["seconds"][i], ref_step_s=ref["seconds"][i],
                 max_grad_rel_l2=max(rel.values()), grad_rel_l2=rel,
                 launches={k: v for k, v in counts.items() if v}, card=card)

        # Each op's backward on the first step's own inputs and cotangents,
        # and the kernel route's fired spikes for the flip witness.
        params = cnn_train.init_params(name, cfg, SEED, device)
        with shadow_vjp(torch, dispatch) as calls, \
                record_pools(torch) as pools, \
                fire_spikes(dispatch) as spikes:
            loss = cnn_train.loss_fn(name, cfg, params, batches[0])
            grads = torch.autograd.grad(loss,
                                        cnn_train.float_leaves(params))
        emit("cnn_train_recording_pass", model=name, equal_to_step_0=all(
            torch.equal(a, b) for a, b in zip(grads, kern["grads"][0])))
        flip_witness(torch, name, cfg, params, batches[0], names, grads,
                     ref["grads"][0], spikes, card)
        del grads, spikes
        gaps = cnn_vjp_gaps(torch, dispatch, calls, pools)
        want_ops = {"lif_scan_occ", "econv"} | (
            {"tconv"} if name == "segnet" else set()) | (
            {"max_pool_events"} if name == "vgg11" else set())
        emit("cnn_train_same_input_vjp", model=name, calls=len(calls),
             pools=len(pools), gaps={op: dict(max_abs=e, max_ref=s)
                                     for op, (e, s) in gaps.items()},
             tol=CNN_GRAD_TOL, floor=CNN_GRAD_FLOOR)
        check(set(gaps) == want_ops,
              f"(t1) {name}: backward check saw ops {sorted(gaps)}")
        for op, (err, scale) in gaps.items():
            check(err <= cnn_grad_bound(scale),
                  f"(t1) {name}: {op}'s backward on the kernels differs "
                  f"from ref's on the same inputs by {err} (max|ref| "
                  f"{scale})")

        # The training forward's spikes on the kernels against `ref`'s.
        stats = []
        for backend in (None, dispatch.REF):
            with contextlib.nullcontext() if backend is None else \
                    dispatch.use_backend(backend):
                _, s = getattr(cnn, f"{name}_apply")(
                    cfg, params, batches[0]["image"], collect_stats=True)
            stats.append([x.detach() for x in s])
        drift = [(a != r).float().mean().item() for a, r in zip(*stats)]
        emit("cnn_train_drift", model=name, differing_share=drift,
             spike_rates=[a.float().mean().item() for a in stats[0]])
        for j, share in enumerate(drift):
            check(share <= FREE_RUNNING_SPIKE_TOL,
                  f"(t1) {name} layer {j}: {share} of training spikes "
                  f"differ from ref's")
        del params, stats, calls, pools
        emit("cnn_train_breakdown", model=name, card=card,
             **step_breakdown(torch, cnn_train.float_leaves(kern["params"]),
                              lambda: cnn_train.loss_fn(
                                  name, cfg, kern["params"], batches[0]),
                              kern["opt"]))
        del kern, ref
        free_card(torch)
    return totals


def status_views(torch, gen, shape, dtype, device, transposed):
    """K and V fires at STATUS_RATE: with `transposed`, (..., N, H, dh)
    fires seen as (..., H, N, dh) views, else contiguous `shape`."""
    fires = [(torch.rand(shape, generator=gen, device=device) < STATUS_RATE)
             .to(dtype) for _ in range(2)]
    return [x.transpose(-3, -2) for x in fires] if transposed else fires


def phase_status(torch, device, results, card):
    """(t2): `ops.sdsa_status` on the spikes and the status word entry,
    bit for bit with their plain versions, one launch a call, times."""
    from repro_torch.core.spikes import pack_spikes_padded, unpack_spikes
    from repro_torch.kernels import launch_counts, ops, \
        reset_launch_counts, sdsa_kernel
    gen = torch.Generator(device=device).manual_seed(SEED)
    launches = 0
    for label, shape, dt, transposed in STATUS_CASES:
        dtype = getattr(torch, dt)
        k, v = status_views(torch, gen, shape, dtype, device, transposed)
        reset_launch_counts()
        got = ops.sdsa_status(k, v)
        torch.cuda.synchronize()
        counts = {n: c for n, c in launch_counts().items() if c}
        check(counts == {"sdsa_status": 1},
              f"(t2) {label}: ops.sdsa_status launched {counts}")
        launches += 1
        want = sdsa_kernel.sdsa_status_spikes_plain(k, v)
        check(got.dtype == dtype and got.shape == want.shape and
              got.is_contiguous() and torch.equal(got, want),
              f"(t2) {label}: status disagrees with its plain version")
        b_ms, by = bound_ms((k.numel() + v.numel() + got.numel()) *
                            k.element_size())
        rec = dict(max_abs_err=0.0,
                   ms=cuda_ms(torch, lambda: ops.sdsa_status(k, v)),
                   device_ms=graph_ms(torch, lambda: ops.sdsa_status(k, v)),
                   plain_ms=cuda_ms(torch, lambda: sdsa_kernel.
                                    sdsa_status_spikes_plain(k, v), reps=5),
                   bound_ms=b_ms, bound_by=by, library_ms=None,
                   shape=list(k.shape), dtype=dt,
                   ones_share=got.float().mean().item(), card=card)
        emit("kernel", name="sdsa_status", case=label,
             entry="sdsa_status_spikes", **rec)
        results["sdsa_status"] = rec
        # The OR form (row 7 with its pass 2) on the same K, V views and a
        # Q of the same layout, as the models' attention runs it.
        q = status_views(torch, gen, shape, dtype, device, transposed)[0]
        full = sdsa_kernel.sdsa_or_spikes(q, k, v)
        check(torch.equal(full, sdsa_kernel.sdsa_or_spikes_plain(q, k, v)),
              f"(t2) {label}: the OR form disagrees with its plain version")
        o_ms, o_by = bound_ms((q.numel() * 2 + k.numel() + v.numel()) *
                              k.element_size())
        emit("sdsa_or_beside_status", case=label, card=card,
             ms=cuda_ms(torch, lambda: sdsa_kernel.sdsa_or_spikes(q, k, v)),
             device_ms=graph_ms(torch, lambda: sdsa_kernel.sdsa_or_spikes(
                 q, k, v)),
             bound_ms=o_ms, bound_by=o_by, shape=list(k.shape), dtype=dt)
        del q, full
        n, d = k.shape[-2:]
        kw, vw = (pack_spikes_padded(x.contiguous().reshape(-1, n, d))
                  for x in (k, v))
        reset_launch_counts()
        gw = sdsa_kernel.sdsa_status_words(kw, vw)
        torch.cuda.synchronize()
        counts = {n_: c for n_, c in launch_counts().items() if c}
        check(counts == {"sdsa_status": 1},
              f"(t2) {label} words: launched {counts}")
        ww = sdsa_kernel.sdsa_status_words_plain(kw, vw)
        check(torch.equal(gw.view(torch.int32), ww.view(torch.int32)),
              f"(t2) {label}: status words disagree with their plain "
              f"version")
        check(torch.equal(unpack_spikes(gw, dtype=dtype)[:, :d].reshape(
            got.shape), got), f"(t2) {label}: words and spikes disagree")
        wb_ms, wby = bound_ms((kw.numel() + vw.numel() + gw.numel()) * 4)
        emit("kernel", name="sdsa_status", case=label + "_words",
             entry="sdsa_status_words", max_abs_err=0.0,
             ms=cuda_ms(torch, lambda: sdsa_kernel.sdsa_status_words(kw, vw)),
             device_ms=graph_ms(torch, lambda: sdsa_kernel.sdsa_status_words(
                 kw, vw)),
             plain_ms=cuda_ms(torch, lambda: sdsa_kernel.
                              sdsa_status_words_plain(kw, vw), reps=5),
             bound_ms=wb_ms, bound_by=wby, library_ms=None,
             shape=list(kw.shape), card=card)
    return {"sdsa_status": launches}


def phase_mlp_events(torch, device, card):
    """(t3): `mlp_apply` on a dense and a packed EventTensor at block 0's
    FFN shapes: exact launches, every registry call equal to `ref` on the
    same inputs, the output against the dense spiking form on `ref`."""
    from repro_torch.core.lif import LIFConfig
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.models import layers
    lif_cfg = LIFConfig(v_th=V_TH)
    p = layers.mlp_init(DIM, 4 * DIM, torch.float32,
                        generator=torch.Generator().manual_seed(SEED),
                        device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    drive = torch.randn((T, B, 64, DIM), generator=gen, device=device)
    fired: list = []
    fire_events, fire = layers.lif_fire_events, layers.lif_fire

    def rec_events(h, cfg, packed=False):
        out = fire_events(h, cfg, packed=packed)
        fired.append(out.dense())
        return out

    def rec_fire(h, cfg):
        out = fire(h, cfg)
        fired.append(out)
        return out

    totals: dict = {}
    with torch.inference_mode():
        for packed in (False, True):
            x = layers.lif_fire_events(drive, lif_cfg, packed=packed)
            fired.clear()
            reset_launch_counts()
            layers.lif_fire_events = rec_events
            try:
                out = layers.mlp_apply(p, x, True, lif_cfg)
            finally:
                layers.lif_fire_events = fire_events
            torch.cuda.synchronize()
            counts = launch_counts()
            want = {k: MLP_LAUNCHES[packed].get(k, 0) for k in counts}
            check(counts == want, f"(t3) packed={packed}: launches {counts} "
                  f"!= {want}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            layers.lif_fire = rec_fire
            try:
                with dispatch.use_backend(dispatch.REF):
                    ref_out = layers.mlp_apply(p, x.dense(), True, lif_cfg)
            finally:
                layers.lif_fire = fire
            hidden, ref_hidden = fired
            differ = (hidden != ref_hidden).float().mean().item()
            scale = ref_out.abs().max().item()
            err = (out - ref_out).abs().max().item()
            # Where a hidden membrane sits within fp32 summation order of
            # the threshold, the two routes fire differently; the kernel
            # output is then held to the down-projection of its own hidden
            # spikes, and the share that differs to (h)'s drift limit.
            down = hidden @ p["w_down"]
            held = err if differ == 0 else \
                (out - down).abs().max().item()
            with shadow_ref(torch, dispatch) as shadow:
                layers.mlp_apply(p, x, True, lif_cfg)
            ms = cuda_ms(torch, lambda: layers.mlp_apply(p, x, True, lif_cfg),
                         reps=10)
            with dispatch.use_backend(dispatch.REF):
                ref_ms = cuda_ms(torch, lambda: layers.mlp_apply(
                    p, x.dense(), True, lif_cfg), reps=10)
            emit("mlp_events", packed=packed, shape=list(x.shape),
                 launches={k: v for k, v in counts.items() if v},
                 max_abs_err=err, max_ref=scale, hidden_differing=differ,
                 held_err=held, same_input_ops=shadow, ms=ms,
                 dense_ref_ms=ref_ms, card=card)
            check(bool(torch.isfinite(out).all()) and
                  out.shape == ref_out.shape, f"(t3) packed={packed}: output")
            check(differ <= FREE_RUNNING_SPIKE_TOL,
                  f"(t3) packed={packed}: {differ} of hidden spikes differ")
            check(held <= 1e-5 * scale + 1e-5,
                  f"(t3) packed={packed}: output {held} from ref's")
            for op, e in shadow.items():
                check(e <= SAME_INPUT_TOL[op],
                      f"(t3) packed={packed}: {op} differs from ref on the "
                      f"same inputs by {e}")
    return totals


def example_numbers(x) -> list:
    """The numbers in an example's returned record."""
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return []
    if isinstance(x, (int, float)):
        return [float(x)]
    if isinstance(x, dict):
        return [n for v in x.values() for n in example_numbers(v)]
    if isinstance(x, (list, tuple)):
        return [n for v in x for n in example_numbers(v)]
    return []


def phase_examples(torch, card):
    """(t4): the five examples' `main()` on the card, cut: clean exits and
    finite numbers."""
    import importlib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    for name, args in EXAMPLE_ARGS.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        reset_launch_counts()
        t0 = time.perf_counter()
        out = mod.main(args)
        torch.cuda.synchronize()
        nums = example_numbers(out)
        emit("example", name=name, args=args,
             seconds=time.perf_counter() - t0, numbers=len(nums),
             launches={k: v for k, v in launch_counts().items() if v},
             card=card)
        check(bool(nums) and all(math.isfinite(n) for n in nums),
              f"(t4) {name}: numbers not finite")
        free_card(torch)


def phase_t(torch, device, results, card):
    """(t) CNN training, the status entry, the MLP on events, the
    examples."""
    totals: dict = {}
    for name, fn, args in (
            ("t1_cnn_train", phase_cnn_train, (torch, device, card)),
            ("t2_status", phase_status, (torch, device, results, card)),
            ("t3_mlp_events", phase_mlp_events, (torch, device, card)),
            ("t4_examples", phase_examples, (torch, card))):
        t0 = time.perf_counter()
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for k, v in (fn(*args) or {}).items():
                totals[k] = totals.get(k, 0) + v
        finally:
            torch.backends.cudnn.deterministic = was
        emit("phase_time", name=name, seconds=time.perf_counter() - t0)
    return totals


# ------------------------------------------------------------ phase (u)
# The mesh on ranks of a process group. On one card every rank shares
# cuda:0 under `gloo` (NCCL refuses two ranks on one card); (u4) runs the
# `nccl` path in a group of one rank.
U_BACKEND = "gloo"
U_SPAWN_TIMEOUT = 300
U1_MESH, U2_MESH, U3_MESH = (2, 1), (1, 2), (4, 2)
U1_LOSS_RTOL = 1e-3
# (u1) step 0's per-leaf gradient gap (relative L2) between the 2-rank
# data-parallel step and the one-process step on the same rows, gated at
# twice the worst leaf read on an NVIDIA H100 80GB HBM3 at 700 W. The
# ranks' forwards run 2 rows each, the one-process forward 4: other GEMM
# shapes, and the ranks' bf16 gradients are summed once more: the first
# card run read 1.573% at `blocks.0.attn.w_v`, with step 0's losses bit
# for bit (PERF.md). `split_grads` is the witness of that cause.
U1_GRAD_GAP_LIMIT = 2 * 0.01573
U_KERNELS = ("lif_fwd_bf16", "lif_bwd_bf16", "sdsa_causal", "lif_bf16")
DRILL_AXES = ("data", "model")
U1_PEAKS: list = []             # (u1)'s ranks' peaks, beside (v2)'s


def rank_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_peak(torch, dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def rank_free(torch, dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def fingerprint(torch, t, chunk: int = 1 << 26) -> int:
    """A 64-bit digest of a tensor's bits computed on its device (each
    16- or 32-bit word times an odd weight of its position, summed mod
    2^64): two tensors that differ in one bit differ here. Chunked, so a
    bank of billions of elements needs no host copy."""
    x = t.detach().contiguous().view(-1)
    bits = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    total = 0
    for s in range(0, bits.numel(), chunk):
        b = bits[s:s + chunk].long()
        w = torch.arange(s, s + b.numel(), device=b.device,
                         dtype=torch.int64) * 6364136223846793005 \
            + 1442695040888963407
        total += int((b * (w | 1)).sum().item())
    return total % (1 << 64)


@contextlib.contextmanager
def timed_reduces(torch, distributed, dev):
    """While active, every `distributed.all_reduce_` is timed (the card
    synchronised before and after) and logged as (bytes, seconds)."""
    orig = distributed.all_reduce_
    log: list = []

    def timed(t, *args, **kwargs):
        rank_sync(torch, dev)
        t0 = time.perf_counter()
        out = orig(t, *args, **kwargs)
        rank_sync(torch, dev)
        log.append((t.numel() * t.element_size(), time.perf_counter() - t0))
        return out

    distributed.all_reduce_ = timed
    try:
        yield log
    finally:
        distributed.all_reduce_ = orig


def reduce_summary(log) -> dict:
    return dict(all_reduces=len(log), all_reduce_bytes=sum(b for b, _ in log),
                all_reduce_ms=sum(s for _, s in log) * 1e3)


@contextlib.contextmanager
def rank_steps(torch, steps_mod, dev):
    """While active, each step `make_train_step` returns logs its
    launches, metrics, host enqueue and span seconds (the card
    synchronised before it), and the fingerprints of the params and of
    the gradients AdamW received."""
    from repro_torch.kernels import launch_counts
    from repro_torch.optim import adamw
    orig_make, orig_update = steps_mod.make_train_step, adamw.update
    log: list = []
    grads_fp: list = []

    def update(grads, *a, **k):
        grads_fp.append([fingerprint(torch, g) for g in adamw.leaves(grads)])
        return orig_update(grads, *a, **k)

    def make(*args, **kwargs):
        step = orig_make(*args, **kwargs)

        def counted(params, opt, batch):
            rank_sync(torch, dev)
            before = launch_counts()
            t0 = time.perf_counter()
            out = step(params, opt, batch)
            host = time.perf_counter() - t0
            rank_sync(torch, dev)
            span = time.perf_counter() - t0
            after = launch_counts()
            log.append(dict(
                launches={k: after[k] - before[k] for k in after},
                loss=out[-1]["loss"].item(),
                grad_norm=out[-1]["grad_norm"].item(),
                host_s=host, span_s=span,
                params=[fingerprint(torch, p) for p in adamw.leaves(out[0])]))
            return out
        return counted

    steps_mod.make_train_step, adamw.update = make, update
    try:
        yield log, grads_fp
    finally:
        steps_mod.make_train_step, adamw.update = orig_make, orig_update


@contextlib.contextmanager
def first_update(adamw):
    """While active, the gradients of the first `adamw.update` call (one
    step's copy, where `captured_grads` keeps every step's)."""
    orig, got = adamw.update, []

    def update(grads, *a, **k):
        if not got:
            got.extend(g.detach().clone() for g in adamw.leaves(grads))
        return orig(grads, *a, **k)

    adamw.update = update
    try:
        yield got
    finally:
        adamw.update = orig


def split_grads(torch, cfg, batch, seq, dev) -> list:
    """(u1)'s witness, on one process: step 0's gradients as the
    data-parallel step makes them. Each data rank's rows of shard 0's
    batch give the gradient of the global loss (their token sum over the
    step's labelled positions) in the leaves' dtypes, and the parts are
    summed in those dtypes, as the ranks' `all_reduce` sums them."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    n = U1_MESH[0]
    params = lm.init_params(cfg, SEED, device=dev)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rows = batch // n
    b = synthetic.lm_batch(SEED, 0, 0, rows, seq, cfg.vocab)
    per = rows // n
    terms = [lm.loss_terms(cfg, params, pipeline.device_put_batch(
        {k: v[i * per:(i + 1) * per] for k, v in b.items()}, dev), True)
        for i in range(n)]
    cnt = sum(c.detach().clone() for _, c in terms)
    total = None
    for tot, _ in terms:
        g = torch.autograd.grad(tot / torch.clamp(cnt, min=1.0), leaves,
                                allow_unused=True, materialize_grads=True)
        total = list(g) if total is None else \
            [a + c for a, c in zip(total, g)]
    return total


def u1_rank(cfg, batch, seq, steps) -> dict:
    """(u1) one rank: rank 0 first runs the one-process `train_loop` (a
    logical mesh of U1_MESH's shape on its card, one step, the same rows)
    and keeps its step-0 loss and gradients; then every rank runs
    `train_loop` over the rank mesh."""
    import torch
    from repro_torch.launch import distributed, steps as steps_mod, train
    from repro_torch.launch.mesh import make_mesh, make_rank_mesh
    from repro_torch.optim import adamw
    dev, me = distributed.device(), distributed.rank()
    out = {"rank": me}
    kw = dict(batch=batch, seq=seq, seed=SEED, log_every=1)
    ref_grads = None
    if me == 0:
        with first_update(adamw) as got:
            ref = train.train_loop(cfg, steps=1, device=dev, mesh=make_mesh(
                U1_MESH, DRILL_AXES, devices=dev), **kw)
        out["one_process_loss"] = ref["losses"][0]
        ref_grads = list(got)
        del ref, got
        rank_free(torch, dev)
        witness = split_grads(torch, cfg, batch, seq, dev)
        rank_free(torch, dev)
    distributed.barrier()
    mesh = make_rank_mesh(U1_MESH, DRILL_AXES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with rank_steps(torch, steps_mod, dev) as (log, grads_fp), \
            first_update(adamw) as got, \
            timed_reduces(torch, distributed, dev) as reduces:
        res = train.train_loop(cfg, steps=steps, mesh=mesh, **kw)
    out.update(losses=res["losses"], steps=log, grads_fp=grads_fp,
               peak_bytes=rank_peak(torch, dev), **reduce_summary(reduces))
    if ref_grads is not None:
        names = leaf_names(res["params"])
        out["grad_gap"] = rel_l2(torch, names, got, ref_grads)
        out["witness_gap"] = rel_l2(torch, names, witness, ref_grads)
        out["witness_unequal"] = [n for n, a, w in zip(names, got, witness)
                                  if not torch.equal(a, w)]
        out["grads_finite"] = all(bool(torch.isfinite(g).all())
                                  for g in got)
    return out


def phase_dp_train(torch, device, card):
    """(u1): TinyLlama-1.1B uncut on a (data 2, model 1) rank mesh of two
    `gloo` ranks on the card, LM_TRAIN_STEPS AdamW steps at LM_TRAIN_BATCH
    x LM_TRAIN_SEQ: after every step the params bit for bit across
    ranks; step 0's loss within U1_LOSS_RTOL of the one-process loop's on
    the same rows and its per-leaf gradient gap within U1_GRAD_GAP_LIMIT;
    finite losses and gradients; exact launches a step on every rank; the
    sum of the ranks' peaks under the card's memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import distributed
    cfg = get_config(LM_ARCH)
    free_card(torch)
    t0 = time.perf_counter()
    ranks = distributed.spawn(
        u1_rank, U1_MESH[0] * U1_MESH[1], backend=U_BACKEND, device=device,
        timeout_s=U_SPAWN_TIMEOUT,
        args=(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS))
    wall = time.perf_counter() - t0
    per_step = lm_train_launches(cfg)
    totals: dict = {}
    gap = ranks[0]["grad_gap"]
    worst = max(gap, key=gap.get)
    for r in ranks:
        emit("dp_train_rank", card=card, rank=r["rank"], backend=U_BACKEND,
             mesh=list(U1_MESH), losses=r["losses"],
             step_span_s=[s["span_s"] for s in r["steps"]],
             host_enqueue_s=[s["host_s"] for s in r["steps"]],
             all_reduces=r["all_reduces"],
             all_reduce_bytes=r["all_reduce_bytes"],
             all_reduce_ms=r["all_reduce_ms"], peak_bytes=r["peak_bytes"],
             launches_per_step=per_step)
        for i, s in enumerate(r["steps"]):
            lm_launch_check(s["launches"], per_step,
                            f"(u1) rank {r['rank']} step {i}")
            for k, v in s["launches"].items():
                totals[k] = totals.get(k, 0) + v
            check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]),
                  f"(u1) rank {r['rank']} step {i}: loss {s['loss']}, "
                  f"grad norm {s['grad_norm']}")
    peaks = sum(r["peak_bytes"] for r in ranks)
    U1_PEAKS[:] = [r["peak_bytes"] for r in ranks]
    loss0, ref0 = ranks[0]["losses"][0], ranks[0]["one_process_loss"]
    emit("dp_train", card=card, arch=cfg.name, ranks=len(ranks),
         batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, steps=LM_TRAIN_STEPS,
         wall_s=wall, loss0=loss0, one_process_loss0=ref0,
         loss0_rel=abs(loss0 - ref0) / abs(ref0), grad_gap_worst=gap[worst],
         grad_gap_worst_leaf=worst, grad_gap_limit=U1_GRAD_GAP_LIMIT,
         peak_sum_bytes=peaks)
    for i in range(LM_TRAIN_STEPS):
        check(all(r["steps"][i]["params"] == ranks[0]["steps"][i]["params"]
                  for r in ranks), f"(u1) step {i}: params differ across "
              f"ranks")
        check(all(r["grads_fp"][i] == ranks[0]["grads_fp"][i]
                  for r in ranks), f"(u1) step {i}: summed gradients "
              f"differ across ranks")
    check(ranks[0]["grads_finite"], "(u1) step 0 gradients not finite")
    check(abs(loss0 - ref0) <= U1_LOSS_RTOL * abs(ref0),
          f"(u1) step 0 loss {loss0} vs one-process {ref0}")
    # The witness: the ranks' step made on one process, its parts' bf16
    # gradients summed once more, equals theirs bit for bit, so the gap is
    # that sum's rounding.
    wgap = ranks[0]["witness_gap"]
    emit("dp_train_witness", card=card, unequal_leaves=len(
        ranks[0]["witness_unequal"]), leaves=len(gap),
         grad_gap_worst=wgap[max(wgap, key=wgap.get)],
         grad_gap_worst_leaf=max(wgap, key=wgap.get))
    check(not ranks[0]["witness_unequal"], f"(u1) the rank step's "
          f"gradients differ from the witness's at "
          f"{ranks[0]['witness_unequal'][:3]}")
    check(gap[worst] <= U1_GRAD_GAP_LIMIT,
          f"(u1) step 0 gradient gap {gap[worst]} at {worst} over "
          f"{U1_GRAD_GAP_LIMIT}")
    check(peaks < CARD_MEMORY_BYTES, f"(u1) ranks' peaks sum to {peaks}")
    return totals


@contextlib.contextmanager
def first_moe_call(name):
    """While active, the input and output of the first call of
    `moe.<name>`, on the CPU."""
    from repro_torch.models import moe
    orig = getattr(moe, name)
    got: list = []

    def kept(p, x, **kw):
        out = orig(p, x, **kw)
        if not got:
            got.extend((x.detach().cpu(), out.detach().cpu()))
        return out

    setattr(moe, name, kept)
    try:
        yield got
    finally:
        setattr(moe, name, orig)


@contextlib.contextmanager
def ep_drops(shard_of=None):
    """While active, each `moe_apply_shard_map` call records the
    assignments it drops for capacity (`moe.dropped_assignments`; a host
    read a call): all of them, or with `shard_of(p)` -> (j, e_loc) a model
    rank's own."""
    from repro_torch.models import moe
    orig = moe.moe_apply_shard_map
    rec: list = []

    def counted(p, x, **kw):
        rec.append(moe.dropped_assignments(
            p, x, top_k=kw["top_k"], capacity_factor=kw["capacity_factor"],
            shard=shard_of(p) if shard_of else None))
        return orig(p, x, **kw)

    moe.moe_apply_shard_map = counted
    try:
        yield rec
    finally:
        moe.moe_apply_shard_map = orig


@contextlib.contextmanager
def planted_ep_rounding(m):
    """(u2)'s witness: while active, `moe_apply` routes, keeps and drops
    as itself but rounds its combine as the expert-parallel MoE over m
    model positions does: each position's experts' slots summed into a
    partial (`_combine` per position, bf16 adds), the partials summed in
    position order. Its expert GEMMs stay whole: splitting them as each
    position does changed no bit on an NVIDIA H100 (PERF.md)."""
    from repro_torch.models import moe
    orig = moe._combine

    def combine(eo, r, s_loc, top_k):
        e_loc = eo.shape[0] // m
        sorted_ids = r.ids.reshape(-1)[r.sort_idx]
        acc = None
        for j in range(m):
            part = orig(eo, r._replace(
                keep=r.keep & (sorted_ids // e_loc == j)), s_loc, top_k)
            acc = part if acc is None else acc + part
        return acc

    moe._combine = combine
    try:
        yield
    finally:
        moe._combine = orig


def bank_leaves(whole, specs) -> list:
    """Per leaf of `whole`, in `adamw.leaves` order: whether it is an
    expert bank its spec splits over `model` (expert parallelism)."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    return adamw.leaves(sharding._zip_specs(
        lambda path, leaf, spec: sharding._bank_dim(path, spec) is not None,
        whole, specs))


def u2_rank(cfg, tokens_np) -> dict:
    """(u2) one rank of the (1, 2) rank mesh: its half of the expert
    banks (the ranks take turns drawing the whole tree from the seed and
    keeping their part), then the spiking prefill, twice."""
    import torch
    from repro_torch.kernels import dispatch, launch_counts, \
        reset_launch_counts
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_rank_mesh, use_concrete_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    dev, me = distributed.device(), distributed.rank()
    mesh = make_rank_mesh(U2_MESH, DRILL_AXES)
    resolved = dispatch.resolved_backends(dev, mesh=mesh)
    print(f"[u2 rank {me}] dispatch backends on {dev}: " + " ".join(
        f"{k}={v}" for k, v in resolved.items()), flush=True)
    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    for turn in range(distributed.world_size()):
        if turn == me:
            full = lm.init_params(cfg, seed=SEED, device=dev)
            params = sharding.local_params(full, specs, mesh)
            del full
            rank_free(torch, dev)
        distributed.barrier()
    sliced = bank_leaves(whole, specs)
    leaves = adamw.leaves(params)
    banks = [fingerprint(torch, t) for t, s in zip(leaves, sliced) if s]
    bank_shapes = [list(t.shape) for t, s in zip(leaves, sliced) if s]
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    tokens = torch.from_numpy(tokens_np).long().to(dev)
    j, m = mesh.coords()["model"], mesh.shape["model"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode(), use_concrete_mesh(mesh):
        reset_launch_counts()
        rank_sync(torch, dev)
        t0 = time.perf_counter()
        with first_moe_call("moe_apply_shard_map") as layer0:
            logits = lm.prefill(cfg, params, tokens, True)
        rank_sync(torch, dev)
        first_s = time.perf_counter() - t0
        counts = launch_counts()
        with timed_reduces(torch, distributed, dev) as reduces:
            t0 = time.perf_counter()
            again = lm.prefill(cfg, params, tokens, True)
            rank_sync(torch, dev)
            span_s = time.perf_counter() - t0
        with ep_drops(lambda p: (j, p["w_gate"].shape[0])) as drops:
            lm.prefill(cfg, params, tokens, True)
    return dict(rank=me, j=j, model=m, resolved=resolved,
                logits=logits.float().cpu(), repeats=bool(
                    torch.equal(again, logits)), launches=counts,
                dropped=drops, layer0=layer0, first_prefill_s=first_s,
                prefill_span_s=span_s, bank_fingerprints=banks,
                bank_shapes=bank_shapes, param_bytes=param_bytes,
                peak_bytes=rank_peak(torch, dev), **reduce_summary(reduces))


def phase_ep_prefill(torch, device, card):
    """(u2): qwen2-moe-a2.7b uncut with `moe_shard_map=True` on a (data 1,
    model 2) rank mesh of two `gloo` ranks on the card, each holding 30
    routed experts a layer (and its half of the attention heads and the
    shared experts' d_ff, every one-process form below running those per
    model position, `placement.witness`): the spiking prefill of
    MOE_BATCH x MOE_PROMPT tokens bit for bit with the one-process
    logical-mesh form; the first
    MoE layer on the same input within 2^-7 * max|ref| of `moe_apply`'s
    ((o1)'s: the two sums of the expert partials round apart in bf16),
    the logits' distance to `moe_apply`'s printed (the later layers'
    fires flip on those roundings); the dropped assignments of every
    layer equal to the logical form's and layer 0's to `moe_apply`'s;
    the witness, `moe_apply` with the EP combine's rounding planted
    (`planted_ep_rounding`), equal to the rank form in logits and drops;
    each rank's banks exactly its half of the seed's, exact launches,
    the same routes on every rank."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_mesh, use_concrete_mesh
    from repro_torch.models import lm, placement
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    base = get_config(MOE_ARCH)
    cfg = base.replace(moe_shard_map=True)
    free_card(torch)
    tokens_np = markov_tokens(SEED, 0, 0, MOE_BATCH, MOE_PROMPT,
                              base.vocab)[:, :MOE_PROMPT]
    params = lm.init_params(cfg, seed=SEED, device=device)
    tokens = torch.from_numpy(tokens_np).long().to(device)
    logical = make_mesh(U2_MESH, DRILL_AXES, devices=device)
    # The ranks' attention and shared experts are tensor-parallel too
    # (phase (v)): every one-process form here runs them per model
    # position on the logical mesh (`placement.witness`), so what the
    # forms below differ in is the MoE alone.
    with torch.inference_mode(), use_concrete_mesh(logical), \
            placement.witness():
        with moe_drops(torch) as drops, first_moe_call("moe_apply") as layer0:
            ref = lm.prefill(base, params, tokens, True)
        with ep_drops() as logical_drops:
            want = lm.prefill(cfg, params, tokens, True)
        with planted_ep_rounding(U2_MESH[1]), moe_drops(torch) as w_drops:
            witness = lm.prefill(base, params, tokens, True)
    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, logical)
    sliced = bank_leaves(whole, specs)
    m = U2_MESH[1]
    halves = []
    for j in range(m):
        halves.append([fingerprint(torch, t.narrow(
            1, j * (t.shape[1] // m), t.shape[1] // m))
            for t, s in zip(adamw.leaves(params), sliced) if s])
    ref_drops = [d for d, _ in drops]
    assignments = sum(n for _, n in drops)
    ref, want = ref.float().cpu(), want.float().cpu()
    witness, w_drops = witness.float().cpu(), [d for d, _ in w_drops]
    del params
    free_card(torch)
    t0 = time.perf_counter()
    ranks = distributed.spawn(u2_rank, m, backend=U_BACKEND, device=device,
                              timeout_s=U_SPAWN_TIMEOUT,
                              args=(cfg, tokens_np))
    wall = time.perf_counter() - t0
    scale = ref.abs().max().item()
    x0, y0 = layer0
    y0_scale = y0.float().abs().max().item()
    totals: dict = {}
    for r in ranks:
        err = (r["logits"] - ref).abs().max().item()
        rx0, ry0 = r["layer0"]
        y0_err = (ry0.float() - y0.float()).abs().max().item()
        emit("ep_prefill_rank", card=card, rank=r["rank"], model=r["j"],
             backend=U_BACKEND, first_prefill_s=r["first_prefill_s"],
             prefill_span_s=r["prefill_span_s"],
             all_reduces=r["all_reduces"],
             all_reduce_bytes=r["all_reduce_bytes"],
             all_reduce_ms=r["all_reduce_ms"], peak_bytes=r["peak_bytes"],
             param_bytes=r["param_bytes"], bank_shapes=r["bank_shapes"][:1],
             dropped=sum(r["dropped"]), max_abs_dlogits_moe_apply=err,
             layer0_max_abs_dout=y0_err, layer0_max_out=y0_scale,
             launches={k: v for k, v in r["launches"].items() if v})
        lm_launch_check(r["launches"], MOE_PREFILL_LAUNCHES,
                        f"(u2) rank {r['rank']} prefill")
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
        check(r["repeats"], f"(u2) rank {r['rank']}: prefill does not "
              f"repeat bit for bit")
        check(torch.equal(r["logits"], want), f"(u2) rank {r['rank']}: "
              f"logits differ from the one-process logical-mesh form by "
              f"{(r['logits'] - want).abs().max().item()}")
        check(torch.equal(rx0, x0), f"(u2) rank {r['rank']}: the first MoE "
              f"layer's input differs from moe_apply's")
        check(y0_err <= 2.0 ** -7 * y0_scale, f"(u2) rank {r['rank']}: the "
              f"first MoE layer's output {y0_err} from moe_apply's (max "
              f"{y0_scale})")
        check(r["bank_fingerprints"] == halves[r["j"]],
              f"(u2) rank {r['rank']}: its banks are not model half "
              f"{r['j']} of the seed's")
        check(r["resolved"] == ranks[0]["resolved"],
              f"(u2) rank {r['rank']} resolved other routes")
    # Per MoE layer: the ranks' own drops summed. Layer 0 routes the same
    # rows in all three forms; from layer 1 on the rows carry the combine's
    # rounding, which the logical form shares bit for bit and moe_apply's
    # one sum over the k slots does not.
    dropped = [sum(x) for x in zip(*(r["dropped"] for r in ranks))]
    emit("ep_prefill", card=card, arch=cfg.name, batch=MOE_BATCH,
         tokens=MOE_PROMPT, ranks=m, wall_s=wall, dropped=sum(dropped),
         logical_dropped=sum(logical_drops),
         moe_apply_dropped=sum(ref_drops), assignments=assignments,
         dropped_by_layer=dropped, moe_apply_dropped_by_layer=ref_drops,
         max_abs_dlogits_logical=(ranks[0]["logits"] - want).abs().max()
         .item(), max_ref=scale,
         peak_sum_bytes=sum(r["peak_bytes"] for r in ranks))
    check(dropped == logical_drops, f"(u2) dropped {dropped} != the "
          f"logical form's {logical_drops}")
    # The witness: `moe_apply` with the EP form's rounding planted lands on
    # the rank form's logits and drops, so what parts them from
    # `moe_apply`'s is that rounding.
    emit("ep_prefill_witness", card=card,
         max_abs_dlogits_logical=(witness - want).abs().max().item(),
         max_abs_dlogits_moe_apply=(witness - ref).abs().max().item(),
         dropped=sum(w_drops))
    check(torch.equal(witness, want), "(u2) moe_apply with the EP combine's "
          "rounding planted differs from the rank form's logits")
    check(w_drops == dropped, f"(u2) moe_apply with the EP combine's "
          f"rounding planted dropped {w_drops}, the rank form {dropped}")
    check(dropped[0] == ref_drops[0], f"(u2) layer 0 dropped {dropped[0]} "
          f"!= moe_apply's {ref_drops[0]}")
    return totals


def u3_drill_rank(cfg, mesh_shape, ck_dir, resume) -> dict:
    """(u3) one rank: the healthy drill saving at 3, 6 and 9 (rank 0
    writes), or the restore onto the shrunk mesh and the resumed steps."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import synthetic
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    dev = distributed.device()
    mesh = make_rank_mesh(mesh_shape, DRILL_AXES)
    batches = [synthetic.lm_batch(0, 0, t, 8, 16, cfg.vocab)
               for t in range(DRILL_STEPS)]
    params = lm.init_params(cfg, seed=0, device=dev)
    fresh = (params, adamw.init(params, adamw.AdamWConfig(lr=1e-2)))
    mgr = CheckpointManager(ck_dir, save_every=DRILL_SAVE_EVERY,
                            writer=mesh.rank == 0)
    if not resume:
        from repro_torch.runtime import sharding
        specs = sharding.state_specs(sharding.param_specs(cfg, params, mesh))
        losses = rank_drill_loop(cfg, mesh, *sharding.local_params(
            fresh, specs, mesh), batches, 0, DRILL_STEPS, mgr)
        return {"losses": losses}
    step, (p, o) = elastic.reshard_restore(cfg, mgr, fresh, mesh)
    losses = rank_drill_loop(cfg, mesh, p, o, batches, step, DRILL_STEPS) \
        if step is not None else []
    return {"step": step, "losses": losses}


def rank_drill_loop(cfg, mesh, params, opt, batches, start, stop, mgr=None):
    """`drill_loop` on a rank mesh: each data rank its slice of the same
    global batches, and rank 0 writing the gathered tree at each save,
    the ranks meeting after it."""
    from repro_torch.data import pipeline
    from repro_torch.launch import distributed, steps as steps_mod, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw, schedule as sched
    from repro_torch.runtime import sharding
    step_fn = steps_mod.make_train_step(
        cfg, adamw.AdamWConfig(lr=1e-2), functools.partial(
            sched.warmup_cosine, warmup_steps=2, total_steps=DRILL_STEPS),
        spiking=False, mesh=mesh)
    whole = lm.abstract_params(cfg)
    specs = sharding.state_specs(sharding.param_specs(cfg, whole, mesh))
    losses = []
    for t in range(start, stop):
        rows = train.rank_rows(batches[t]["tokens"].shape[0], mesh)
        batch = {k: v[rows] for k, v in batches[t].items()}
        params, opt, metrics = step_fn(
            params, opt, pipeline.device_put_batch(batch, mesh.device))
        losses.append(float(metrics["loss"]))
        if mgr and mgr.should_save(t + 1):
            mgr.save(t + 1, leaves=sharding.full_leaves((params, opt), specs,
                                                        mesh))
            mgr.wait()
            distributed.barrier()
    return losses


def phase_rank_drill(torch, device, card):
    """(u3): the reference's elastic drill (its `drill` config, dense) on
    a (4, 2) rank mesh of 8 `gloo` ranks on the card saving at 3, 6 and
    9; step 9's snapshot torn; `reshard_restore` onto the (2, 2) mesh of
    4 ranks walks back to step 6 on every rank and the resumed losses
    track the healthy run within DRILL_TOL."""
    import shutil
    import tempfile
    from repro_torch.configs.base import LMConfig, SpikingConfig
    from repro_torch.launch import distributed
    from repro_torch.runtime import elastic, faults
    cfg = LMConfig(name="drill", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                   spiking=SpikingConfig(t_steps=1), remat="none",
                   loss_chunk=16)
    plan = elastic.shrunk_mesh(U3_MESH, DRILL_AXES, n_failed_data_groups=2)
    free_card(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rank_drill_")
    try:
        t0 = time.perf_counter()
        healthy = distributed.spawn(
            u3_drill_rank, U3_MESH[0] * U3_MESH[1], backend=U_BACKEND,
            device=device, timeout_s=U_SPAWN_TIMEOUT,
            args=(cfg, U3_MESH, tmp, False))
        healthy_s = time.perf_counter() - t0
        saved = sorted(os.listdir(tmp))
        faults.truncate_checkpoint(os.path.join(tmp, "step_000000009"))
        t0 = time.perf_counter()
        resumed = distributed.spawn(
            u3_drill_rank, plan.mesh_shape[0] * plan.mesh_shape[1],
            backend=U_BACKEND, device=device, timeout_s=U_SPAWN_TIMEOUT,
            args=(cfg, plan.mesh_shape, tmp, True))
        resumed_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    h = healthy[0]["losses"]
    emit("rank_drill", card=card, backend=U_BACKEND, mesh=list(U3_MESH),
         shrunk=list(plan.mesh_shape), saved=saved, healthy=h,
         restored_steps=[r["step"] for r in resumed],
         resumed=resumed[0]["losses"], healthy_s=healthy_s,
         resumed_s=resumed_s)
    check(all(r["losses"] == h for r in healthy),
          "(u3) healthy losses differ across ranks")
    check(saved == ["step_000000003", "step_000000006", "step_000000009"],
          f"(u3) saved {saved}")
    check(all(r["step"] == 6 for r in resumed),
          f"(u3) restored {[r['step'] for r in resumed]}, not step 6")
    for r in resumed:
        check(len(r["losses"]) == 4 and all(
            math.isfinite(v) and abs(v - x) <= DRILL_TOL * (1 + abs(x))
            for v, x in zip(r["losses"], h[6:])),
            f"(u3) resumed {r['losses']} off healthy {h[6:]}")


def phase_nccl_rank(torch, device, card):
    """(u4): (u1)'s first step at TinyLlama-1.1B width in a one-rank
    `nccl` group on the card (the step's all-reduces run NCCL's one-rank
    path): its loss and every param bit for bit with the
    non-distributed step's, from the same draw and rows."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import distributed, steps as steps_mod
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw, schedule as sched
    cfg = get_config(LM_ARCH)
    free_card(torch)
    rows = LM_TRAIN_BATCH // U1_MESH[0]
    batch = pipeline.device_put_batch(synthetic.lm_batch(
        SEED, 0, 0, rows, LM_TRAIN_SEQ, cfg.vocab), device)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, state_dtype=cfg.opt_state_dtype)
    schedule = functools.partial(sched.warmup_cosine, warmup_steps=2,
                                 total_steps=LM_TRAIN_STEPS)

    def one_step(mesh):
        params = lm.init_params(cfg, SEED, device=device)
        opt = adamw.init(params, opt_cfg)
        step = steps_mod.make_train_step(cfg, opt_cfg, schedule,
                                         spiking=True, mesh=mesh)
        reset_launch_counts()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        fps = [fingerprint(torch, p) for p in adamw.leaves(params)]
        loss = metrics["loss"].clone()
        del params, opt, metrics
        free_card(torch)
        return loss, fps, counts

    plain_loss, plain_fps, plain_counts = one_step(None)
    t0 = time.perf_counter()
    with distributed.single_rank("nccl", device) as dev:
        check(dev == device, f"(u4) the nccl rank runs on {dev}")
        mesh = make_rank_mesh((1, 1), DRILL_AXES)
        with timed_reduces(torch, distributed, dev) as reduces:
            loss, fps, counts = one_step(mesh)
    wall = time.perf_counter() - t0
    emit("nccl_rank", card=card, backend="nccl", loss=loss.item(),
         plain_loss=plain_loss.item(), params_equal=fps == plain_fps,
         wall_s=wall, launches={k: v for k, v in counts.items() if v},
         **reduce_summary(reduces))
    lm_launch_check(counts, lm_train_launches(cfg), "(u4) nccl step")
    check(reduces and torch.equal(loss, plain_loss),
          f"(u4) loss {loss.item()} vs {plain_loss.item()}")
    check(fps == plain_fps, "(u4) params differ from the plain step's")
    check(counts == plain_counts, "(u4) launches differ from the plain "
          "step's")
    return counts


def phase_u(torch, device, card):
    """(u) the mesh on ranks of a process group: data-parallel training,
    expert-parallel MoE prefill, the elastic drill across ranks, and one
    `nccl` rank."""
    totals: dict = {}
    for name, fn in (("u1_dp_train", phase_dp_train),
                     ("u2_ep_prefill", phase_ep_prefill),
                     ("u3_rank_drill", phase_rank_drill),
                     ("u4_nccl_rank", phase_nccl_rank)):
        t0 = time.perf_counter()
        counts = fn(torch, device, card) or {}
        emit("phase_time", name=name, seconds=time.perf_counter() - t0,
             launches={k: v for k, v in counts.items() if v})
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ------------------------------------------------------------ phase (v)
# Every leaf placed on ranks by `param_specs`: tensor-parallel, FSDP and
# pure-FSDP placement, on ranks that share cuda:0 under `gloo` as (u)'s.
# One 2-rank world runs (v1)-(v3), one 4-rank world (v4).
V_TP_MESH, V_FSDP_MESH = (1, 2), (2, 1)
V_SAVE_MESH, V_RESTORE_MESH = (2, 2), (1, 4)
V_SERVE_ARCH = "qwen3-4b"
V_BATCH, V_PROMPT, V_DECODE_STEPS = 8, 128, 4
V_STATE_TOKENS = 32             # (v3)'s decode state: the prompt's first
# Step 0's gaps to the one-process step on the same rows, gated at twice
# the readings of the first card runs (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md). (v1) the tensor-parallel step: the loss's relative gap, and
# the worst leaf's relative L2 gradient gap, which reads above 1 because
# its row-split partials, rounded to bf16 before they are summed, flip
# spikes from block 0 on; what holds its products to the unsharded ones
# is the same prefill in f32 (`block_drift`), where that rounding is
# 2^16 times finer: the worst block's max|d| / max|x| read 1.0045e-7.
# (v2) the pure-FSDP step: its loss read equal to the one-process loss
# (gated equal), its worst gradient gap 1.5754% ((u1)'s: its bf16
# gradient parts summed by the reduce-scatter).
V1_LOSS_GAP_LIMIT = 2 * 0.0016254511
V1_GRAD_GAP_LIMIT = 2 * 1.2765648
V1_F32_DRIFT_LIMIT = 2 * 1.0044689e-7
V2_GRAD_GAP_LIMIT = 2 * 0.015753871
V_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")


@contextlib.contextmanager
def timed_collectives(torch, distributed, dev):
    """While active, every call of the three collective wrappers of
    `distributed` is timed (the card synchronised before and after) and
    logged as (name, bytes of its result, seconds)."""
    names = {"all_reduce": "all_reduce_", "all_gather": "all_gather",
             "reduce_scatter": "reduce_scatter"}
    origs = {k: getattr(distributed, v) for k, v in names.items()}
    log: list = []

    def timed(name):
        def call(*args, **kwargs):
            rank_sync(torch, dev)
            t0 = time.perf_counter()
            out = origs[name](*args, **kwargs)
            rank_sync(torch, dev)
            log.append((name, out.numel() * out.element_size(),
                        time.perf_counter() - t0))
            return out
        return call

    for k, v in names.items():
        setattr(distributed, v, timed(k))
    try:
        yield log
    finally:
        for k, v in names.items():
            setattr(distributed, v, origs[k])


def collective_summary(log, steps: int = 1) -> dict:
    """Per collective: calls, bytes and ms, over `steps` (a step's mean)."""
    out = {}
    for name in V_COLLECTIVES:
        got = [(b, t) for n, b, t in log if n == name]
        out[name] = {"calls": len(got) / steps,
                     "bytes": sum(b for b, _ in got) / steps,
                     "ms": sum(t for _, t in got) * 1e3 / steps}
    return out


def v_fire_split(torch, device, card, cfg):
    """(v1)'s fire check on the card: the bf16 fire of TinyLlama-1.1B's
    MLP drive (T x 8 x 128 tokens x d_ff) and of its query heads' drive,
    whole and as two halves of the hidden width (a tensor-parallel rank's
    part), the halves joined bit for bit the whole fire: LIF is
    elementwise over neurons."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.layers import lif_fire
    from repro_torch.models.lm import lif_cfg_of
    lif = lif_cfg_of(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    t = cfg.spiking.t_steps
    for name, width in (("mlp", cfg.d_ff), ("q", cfg.n_heads * cfg.head_dim)):
        drive = (1.5 * torch.randn((t, V_BATCH * V_PROMPT, width),
                                   generator=gen, device=device)).bfloat16()
        with torch.inference_mode():
            reset_launch_counts()
            whole = lif_fire(drive, lif)
            halves = [lif_fire(h.contiguous(), lif)
                      for h in drive.chunk(2, dim=-1)]
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
        joined = torch.cat(halves, dim=-1)
        emit("tp_fire_split", card=card, drive=name, shape=list(drive.shape),
             spikes=int(whole.float().sum().item()),
             equal=bool(torch.equal(joined, whole)), launches=counts)
        check(torch.equal(joined, whole), f"(v1) the {name} fire split in "
              f"two differs from the whole fire")
        check(counts.get("lif_bf16", 0) == 3, f"(v1) the {name} fire "
              f"launched {counts}")


def block_drift(torch, cfg, params, tokens, logical) -> dict:
    """The prefill's block outputs, unsharded against the witness (its
    row-split partials rounded before they are summed): per block, the
    share of elements that differ and max|d| / max|x|; and the two
    prefills' last-position logits."""
    from repro_torch.launch.mesh import use_concrete_mesh
    from repro_torch.models import lm, placement
    orig, seen = lm._apply_block, []

    def kept(*args, **kwargs):
        x = orig(*args, **kwargs)
        seen.append(x.detach().clone())
        return x

    lm._apply_block = kept
    try:
        with torch.inference_mode():
            plain = lm.prefill(cfg, params, tokens, True)
            n = len(seen)
            with use_concrete_mesh(logical), placement.witness():
                wit = lm.prefill(cfg, params, tokens, True)
    finally:
        lm._apply_block = orig
    share, rel = [], []
    for a, b in zip(seen[:n], seen[n:]):
        share.append((a != b).float().mean().item())
        rel.append(((a.float() - b.float()).abs().max() /
                    a.float().abs().max().clamp_min(1e-30)).item())
    return {"share_unequal": share, "max_rel_gap": rel,
            "argmax_share_equal": (plain.argmax(-1) == wit.argmax(-1))
            .float().mean().item(),
            "logits_max_abs_gap": (plain - wit).abs().max().item(),
            "logits_max": plain.abs().max().item()}


def _v_tp_train(torch, cfg, mesh, dev, me, out):
    """(v1) on this rank: rank 0's one-process references (the unsharded
    prefill and step 0, and their `placement.witness` forms), then the
    prefill and LM_TRAIN_STEPS `train_loop` steps on the rank mesh."""
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import distributed, steps as steps_mod, train
    from repro_torch.launch.mesh import make_mesh, use_concrete_mesh
    from repro_torch.models import lm, placement
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    tokens = torch.from_numpy(markov_tokens(
        SEED, 0, 0, V_BATCH, V_PROMPT, cfg.vocab)[:, :V_PROMPT]).long() \
        .to(dev)
    kw = dict(batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, seed=SEED,
              log_every=100)
    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    refs = {}
    if me == 0:
        logical = make_mesh(V_TP_MESH, DRILL_AXES, devices=dev)
        params = lm.init_params(cfg, SEED, device=dev)
        with torch.inference_mode():
            reset_launch_counts()
            refs["logits"] = lm.prefill(cfg, params, tokens, True).cpu()
            rank_sync(torch, dev)
            refs["launches"] = launch_counts()
            with use_concrete_mesh(logical), placement.witness():
                refs["witness_logits"] = lm.prefill(cfg, params, tokens,
                                                    True).cpu()
        # Where the unsharded and the tensor-parallel arithmetic part: a
        # bf16 rounding of the row-split partials in block 0, spike flips
        # from there on; in f32 the same split rounds 2^16 times finer.
        refs["drift"] = block_drift(torch, cfg, params, tokens, logical)
        refs["drift_f32"] = block_drift(
            torch, cfg, lm._tree_map(lambda t: t.float(), params), tokens,
            logical)
        del params
        with first_update(adamw) as got:
            ref = train.train_loop(cfg, steps=1, device=dev, **kw)
        refs["loss0"] = ref["losses"][0]
        refs["grads"] = [g.clone() for g in adamw.leaves(
            sharding.local_params(adamw.unflatten(whole, got), specs, mesh))]
        del ref, got
        rank_free(torch, dev)
        with first_update(adamw) as got, placement.witness():
            wit = train.train_loop(cfg, steps=1, device=dev, mesh=logical,
                                   **kw)
        refs["witness_loss0"] = wit["losses"][0]
        refs["witness_grads"] = adamw.leaves(sharding.local_params(
            adamw.unflatten(whole, got), specs, mesh))
        del wit, got
        rank_free(torch, dev)
    distributed.barrier()
    for turn in range(distributed.world_size()):
        if turn == me:
            full = lm.init_params(cfg, SEED, device=dev)
            params = sharding.local_params(full, specs, mesh)
            del full
            rank_free(torch, dev)
        distributed.barrier()
    with torch.inference_mode(), use_concrete_mesh(mesh):
        reset_launch_counts()
        rank_sync(torch, dev)
        t0 = time.perf_counter()
        logits = lm.prefill(cfg, params, tokens, True)
        rank_sync(torch, dev)
        prefill_s = time.perf_counter() - t0
        prefill_launches = launch_counts()
    del params
    rank_free(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with rank_steps(torch, steps_mod, dev) as (log, grads_fp), \
            first_update(adamw) as got, \
            timed_collectives(torch, distributed, dev) as coll:
        res = train.train_loop(cfg, steps=LM_TRAIN_STEPS, mesh=mesh, **kw)
    out.update(prefill_s=prefill_s, prefill_launches=prefill_launches,
               losses=res["losses"], steps=log, grads_fp=grads_fp,
               peak_bytes=rank_peak(torch, dev),
               collectives=collective_summary(coll, LM_TRAIN_STEPS),
               held_bytes=sum(t.numel() * t.element_size()
                              for t in adamw.leaves(res["params"])))
    if me == 0:
        names = leaf_names(res["params"])
        out.update(
            logits_equal_witness=bool(torch.equal(logits.cpu(),
                                                  refs["witness_logits"])),
            logits_gap=(logits.cpu() - refs["logits"]).abs().max().item(),
            logits_max=refs["logits"].abs().max().item(),
            tokens_equal_one_process=float(
                (logits.cpu().argmax(-1) == refs["logits"].argmax(-1))
                .float().mean()),
            one_process_launches=refs["launches"],
            drift=refs["drift"], drift_f32=refs["drift_f32"],
            loss0_ref=refs["loss0"], witness_loss0=refs["witness_loss0"],
            grad_gap=rel_l2(torch, names, got, refs["grads"]),
            witness_unequal=[n for n, a, w in zip(
                names, got, refs["witness_grads"]) if not torch.equal(a, w)],
            grads_finite=all(bool(torch.isfinite(g).all()) for g in got))
    del res
    rank_free(torch, dev)


def _v_fsdp_train(torch, cfg, mesh, dev, me, out):
    """(v2) on this rank: rank 0's one-process step 0 on the same rows and
    (u1)'s `split_grads` witness, then LM_TRAIN_STEPS pure-FSDP steps."""
    from repro_torch.launch import distributed, steps as steps_mod, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    kw = dict(batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, seed=SEED,
              log_every=100)
    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    refs = {}
    if me == 0:
        with first_update(adamw) as got:
            ref = train.train_loop(cfg, steps=1, device=dev, mesh=make_mesh(
                V_FSDP_MESH, DRILL_AXES, devices=dev), **kw)
        refs["loss0"] = ref["losses"][0]
        refs["grads"] = adamw.leaves(sharding.local_params(
            adamw.unflatten(whole, got), specs, mesh))
        del ref, got
        rank_free(torch, dev)
        refs["witness"] = adamw.leaves(sharding.local_params(
            adamw.unflatten(whole, split_grads(torch, cfg, LM_TRAIN_BATCH,
                                               LM_TRAIN_SEQ, dev)),
            specs, mesh))
        rank_free(torch, dev)
    distributed.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with rank_steps(torch, steps_mod, dev) as (log, grads_fp), \
            first_update(adamw) as got, \
            timed_collectives(torch, distributed, dev) as coll:
        res = train.train_loop(cfg, steps=LM_TRAIN_STEPS, mesh=mesh, **kw)
    out.update(losses=res["losses"], steps=log, grads_fp=grads_fp,
               peak_bytes=rank_peak(torch, dev),
               collectives=collective_summary(coll, LM_TRAIN_STEPS),
               held_bytes=sum(t.numel() * t.element_size()
                              for t in adamw.leaves(res["params"])))
    if me == 0:
        names = leaf_names(res["params"])
        out.update(loss0_ref=refs["loss0"],
                   grad_gap=rel_l2(torch, names, got, refs["grads"]),
                   witness_unequal=[n for n, a, w in zip(
                       names, got, refs["witness"]) if not torch.equal(a, w)],
                   grads_finite=all(bool(torch.isfinite(g).all())
                                    for g in got))
    del res
    rank_free(torch, dev)


def _v_serve(torch, cfg, mesh, dev, me, out):
    """(v3) on this rank: rank 0's one-process prefill and decode steps,
    unsharded and as `placement.witness`, then the ranks' own."""
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_mesh, use_concrete_mesh
    from repro_torch.models import lm, placement
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    tokens = torch.from_numpy(markov_tokens(
        SEED, 0, 0, V_BATCH, V_PROMPT, cfg.vocab)[:, :V_PROMPT]).long() \
        .to(dev)

    def serve(params):
        """Prefill logits, then the decode state over the prompt's first
        V_STATE_TOKENS tokens and V_DECODE_STEPS greedy steps from the
        prefill's next token: (logits, tokens, prefill launches, a decode
        step's launches, state head counts, seconds)."""
        reset_launch_counts()
        rank_sync(torch, dev)
        t0 = time.perf_counter()
        logits = lm.prefill(cfg, params, tokens, True)
        rank_sync(torch, dev)
        prefill_s = time.perf_counter() - t0
        pre = launch_counts()
        _, state = lm.prefill_with_state(cfg, params,
                                         tokens[:, :V_STATE_TOKENS], True)
        tok, toks = logits.argmax(-1), []
        step_launches = None
        for i in range(V_DECODE_STEPS):
            reset_launch_counts()
            lg, state = lm.decode_step(cfg, params, state, tok,
                                       V_STATE_TOKENS + i, True)
            rank_sync(torch, dev)
            step_launches = step_launches or launch_counts()
            tok = lg.argmax(-1)
            toks.append(tok)
        heads = sorted({int(st.sdsa.status.shape[2]) for st in state
                        if st.sdsa is not None})
        return (logits.float().cpu(), torch.stack(toks).cpu(), pre,
                step_launches, heads, prefill_s)

    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    refs = {}
    for turn in range(distributed.world_size()):
        if turn == me:
            full = lm.init_params(cfg, SEED, device=dev)
            if me == 0:
                with torch.inference_mode():
                    refs["plain"] = serve(full)
                    with use_concrete_mesh(make_mesh(
                            V_TP_MESH, DRILL_AXES, devices=dev)), \
                            placement.witness():
                        refs["witness"] = serve(full)
            params = sharding.local_params(full, specs, mesh)
            del full
            rank_free(torch, dev)
        distributed.barrier()
    with torch.inference_mode(), use_concrete_mesh(mesh), \
            timed_collectives(torch, distributed, dev) as coll:
        got = serve(params)
    out.update(logits=got[0], tokens=got[1], prefill_launches=got[2],
               step_launches=got[3], heads=got[4], prefill_s=got[5],
               collectives=collective_summary(coll),
               held_bytes=sum(t.numel() * t.element_size() for t in
                              adamw.leaves(params)))
    if me == 0:
        out.update(witness=refs["witness"][:2], plain=refs["plain"][:2],
                   plain_launches=refs["plain"][2:4],
                   plain_heads=refs["plain"][4])
    del params
    rank_free(torch, dev)


def v_rank(cfg, serve_cfg) -> dict:
    """(v1)-(v3) on one rank of the 2-rank world."""
    import torch
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_rank_mesh
    dev, me = distributed.device(), distributed.rank()
    out = {"rank": me}
    for key, fn, c, shape in (
            ("v1", _v_tp_train, cfg, V_TP_MESH),
            ("v2", _v_fsdp_train, cfg.replace(pure_fsdp=True), V_FSDP_MESH),
            ("v3", _v_serve, serve_cfg, V_TP_MESH)):
        mesh = make_rank_mesh(shape, DRILL_AXES)
        out[key] = {"coords": mesh.coords()}
        t0 = time.perf_counter()
        fn(torch, c, mesh, dev, me, out[key])
        out[key]["wall_s"] = time.perf_counter() - t0
        distributed.barrier()
    return out


def v4_rank(cfg, ck_dir) -> dict:
    """(v4) on one rank of the 4-rank world: two drill steps on the (2, 2)
    rank mesh, the state saved with its TP and FSDP shards gathered by
    rank 0, then restored onto the (1, 4) mesh (each leaf cut as it is
    read), beside the whole snapshot cut by `local_params`."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import synthetic
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic, sharding
    dev = distributed.device()
    save_mesh = make_rank_mesh(V_SAVE_MESH, DRILL_AXES)
    params = lm.init_params(cfg, seed=0, device=dev)
    fresh = (params, adamw.init(params, adamw.AdamWConfig(lr=1e-2)))
    specs = sharding.state_specs(sharding.param_specs(cfg, params,
                                                      save_mesh))
    mgr = CheckpointManager(ck_dir, save_every=2,
                            writer=save_mesh.rank == 0)
    batches = [synthetic.lm_batch(0, 0, t, 8, 16, cfg.vocab)
               for t in range(2)]
    losses = rank_drill_loop(cfg, save_mesh, *sharding.local_params(
        fresh, specs, save_mesh), batches, 0, 2, mgr)
    mesh = make_rank_mesh(V_RESTORE_MESH, DRILL_AXES)
    whole = lm.abstract_params(cfg)
    target = (whole, adamw.init(whole))
    t0 = time.perf_counter()
    step, restored = elastic.reshard_restore(cfg, mgr, target, mesh)
    restore_s = time.perf_counter() - t0
    _, snap = mgr.restore_latest(target, dev)
    new_specs = sharding.state_specs(sharding.param_specs(cfg, whole, mesh))
    want = sharding.local_params(snap, new_specs, mesh)
    gathered = list(sharding.full_leaves(restored, new_specs, mesh))
    return {"rank": mesh.rank, "losses": losses, "step": step,
            "restore_s": restore_s,
            "shards_equal": all(torch.equal(a, b) for a, b in zip(
                adamw.leaves(restored), adamw.leaves(want))),
            "whole_equal": all(torch.equal(a, b) for a, b in zip(
                gathered, adamw.leaves(snap))),
            "cut_leaves": sum(sharding.sliced_leaves(
                target, new_specs, mesh)),
            "leaves": len(adamw.leaves(target))}


def phase_v(torch, device, card):
    """(v) every leaf placed on ranks: (v1) TinyLlama-1.1B uncut on a
    (data 1, model 2) tensor-parallel rank mesh, a prefill of V_BATCH x
    V_PROMPT and LM_TRAIN_STEPS `train_loop` steps beside the one-process
    run; (v2) the same model with `pure_fsdp=True` on (data 2, model 1);
    (v3) qwen3-4b uncut on (1, 2), a spiking prefill and V_DECODE_STEPS
    decode steps; (v4) the drill config with fsdp saved from (2, 2) and
    restored onto (1, 4). Gates: the split fire bit for bit; logits,
    tokens and (v1)'s step-0 gradients bit for bit with the one-process
    witness (`placement.witness`; (v2): `split_grads`); step 0's loss and
    per-leaf gradient gaps to the one-process step within twice their
    readings ((v2)'s loss equal), and (v1)'s f32 prefill within twice
    its block drift's reading of the unsharded one; exact launches a step on every rank; replicated params
    bit for bit across ranks; the restored shards exact."""
    import shutil
    import tempfile
    from repro_torch.configs.base import LMConfig, SpikingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import lm
    from repro_torch.runtime import sharding
    totals: dict = {}
    cfg, serve_cfg = get_config(LM_ARCH), get_config(V_SERVE_ARCH)
    t0 = time.perf_counter()
    v_fire_split(torch, device, card, cfg)
    emit("phase_time", name="v1_fire_split",
         seconds=time.perf_counter() - t0)
    free_card(torch)
    t0 = time.perf_counter()
    ranks = distributed.spawn(v_rank, 2, backend=U_BACKEND, device=device,
                              timeout_s=2 * U_SPAWN_TIMEOUT,
                              args=(cfg, serve_cfg))
    wall = time.perf_counter() - t0
    per_step = lm_train_launches(cfg)
    r0 = ranks[0]
    # (v1)
    v1 = [r["v1"] for r in ranks]
    gap = v1[0]["grad_gap"]
    worst = max(gap, key=gap.get)
    loss_gap = abs(v1[0]["losses"][0] - v1[0]["loss0_ref"]) / \
        abs(v1[0]["loss0_ref"])
    for r in ranks:
        v = r["v1"]
        emit("tp_train_rank", card=card, rank=r["rank"],
             mesh=list(V_TP_MESH), coords=v["coords"], losses=v["losses"],
             held_bytes=v["held_bytes"], peak_bytes=v["peak_bytes"],
             prefill_s=v["prefill_s"],
             step_span_s=[s["span_s"] for s in v["steps"]],
             collectives_per_step=v["collectives"],
             launches_per_step=per_step, wall_s=v["wall_s"])
        lm_launch_check(v["prefill_launches"], v1[0]["one_process_launches"],
                        f"(v1) rank {r['rank']} prefill")
        for i, s in enumerate(v["steps"]):
            lm_launch_check(s["launches"], per_step,
                            f"(v1) rank {r['rank']} step {i}")
            for k, n in s["launches"].items():
                totals[k] = totals.get(k, 0) + n
            check(math.isfinite(s["loss"]), f"(v1) step {i} loss {s['loss']}")
        for k, n in v["prefill_launches"].items():
            totals[k] = totals.get(k, 0) + n
        check(v["losses"] == v1[0]["losses"], "(v1) losses differ across "
              "ranks")
    emit("tp_train", card=card, arch=cfg.name, ranks=2, wall_s=wall,
         prefill=[V_BATCH, V_PROMPT], batch=LM_TRAIN_BATCH,
         seq=LM_TRAIN_SEQ, loss0=v1[0]["losses"][0],
         one_process_loss0=v1[0]["loss0_ref"], loss0_rel_gap=loss_gap,
         loss0_gap_limit=V1_LOSS_GAP_LIMIT, grad_gap_worst=gap[worst],
         grad_gap_worst_leaf=worst, grad_gap_limit=V1_GRAD_GAP_LIMIT,
         witness_loss0=v1[0]["witness_loss0"],
         witness_unequal_leaves=len(v1[0]["witness_unequal"]),
         logits_equal_witness=v1[0]["logits_equal_witness"],
         logits_max_abs_gap_one_process=v1[0]["logits_gap"],
         logits_max=v1[0]["logits_max"],
         argmax_share_equal_one_process=v1[0]["tokens_equal_one_process"],
         replicated_peak_bytes=U1_PEAKS)
    for dt in ("drift", "drift_f32"):
        d = v1[0][dt]
        emit("tp_block_drift", card=card, dtype="f32" if dt == "drift_f32"
             else "bf16", blocks=len(d["share_unequal"]),
             max_rel_gap_limit=V1_F32_DRIFT_LIMIT if dt == "drift_f32"
             else None,
             share_unequal=d["share_unequal"], max_rel_gap=d["max_rel_gap"],
             argmax_share_equal=d["argmax_share_equal"],
             logits_max_abs_gap=d["logits_max_abs_gap"],
             logits_max=d["logits_max"])
    check(v1[0]["logits_equal_witness"], "(v1) prefill logits differ from "
          "the one-process witness's")
    check(v1[0]["grads_finite"], "(v1) step 0 gradients not finite")
    check(not v1[0]["witness_unequal"], f"(v1) step 0 gradients differ from "
          f"the witness's at {v1[0]['witness_unequal'][:3]}")
    check(v1[0]["losses"][0] == v1[0]["witness_loss0"], "(v1) step 0 loss "
          "differs from the witness's")
    check(loss_gap <= V1_LOSS_GAP_LIMIT, f"(v1) step 0 loss gap {loss_gap}")
    check(gap[worst] <= V1_GRAD_GAP_LIMIT, f"(v1) step 0 gradient gap "
          f"{gap[worst]} at {worst}")
    f32_drift = max(v1[0]["drift_f32"]["max_rel_gap"])
    check(f32_drift <= V1_F32_DRIFT_LIMIT, f"(v1) the f32 tensor-parallel "
          f"prefill's worst block is {f32_drift} of max|x| from the "
          f"unsharded one's")
    check(v1[0]["drift_f32"]["argmax_share_equal"] == 1.0, "(v1) the f32 "
          "tensor-parallel prefill's tokens differ from the unsharded one's")
    # (v2)
    v2 = [r["v2"] for r in ranks]
    gap2 = v2[0]["grad_gap"]
    worst2 = max(gap2, key=gap2.get)
    loss_gap2 = abs(v2[0]["losses"][0] - v2[0]["loss0_ref"]) / \
        abs(v2[0]["loss0_ref"])
    for r in ranks:
        v = r["v2"]
        emit("fsdp_train_rank", card=card, rank=r["rank"],
             mesh=list(V_FSDP_MESH), losses=v["losses"],
             held_bytes=v["held_bytes"], peak_bytes=v["peak_bytes"],
             replicated_peak_bytes=U1_PEAKS[r["rank"]] if U1_PEAKS else None,
             step_span_s=[s["span_s"] for s in v["steps"]],
             collectives_per_step=v["collectives"], wall_s=v["wall_s"])
        for i, s in enumerate(v["steps"]):
            lm_launch_check(s["launches"], per_step,
                            f"(v2) rank {r['rank']} step {i}")
            for k, n in s["launches"].items():
                totals[k] = totals.get(k, 0) + n
        check(v["losses"] == v2[0]["losses"], "(v2) losses differ across "
              "ranks")
    emit("fsdp_train", card=card, arch=cfg.name, ranks=2,
         loss0=v2[0]["losses"][0], one_process_loss0=v2[0]["loss0_ref"],
         loss0_rel_gap=loss_gap2, loss0_gap_limit=0.0,
         grad_gap_worst=gap2[worst2], grad_gap_worst_leaf=worst2,
         grad_gap_limit=V2_GRAD_GAP_LIMIT,
         witness_unequal_leaves=len(v2[0]["witness_unequal"]))
    check(v2[0]["grads_finite"], "(v2) step 0 gradients not finite")
    check(not v2[0]["witness_unequal"], f"(v2) step 0 gradients differ from "
          f"split_grads' at {v2[0]['witness_unequal'][:3]}")
    check(v2[0]["losses"][0] == v2[0]["loss0_ref"], f"(v2) step 0 loss "
          f"{v2[0]['losses'][0]} differs from the one-process step's "
          f"{v2[0]['loss0_ref']}")
    check(gap2[worst2] <= V2_GRAD_GAP_LIMIT, f"(v2) step 0 gradient gap "
          f"{gap2[worst2]} at {worst2}")
    for key, mesh_shape, c in (("v1", V_TP_MESH, cfg),
                               ("v2", V_FSDP_MESH,
                                cfg.replace(pure_fsdp=True))):
        whole = lm.abstract_params(c)
        sliced = sharding.sliced_leaves(whole, sharding.param_specs(
            c, whole, abstract_mesh(mesh_shape, DRILL_AXES)),
            abstract_mesh(mesh_shape, DRILL_AXES))
        for i in range(LM_TRAIN_STEPS):
            fps = [[f for f, s in zip(r[key]["steps"][i]["params"], sliced)
                    if not s] for r in ranks]
            check(all(f == fps[0] for f in fps), f"({key}) step {i}: "
                  f"replicated params differ across ranks")
    # (v3)
    v3 = [r["v3"] for r in ranks]
    w_logits, w_tokens = v3[0]["witness"]
    p_logits, p_tokens = v3[0]["plain"]
    pre_want, step_want = v3[0]["plain_launches"]
    for r in ranks:
        v = r["v3"]
        emit("tp_serve_rank", card=card, rank=r["rank"], arch=serve_cfg.name,
             held_bytes=v["held_bytes"], heads=v["heads"],
             prefill_s=v["prefill_s"], collectives=v["collectives"],
             prefill_launches={k: n for k, n in
                               v["prefill_launches"].items() if n},
             wall_s=v["wall_s"])
        check(torch.equal(v["logits"], w_logits), f"(v3) rank {r['rank']}: "
              f"prefill logits differ from the witness's")
        check(torch.equal(v["tokens"], w_tokens), f"(v3) rank {r['rank']}: "
              f"tokens differ from the witness's")
        check(v["heads"] == [serve_cfg.n_heads // V_TP_MESH[1]],
              f"(v3) rank {r['rank']} holds {v['heads']} heads of state")
        lm_launch_check(v["prefill_launches"], pre_want,
                        f"(v3) rank {r['rank']} prefill")
        lm_launch_check(v["step_launches"], step_want,
                        f"(v3) rank {r['rank']} decode step")
        for k, n in v["prefill_launches"].items():
            totals[k] = totals.get(k, 0) + n
    emit("tp_serve", card=card, arch=serve_cfg.name, ranks=2,
         prefill=[V_BATCH, V_PROMPT], decode_steps=V_DECODE_STEPS,
         tokens_equal_witness=True,
         tokens_share_equal_one_process=float(
             (v3[0]["tokens"] == p_tokens).float().mean()),
         logits_max_abs_gap_one_process=(v3[0]["logits"] - p_logits).abs()
         .max().item(), logits_max=p_logits.abs().max().item(),
         one_process_heads=v3[0]["plain_heads"])
    # (v4)
    drill = LMConfig(name="drill", family="dense", n_layers=2, d_model=32,
                     n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                     spiking=SpikingConfig(t_steps=1), remat="none",
                     loss_chunk=16, fsdp=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_v4_")
    try:
        t0 = time.perf_counter()
        restored = distributed.spawn(
            v4_rank, 4, backend=U_BACKEND, device=device,
            timeout_s=U_SPAWN_TIMEOUT, args=(drill, tmp))
        v4_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("reshard_restore", card=card, saved_on=list(V_SAVE_MESH),
         restored_on=list(V_RESTORE_MESH), wall_s=v4_s,
         steps=[r["step"] for r in restored],
         losses=restored[0]["losses"],
         restore_s=[r["restore_s"] for r in restored],
         cut_leaves=restored[0]["cut_leaves"], leaves=restored[0]["leaves"])
    for r in restored:
        check(r["step"] == 2, f"(v4) rank {r['rank']} restored {r['step']}")
        check(r["shards_equal"], f"(v4) rank {r['rank']}: restored shards "
              f"differ from the snapshot's cut")
        check(r["whole_equal"], f"(v4) rank {r['rank']}: the restored state "
              f"gathered whole differs from the snapshot")
    check(restored[0]["cut_leaves"] > 0, "(v4) nothing was cut")
    return totals


# ------------------------------------------------------------ phase (w)
# The MoE configs on rank meshes as the registry configures them:
# qwen2-moe-a2.7b's `moe_apply` (T = 2, four shared experts, one dispatch
# group) on ranks that share cuda:0 under `gloo` as (u)'s and (v)'s, each
# routing the global tokens the batch ranks gather. One 4-rank world runs
# (w1) and (w2), one 2-rank world (w3); the one-process references run
# first, on the card alone, and wait on the host.
W_MESH, W_FSDP_MESH = (2, 2), (1, 2)
W_BATCH, W_PROMPT, W_DECODE_STEPS = 8, 128, 4
# The decode state: the prompt's first W_STATE_TOKENS tokens, (v3)'s
# count. `prefill_with_state` is a decode step a token (about 0.5 s a
# step on the four ranks, PERF.md), so the whole prompt's 128 would add
# about a minute.
W_STATE_TOKENS = 32
W_TRAIN_STEPS, W_TRAIN_SEQ = 3, 128
# (w2)'s depth: the deepest whose four ranks' peaks sum under
# W_PEAK_BUDGET, reckoned from (s2)'s reading: qwen2-moe-a2.7b at 4
# layers, 8 x 128, peaked at 60 GB on one process.
W_PEAK_BUDGET = 70e9
S2_LAYERS, S2_PEAK = 4, 60e9
# Step 0's gaps to the unsharded one-process step on the same rows (the
# loss's relative gap; the worst leaf's relative L2 gradient gap), gated
# at twice the readings of the first card run (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md). (w2): 5.5789e-5 and 0.20821 at the
# router, the tensor-parallel partials' bf16 rounding flipping spikes and
# routes as (v1)'s do (its forward is the witness's bit for bit); (w3):
# 7.9927e-8 and 0.0064201, the ranks' sums of their loss and bf16
# gradient parts. `parts_grads` is the witness of both causes: the
# ranks' step 0 bit for bit.
W2_LOSS_GAP_LIMIT = 2 * 5.5789e-5
W2_GRAD_GAP_LIMIT = 2 * 0.20821
W3_LOSS_GAP_LIMIT = 2 * 7.9927e-8
W3_GRAD_GAP_LIMIT = 2 * 0.0064201


def w_train_depth(torch, cfg) -> dict:
    """(w2)'s depth, reckoned from (s2)'s peak: a one-process layer's
    activations at 8 x 128 are (s2)'s peak less its training state
    (`train_state_bytes`), over its layers; a (2, 2) rank holds its own
    training state (its `local_params`) and, counted at the one-process
    size, a layer's activations a layer. The deepest depth whose four
    ranks' sum stays under W_PEAK_BUDGET."""
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.launch.train import train_state_bytes
    s2_state = train_state_bytes(cfg.replace(n_layers=S2_LAYERS))
    act = (S2_PEAK - s2_state) / S2_LAYERS
    n = W_MESH[0] * W_MESH[1]
    rows = []
    for layers in range(1, cfg.n_layers + 1):
        c = cfg.replace(n_layers=layers)
        state = [train_state_bytes(c, RankMesh(W_MESH, DRILL_AXES, r,
                                               torch.device("cpu"), {}))
                 for r in range(n)]
        rows.append({"layers": layers, "rank_state_bytes": max(state),
                     "sum_bytes": sum(state) + n * layers * act})
        if rows[-1]["sum_bytes"] > W_PEAK_BUDGET:
            break
    fits = [r["layers"] for r in rows if r["sum_bytes"] <= W_PEAK_BUDGET]
    return {"layers": max(fits) if fits else 1, "s2_state_bytes": s2_state,
            "activation_bytes_per_layer": act, "budget_bytes": W_PEAK_BUDGET,
            "reckoned": rows}


@contextlib.contextmanager
def route_drops():
    """While active, the assignments each `moe.route` call drops for
    capacity (a host read a call): on a rank, those of the global
    tokens' routing, which every rank routes alike."""
    from repro_torch.models import moe
    orig, rec = moe.route, []

    def counted(*args, **kwargs):
        r = orig(*args, **kwargs)
        rec.append(int((~r.keep).sum()))
        return r

    moe.route = counted
    try:
        yield rec
    finally:
        moe.route = orig


@contextlib.contextmanager
def first_hidden():
    """While active, the output of the first `lm.forward_hidden` call, on
    the CPU (a training step's final hidden state)."""
    from repro_torch.models import lm
    orig, got = lm.forward_hidden, []

    def kept(*args, **kwargs):
        h = orig(*args, **kwargs)
        if not got:
            got.append(h.detach().cpu())
        return h

    lm.forward_hidden = kept
    try:
        yield got
    finally:
        lm.forward_hidden = orig


def w_serve(torch, cfg, params, tokens, dev) -> dict:
    """The spiking prefill of `tokens` three times (the launches, drops
    and first MoE layer; a clean span; the collectives timed), then the
    decode state over the prompt's first W_STATE_TOKENS tokens and
    W_DECODE_STEPS greedy steps from the state's next token, under the
    ambient mesh."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import distributed
    from repro_torch.models import lm
    out = {}
    with torch.inference_mode():
        reset_launch_counts()
        rank_sync(torch, dev)
        t0 = time.perf_counter()
        with first_moe_call("moe_apply") as layer0, route_drops() as drops:
            logits = lm.prefill(cfg, params, tokens, True)
        rank_sync(torch, dev)
        out.update(first_prefill_s=time.perf_counter() - t0,
                   prefill_launches=launch_counts(), drops=drops,
                   layer0=layer0)
        t0 = time.perf_counter()
        again = lm.prefill(cfg, params, tokens, True)
        rank_sync(torch, dev)
        out["prefill_span_s"] = time.perf_counter() - t0
        if distributed.is_initialized():
            with timed_collectives(torch, distributed, dev) as coll:
                lm.prefill(cfg, params, tokens, True)
            out["collectives"] = collective_summary(coll)
        t0 = time.perf_counter()
        lg, state = lm.prefill_with_state(cfg, params,
                                          tokens[:, :W_STATE_TOKENS], True)
        rank_sync(torch, dev)
        out["state_s"] = time.perf_counter() - t0
        tok, toks, step_launches, step_s = lg.argmax(-1), [], None, []
        for i in range(W_DECODE_STEPS):
            reset_launch_counts()
            t0 = time.perf_counter()
            lg, state = lm.decode_step(cfg, params, state, tok,
                                       W_STATE_TOKENS + i, True)
            rank_sync(torch, dev)
            step_s.append(time.perf_counter() - t0)
            step_launches = step_launches or launch_counts()
            tok = lg.argmax(-1)
            toks.append(tok)
    out.update(logits=logits.float().cpu(),
               repeats=bool(torch.equal(again, logits)),
               tokens=torch.stack(toks).cpu(), step_launches=step_launches,
               decode_step_s=step_s)
    return out


def w1_refs(torch, cfg, tokens_np, device) -> dict:
    """(w1)'s one-process runs on the card, unsharded and as the witness
    on a logical W_MESH (`placement.witness`: the tensor-parallel products
    per model position, each position's experts on their whole buffers),
    their results on the host."""
    from repro_torch.launch.mesh import make_mesh, use_concrete_mesh
    from repro_torch.models import lm, placement
    params = lm.init_params(cfg, seed=SEED, device=device)
    tokens = torch.from_numpy(tokens_np).long().to(device)
    plain = w_serve(torch, cfg, params, tokens, device)
    with use_concrete_mesh(make_mesh(W_MESH, DRILL_AXES, devices=device)), \
            placement.witness():
        witness = w_serve(torch, cfg, params, tokens, device)
    del params
    free_card(torch)
    return {"plain": plain, "witness": witness}


def parts_grads(torch, cfg, mesh_shape, dev) -> dict:
    """The witness of (w2) / (w3)'s step 0, the ranks' arithmetic on one
    process: each batch rank's loss terms on its rows of the step's
    W_BATCH rows run in a thread of `placement.witness_parts`, each with
    its own copy of every leaf (`placement.Split`: the copies' gradients
    summed in f32 in rank order, as the ranks' all-reduce sums them),
    under `placement.witness` on a (1, model) mesh; every MoE layer
    routes the threads' rows joined, as the ranks' does, and one backward
    runs through all of them. It runs with `remat="none"`: the backward
    runs on one thread, where a recompute could not join the threads'
    rows, and a recompute gives the forward's values bit for bit, so the
    ranks' `remat` changes no gradient bit. Its loss and gradients, on
    the host."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.launch.mesh import make_mesh, use_concrete_mesh
    from repro_torch.models import lm, placement
    from repro_torch.optim import adamw
    n = mesh_shape[0] * (mesh_shape[1] if cfg.pure_fsdp else 1)
    cfg = cfg.replace(remat="none")
    params = lm.init_params(cfg, SEED, device=dev)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    copies = [placement.Split.apply(p, n) for p in leaves]
    b = synthetic.lm_batch(SEED, 0, 0, W_BATCH, W_TRAIN_SEQ, cfg.vocab)
    per = W_BATCH // n

    def part(i):
        mine = adamw.unflatten(params, [c[i] for c in copies])
        return lm.loss_terms(cfg, mine, pipeline.device_put_batch(
            {k: v[i * per:(i + 1) * per] for k, v in b.items()}, dev), True)
    with placement.witness(), use_concrete_mesh(make_mesh(
            (1, mesh_shape[1]), DRILL_AXES, devices=dev)):
        terms = placement.witness_parts(part, n)
        cnt = torch.clamp(sum(c.detach() for _, c in terms), min=1.0)
        grads = torch.autograd.grad([t / cnt for t, _ in terms], leaves,
                                    allow_unused=True,
                                    materialize_grads=True)
    out = {"loss0": float(sum(t.detach() for t, _ in terms) / cnt),
           "grads": [g.cpu() for g in grads]}
    del params, leaves, copies, terms, grads
    free_card(torch)
    return out


def w_train_refs(torch, cfg, mesh_shape, batch, device, grads_path,
                 witness: bool) -> dict:
    """Step 0 of `train_loop` on one process over a logical mesh of
    `mesh_shape` (the ranks' batch: shard 0's rows of `batch`): its loss
    and final hidden state; with `witness`, the hidden state of the same
    step under `placement.witness`. Its gradients and `parts_grads`'
    are written to `grads_path`."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import placement
    from repro_torch.optim import adamw
    logical = make_mesh(mesh_shape, DRILL_AXES, devices=device)
    kw = dict(batch=batch, seq=W_TRAIN_SEQ, seed=SEED, log_every=100,
              steps=1, device=device, mesh=logical)
    with first_update(adamw) as got, first_hidden() as hid:
        ref = train.train_loop(cfg, **kw)
    grads = {"unsharded": [g.cpu() for g in got]}
    out = {"loss0": ref["losses"][0], "hidden": hid[0]}
    del ref, got
    free_card(torch)
    parts = parts_grads(torch, cfg, mesh_shape, device)
    grads["parts"], out["parts_loss0"] = parts["grads"], parts["loss0"]
    torch.save(grads, grads_path)
    del grads, parts
    if witness:
        with placement.witness(), first_hidden() as hid:
            train.train_loop(cfg, **kw)
        out["witness_hidden"] = hid[0]
        free_card(torch)
    return out


def w_train(torch, cfg, mesh, dev, batch, grads_path, out):
    """W_TRAIN_STEPS `train_loop` steps of `cfg` on this rank of `mesh`:
    launches, losses and params' fingerprints a step, the peak, the
    collectives a step, step 0's final hidden state (own rows) and, on
    rank 0, each leaf's step-0 gradient gathered whole and held to the
    one-process step's and to `parts_grads`' at `grads_path`."""
    from repro_torch.launch import distributed, steps as steps_mod, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with rank_steps(torch, steps_mod, dev) as (log, _), \
            first_update(adamw) as got, first_hidden() as hid, \
            timed_collectives(torch, distributed, dev) as coll:
        res = train.train_loop(cfg, steps=W_TRAIN_STEPS, mesh=mesh,
                               batch=batch, seq=W_TRAIN_SEQ, seed=SEED,
                               log_every=100)
    out.update(loop_s=time.perf_counter() - t0, losses=res["losses"],
               steps=log, peak_bytes=rank_peak(torch, dev),
               collectives=collective_summary(coll, W_TRAIN_STEPS),
               hidden=hid[0], coords=mesh.coords(),
               held_bytes=sum(t.numel() * t.element_size()
                              for t in adamw.leaves(res["params"])),
               grads_finite=all(bool(torch.isfinite(g).all()) for g in got))
    del res
    rank_free(torch, dev)
    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    ref = torch.load(grads_path, mmap=True) if mesh.rank == 0 else None
    gaps, unequal = {}, []
    for i, (name, g) in enumerate(zip(leaf_names(whole), sharding.full_leaves(
            adamw.unflatten(whole, got), specs, mesh))):
        if ref is not None:
            r = ref["unsharded"][i].to(dev).float()
            gaps[name] = ((g.float() - r).norm() /
                          (r.norm() + 1e-30)).item()
            if not torch.equal(g, ref["parts"][i].to(dev)):
                unequal.append(name)
    out.update(grad_gap=gaps, parts_unequal=unequal)
    del got, ref
    rank_free(torch, dev)


def w_rank(cfg, train_cfg, tokens_np, grads_path) -> dict:
    """(w1) and (w2) on one rank of the 4-rank world, on the W_MESH rank
    mesh: its part of the seed's params, cut as they are drawn
    (`sharding.local_init`), serving its rows of the pool; then
    `train_cfg`'s steps."""
    import torch
    from repro_torch.launch import distributed, train
    from repro_torch.launch.mesh import make_rank_mesh, use_concrete_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    dev, me = distributed.device(), distributed.rank()
    mesh = make_rank_mesh(W_MESH, DRILL_AXES)
    out = {"rank": me, "coords": mesh.coords(), "w1": {}, "w2": {}}
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = sharding.local_init(cfg, SEED, mesh, dev)
    rows = train.rank_rows(W_BATCH, mesh)
    tokens = torch.from_numpy(tokens_np[rows]).long().to(dev)
    with use_concrete_mesh(mesh):
        out["w1"] = w_serve(torch, cfg, params, tokens, dev)
    out["w1"].update(rows=(rows.start, rows.stop),
                     peak_bytes=rank_peak(torch, dev),
                     held_bytes=sum(t.numel() * t.element_size()
                                    for t in adamw.leaves(params)),
                     wall_s=time.perf_counter() - t0)
    del params
    rank_free(torch, dev)
    distributed.barrier()
    t0 = time.perf_counter()
    w_train(torch, train_cfg, mesh, dev, 2 * W_BATCH, grads_path, out["w2"])
    out["w2"]["wall_s"] = time.perf_counter() - t0
    return out


def w3_rank(cfg, grads_path) -> dict:
    """(w3) on one rank of the 2-rank world: `cfg`'s pure-FSDP steps on
    the W_FSDP_MESH rank mesh."""
    import torch
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_rank_mesh
    dev = distributed.device()
    mesh = make_rank_mesh(W_FSDP_MESH, DRILL_AXES)
    out = {"rank": distributed.rank()}
    t0 = time.perf_counter()
    w_train(torch, cfg, mesh, dev, W_BATCH, grads_path, out)
    out["wall_s"] = time.perf_counter() - t0
    return out


def w_check_train(torch, key, ranks, refs, cfg, mesh_shape, local_b,
                  totals, card, limits):
    """(w2) / (w3)'s gates on the ranks' `w_train` results: exact
    launches a step on every rank, finite equal losses across ranks,
    step 0's loss and every gradient bit for bit with `parts_grads`', its
    loss and worst gradient gaps to the unsharded step within `limits`,
    the final hidden state of step 0 bit for bit with the witness's rows,
    and after the last step each leaf's blocks equal on every rank that
    holds them."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import RankMesh, abstract_mesh
    from repro_torch.models import lm
    from repro_torch.runtime import sharding
    per_step = lm_train_launches(cfg)
    r0 = ranks[0]
    gap = r0["grad_gap"]
    worst = max(gap, key=gap.get)
    loss_gap = abs(r0["losses"][0] - refs["loss0"]) / abs(refs["loss0"])
    witness = refs.get("witness_hidden", refs["hidden"])
    equal_rows = []
    for r in ranks:
        emit(f"{key}_rank", card=card, rank=r["rank"], mesh=list(mesh_shape),
             coords=r["coords"], layers=cfg.n_layers, losses=r["losses"],
             held_bytes=r["held_bytes"], peak_bytes=r["peak_bytes"],
             loop_s=r["loop_s"], step_span_s=[s["span_s"] for s in r["steps"]],
             step_host_s=[s["host_s"] for s in r["steps"]],
             collectives_per_step=r["collectives"],
             launches_per_step=per_step, wall_s=r["wall_s"])
        for i, s in enumerate(r["steps"]):
            lm_launch_check(s["launches"], per_step,
                            f"({key}) rank {r['rank']} step {i}")
            add_counts(totals, s["launches"])
            check(math.isfinite(s["loss"]), f"({key}) step {i} loss "
                  f"{s['loss']}")
        check(r["losses"] == r0["losses"], f"({key}) losses differ across "
              f"ranks")
        check(r["grads_finite"], f"({key}) rank {r['rank']}: step 0 "
              f"gradients not finite")
        rows = train.rank_rows(local_b, RankMesh(
            mesh_shape, DRILL_AXES, r["rank"], torch.device("cpu"), {}),
            cfg.pure_fsdp)
        equal_rows.append(bool(torch.equal(r["hidden"], witness[rows])))
    emit(key, card=card, arch=cfg.name, layers=cfg.n_layers,
         mesh=list(mesh_shape), ranks=len(ranks), rows_per_step=local_b,
         seq=W_TRAIN_SEQ, loss0=r0["losses"][0],
         one_process_loss0=refs["loss0"], loss0_rel_gap=loss_gap,
         parts_loss0=refs["parts_loss0"],
         parts_unequal_leaves=len(r0["parts_unequal"]),
         loss0_gap_limit=limits[0], grad_gap_worst=gap[worst],
         grad_gap_worst_leaf=worst, grad_gap_limit=limits[1],
         hidden_equal_witness=equal_rows,
         witness_equal_unsharded=bool(torch.equal(witness, refs["hidden"])),
         peak_sum_bytes=sum(r["peak_bytes"] for r in ranks))
    check(all(equal_rows), f"({key}) step 0's final hidden state differs "
          f"from the one-process witness's on ranks "
          f"{[i for i, e in enumerate(equal_rows) if not e]}")
    check(r0["losses"][0] == refs["parts_loss0"], f"({key}) step 0 loss "
          f"{r0['losses'][0]} differs from parts_grads' "
          f"{refs['parts_loss0']}")
    check(not r0["parts_unequal"], f"({key}) step 0 gradients differ from "
          f"parts_grads' at {r0['parts_unequal'][:3]}")
    check(loss_gap <= limits[0], f"({key}) step 0 loss gap {loss_gap}")
    check(gap[worst] <= limits[1], f"({key}) step 0 gradient gap "
          f"{gap[worst]} at {worst}")
    whole = lm.abstract_params(cfg)
    mesh = abstract_mesh(mesh_shape, DRILL_AXES)
    axes = sharding.leaf_split_axes(whole, sharding.param_specs(
        cfg, whole, mesh), mesh)
    names = leaf_names(whole)
    for i, split in enumerate(axes):
        held: dict = {}
        for r in ranks:
            held.setdefault(tuple(r["coords"][a] for a in sorted(split)),
                            set()).add(r["steps"][-1]["params"][i])
        check(all(len(v) == 1 for v in held.values()), f"({key}) after "
              f"{W_TRAIN_STEPS} steps the ranks holding {names[i]}'s "
              f"blocks hold other bits")


def phase_w(torch, device, card):
    """(w) the MoE configs on rank meshes as the registry configures them:
    (w1) qwen2-moe-a2.7b uncut and as configured (`moe_apply`, T = 2, four
    shared experts, one dispatch group) on a (data 2, model 2) rank mesh
    of four `gloo` ranks, each holding 30 routed experts a layer, half
    the attention heads, half the shared experts' d_ff and half the
    vocab: a spiking prefill of W_BATCH x W_PROMPT and W_DECODE_STEPS
    decode steps on the pool's slots, split over the data ranks; (w2)
    the same model at full width, cut to the depth `w_train_depth`
    reckons, W_TRAIN_STEPS `train_loop` steps of 8 x 128 rows on the same
    mesh; (w3) that model with `pure_fsdp=True` on (1, 2). Gates: (w1)
    every layer's dropped assignments equal to the one-process run's,
    the first MoE layer's output bit for bit with the one-process
    `moe_apply`'s (its witness form, whose shared experts run per model
    position), logits and tokens bit for bit with the witness, exact
    launches on every rank; (w2), (w3) `w_check_train`. Returns the
    launches."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.launch import distributed
    cfg = get_config(MOE_ARCH)
    totals: dict = {}
    depth = w_train_depth(torch, cfg)
    emit("moe_rank_train_depth", card=card, **depth)
    train_cfg = cfg.replace(n_layers=depth["layers"])
    fsdp_cfg = train_cfg.replace(pure_fsdp=True)
    tokens_np = markov_tokens(SEED, 0, 0, W_BATCH, W_PROMPT,
                              cfg.vocab)[:, :W_PROMPT]

    def parent_free():
        """free_card after dropping the cuBLAS workspaces, whose segments
        `empty_cache` cannot release: the four ranks need all but a few
        GB of the card (PERF.md PR 40 runs 6-7: this process kept 2.49 GB
        reserved for 134 MB allocated after the refs)."""
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        return free_card(torch), torch.cuda.memory_reserved()
    held = [("start", *parent_free())]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_w_")
    try:
        t0 = time.perf_counter()
        refs1 = w1_refs(torch, cfg, tokens_np, device)
        held.append(("w1_refs", *parent_free()))
        w2_path, w3_path = (os.path.join(tmp, f"{k}.pt") for k in
                            ("w2", "w3"))
        refs2 = w_train_refs(torch, train_cfg, W_MESH, 2 * W_BATCH, device,
                             w2_path, witness=True)
        held.append(("w2_refs", *parent_free()))
        refs3 = w_train_refs(torch, fsdp_cfg, W_FSDP_MESH, W_BATCH, device,
                             w3_path, witness=False)
        held.append(("w3_refs", *parent_free()))
        # what this process holds on the card while the ranks run
        emit("w_parent_bytes", card=card, **{
            f"{k}_{n}": v for k, a, r in held
            for n, v in (("allocated", a), ("reserved", r))})
        refs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = distributed.spawn(w_rank, W_MESH[0] * W_MESH[1],
                                  backend=U_BACKEND, device=device,
                                  timeout_s=2 * U_SPAWN_TIMEOUT,
                                  args=(cfg, train_cfg, tokens_np, w2_path))
        world4_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks3 = distributed.spawn(w3_rank, W_FSDP_MESH[1],
                                   backend=U_BACKEND, device=device,
                                   timeout_s=U_SPAWN_TIMEOUT,
                                   args=(fsdp_cfg, w3_path))
        world2_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("phase_time", name="w_one_process_refs", seconds=refs_s)
    emit("phase_time", name="w1_w2_ranks", seconds=world4_s)
    emit("phase_time", name="w3_ranks", seconds=world2_s)
    # (w1)
    plain, wit = refs1["plain"], refs1["witness"]
    x0, y0 = wit["layer0"]
    _, p_y0 = plain["layer0"]
    for r in ranks:
        v = r["w1"]
        rows = slice(*v["rows"])
        rx0, ry0 = v["layer0"]
        emit("moe_rank_serve_rank", card=card, rank=r["rank"],
             coords=r["coords"], held_bytes=v["held_bytes"],
             peak_bytes=v["peak_bytes"], first_prefill_s=v["first_prefill_s"],
             prefill_span_s=v["prefill_span_s"], state_s=v["state_s"],
             decode_step_s=v["decode_step_s"],
             collectives_per_prefill=v["collectives"],
             dropped=sum(v["drops"]), wall_s=v["wall_s"],
             layer0_max_abs_dout_plain=(ry0.float() - p_y0[:, rows].float())
             .abs().max().item(),
             prefill_launches={k: n for k, n in v["prefill_launches"].items()
                               if n})
        lm_launch_check(v["prefill_launches"], MOE_PREFILL_LAUNCHES,
                        f"(w1) rank {r['rank']} prefill")
        lm_launch_check(v["step_launches"], MOE_DECODE_LAUNCHES,
                        f"(w1) rank {r['rank']} decode step")
        add_counts(totals, v["prefill_launches"])
        add_counts(totals, v["step_launches"])
        check(v["repeats"], f"(w1) rank {r['rank']}: the prefill does not "
              f"repeat bit for bit")
        check(v["drops"] == wit["drops"], f"(w1) rank {r['rank']} dropped "
              f"{v['drops']}, the one-process run {wit['drops']}")
        check(torch.equal(rx0, x0[:, rows]), f"(w1) rank {r['rank']}: the "
              f"first MoE layer's input differs from the one-process one's")
        check(torch.equal(ry0, y0[:, rows]), f"(w1) rank {r['rank']}: the "
              f"first MoE layer's output differs from moe_apply's by "
              f"{(ry0.float() - y0[:, rows].float()).abs().max().item()}")
        check(torch.equal(v["logits"], wit["logits"][rows]), f"(w1) rank "
              f"{r['rank']}: logits differ from the witness's by "
              f"{(v['logits'] - wit['logits'][rows]).abs().max().item()}")
        check(torch.equal(v["tokens"], wit["tokens"][:, rows]), f"(w1) rank "
              f"{r['rank']}: decoded tokens differ from the witness's")
    peaks = [r["w1"]["peak_bytes"] for r in ranks]
    emit("moe_rank_serve", card=card, arch=cfg.name, mesh=list(W_MESH),
         ranks=len(ranks), batch=W_BATCH, prompt=W_PROMPT,
         decode_steps=W_DECODE_STEPS, dropped=sum(wit["drops"]),
         unsharded_dropped=sum(plain["drops"]),
         assignments=W_BATCH * W_PROMPT * cfg.spiking.t_steps
         * cfg.moe.top_k * cfg.n_layers, dropped_by_layer=wit["drops"],
         unsharded_dropped_by_layer=plain["drops"],
         logits_max_abs_gap_unsharded=(wit["logits"] - plain["logits"])
         .abs().max().item(), logits_max=plain["logits"].abs().max().item(),
         tokens_share_equal_unsharded=float(
             (wit["tokens"] == plain["tokens"]).float().mean()),
         one_process_prefill_s=plain["first_prefill_s"],
         one_process_prefill_span_s=plain["prefill_span_s"],
         one_process_decode_step_s=plain["decode_step_s"],
         peak_sum_bytes=sum(peaks), peak_bytes=peaks,
         card_bytes=CARD_MEMORY_BYTES)
    check(wit["drops"][0] == plain["drops"][0], "(w1) the witness's first "
          "MoE layer drops other assignments than the unsharded run's")
    check(sum(peaks) < CARD_MEMORY_BYTES, f"(w1) the four ranks' peaks sum "
          f"to {sum(peaks)} bytes")
    # (w2), (w3)
    w_check_train(torch, "w2", [r["w2"] | {"rank": r["rank"]} for r in ranks],
                  refs2, train_cfg, W_MESH, W_BATCH, totals, card,
                  (W2_LOSS_GAP_LIMIT, W2_GRAD_GAP_LIMIT))
    w_check_train(torch, "w3", ranks3, refs3, fsdp_cfg, W_FSDP_MESH,
                  W_BATCH, totals, card,
                  (W3_LOSS_GAP_LIMIT, W3_GRAD_GAP_LIMIT))
    return totals



# ------------------------------------------------------------ phase (x)
# The data-parallel side on ranks: sharded event ops with one shard a
# rank, compressed gradients over the batch ranks, the multi-pod mesh.
X_RANKS = 4
X_MESH = (X_RANKS, 1)
# 960 rows a rank: (r2)'s ragged per-shard rows (7680 over 4 ranks is
# 1920 a rank, 15 whole tiles, no ragged grid).
X_RAGGED_ROWS = X_RANKS * 960
# The rebalanced call: the hot band piles the occupied tiles on rank 0.
X_REBALANCED = ("ffn_fc1", "clustered50_hotband")
X2_POD_MESH, X2_POD_AXES = (2, 1, 2), ("pod", "data", "model")
X2_WITNESS_MESH = (2, 2)
X2_STEPS = 2


def x1_calls(operands) -> list:
    """(key, operand index, op, packed, variant) of (x1): every op and
    payload static on each operand set, the rebalanced call, and the
    ragged grid on the first set's first X_RAGGED_ROWS rows."""
    calls = []
    for i, (label, data, *_rest) in enumerate(operands):
        for op in ("spike_matmul", "apec_matmul"):
            for packed in (False, True):
                calls.append((f"{op}|{int(packed)}|{label}|{data}|static",
                              i, op, packed, "static"))
        if (label, data) == X_REBALANCED:
            calls.append((f"spike_matmul|0|{label}|{data}|rebalanced",
                          i, "spike_matmul", False, "rebalanced"))
    calls.append(("spike_matmul|0|ragged", 0, "spike_matmul", False,
                  "ragged"))
    return calls


def x1_call(torch, mesh, op, packed, variant, s, w, occ):
    """One (x1) call on `mesh` (logical or a rank's): its output and
    report. `s` dense spikes (packed here for a packed call), `occ` the
    carried map on the card (the ragged call's map is dropped)."""
    from repro_torch.core.spikes import pack_spikes_padded
    from repro_torch.runtime import sharding
    kw = {"packed_k": s.shape[-1]} if packed else {}
    if op == "apec_matmul":
        kw["g"] = MESH_APEC_G
    payload = pack_spikes_padded(s) if packed else s
    with torch.inference_mode():
        return sharding.event_op_sharded(
            mesh, op, payload, w, occupancy=occ, with_report=True,
            rebalance=variant == "rebalanced", **kw)


def x1_grad_case(torch, s, w, occ, op, mesh, g):
    """dw of `op` through `event_op_sharded` on `mesh` (None: the
    unsharded dispatch) against the cotangent `g`."""
    from repro_torch.kernels import dispatch
    from repro_torch.runtime import sharding
    kw = {"g": MESH_APEC_G} if op == "apec_matmul" else {}
    wr = w.clone().requires_grad_(True)
    out = dispatch.dispatch(op, s, wr, occupancy=occ, **kw) if mesh is None \
        else sharding.event_op_sharded(mesh, op, s, wr, occupancy=occ, **kw)
    return torch.autograd.grad((out * g).sum(), wr)[0]


def x1_cotangent(torch, rows, n, device):
    return torch.randn((rows, n), generator=torch.Generator().manual_seed(
        SEED)).to(device)


def x1_refs(torch, device, tmp) -> dict:
    """(x1)'s one-process side: every call on a logical mesh of X_RANKS
    positions on the card (each rank's rows' fingerprints, the report),
    the unsharded dw of both ops, and each rank's operands written to
    `tmp` (its rows of the spikes and of the map, the weights)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(X_MESH, DRILL_AXES, devices=device)
    operands = mesh_operands(torch, device)
    calls = x1_calls(operands)
    refs = {"calls": calls, "fp": {}, "rep": {}, "rows": {}}
    for key, i, op, packed, variant in calls:
        _, _, s, w, occ = operands[i]
        if variant == "ragged":
            s = s[:X_RAGGED_ROWS].contiguous()
            occ = ops.padded_occupancy(s)
        out, rep = x1_call(torch, mesh, op, packed, variant, s, w, occ)
        per = out.shape[0] // X_RANKS
        refs["fp"][key] = [fingerprint(torch, out[r * per:(r + 1) * per])
                           for r in range(X_RANKS)]
        refs["rep"][key] = rep
        refs["rows"][key] = out.shape[0]
    # the weight gradient through the shards against the unsharded one
    _, _, s, w, occ = (t.clone() if hasattr(t, "clone") else t
                       for t in operands[0])
    g = x1_cotangent(torch, s.shape[0], w.shape[1], device)
    refs["dw"] = {op: x1_grad_case(torch, s, w, occ, op, None, g).cpu()
                  for op in ("spike_matmul", "apec_matmul")}
    for r in range(X_RANKS):
        mine = {}
        for i, (_, _, s, w, occ) in enumerate(operands):
            per, mt = s.shape[0] // X_RANKS, occ.shape[0] // X_RANKS
            mine[i] = (s[r * per:(r + 1) * per].cpu(), w.cpu(),
                       occ[r * mt:(r + 1) * mt].cpu())
        s = operands[0][2][:X_RAGGED_ROWS]
        per = X_RAGGED_ROWS // X_RANKS
        mine["ragged"] = s[r * per:(r + 1) * per].cpu()
        torch.save(mine, os.path.join(tmp, f"x1_rank{r}.pt"))
    del operands
    return refs


def x1_rank_part(torch, tmp, calls, out):
    """(x1) on this rank: every call on its own rows on the rank mesh,
    its launches, output fingerprint and report; the dw of both ops."""
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_rank_mesh
    dev, me = distributed.device(), distributed.rank()
    mesh = make_rank_mesh(X_MESH, DRILL_AXES)
    mine = torch.load(os.path.join(tmp, f"x1_rank{me}.pt"),
                      map_location=dev)
    got = {}
    t0 = time.perf_counter()
    for key, i, op, packed, variant in calls:
        s, w, occ = mine[i]
        if variant == "ragged":
            s = mine["ragged"]
            occ = ops.padded_occupancy(s)
        distributed.barrier()
        rank_sync(torch, dev)
        reset_launch_counts()
        c0 = time.perf_counter()
        y, rep = x1_call(torch, mesh, op, packed, variant, s, w, occ)
        rank_sync(torch, dev)
        got[key] = dict(fp=fingerprint(torch, y), rep=rep,
                        launches=launch_counts(),
                        s=time.perf_counter() - c0)
    calls_s = time.perf_counter() - t0
    s, w, occ = mine[0]
    g = x1_cotangent(torch, s.shape[0] * X_RANKS, w.shape[1], dev)
    per = s.shape[0]
    dw = {op: x1_grad_case(torch, s.clone(), w, occ, op, mesh,
                           g[me * per:(me + 1) * per]).cpu()
          for op in ("spike_matmul", "apec_matmul")}
    out["x1"] = dict(calls=got, dw=dw, calls_s=calls_s)
    del mine
    rank_free(torch, dev)


# Elements a chunk of the one-process compression check (f32 temporaries
# of 128 MB each): a stacked leaf of 22 blocks holds 253M.
X2_CHECK_CHUNK = 1 << 25


@contextlib.contextmanager
def x2_compress_check(torch, mesh, specs, steps: int):
    """While active, the first `steps` calls of `grad_compress.compress`
    are held, leaf by leaf, to `grad_compress.compress` run in one
    process on the whole summed gradient and EF state: every rank
    gathers each leaf whole (`sharding.full_leaves`) and rank 0 compares
    wire, scale and EF bit for bit, the leaf compressed in chunks of
    X2_CHECK_CHUNK elements on its whole max (`compress`'s `whole_max`;
    elementwise, so the same bits as one call). Yields the mismatches
    (step, leaf, part) and the seconds the checks took."""
    from repro_torch.launch import distributed
    from repro_torch.optim import adamw, grad_compress
    from repro_torch.runtime import sharding
    orig = grad_compress.compress
    bad: list = []
    seconds = [0.0]
    calls = [0]

    def compress(grads, ef, whole_max=None):
        wire, scales, new = orig(grads, ef, whole_max)
        if calls[0] < steps:
            t0 = time.perf_counter()
            gens = [sharding.full_leaves(tree, specs, mesh)
                    for tree in (grads, ef.error, wire, new.error)]
            for k, ((g, e, q, n2), sc) in enumerate(zip(
                    zip(*gens), adamw.leaves(scales))):
                if distributed.rank() == 0:
                    chunks = list(zip(g.reshape(-1).split(X2_CHECK_CHUNK),
                                      e.reshape(-1).split(X2_CHECK_CHUNK)))
                    amax = torch.stack([(gc.float() + ec.float()).abs().max()
                                        for gc, ec in chunks]).max()
                    parts = [orig([gc], grad_compress.EFState([ec]),
                                  lambda _: [amax]) for gc, ec in chunks]
                    wire1 = torch.cat([w1[0] for w1, _, _ in parts])
                    ef1 = torch.cat([e1.error[0] for _, _, e1 in parts])
                    for part, a, b in (("wire", q.reshape(-1), wire1),
                                       ("ef", n2.reshape(-1), ef1),
                                       ("scale", sc, parts[0][1][0])):
                        if not torch.equal(a, b):
                            bad.append((calls[0], k, part))
                    del parts, wire1, ef1
                del g, e, q, n2
            seconds[0] += time.perf_counter() - t0
        calls[0] += 1
        return wire, scales, new

    grad_compress.compress = compress
    try:
        yield bad, seconds
    finally:
        grad_compress.compress = orig


def x2_run(torch, cfg, mesh, check: bool) -> dict:
    """X2_STEPS compressed steps of `cfg` at LM_TRAIN_BATCH x LM_TRAIN_SEQ
    on this rank of `mesh`, from `sharding.local_init`: losses, grad
    norms, launches and span a step, fingerprints of the params and EF
    state after, the peak; with `check`, `x2_compress_check`."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import distributed, steps as steps_mod, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw, grad_compress
    from repro_torch.runtime import sharding
    dev = distributed.device()
    whole = lm.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, mesh)
    params = sharding.local_init(cfg, SEED, mesh, dev)
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    opt = adamw.init(params, opt_cfg)
    ef = grad_compress.init(params)
    step = steps_mod.make_train_step(cfg, opt_cfg, spiking=True,
                                     grad_compression=True, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rows = train.rank_rows(LM_TRAIN_BATCH, mesh)
    log = []
    with contextlib.ExitStack() as stack:
        bad, check_s = stack.enter_context(x2_compress_check(
            torch, mesh, specs, X2_STEPS if check else 0))
        for t in range(X2_STEPS):
            b = synthetic.lm_batch(SEED, 0, t, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                   cfg.vocab)
            batch = pipeline.device_put_batch(
                {k: v[rows] for k, v in b.items()}, dev)
            rank_sync(torch, dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            params, opt, ef, metrics = step(params, opt, ef, batch)
            rank_sync(torch, dev)
            log.append(dict(loss=metrics["loss"].item(),
                            grad_norm=metrics["grad_norm"].item(),
                            launches=launch_counts(),
                            span_s=time.perf_counter() - t0))
    out = dict(steps=log, bad=list(bad), check_s=check_s[0],
               peak_bytes=rank_peak(torch, dev), rows=str(rows),
               coords=mesh.coords(),
               params=[fingerprint(torch, p) for p in adamw.leaves(params)],
               ef=[fingerprint(torch, e) for e in adamw.leaves(ef.error)])
    del params, opt, ef, step
    rank_free(torch, dev)
    return out


def x_rank(tmp, calls, cfg) -> dict:
    """(x) on one rank of four: (x1), then (x2) on the multi-pod mesh
    (`make_production_mesh` would give (2, 2, 1): its (2, 1, 2) form is
    built here, a model axis for TinyLlama's tensor-parallel leaves) and
    on its (data 2, model 2) witness."""
    import torch
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_production_mesh, \
        make_rank_mesh
    out = {"rank": distributed.rank()}
    x1_rank_part(torch, tmp, calls, out)
    production = make_production_mesh(multi_pod=True)
    out["production_shape"] = dict(production.shape)
    pod = make_rank_mesh(X2_POD_MESH, X2_POD_AXES)
    witness = make_rank_mesh(X2_WITNESS_MESH, DRILL_AXES)
    t0 = time.perf_counter()
    out["pod"] = x2_run(torch, cfg, pod, check=True)
    out["witness"] = x2_run(torch, cfg, witness, check=False)
    out["x2_s"] = time.perf_counter() - t0
    return out


def phase_x(torch, device, card):
    """(x) the data-parallel side of rank meshes, X_RANKS `gloo` ranks on
    the card in one world. (x1) `event_op_sharded` with one shard a rank
    at SpikingFormer-4-384's full-width shapes (stage 1 (131072 x 432) .
    (432 x 96), fc1, fc2; (r2)'s operands on the model's maps and the
    50%-clustered hot band): dense `spike_matmul` (kernel 12), packed
    (14), APEC dense (19 spikes + 18) and packed (19 + 16) on each, one
    rebalanced call (X_REBALANCED, the map on the card read once) and the
    ragged grid (960 rows a rank: kernel 10 by the chain). Gates: each
    rank's rows bit for bit with the same rows of the one-process call on
    a logical mesh of X_RANKS positions; one launch a rank of the
    resolved kernels and none of any other; every rank's report equal to
    the one-process report; the ranks' summed dw within MESH_TOL of the
    unsharded one. (x2) TinyLlama-1.1B uncut on the multi-pod (pod 2,
    data 1, model 2) mesh, `grad_compression=True`, LM_TRAIN_BATCH x
    LM_TRAIN_SEQ for X2_STEPS steps, beside the same run on (data 2,
    model 2) in the same world (the batch group is the same ranks in the
    same order). Gates: losses, params and EF state bit for bit with that
    witness; each rank's wire, scales and EF blocks bit for bit with
    one-process compression of the gathered summed gradient at every
    step; exact launches a step on every rank; the ranks' peaks summed
    under the card. Returns the launches."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import distributed
    cfg = get_config(LM_ARCH)
    totals: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_x_")
    try:
        t0 = time.perf_counter()
        refs = x1_refs(torch, device, tmp)
        free_card(torch)
        refs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = distributed.spawn(x_rank, X_RANKS, backend=U_BACKEND,
                                  device=device,
                                  timeout_s=2 * U_SPAWN_TIMEOUT,
                                  args=(tmp, refs["calls"], cfg))
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("phase_time", name="x_one_process_refs", seconds=refs_s)
    emit("phase_time", name="x_ranks", seconds=ranks_s)
    # (x1)
    for key, _, op, packed, variant in refs["calls"]:
        want = {k: 1 for k in MESH_SHARD_LAUNCHES[(op, packed)]} \
            if variant != "ragged" else {"spike_matmul_pred": 1}
        rep = refs["rep"][key]
        for r in ranks:
            c = r["x1"]["calls"][key]
            check(c["fp"] == refs["fp"][key][r["rank"]],
                  f"(x1) {key}: rank {r['rank']}'s rows differ from the "
                  f"one-process call's")
            check(c["launches"] == {k: want.get(k, 0)
                                    for k in c["launches"]},
                  f"(x1) {key}: rank {r['rank']} launched {c['launches']}, "
                  f"not {want}")
            check(c["rep"] == rep, f"(x1) {key}: rank {r['rank']}'s report "
                  f"{c['rep']} is not the one-process report {rep}")
            add_counts(totals, c["launches"])
        imb = rep["occupancy"]
        emit("x1_sharded", card=card, call=key, rows=refs["rows"][key],
             ranks=X_RANKS, attribution=rep["attribution"],
             occupancy_source=rep["occupancy_source"],
             host_reads=rep["host_reads"], moved_bytes=rep["moved_bytes"],
             per_shard=list(imb.per_shard), imbalance=imb.imbalance,
             pre_per_shard=list(imb.pre_per_shard),
             pre_imbalance=imb.pre_imbalance,
             rank_s=[r["x1"]["calls"][key]["s"] for r in ranks],
             launches_a_rank=ranks[0]["x1"]["calls"][key]["launches"])
        if variant == "rebalanced":
            check(bool(imb.pre_per_shard) and imb.imbalance
                  < imb.pre_imbalance and rep["moved_bytes"] > 0
                  and rep["host_reads"] == 1,
                  f"(x1) {key}: the plan did not engage ({rep})")
        if variant == "ragged":
            check(rep["attribution"] == "cuda-pred<-cuda-pipe",
                  f"(x1) ragged: {rep['attribution']}")
    for op, want in refs["dw"].items():
        got = sum(r["x1"]["dw"][op] for r in ranks)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        emit("x1_grad", card=card, op=op, case="ffn_fc1_model",
             max_rel_dw=rel)
        check(rel <= MESH_TOL, f"(x1) {op}: the ranks' summed dw is off "
              f"the unsharded one by {rel}")
    emit("x1_ranks", card=card, calls=len(refs["calls"]),
         calls_s=[r["x1"]["calls_s"] for r in ranks])
    # (x2)
    per_step = lm_train_launches(cfg)
    peaks = []
    for r in ranks:
        check(r["production_shape"] == {"pod": 2, "data": 2, "model": 1},
              f"(x2) make_production_mesh(multi_pod=True) gave "
              f"{r['production_shape']}")
        pod, wit = r["pod"], r["witness"]
        for k, st in enumerate(pod["steps"]):
            lm_launch_check(st["launches"], per_step,
                            f"(x2) rank {r['rank']} pod step {k}")
            add_counts(totals, st["launches"])
        for k, st in enumerate(wit["steps"]):
            lm_launch_check(st["launches"], per_step,
                            f"(x2) rank {r['rank']} witness step {k}")
            add_counts(totals, st["launches"])
        losses = [st["loss"] for st in pod["steps"]]
        check(losses == [st["loss"] for st in wit["steps"]]
              and all(math.isfinite(x) for x in losses),
              f"(x2) rank {r['rank']}: losses {losses} against the "
              f"witness's {[st['loss'] for st in wit['steps']]}")
        check(pod["params"] == wit["params"], f"(x2) rank {r['rank']}: "
              f"params differ from the witness's")
        check(pod["ef"] == wit["ef"], f"(x2) rank {r['rank']}: the EF "
              f"state differs from the witness's")
        check(pod["rows"] == wit["rows"], f"(x2) rank {r['rank']}: rows "
              f"{pod['rows']} against {wit['rows']}")
        peaks.append(max(pod["peak_bytes"], wit["peak_bytes"]))
        emit("x2_rank", card=card, rank=r["rank"], coords=pod["coords"],
             rows=pod["rows"], losses=losses,
             grad_norms=[st["grad_norm"] for st in pod["steps"]],
             step_s=[st["span_s"] for st in pod["steps"]],
             witness_step_s=[st["span_s"] for st in wit["steps"]],
             compress_check_s=pod["check_s"], peak_bytes=pod["peak_bytes"],
             witness_peak_bytes=wit["peak_bytes"], x2_s=r["x2_s"])
    bad = ranks[0]["pod"]["bad"]
    check(not bad, f"(x2) wire / scale / EF off one-process compression "
          f"at (step, leaf, part) {bad[:6]}")
    losses = {tuple(st["loss"] for st in r["pod"]["steps"]) for r in ranks}
    check(len(losses) == 1, f"(x2) the ranks' losses differ: {losses}")
    emit("x2_multi_pod", card=card, arch=cfg.name, mesh=list(X2_POD_MESH),
         witness_mesh=list(X2_WITNESS_MESH), batch=LM_TRAIN_BATCH,
         seq=LM_TRAIN_SEQ, steps=X2_STEPS, losses=list(losses.pop()),
         checked_steps=X2_STEPS, mismatches=len(bad),
         peak_sum_bytes=sum(peaks), card_bytes=CARD_MEMORY_BYTES)
    check(sum(peaks) < CARD_MEMORY_BYTES, f"(x2) the four ranks' peaks sum "
          f"to {sum(peaks)} bytes")
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
    # The mesh: the models under an 8-position data mesh, every sharded
    # route once per shard (rows 12, 14, 16, 18, 19; row 10 on the ragged
    # grid and the degraded CNN calls), the LM's serving and training
    # under a mesh.
    for name, n in timed("r_mesh", phase_mesh, torch, device, card).items():
        totals[name] = totals.get(name, 0) + n
    # LM training across the families: rows 2 and 3 bf16 in every block,
    # row 9 in qwen2-moe's and jamba's attention layers.
    for name, n in timed("s_train_families", phase_train_families, torch,
                         device, card).items():
        totals[name] = totals.get(name, 0) + n
    # The CNNs' training steps launch rows 5 and 3, 12 and (SegNet) 10;
    # the status entry its own instance of row 7; the MLP on events rows
    # 12 / 14 and 4 / 6.
    for name, n in timed("t_cnn_train_examples", phase_t, torch, device,
                         results, card).items():
        totals[name] = totals.get(name, 0) + n
    # Ranks of a process group on the card: the data-parallel TinyLlama
    # steps launch rows 2 and 3 bf16 and row 9 on every rank, the
    # expert-parallel qwen2-moe prefill row 1 bf16 and row 9, the nccl
    # rank's step rows 2, 3 bf16 and 9 (counted inside the ranks).
    for name, n in timed("u_ranks", phase_u, torch, device, card).items():
        totals[name] = totals.get(name, 0) + n
    # Every leaf placed on ranks: the tensor-parallel TinyLlama prefill and
    # steps, the pure-FSDP steps and the tensor-parallel qwen3-4b prefill
    # launch rows 1, 2 and 3 bf16 and row 9 at a rank's shapes.
    for name, n in timed("v_placement", phase_v, torch, device,
                         card).items():
        totals[name] = totals.get(name, 0) + n
    # The MoE configs on rank meshes: qwen2-moe-a2.7b's prefill, decode
    # and training steps on (2, 2) and its pure-FSDP steps on (1, 2)
    # launch rows 1, 2 and 3 bf16 and row 9 at a rank's shapes.
    for name, n in timed("w_moe_ranks", phase_w, torch, device,
                         card).items():
        totals[name] = totals.get(name, 0) + n
    # The data-parallel side on ranks: each rank's sharded calls launch
    # rows 12, 14, 16, 18, 19 and (the ragged grid) 10 once; the
    # compressed multi-pod steps rows 2, 3 bf16 and 9 on every rank.
    for name, n in timed("x_event_ranks", phase_x, torch, device,
                         card).items():
        totals[name] = totals.get(name, 0) + n
    emit("phase_time", name="total", seconds=time.perf_counter() - t_start)
    kernels = []
    for name in INFERENCE_KERNELS + TRAINING_KERNELS + APEC_KERNELS + \
            PACKED_KERNELS + LM_KERNELS + LM_TRAIN_KERNELS + T_KERNELS:
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
