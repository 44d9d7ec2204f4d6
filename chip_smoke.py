#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. hold the fused NSD kernel bit-exact against its plain PyTorch version
     on both routes (the dither drawn inside from a stream key, and fed) at
     the unpadded cotangents of VGG11 layers c0 (131,072 x 64), c1, c5 and
     fc2 (128 x 10) at batch 128 and at delta = 0, its bitmap, counts and
     mask against the pack's plain version on its k; the draw-only Philox
     kernel against its plain version; the pack kernel at c0's padded k and
     with an empty tile; the int8 matmul at c1 and c5 with full and empty
     masks;
  3b. hold the levels compact and expand kernels (chunk-local, and the
     one-launch wire kernels that lay out a whole chunk stream: levels,
     bitmap and nnz; its decode; the paged expand that decodes a stack of
     wire containers at once) and the bitmap-unpack kernel bit for bit
     against their plain versions at c1's residual size at batch 128
     (2,097,152 elements, 8,192 chunks) and at the edges (an all-zero and
     an all-non-zero chunk, an all-zero and an all-non-zero tensor, one
     chunk, 2^18 chunks for the wire kernels, n = 1000 through the wire
     container; for the paged expand gemma-2b's KV pages of 16 chunks, 64
     and 4,096 of them, pages of 1 and of 40 chunks, repeated ids, an
     all-zero and an all-non-zero page), and the dequant product
     within its band (relative L2 <= 8 sqrt(K) 2^-24 for a K-long
     contraction) at the c1 and c5 dx and dW shapes with full, empty and
     partial masks;
  4. train VGG11-CIFAR at full width, batch 128, 5 steps, variant=kernel,
     through ``repro_torch.train.classifier.train_classifier``; check the
     loss is finite, the launch counts (per step: NSD 11, bsp 21, c0's dx
     being skipped because the images need no gradient; pack and the draw
     kernel 0: the NSD kernel draws the dither and writes the bitmap and
     tile mask itself), that no
     structural fallback happened, that dither sparsity is within 8 points
     of the same steps run on the plain versions, and that step 1's
     gradients agree with the plain versions' (relative L2 <= 1e-5 per
     parameter; the kernels are bit-exact, so 0 is expected);
  4b. the same training with ``memory="default=nsd"``: every dithered
     layer's input is NSD-encoded into the wire container in the forward
     and decoded in the backward. Check the loss is finite, the launch
     counts (per step: NSD 22, wire compact 11, wire expand 11, bsp 21;
     pack, unpack and the draw kernel 0), no fallback,
     ``residual_compression`` equal to the plain
     versions' run (relative 1e-6), sparsity within 8 points of phase 4's
     run, step-1 gradients against the plain versions (relative L2 <=
     1e-5), and step-1 BatchNorm and bias gradients and dither telemetry
     identical to the fp32-residual step's (only weight gradients move);
  4c. the f32-operand backward: ``ops.dithered_backward_matmuls(...,
     int8_operands=False)`` on every layer's captured (g, x, w, u) of one
     step, held to its plain versions and to the paper variant's f32
     products within the dequant band, with its launches counted (NSD 11,
     dequant 22);
  4d. the paper variant (NSD in f32 ops, f32 products) for 5 steps: its
     only kernel is the draw-only Philox kernel, 11 launches a step; loss
     finite, step time printed;
  4e. the other five Table-1 models (MLP-(500, 500), LeNet-300-100,
     LeNet5, AlexNet-CIFAR, ResNet18) at full width, batch 128, 5 steps,
     variant=kernel, each through ``train_classifier``: loss finite, no
     fallback, the launches per step (NSD / int8 product: MLP and
     LeNet-300-100 3 / 5, LeNet5 5 / 9, AlexNet 8 / 15, ResNet18 21 / 41;
     the first layer's dx is skipped; pack and the draw kernel 0), sparsity
     within 8 points of the same steps on the plain versions, step-1
     gradients against the plain versions (relative L2 <= 1e-5), and the
     share of live tiles that the masks skipped; ResNet18 again with
     ``memory="default=nsd"`` (NSD 42, compact 21, expand 21, int8 product
     41 a step; ``residual_compression`` equal to the plain versions' run),
     a torch.profiler breakdown of one fp32-residual ResNet18 step, and the
     peak device memory of one step with fp32 and with nsd residuals;
  4f. the int8 variant, 3 steps, on MLP (NSD 3, int8 product 5, draw 0 a
     step) and LeNet5 (NSD 3 and int8 product 6 for fc1-fc3, the draw
     kernel 2 for c1 and c2, which take the generic path); step 1's k and
     gradients against the plain versions';
  4g. Table 1 over the six models at the reference's recipe
     (``repro_torch.train.table1.run(quick=False)``: s = 2, batch 64, 50
     steps; plain, dithered and 8-bit + dithered); the three MNIST rows
     gated by ``repro_torch.bench.compare`` against the reference's
     ``benchmarks/baselines/BENCH_table1_sparsity.json`` (accuracy within
     10 points, sparsity 8, bits 1), ResNet18's dithered and int8
     accuracies within 10 points of the same run's baseline; AlexNet's and
     VGG11's, whose 50-step accuracy spreads over tens of points from seed
     to seed (in the reference too), as the mean over ``TABLE1_SEEDS``
     (this run's seed 0 and further trainings at seeds 1-23) at most 10
     points under the reference's mean over the same 24 seeds on the CPU
     (``src/repro_torch/bench/baselines/table1_cifar_reference.json``, made
     by ``tests/table1_cifar_rows.py``);
  4h. the classifier trainer repeats: AlexNet-CIFAR at seed 0, Table 1's
     recipe (50 steps, batch 64), paper and int8 variants, trained twice
     with cuDNN's deterministic algorithms (``train_classifier``'s default)
     and twice with the library's default ones, in turns: the first pair
     equal bit for bit (every parameter and the loss), each pair's ms a
     step printed;
  5. capture every kernel input of one step (for the NSD kernel its
     cotangent calls of the fp32 step and, apart, its calls in the nsd
     step's residual encode; for compact and expand the wire calls of the
     nsd step; for pack and unpack, which no path launches now, the fp32
     step's k and the bitmaps of the nsd step's decodes; for the draw
     kernel the fp32 step's cotangent shapes), hold each call against its
     plain version again (the
     dequant product and the wire kernels also against a second launch of
     themselves, the wire kernels also against a CUDA-graph replay, bit for
     bit), log each matmul call's split-K count, and time kernel, plain
     version and the library yardstick with CUDA events (every kernel also
     by CUDA-graph replay, but unpack; the chunk-local compact
     and expand on the same chunks on lines of their own), beside the
     least time the card could take (bytes over 3.35 TB/s, or operations
     over the peak rate of the units that do them); then break one step's
     device time (and the host's self CPU time by op) down with
     torch.profiler, for fp32 and for nsd residuals and for the
     f32-operand backward, and print one step's peak device memory for the
     first two;
  5a. (before the timing) the split-K edges of both matmuls, with A read
     transposed as dW reads it: c0's dW shape at batch 128 (128 x 131,072
     x 128, which must run split), a K-tile count the split count does not
     divide, a split whose K-tiles are all masked, only the last K-tile
     occupied, and an all-masked mask (zeros); the int8 product bit-exact,
     the dequant product within its band and equal over two launches;
  5d. time the fp32-residual and the nsd forward+backward step in turns
     (host clock around synchronised steps, median of 15 each) and print
     the nsd step's excess;
  6. data-parallel SSGD on simulated nodes with the compressed gradient
     wire (``repro_torch.distributed``, ``repro_torch.comm``):
     6a. fixed node gradients (nsd, int8, topk_ef and dense leaves, among
         them a 500-element bias, a 500 x 10 leaf and a 257-element leaf
         whose node slices are not 16-byte aligned) through ``ps`` at N = 4
         and the ring at N = 2, 3, 4, 8, kernel route against plain route:
         mean, every pack's levels, bitmap, deltas and nnz, wire_bytes,
         dense_bytes and error_bound bit for bit, and the launches the code
         implies (ps: N NSD per nsd and int8 leaf, N compact and expand per
         nsd leaf; ring: N^2 NSD, compact and expand per compressed leaf);
     6b. ``make_ssgd_step`` at full width, variant=kernel, 32 images a
         node: VGG11-CIFAR at N = 4 under ``ps`` and ``ring`` and
         MLP-(500, 500) at N = 1, 2, 4 under ``ps``, 3 steps each; every
         node's step-0 gradients against the plain versions' (relative L2
         <= 1e-5), the exact launches of every step (a node's backward as
         in phases 4 and 4e, plus the comm packs), and per step the host
         time, the grad / reduce / update spans (CUDA events around the
         step's ``record_function`` spans), the comm bytes and error bound
         and the peak device memory above what was held before the step;
     6c. ``python -m repro_torch.train.distributed_nodes --check
         benchmarks/baselines/BENCH_distributed_nodes.json`` through its
         ``main``: every row within the reference's gates, the overlap
         row's bucketed reduce bit for bit with the blocking one among
         them;
  7. gemma-2b at full width (2.51 B parameters, bf16, remat per block,
     AdamW; batch 8 x seq 128) through the LM launcher,
     ``repro_torch.launch.train.main``:
     7a. ``--preset full --steps 6`` with the program ``phase@0=off;
         phase@2=kernel;s=lin(2,6,4.0,2.0);rule lm_head:off``: every loss
         finite; steps 0-1 launch no kernel; each kernel step launches
         126 NSD (18 blocks x 7 dithered denses) and 252 int8 products and
         nothing else; no fallback; every int8 product's K <= 133,144 (its
         int32 sum exact); each step's host ms, the peak device memory and
         a torch.profiler breakdown of one kernel step;
     7b. the first kernel step's gradients (step 2) against the same step
         on the plain versions (relative L2 <= 1e-5 per parameter; 0
         expected) and its dither sparsity within 8 points; per-layer
         sparsity and bits;
     7c. the same launcher with ``memory: default=nsd``, ``phase@0=kernel``,
         3 steps: the launches per step (NSD 378: the cotangents and two
         encodes a dense, in the forward and in the block's rerun; wire
         compact 252, wire expand 126, int8 product 252), losses finite,
         peak memory, ``residual_compression`` of a step equal to the
         plain versions' (relative 1e-6);
     7d. the same launcher with ``--grad-accum 2``, ``phase@0=kernel``,
         2 steps: two micro-batches of 4 a step, their gradients summed in
         f32 and handed to AdamW's f32 masters; each step launches twice
         7a's kernel step; losses finite, peak memory;
  8. the ``quant:`` section of the launcher and the quant bench:
     8a. 7a's program with ``quant: mu=m8;nu=u8``, 6 steps: the launches of
         every step equal to 7a's, losses finite and printed beside 7a's
         (steps 0-1 equal: the first update uses the fresh f32 moments),
         the stored bytes of mu and nu read from the state's tensors and
         equal to ``stored_nbytes``, beside the f32 state's; the peak
         device memory and ms a step beside 7a's, and a torch.profiler
         breakdown of one kernel step; then one update of every
         parameter from the run's state and the next step's gradient with
         f32 moments and with m8 / u8: masters equal bit for bit, and each
         decoded moment within the codec's ``error_bound`` of the f32
         moment;
     8b. 7a's program with ``quant: grad=int4@g32``, 4 steps (2 kernel):
         no NSD and no int8 launch (the codec replaces the kernel route, as
         in the reference), no fallback; a kernel step's loss, sparsity and
         bits (4);
     8c. ``repro_torch.train.quant_bench.bench(quick=True)`` on the card,
         gated by ``repro_torch.bench.compare`` against the reference's
         ``benchmarks/baselines/BENCH_quant_bench.json``;
  9. observability and the closed-loop sparsity controller:
     9a. gemma-2b through the launcher with ``--run-dir RUN
         --escalate-monitors`` and the program ``phase@0=off;phase@2=kernel;
         rule lm_head:off;controller:target=0.9,gain=2.0``, 6 steps, then
         ``python -m repro_torch.obs.report RUN``: the run directory holds
         the manifest and the dither, memory, phase and train streams,
         ``read_run`` reads it and the report renders the per-layer table;
         spans ``data``, ``dispatch``, ``controller`` and ``monitor`` every
         step; no critical monitor event; launches a step equal to 7a's and
         no fallback; one log-scale per discovered layer name; the ``s``
         each NSD call received (captured at ``ops.quantize_and_mask``) is
         2 x exp(log-scale) of its projection at every kernel step, and
         every tick moves each log-scale toward (target - measured); ms a
         step beside 7a's, and one kernel step's forward and backward with
         the telemetry on and off, in turns;
     9b. ``repro_torch.train.layer_sparsity.bench(quick=True)`` gated
         against ``benchmarks/baselines/BENCH_layer_sparsity.json``; then
         LeNet-300-100 under ``phase@0=kernel;controller:target=0.93,
         gain=4.0``, 40 steps: final-window sparsity within 5 points of
         the target for every layer, NSD 3 and int8 product 5 launches a
         step, no fallback;
     9c. ``repro_torch.train.obs_bench.bench(quick=True)`` gated against
         ``benchmarks/baselines/BENCH_obs_bench.json``;
  10. serving (``repro_torch.serve``, ``repro_torch.launch.serve``):
     10a. ``repro_torch.train.serve_bench.bench(quick=True)`` on the card
         (gemma-2b's smoke model, the reference's 24-request trace, arms
         dense, fp32, int8, nsd and preempt), every gate of
         ``benchmarks/baselines/BENCH_serve_bench.json`` checked;
     10b. ``python -m repro_torch.launch.serve --preset full --serve
         "worker gemma-2b: batch=8;max_len=128;chunk=8;kv=nsd;page=16"
         --requests 16 --new-tokens 16 --run-dir RUN`` through its
         ``main``: every request served, the NSD, compact and expand
         launches equal to what the run's micro-steps and sealed pages
         imply (two paged expands a layer a micro-step; two NSD and two
         compact launches a layer a sealed page; one of each a layer for
         the pools' zero page), no fallback, no ``serve_stall`` event, the
         run directory's serve rows; tokens a second, median and p99 tick
         ms and peak device memory; one paged-expand call of the run held
         bit for bit against its plain version and timed;
     10c. the same requests under ``kv=fp32;page=16`` and with dense
         buffers: their tokens equal; the nsd run's disagreement with
         them printed;
  11. checkpoints, resume and fault tolerance
     (``repro_torch.train.{checkpoint,fault_tolerance}``,
     ``repro_torch.data.ShardedLoader``) and the two-level reduces:
     11a. phase 6a's node gradients through ``hier`` (N = 8 in 2 pods, N =
         6 in 3) and ``butterfly`` (N = 8 in 4 pods, N = 6 in 3: the
         ragged pre- and post-fold), kernel route against plain route: the
         mean, every pack, the wire, dense, ICI and DCN bytes,
         ``peak_dcn_bytes`` and the bound bit for bit, no host sync, the
         launches the code implies; overlap bucketing at 262,144 B over
         VGG11's leaves (N = 4, hier in 2 pods) equal to the blocking
         reduce (the means bit for bit) and bit-exact across routes;
     11b. ``ElasticSSGD`` on VGG11-CIFAR at full width, variant=kernel, 32
         images a node, ``hier`` in 2 pods: 2 steps at N = 8, ``resize(6)``
         (pods stay 2) and ``resize(3)`` (pods become 1), a step after
         each, parameters, moments and ``ctrl`` equal to the saved ones bit
         for bit; then a ``butterfly`` driver (N = 8, 4 pods) resumed from
         that checkpoint for one step; then ``topk_ef`` under ``ps``
         resized 4 -> 2 -> 6 with its EF residuals bit for bit; the exact
         launches of every step, each save's blocking time (gather plus
         drain) and its writer's time;
     11c. gemma-2b's smoke preset through the launcher with ``--ckpt-dir``
         and ``--ckpt-every 2`` on phase 7a's program for 4 steps; a
         ``Trainer`` resumed from its step-2 checkpoint on a
         ``ShardedLoader(start_step=2)`` (pinned batches, side-stream
         copies) ends with parameters and moments equal to the straight
         run's bit for bit; a preemption notice while batch 3 is fetched
         puts the checkpoint at step 4;
  12. the rest of the LM zoo's dense and MoE families, batch 8 x seq 128
     zipf tokens, bf16, remat, AdamW, the program ``phase@0=off;
     phase@1=kernel;rule lm_head:off`` (an untied head of vocab > 133,144
     or gemma3's tied 262,144 would overflow the int8 product's int32 sum):
     12a. gemma3-4b at full width and depth through the launcher
         (``--preset full``, 4 steps; 34 blocks, 29 of them local with
         window 1024): finite losses, per kernel step 238 NSD and 476 int8
         launches, every int8 product's K <= 133,144, no fallback; host ms
         a step, peak device memory, a profile of one kernel step;
     12b. its first kernel step's gradients against the plain versions
         (relative L2 <= 1e-5 per parameter; 0 expected) and its dither
         sparsity within 8 points;
     12c. moonshot-v1-16b-a3b at full width, depth cut 48 -> 4, 3 steps
         through ``repro_torch.train.Trainer``: a kernel step launches per
         block 11 NSD (attention 4, router 1, shared experts 3, the three
         expert einsums one each), 192 packs (one per expert slice of each
         expert einsum) and 400 int8 products; a captured slice's pack of
         each shape (128 x 1,408 and 128 x 2,048) bit for bit against its
         plain version and timed; the 128 x 128 tiles the expert slices
         skip, counted; a profile of one kernel step; 12b's gradient check
         on the first kernel step;
     12d. qwen2.5-32b and minitron-8b at full width cut to 2 blocks, 2
         steps each; dbrx-132b at full width cut to 1 block (4.5 B
         parameters) under ``quant: mu=m8;nu=u8`` (its f32 moments, ~72 GB
         of state, do not fit), 2 steps: per kernel step 8 NSD, 48 packs
         and 106 int8 products (C = 320 padded to 384 rows, K up to
         10,752), a captured slice's pack of each shape (384 x 10,752 and
         384 x 6,144) bit for bit and timed, 12b's gradient check; and
         dbrx-132b's smoke preset through the launcher: finite losses, the
         launches the blocks imply, no fallback;
     12e. serving: gemma3-4b at full width through the serve launcher on
         dense buffers (8 requests of 4 + 16 tokens, tokens a second and
         the median tick); gemma3's smoke model in the engine with prompts
         past its window of 8 (the ring wraps), its tokens equal to
         ``greedy_generate``'s; moonshot's smoke model in the engine at
         batch 1, chunk 1, its tokens equal to a token-by-token decode
         from an empty cache; the five archs' smoke presets through the
         serve launcher;
  13. the VLM, SSM and hybrid families at full width and depth, batch 8 x
     seq 128 zipf tokens, bf16, AdamW, each config's own remat, the
     program of phase 12, each through the launcher (``--preset full``, 4
     steps): finite losses and gradient norms, the launches a kernel step
     that the blocks imply, every int8 product's K <= 133,144, no
     fallback; host ms a step, peak device memory, a device-only profile
     of one kernel step with the int8 products' device time beside their
     bound (operations on the live 128 x 128 tiles at 1,979 TOP/s), 12b's
     gradient check on the first kernel step (every gradient finite):
     13a. mamba2-370m (48 blocks, no remat): 96 NSD and 192 int8 a kernel
         step; the chunked SSD scan's device time a step and its share;
     13b. hymba-1.5b (32 blocks, 128 meta tokens, 29 local layers): 288 and
         576 (attention 4, the mixer 2, the MLP 3 a block); the SSD scan;
     13c. internvl2-2b (24 blocks and the projector, 256 patch embeddings
         ahead of the 128 text positions): 170 and 339 (``vit_proj1``'s dx
         skipped);
     13d. serving: each arch at full width through the serve launcher (8
         requests of 4 + 16 tokens: tokens a second, the median tick, the
         hybrid's meta bootstrap), internvl2-2b on dense buffers and on nsd
         pages of 16 (the launches that its 24 layers' pages imply); each
         smoke model and a 4-layer hybrid whose prompts run past its
         window of 8 in the engine, its tokens equal to
         ``greedy_generate``'s; the three smoke presets through the serve
         launcher;
  14. the audio family: whisper-small (12 encoder and 12 decoder blocks,
     d 768, vocab 51,865, tied; 238.45 M parameters) at full width and
     depth, bf16, remat, AdamW, batch 8 x 448 zipf tokens (the decoder's
     whole context) over 1,500 frames a sequence (8 x 1,500 = 12,000
     encoder rows, 12,000 mod 128 = 96), the program ``phase@0=off;
     phase@1=kernel``: lm_head on the kernel (K = 51,865, inside the int8
     product's exact range);
     14a. through the launcher (``--preset full``, 4 steps): finite losses
         and gradient norms, per kernel step 193 NSD (12 x 6 encoder and 12
         x 10 decoder denses and lm_head) and 386 int8 launches, every int8
         product's K <= 133,144, no fallback; host ms a step, peak device
         memory, a device-only profile of one kernel step with the int8
         products' device time beside their bound; the NSD kernel at the
         ragged cotangents (12,000 rows; lm_head's 3,584 x 51,865) and the
         int8 product at the ragged contractions (12,032 and 51,968 once
         padded) captured from a kernel step and held bit for bit against
         their plain versions; 12b's gradient check on the first kernel
         step (every gradient finite);
     14b. 2 kernel steps of the same model under ``memory: default=nsd``:
         the launches (NSD 578: the cotangents and two encodes a block's
         dense, one for lm_head's; compact 385, expand 193, int8 386),
         finite losses, ``residual_compression`` and the gradients of a
         step against the plain versions;
     14c. serving at full width: ``greedy_generate(model, net, prompt, 32,
         frames=...)`` with one request's 1,500 frames and a 4-token
         prompt (tokens a second); its prefill and decode logits against
         the teacher-forced ``forward`` logits over the same 35 tokens
         (relative L2 <= 5e-2 in bf16, <= 1e-4 for an f32 copy), the
         decode's argmax equal to the greedy tokens; ``Engine`` and
         ``python -m repro_torch.launch.serve --arch whisper-small`` each
         raise the reference's ``ValueError``;
  15. data-parallel over processes (``repro_torch.launch.mesh``,
     ``repro_torch.comm`` with a mesh): one node a process, 8 ranks
     spawned on the one card over gloo (NCCL refuses two ranks on one
     device), every message staged through pinned host memory:
     15a. phase 6a's leaves through the process reduces, ring N = 4, hier
         N = 8 in 2 pods, butterfly N = 8 in 4 pods and N = 6 in 3: every
         rank's means and its wire, dense, ICI, DCN and peak-DCN bytes,
         bound, hops and packs_per_segment equal the one-process
         simulation's bit for bit; the packs the ranks received sum to the
         telemetry's wire bytes less the dense leaves'; each rank's
         launches are what its share implies (``mesh_rank_launches``: NSD
         and compact a pack, expand an unpack); each rank's reduce time;
     15b. ``make_ssgd_step(mesh=)`` on VGG11-CIFAR at full width,
         variant=kernel, 32 images a node from ``ShardedLoader(mesh=)``,
         N = 4, ``ring``, 3 steps: every rank's parameters and momenta
         equal 6b's simulated step's bit for bit after each step; per rank
         the launches (a node's backward, NSD 11 and int8 21, plus its
         packs), host ms, the grad / reduce / update spans and the bytes
         that crossed;
     15c. ``repro_torch.launch.train --distributed`` at world size 1 on
         NCCL (gemma-2b's smoke preset, 2 steps, batch 4 x 64): its losses
         equal the run without the flag's bit for bit; then, in the same
         process, a ``NodeMesh`` on NCCL at world size 1 (its barrier) and
         15a's leaves reduced over it under ``ps`` and ``ring``, equal to
         the one-process reduce of the one node bit for bit;
     a rank's failure fails the phase;
  16. the trainer's gradient wire on gemma-2b (``comm:`` and ``quant:
     wire=``), the reference's leaves (the 18 blocks stacked, 11 leaves)
     through the flat reducer each step:
     16a. 7a's run with ``comm: default=nsd;s=2.0;stats=1`` through the
         launcher: each step's launches (7a's plus one NSD, one wire
         compact and one wire expand a leaf), host ms and its split into
         the backward, the wire (``step/comm``) and the update, the loss beside 7a's (step 0's equal), wire and
         dense bytes and their ratio, the comm telemetry's rows against
         the history's ``comm_wire_mb``, the peak device memory; then step
         2's gradients reduced on the kernel and the plain versions'
         routes, every pack's levels, bitmap, deltas and nnz and the
         reduced gradients bit for bit;
     16b. the same model, built once, 2 steps under ``quant:
         wire=int4@g32``: no launch, the wire bytes the codec's measured
         bytes;
     16c. ``comm: default=topk_ef;topk_frac=0.01`` at the smoke preset
         with ``--ckpt-dir``: a trainer resumed from step 2 ends with the
         straight run's parameters, moments and error-feedback residuals
         bit for bit;
  17. print one JSON line naming the seven kernels (the NSD row carries its
     residual-encode figures under ``nsd_residual_encode``, the draw-only
     kernel of its source under ``philox_uniform``, the expand row the
     paged expand of phase 10b under ``serve_pages``, the pack row its
     times at the expert-slice shapes of phases 12c and 12d under
     ``moe_expert_slice``, by arch;
     phase 5's log gives the NSD row's bound by the padded definition too,
     9 bytes a padded element; every row's ``launches_by_path`` gives its
     launches in the runs of phases 4e, 4f, 6b, 6c, 7, 8, 9, 10, 11, 12,
     13, 14, 15 and 16, phase 15's summed over the ranks);
  18. print the JSON result line last.

It imports nothing of JAX or of the reference package, and needs the
checkout's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12  # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # dense TF32 tensor-core peak
BATCH, STEPS, SEED = 128, 5, 0
STEP_PAIRS = 15  # phase 5d: fp32 and nsd steps, taken in turns
# the kernel variant: one NSD launch a layer (the dither drawn inside, the
# bitmap and tile mask written with k), two products but for c0's dx
PER_STEP = {"nsd_quant": 11, "bitmap_pack": 0, "bsp_matmul_int8": 21,
            "philox_uniform": 0}
# memory="default=nsd": each of the 11 layers encodes its input (NSD, wire
# compact) in the forward and decodes it (wire expand) in the backward
NSD_PER_STEP = {"nsd_quant": 22, "bitmap_pack": 0, "bsp_matmul_int8": 21,
                "levels_compact": 11, "bitmap_unpack": 0, "levels_expand": 11,
                "bsp_matmul_dequant": 0, "philox_uniform": 0}
# the f32-operand backward of the 11 layers: one NSD each, both products on
# the dequant kernel
F32_OPERAND_LAUNCHES = {"nsd_quant": 11, "bsp_matmul_dequant": 22}
# the paper variant: the unit draw of each layer, nothing else
PAPER_PER_STEP = {"philox_uniform": 11}
# the unpadded cotangents (T, N) of the fp32 step at batch 128, held on
# both NSD routes in phase 3
COTANGENTS = {"c0": (131072, 64), "c1": (32768, 128), "c5": (2048, 512),
              "fc2": (128, 10)}
# phase 4e, variant=kernel: one NSD a layer, two products but for the first
# layer's dx; pack and the draw kernel 0
NEW_MODELS = {
    "mlp-mnist": {"nsd_quant": 3, "bsp_matmul_int8": 5},
    "lenet300100": {"nsd_quant": 3, "bsp_matmul_int8": 5},
    "lenet5": {"nsd_quant": 5, "bsp_matmul_int8": 9},
    "alexnet-cifar": {"nsd_quant": 8, "bsp_matmul_int8": 15},
    "resnet18-cifar": {"nsd_quant": 21, "bsp_matmul_int8": 41},
}
# ResNet18 with memory="default=nsd": each of the 21 layers encodes its input
RESNET_NSD_PER_STEP = {"nsd_quant": 42, "bsp_matmul_int8": 41,
                       "levels_compact": 21, "levels_expand": 21}
# phase 4f, variant=int8: dense layers on the NSD and int8 kernels, the
# convolutions' unit draws on the draw kernel
INT8_STEPS = 3
INT8_MODELS = {
    "mlp-mnist": {"nsd_quant": 3, "bsp_matmul_int8": 5},
    "lenet5": {"nsd_quant": 3, "bsp_matmul_int8": 6, "philox_uniform": 2},
}
TABLE1_ACC_BAND = 10.0  # points; Table 1's accuracy gate
# AlexNet's and VGG11's Table-1 accuracies are held as the card's means over
# these seeds against the reference's means over its rows (24 seeds a model).
# One 50-step row of either is mostly seed noise: the reference's own AlexNet
# on the CPU has a dithered or int8 accuracy more than 10 points under its
# plain run at 10 of its 24 seeds. A seed's accuracy in one package says
# nothing of the other's at that seed (correlation ~0). The card's rows
# repeat run to run (deterministic cuDNN, phase 4h), so it takes the
# reference's own seeds 0-23
TABLE1_SEEDS = tuple(range(24))
REPEAT_STEPS = 50  # phase 4h: two trainings a setting, Table 1's recipe
TABLE1_REFERENCE_SEEDS = 24
TABLE1_MEAN_MODELS = ("alexnet-c10", "vgg11-c10")
TABLE1_REFERENCE = "src/repro_torch/bench/baselines/table1_cifar_reference.json"
MEMORY = "default=nsd"
# phase 6: node gradients (random, fixed by the seed) through the reduce on
# both routes: nsd, int8, topk_ef and dense leaves, a 257-element leaf whose
# node slices are not 16-byte aligned, a 500-element bias and a 500 x 10 leaf
REDUCE_LEAVES = {"c3_w": (256, 128, 3, 3), "fc0_w": (512, 512), "fc0_b": (512,),
                 "fc1_w": (512, 512), "fc2_w": (500, 10), "b500": (500,),
                 "b257": (257,), "c0_b": (64,)}
REDUCE_OVERRIDES = (("fc1", "int8"), ("fc0_b", "topk_ef"))
PS_NODES, RING_NODES = 4, (2, 3, 4, 8)
# the SSGD runs of 6b: (model, nodes, topology, steps), 32 images a node
SSGD_NODE_BATCH = 32
SSGD_RUNS = (("vgg11-cifar", 4, "ps", 3), ("vgg11-cifar", 4, "ring", 3),
             ("mlp-mnist", 1, "ps", 3), ("mlp-mnist", 2, "ps", 3),
             ("mlp-mnist", 4, "ps", 3))
# a node's backward, variant=kernel (phases 4 and 4e)
SSGD_PER_NODE = {"vgg11-cifar": PER_STEP, "mlp-mnist": NEW_MODELS["mlp-mnist"]}
DIST_BASELINE = "benchmarks/baselines/BENCH_distributed_nodes.json"
# phase 11a: (topology, nodes, pods) on phase 6a's leaves: 4 and 2 nodes a
# pod, 2 pods of 3 (hier), a power-of-two and a ragged pod count (butterfly)
TWO_LEVEL_REDUCES = (("hier", 8, 2), ("hier", 6, 3), ("butterfly", 8, 4),
                     ("butterfly", 6, 3))
OVERLAP_BUCKET_BYTES = 262144  # the reference's overlap row
# phase 11c: gemma-2b's smoke preset through the launcher, checkpointed
LM_RESUME_BATCH, LM_RESUME_SEQ = 4, 64

# phase 15: data-parallel over processes, one node a process, the ranks on
# cuda:0 over gloo (NCCL refuses two ranks on one card). 15a: phase 6a's
# leaves through the process reduces, (topology, nodes, pods); 15b: 6b's
# VGG11 ring run, one node a rank; 15c: the launcher's --distributed on NCCL
MESH_WORLD = 8
MESH_REDUCES = (("ring", 4, 1), ("hier", 8, 2), ("butterfly", 8, 4),
                ("butterfly", 6, 3))
MESH_SSGD = ("vgg11-cifar", 4, "ring", 3)
MESH_LM_ARGS = ["--arch", "gemma-2b", "--preset", "smoke", "--steps", "2",
                "--batch", "4", "--seq", "64"]
# 6b's simulated VGG11 ring steps (parameters and optimizer state after
# each, on the host), the reference of 15b
SIM_SSGD_STEPS = []
# 7a's steps (step, host ms, loss, launches), beside which phase 16a prints
LM_7A_STEPS = []

# phase 16: the trainer's gradient wire. 16a: 7a's run with every gradient
# leaf of >= 256 elements (the reference's leaves, the blocks stacked: 11
# of gemma-2b's) through the NSD wire each step, one NSD, one wire compact
# and one wire expand a leaf; 16b: int4 on the wire (a codec spec, its
# measured bytes); 16c: topk_ef at the smoke preset, a 2 + 2 resume
LM_COMM = "comm: default=nsd;s=2.0;stats=1"
LM_WIRE_LEAVES = 11
LM_WIRE_CODEC = "int4@g32"
LM_WIRE_STEPS = 2
LM_TOPK_COMM = "comm: default=topk_ef;topk_frac=0.01"

# phase 7: gemma-2b at full width through the LM launcher (bf16, remat per
# block, AdamW), 8 sequences of 128 tokens a step
LM_ARGS = ["--arch", "gemma-2b", "--preset", "full", "--batch", "8",
           "--seq", "128"]
LM_STEPS, LM_NSD_STEPS, LM_ACCUM_STEPS, LM_ACCUM = 6, 3, 2, 2
LM_PROGRAM = "dither: phase@0=off;phase@2=kernel;s=lin(2,6,4.0,2.0);rule lm_head:off"
LM_NSD_PROGRAM = "dither: phase@0=kernel;rule lm_head:off memory: default=nsd"
LM_ACCUM_PROGRAM = "dither: phase@0=kernel;rule lm_head:off"
LM_PARAMS = 2_506_172_416
LM_BLOCKS = 18  # gemma-2b's blocks, all under the one scan tag "L"
LM_FIRST_KERNEL_STEP = 2
# a kernel step: 18 blocks x 7 dithered denses (q, k, v, o, gate, up, down;
# lm_head off), one NSD and two int8 products each (every input needs dx)
LM_KERNEL_STEP = {"nsd_quant": 126, "bsp_matmul_int8": 252}
# memory: default=nsd under remat: each dense encodes its input (NSD, wire
# compact) in the forward and again when the backward reruns the block, and
# decodes it (wire expand) once
LM_NSD_STEP = {"nsd_quant": 126 + 2 * 126, "bsp_matmul_int8": 252,
               "levels_compact": 2 * 126, "levels_expand": 126}
# phase 8: the quant: section on 7a's program
LM_QUANT_MOMENTS = "quant: mu=m8;nu=u8"
LM_QUANT_GRAD = "quant: grad=int4@g32"
# |decoded - f32| / error_bound: 1 up to f32 rounding (the quant bench's band)
QUANT_BOUND_SLACK = 1.05
QUANT_BASELINE = "benchmarks/baselines/BENCH_quant_bench.json"
INT32_EXACT_K = 133_144  # the int8 products' int32 sum is exact while K 127^2 < 2^31
# phase 9: 7a's launcher run under the sparsity controller, with a run
# directory; the classifier's kernel path under the controller; the benches
CTRL_TARGET = 0.9
LM_CTRL_PROGRAM = (f"dither: phase@0=off;phase@2=kernel;rule lm_head:off;"
                   f"controller:target={CTRL_TARGET},gain=2.0")
LM_PROJECTIONS = tuple(f"L.{n}" for n in ("attn.k", "attn.o", "attn.q",
                                          "attn.v", "mlp.down", "mlp.gate",
                                          "mlp.up"))
PHASE_SPANS = ("controller", "data", "dispatch", "monitor")
LENET_CTRL_PROGRAM = "phase@0=kernel;controller:target=0.93,gain=4.0"
LENET_CTRL_STEPS, CTRL_GAP = 40, 5.0  # the reference's gate, in points
STATS_PAIRS = 5  # 9a: a kernel step's gradients with stats on and off
LAYER_SPARSITY_BASELINE = "benchmarks/baselines/BENCH_layer_sparsity.json"
OBS_BASELINE = "benchmarks/baselines/BENCH_obs_bench.json"

SPARSITY_BAND = 8.0  # percentage points (Table 1's own band)
GRAD_BAND = 1e-5  # relative L2, kernels vs plain versions
COMPRESSION_BAND = 1e-6  # relative, kernels vs plain versions

# phase 10: serving. The reference's serve bench (five arms) and its
# committed results; gemma-2b at full width through the serve launcher
SERVE_BASELINE = "benchmarks/baselines/BENCH_serve_bench.json"
SERVE_ARGS = ["--preset", "full", "--requests", "16", "--new-tokens", "16"]
SERVE_SPEC = "worker gemma-2b: batch=8;max_len=128;chunk=8;{}"
SERVE_REQUESTS, SERVE_NEW = 16, 16
# every micro-step decodes each layer's K and V pages with one paged-expand
# launch each; every page that seals encodes K and V (an NSD and a compact
# launch each), and each layer's pool starts as one encoded zero page
SERVE_EXPAND_PER_STEP = 2 * LM_BLOCKS
SERVE_ENCODES_PER_SEAL = 2 * LM_BLOCKS

# phase 12: the rest of the LM zoo at batch 8 x seq 128, the kernel program
# from step 1 (lm_head off: its K would overflow the int32 sum)
ZOO_PROGRAM = "dither: phase@0=off;phase@1=kernel;rule lm_head:off"
ZOO_FIRST_KERNEL_STEP = 1
ZOO_BATCH, ZOO_SEQ = 8, 128
GEMMA3_ARGS = ["--arch", "gemma3-4b", "--preset", "full", "--batch", "8",
               "--seq", "128"]
GEMMA3_STEPS = 4
GEMMA3_PARAMS = 3_879_907_840
# (arch, blocks kept of the full depth, steps, the program's quant:
# section): AdamW's state of the full depth exceeds the card's 80 GB.
# dbrx's one block holds 4.5 B parameters: its f32 moments (~72 GB of state)
# do not fit, its 8-bit ones (~45 GB) do
ZOO_CUTS = (("moonshot-v1-16b-a3b", 4, 3, ""), ("qwen2.5-32b", 2, 2, ""),
            ("minitron-8b", 2, 2, ""),
            ("dbrx-132b", 1, 2, "quant: mu=m8;nu=u8"))
ZOO_SMOKE_TRAIN = "dbrx-132b"  # its smoke preset through the launcher too
ZOO_SERVE_SPEC = "worker gemma3-4b: batch=8;max_len=128;chunk=8"
ZOO_SERVE_REQUESTS, ZOO_SERVE_NEW = 8, 16
ZOO_ARCHS = ("gemma3-4b", "qwen2.5-32b", "minitron-8b", "moonshot-v1-16b-a3b",
             "dbrx-132b")

# phase 13: the VLM, SSM and hybrid families at full width and depth, batch
# 8 x seq 128 (internvl2-2b's 256 patch embeddings come on top), the kernel
# program from step 1, each config's own remat; (label, arch, blocks)
FAMILY_RUNS = (("13a", "mamba2-370m", 48), ("13b", "hymba-1.5b", 32),
               ("13c", "internvl2-2b", 24))
FAMILY_STEPS = 4
FAMILY_SERVE_SPEC = "worker {}: batch=8;max_len=128;chunk=8{}"
FAMILY_SERVE_REQUESTS, FAMILY_SERVE_NEW = 8, 16

# phase 14: whisper-small at full width and depth, batch 8 x 448 decoder
# tokens (its whole context) over 1,500 frames, the kernel program from step
# 1 with lm_head on the kernel (K = 51,865 < INT32_EXACT_K)
AUDIO_ARCH = "whisper-small"
AUDIO_SEQ = 448
AUDIO_PROGRAM = "dither: phase@0=off;phase@1=kernel"
AUDIO_NSD_PROGRAM = "dither: phase@0=kernel memory: default=nsd"
AUDIO_STEPS, AUDIO_NSD_STEPS = 4, 2
AUDIO_PARAMS = 238_452_480  # the tree; the reference's count is 238,450,944
AUDIO_PROMPT, AUDIO_NEW = 4, 32
# prefill + decode against the teacher-forced forward, relative L2 of the
# logits: bf16 rounds each token's path at other places (2^-9 relative a
# rounding, compounded over 24 blocks); f32 differs in summation order only
AUDIO_LOGIT_BAND = {"bf16": 5e-2, "f32": 1e-4}


def zoo_kernel_step(cfg) -> dict:
    """The launches of one kernel step (lm_head off) of an LM config: per
    block one NSD per dithered dense (attention 4; an MLP's 3 gated or 2;
    an MoE block's router and shared experts; a Mamba-2 mixer's in and out
    projections, 2) and per expert einsum (3), one pack per expert slice
    of each expert einsum, and two int8 products per dense and per expert
    slice (every input needs dx); the VLM's projector adds two NSD and
    three int8 products (``vit_proj1``'s dx is skipped: the patch
    embeddings need no gradient). The encoder-decoder (whisper's program
    keeps lm_head on the kernel): 6 denses an encoder block, 10 a decoder
    block (self and cross attention, the MLP) and lm_head."""
    if hasattr(cfg, "n_frames"):  # the encoder-decoder, lm_head on the kernel
        dense = cfg.n_layers * (6 + 10) + 1
        return {"nsd_quant": dense, "bsp_matmul_int8": 2 * dense}
    mlp = 3 if getattr(cfg, "act", None) in ("swiglu", "geglu") else 2
    einsums = slices = extra_nsd = extra_int8 = 0
    if not hasattr(cfg, "n_heads"):  # the SSM LM: the mixer alone
        dense = 2
    elif hasattr(cfg, "n_meta_tokens"):  # the hybrid: attention, mixer, MLP
        dense = 4 + 2 + mlp
    elif cfg.moe is None:
        dense = 4 + mlp
        if cfg.vlm_patches:
            extra_nsd, extra_int8 = 2, 3
    else:
        dense = 4 + 1 + (3 if cfg.moe.n_shared else 0)
        einsums, slices = 3, 3 * cfg.moe.n_experts
    n = cfg.n_layers
    out = {"nsd_quant": n * (dense + einsums) + extra_nsd,
           "bsp_matmul_int8": 2 * n * (dense + slices) + extra_int8}
    if slices:
        out["bitmap_pack"] = n * slices
    return out


KERNELS = {
    "nsd_quant": ("src/repro_torch/kernels/csrc/nsd_quant.cu",
                  "src/repro/kernels/nsd_quant/nsd_quant.py:27"),
    "bitmap_pack": ("src/repro_torch/kernels/csrc/pack.cu",
                    "src/repro/kernels/pack/pack.py:52"),
    "bsp_matmul_int8": ("src/repro_torch/kernels/csrc/bsp_matmul_int8.cu",
                        "src/repro/kernels/bsp_matmul/bsp_matmul.py:63"),
    "bitmap_unpack": ("src/repro_torch/kernels/csrc/pack.cu",
                      "src/repro/kernels/pack/pack.py:67"),
    "levels_compact": ("src/repro_torch/kernels/csrc/levels.cu",
                       "src/repro/kernels/levels/levels.py:112"),
    "levels_expand": ("src/repro_torch/kernels/csrc/levels.cu",
                      "src/repro/kernels/levels/levels.py:123"),
    "bsp_matmul_dequant": ("src/repro_torch/kernels/csrc/bsp_matmul_dequant.cu",
                           "src/repro/kernels/bsp_matmul/bsp_matmul.py:44"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def f32_band(K: int) -> float:
    """Relative L2 band of two f32 evaluations of a K-long contraction in
    different orders: the rounding of a sum of K random-sign terms grows as
    sqrt(K) u relative to the result (u = 2^-24); 8x that."""
    return 8 * math.sqrt(K) * 2.0 ** -24


def profile_step(torch, step_fn, card, label, steps=3, phase="5b",
                 what=f"forward+backward of one batch-{BATCH} step", host=True):
    """Print the device time per step of the top kernels, of the port's
    kernels, and the device's busy share of the wall time, from
    torch.profiler over ``steps`` forward+backward passes. Informational:
    where the profiler records no device time it says so and returns None;
    else it returns the device rows (ms a step, launches a step, kernel
    name) and the wall ms a step. ``host=False`` traces the device alone
    (no host rows: the trace of a step of tens of thousands of launches
    is read several times faster)."""
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host else []
    with profile(activities=acts + [ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op also reports, as its own device
        # time, the kernels it launched, and would be counted twice
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if e.key.startswith(("ssgd/", "step/")):  # a record_function span's range
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    if not rows:
        log(f"phase {phase} ({label}): torch.profiler recorded no device time: "
            f"not measured")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"phase {phase} ({label}): {what}: wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{sum(r[1] for r in rows)} device kernels launched ({card})")
    # a matmul's name also matches its split-K reduce kernel, listed after it;
    # "Memset" counts the wire kernels' workspace clears among others
    for name in ("nsd_quant_kernel", "philox_uniform_kernel", "bitmap_pack_kernel",
                 "bsp_int8_kernel",
                 "bsp_int8_kernel_reduce", "levels_compact_kernel",
                 "levels_compact_wire_kernel", "bitmap_unpack_kernel",
                 "levels_expand_kernel", "levels_expand_wire_kernel",
                 "bsp_dequant_kernel", "bsp_dequant_kernel_reduce", "Memset"):
        ms = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        log(f"  port kernel {name}: {ms:.4f} ms device time per step over {n} launches")
    for ms, n, key in rows[:15]:
        log(f"  {ms:9.4f} ms  x{n:<4d} {key[:100]}")
    if not host:
        return rows, wall_ms
    # the host side: self CPU time of the recorded (aten) ops; the rest of
    # the wall is Python, ctypes launches and the profiler's own cost
    host = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count // steps, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU
                   and e.self_cpu_time_total > 0), reverse=True)
    log(f"  host: {sum(h[0] for h in host):.3f} ms per step of self CPU time in "
        f"{sum(h[1] for h in host)} recorded ops, under the profiler")
    for ms, n, key in host[:8]:
        log(f"  host {ms:9.4f} ms  x{n:<4d} {key[:80]}")
    return rows, wall_ms


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


@contextlib.contextmanager
def no_host_sync(torch):
    """Raise on any operation that synchronises the host with the device
    (torch's sync debug mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


# every telemetry field that phases 6a and 11a hold bit for bit between the
# kernel and plain routes of a reduce
REDUCE_TELEMETRY = ("wire_bytes", "dense_bytes", "error_bound", "wire_ici_bytes",
                    "wire_dcn_bytes", "peak_dcn_bytes")


def reduce_both_routes(torch, plain_kernels, red, g, label, key=SEED, step=1):
    """``red.reduce(g, key, step)`` on the kernel route (no host sync
    allowed) and on the plain route: the mean, every pack's levels, bitmap, deltas and nnz,
    and the telemetry (``REDUCE_TELEMETRY``) bit for bit. Returns the kernel
    route's telemetry, packs and launches."""
    from repro_torch.kernels import build
    from repro_torch.quant import wire

    runs = []
    for route in ("kernel", "plain"):
        packs = []
        real_pack = wire.pack_nsd

        def recording_pack(*a, **kw):
            packs.append(real_pack(*a, **kw))
            return packs[-1]

        ctx = plain_kernels() if route == "plain" else no_host_sync(torch)
        torch.cuda.synchronize()
        build.reset_launches()
        wire.pack_nsd = recording_pack
        try:
            with ctx:
                out, tele, _ = red.reduce(g, key, step)
        finally:
            wire.pack_nsd = real_pack
        torch.cuda.synchronize()
        runs.append((out, tele, packs, dict(build.LAUNCHES)))
    (out_k, tele_k, packs_k, launches), (out_p, tele_p, packs_p, lp) = runs
    check(not any(lp.values()), f"{label}: plain route launched {lp}")
    for name in g:
        check(torch.equal(out_k[name], out_p[name]),
              f"{label}: mean of {name} differs between routes")
    check(len(packs_k) == len(packs_p), f"{label}: pack counts differ")
    for pk, pp in zip(packs_k, packs_p):
        for f in ("levels", "bitmap", "deltas", "nnz"):
            check(torch.equal(getattr(pk, f), getattr(pp, f)),
                  f"{label}: pack {f} differs between routes")
    for f in REDUCE_TELEMETRY:
        check(float(getattr(tele_k, f)) == float(getattr(tele_p, f)),
              f"{label}: {f} {float(getattr(tele_k, f))} vs "
              f"{float(getattr(tele_p, f))}")
    return tele_k, packs_k, launches


def phase6(torch, card, dev, plain_kernels, worst_rel):
    """Phase 6: the compressed reduce on both routes (6a), the SSGD step at
    full width on variant=kernel (6b) and the figs. 5/6 rows (6c). Returns
    the launches of each SSGD path by kernel, for the kernels line."""
    from repro_torch import comm
    from repro_torch.configs import paper_models
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.data.synthetic import ClassifConfig, classification_batch
    from repro_torch.distributed import SSGDConfig, make_ssgd_step, shard_batch
    from repro_torch.distributed import ssgd as ssgd_mod
    from repro_torch.kernels import build
    from repro_torch.models.cnn import CNN
    from repro_torch.optim.optimizers import OptConfig, init_opt_state
    from repro_torch.train import distributed_nodes

    # -- 6a: fixed node gradients through ps and the ring, kernel route
    # against the plain route: bit for bit, with the launches the code implies
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n_max = max(max(RING_NODES), PS_NODES)
    grads = {name: torch.randn((n_max,) + shape, device=dev, generator=gen) * 1e-2
             for name, shape in REDUCE_LEAVES.items()}
    for topology, n in [("ps", PS_NODES)] + [("ring", n) for n in RING_NODES]:
        pol = comm.CommPolicy(s=2.0, topology=topology, overrides=REDUCE_OVERRIDES)
        g = {k: v[:n].contiguous() for k, v in grads.items()}
        tele_k, packs_k, launches = reduce_both_routes(
            torch, plain_kernels, comm.reducer(pol, n_nodes=n), g,
            f"6a {topology} N={n}")
        modes = [pol.mode_for(k, v[0].numel()) for k, v in g.items()]
        if topology == "ps":
            packed = n * modes.count("nsd")
            want = {"nsd_quant": packed + n * modes.count("int8"),
                    "levels_compact": packed, "levels_expand": packed}
        else:  # int8 and topk_ef leaves travel as nsd on the ring
            packed = n * n * sum(m != "dense" for m in modes)
            want = {"nsd_quant": packed, "levels_compact": packed,
                    "levels_expand": packed}
        check(nonzero(launches) == want,
              f"6a {topology} N={n}: launches {nonzero(launches)}, want {want}")
        log(f"phase 6a: {topology} N={n}: mean, levels, bitmap, deltas, nnz, "
            f"wire_bytes {float(tele_k.wire_bytes)}, dense_bytes "
            f"{float(tele_k.dense_bytes)}, error_bound {float(tele_k.error_bound)} "
            f"bit-exact between the kernel and plain routes over {len(packs_k)} "
            f"packs, the kernel route without a host sync; launches "
            f"{nonzero(launches)}")

    # -- 6b: the SSGD step at full width, variant=kernel, timed by span
    spans = []
    real_span = ssgd_mod.annotate

    @contextlib.contextmanager
    def timed_span(name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with real_span(name):
            a.record()
            yield
            b.record()
        spans.append((name.split("/")[-1], a, b))

    path_launches = {}
    for mname, n, topology, steps in SSGD_RUNS:
        mcfg = paper_models.MODELS[mname]()
        net = CNN(mcfg, seed=SEED)
        dcfg = SSGDConfig(n_nodes=n, s_schedule="sqrt", s_base=2.0)
        cpol = comm.CommPolicy(default="nsd", s=dcfg.s_for_n(), topology=topology)
        opt_cfg = OptConfig(name="sgd", lr=0.05, momentum=0.9,
                            weight_decay=5e-4, grad_clip=None)
        step, _ = make_ssgd_step(net, opt_cfg, dcfg,
                                 DitherPolicy(variant="kernel"), cpol)
        data = ClassifConfig(n_classes=mcfg.n_classes, img_size=mcfg.img_size,
                             channels=mcfg.in_channels, noise=0.5, seed=SEED)
        label = f"ssgd {mname} {topology} N={n} kernel"
        b0 = shard_batch(classification_batch(data, 0, SSGD_NODE_BATCH * n), n)
        _, gk = step.node_grads(b0, SEED, 0)
        with plain_kernels():
            build.reset_launches()
            _, gp = step.node_grads(b0, SEED, 0)
            check(not any(build.LAUNCHES.values()), "plain run launched a kernel")
        worst = worst_rel({f"{k}[{w}]": v[w] for k, v in gk.items() for w in range(n)},
                          {f"{k}[{w}]": v[w] for k, v in gp.items() for w in range(n)},
                          label)
        del gp
        n_comp = sum(cpol.mode_for(k, p.numel()) != "dense"
                     for k, p in net.named_parameters())
        packs = n * n_comp if topology == "ps" else n * n * n_comp
        if mname == "vgg11-cifar":
            # the reduce of this run's own node gradients (whole VGG11
            # leaves under ps, ~590k-element segments on the ring) on both
            # routes
            tele_k, packs_k, got = reduce_both_routes(torch, plain_kernels, step.reducer, gk,
                                                    label)
            want = {"nsd_quant": packs, "levels_compact": packs,
                    "levels_expand": packs}
            check(nonzero(got) == want,
                  f"{label}: reduce launches {nonzero(got)}, want {want}")
            log(f"phase 6b: {label}: the reduce of the step-0 node gradients "
                f"bit-exact between the kernel and plain routes over "
                f"{len(packs_k)} packs (largest {max(math.prod(p.shape) for p in packs_k)} "
                f"elements): mean, levels, bitmap, deltas, nnz, wire_bytes "
                f"{float(tele_k.wire_bytes)}, error_bound "
                f"{float(tele_k.error_bound)}")
        del gk
        per_node = SSGD_PER_NODE[mname]
        want = {"nsd_quant": n * per_node["nsd_quant"] + packs,
                "bsp_matmul_int8": n * per_node["bsp_matmul_int8"],
                "levels_compact": packs, "levels_expand": packs}
        state = init_opt_state(dict(net.named_parameters()), opt_cfg)
        total = {k: 0 for k in build.LAUNCHES}
        ssgd_mod.annotate = timed_span
        try:
            for i in range(steps):
                b = shard_batch(classification_batch(data, i, SSGD_NODE_BATCH * n), n)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                spans.clear()
                build.reset_launches()
                t0 = time.perf_counter()
                m, _ = step(state, b, SEED)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                got = dict(build.LAUNCHES)
                for k, v in got.items():
                    total[k] += v
                check(math.isfinite(float(m["loss"])), f"{label}: loss {m['loss']}")
                check(nonzero(got) == want,
                      f"{label} step {i}: launches {nonzero(got)}, want {want}")
                split = {name: round(a.elapsed_time(b_), 3) for name, a, b_ in spans}
                log(f"phase 6b: {label} step {i}: {wall:.3f} ms on the host clock, "
                    f"spans (CUDA events) {split}; loss {float(m['loss']):.5f}; "
                    f"launches {nonzero(got)}; comm_wire_bytes "
                    f"{float(m['comm_wire_bytes'])}, comm_dense_bytes "
                    f"{float(m['comm_dense_bytes'])}, comm_error_bound "
                    f"{float(m.get('comm_error_bound', 0.0))}; peak device memory "
                    f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} MiB "
                    f"above the {held / 2**20:.1f} MiB held before the step ({card})")
                if (mname, n, topology, steps) == MESH_SSGD:
                    SIM_SSGD_STEPS.append(host_state(torch, net, state))
        finally:
            ssgd_mod.annotate = real_span
        path_launches[label] = total
        log(f"phase 6b: {label}: node gradients at batch {SSGD_NODE_BATCH} a node "
            f"against the plain versions: worst relative L2 {worst}")
        if mname == "vgg11-cifar":
            b = shard_batch(classification_batch(data, 0, SSGD_NODE_BATCH * n), n)
            profile_step(torch, lambda: step(state, b, SEED), card, label,
                         steps=2, phase="6b", what=f"one SSGD step of {n} nodes")
        del step, net, state

    # -- 6c: the figs. 5/6 rows through the CLI, gated against the
    # reference's committed baseline
    build.reset_launches()
    rc = distributed_nodes.main(["--check", str(Path(__file__).resolve().parent
                                                / DIST_BASELINE)])
    got = dict(build.LAUNCHES)
    check(rc == 0, "distributed_nodes --check: the figs. 5/6 rows miss the "
                   "reference's gates")
    check(got["nsd_quant"] > 0 and got["levels_compact"] == got["nsd_quant"]
          and got["levels_expand"] == got["nsd_quant"]
          and got["philox_uniform"] > 0 and got["bsp_matmul_int8"] == 0,
          f"distributed_nodes launches {nonzero(got)}")
    path_launches["figs5-6 paper ps N=1,2,4 + ring N=8"] = got
    log(f"phase 6c: distributed_nodes --check {DIST_BASELINE}: launches "
        f"{nonzero(got)} ({card})")
    return path_launches


def phase7(torch, card, dev, plain_kernels, swapped, kernel, worst_rel):
    """Phases 7 and 8: gemma-2b at full width through the LM launcher
    (``repro_torch.launch.train.main``): the kernel program (7a), the first
    kernel step's gradients against the plain versions' (7b), the nsd
    residual store (7c), gradient accumulation (7d); the ``quant:`` section
    with m8 / u8 moments (8a) and int4 on the cotangent (8b), and the quant
    bench (8c). Returns the launches of each run by kernel, for the
    kernels line."""
    import dataclasses
    import gc

    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as lm_train
    from repro_torch.obs import metrics
    from repro_torch.train import trainer as trainer_mod

    steps_seen = []
    ks = []
    real_step = trainer_mod.Trainer.train_step

    def timed_step(self, batch, step):
        """One launcher step on the host clock, with its launches."""
        torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        out = real_step(self, batch, step)
        torch.cuda.synchronize()
        steps_seen.append((step, (time.perf_counter() - t0) * 1e3,
                           float(out["loss"]),
                           {k: v - before[k] for k, v in build.LAUNCHES.items()
                            if v != before[k]}))
        return out

    def recording_int8(a, b, scale, mask, *, trans_a=False, trans_b=False):
        ks.append(a.shape[0] if trans_a else a.shape[1])
        return kernel["bsp_matmul_int8"](a, b, scale, mask, trans_a=trans_a,
                                         trans_b=trans_b)

    def run(argv, label):
        """The launcher on ``argv``: per-step host ms, loss and launches,
        the total launches and the peak device memory of the run."""
        steps_seen.clear()
        ks.clear()
        ops.KERNEL_FALLBACKS.clear()
        build.reset_launches()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer_mod.Trainer.train_step = timed_step
        try:
            with swapped({"bsp_matmul_int8": recording_int8}):
                trainer = lm_train.main(argv)
        finally:
            trainer_mod.Trainer.train_step = real_step
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        total = dict(build.LAUNCHES)
        check(not ops.KERNEL_FALLBACKS, f"{label}: fallbacks {ops.KERNEL_FALLBACKS}")
        n_params = sum(p.numel() for p in trainer.net.parameters())
        check(n_params == LM_PARAMS, f"{label}: {n_params} parameters")
        check(all(p.dtype == torch.bfloat16 for p in trainer.net.parameters())
              and trainer.model.cfg.remat, f"{label}: not bf16 with remat")
        for step, ms, loss, launched in steps_seen:
            check(math.isfinite(loss), f"{label} step {step}: loss {loss}")
            log(f"phase {label[0]} {label} step {step}: {ms:.3f} ms on the host clock, "
                f"loss {loss:.4f}, launches {launched}")
        check(max(ks, default=0) <= INT32_EXACT_K,
              f"{label}: an int8 product of K {max(ks, default=0)} > "
              f"{INT32_EXACT_K}")
        log(f"phase {label[0]} {label}: {n_params} parameters (bf16, remat), "
            f"{seconds:.1f} s for {len(steps_seen)} steps with the model's "
            f"build; int8 products' K {sorted(set(ks))} (exact up to "
            f"{INT32_EXACT_K}); peak device memory {peak / 2**30:.2f} GiB above "
            f"the {held / 2**30:.2f} GiB held before ({card})")
        return trainer, total, peak

    def step_grads(trainer, batch, step):
        """Step ``step``'s loss, gradients and dither and memory telemetry,
        the program's base with stats on."""
        metrics.reset()
        for p in trainer.net.parameters():
            p.grad = None
        loss, grads = trainer.grads(batch, step)
        loss = float(loss)
        if grads is None:  # one micro-batch: they are in .grad
            grads = {n: p.grad for n, p in trainer.net.named_parameters()}
        for p in trainer.net.parameters():
            p.grad = None
        rows = {t: metrics.rows(t) for t in metrics.tags()}
        sp = metrics.overall_sparsity() * 100
        comp = (metrics.overall_residual_compression() if metrics.memory_tags()
                else None)
        return loss, grads, rows, sp, comp

    def with_stats(trainer):
        prog = trainer.program
        trainer.program = prog.replace(base=prog.base.replace(collect_stats=True))

    t_phase = time.perf_counter()
    # -- 7a: the kernel program through the launcher ----------------------
    argv = LM_ARGS + ["--steps", str(LM_STEPS), "--program", LM_PROGRAM]
    log(f"phase 7a: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, kernel_total, peak_7a = run(argv, "7a")
    check(len(steps_seen) == LM_STEPS, f"7a: {len(steps_seen)} steps")
    seen_7a = list(steps_seen)
    LM_7A_STEPS[:] = seen_7a
    for step, _, _, launched in steps_seen:
        want = LM_KERNEL_STEP if step >= LM_FIRST_KERNEL_STEP else {}
        check(launched == want, f"7a step {step}: launches {launched}, want {want}")
    ms = [m for s, m, _, _ in steps_seen]
    log(f"phase 7a: off steps {ms[1]:.3f} ms (step 0 {ms[0]:.3f} ms with the "
        f"first-use costs), kernel steps {min(ms[3:]):.3f}-{max(ms[3:]):.3f} ms "
        f"(step 2 {ms[2]:.3f} ms); launches over the run {kernel_total}")
    tcfg = TokenStreamConfig(vocab=trainer.model.cfg.vocab, seq_len=128, batch=8)
    batch = token_batch(tcfg, LM_FIRST_KERNEL_STEP, device=dev)
    profile_step(torch, lambda: trainer.train_step(batch, LM_FIRST_KERNEL_STEP),
                 card, "gemma-2b kernel step", steps=1, phase="7a",
                 what="one gemma-2b training step, variant=kernel (batch 8 x "
                      "seq 128, bf16, remat, AdamW)")

    # -- 7b: the first kernel step's gradients against the plain versions --
    with_stats(trainer)
    build.reset_launches()
    loss_k, grads_k, rows_k, sp_k, _ = step_grads(trainer, batch,
                                                  LM_FIRST_KERNEL_STEP)
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    check(launched == LM_KERNEL_STEP, f"7b: launches {launched}")
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    t0 = time.perf_counter()
    with plain_kernels():
        build.reset_launches()
        loss_p, grads_p, rows_p, sp_p, _ = step_grads(trainer, batch,
                                                      LM_FIRST_KERNEL_STEP)
        check(not any(build.LAUNCHES.values()), "7b: the plain run launched a kernel")
    plain_s = time.perf_counter() - t0
    worst = worst_rel(grads_k, grads_p, "7b gemma-2b step 2")
    check(abs(sp_k - sp_p) <= SPARSITY_BAND, f"7b: sparsity {sp_k} vs plain {sp_p}")
    log(f"phase 7b: step {LM_FIRST_KERNEL_STEP} (s = 4.0) loss {loss_k:.6f} (plain "
        f"{loss_p:.6f}); worst relative L2 gradient difference kernel vs plain "
        f"{worst} over {len(grads_k)} parameters; sparsity {sp_k:.3f}% (plain "
        f"{sp_p:.3f}%); the plain step {plain_s:.1f} s")
    for tag in sorted(rows_k):
        r = rows_k[tag]
        check(len(r) == 18, f"7b: {tag}: {len(r)} rows")
        # the backward visits the blocks last to first
        log(f"phase 7b: {tag} sparsity % by block 0-17 "
            + " ".join(f"{100 * v:.1f}" for v in r[::-1, 0])
            + f"; bits {int(r[:, 1].min())}-{int(r[:, 1].max())}")
    del grads_k, grads_p, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7c: the nsd residual store through the launcher ------------------
    argv = LM_ARGS + ["--steps", str(LM_NSD_STEPS), "--program",
                      LM_NSD_PROGRAM]
    log(f"phase 7c: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, nsd_total, _ = run(argv, "7c")
    for step, _, _, launched in steps_seen:
        check(launched == LM_NSD_STEP,
              f"7c step {step}: launches {launched}, want {LM_NSD_STEP}")
    with_stats(trainer)
    batch = token_batch(tcfg, LM_NSD_STEPS, device=dev)
    _, _, _, sp_k, comp_k = step_grads(trainer, batch, LM_NSD_STEPS)
    with plain_kernels():
        _, _, _, sp_p, comp_p = step_grads(trainer, batch, LM_NSD_STEPS)
    check(abs(comp_k - comp_p) <= COMPRESSION_BAND * comp_p,
          f"7c: residual_compression {comp_k} vs plain {comp_p}")
    check(abs(sp_k - sp_p) <= SPARSITY_BAND, f"7c: sparsity {sp_k} vs plain {sp_p}")
    log(f"phase 7c: residual_compression {comp_k} (plain versions {comp_p}), "
        f"sparsity {sp_k:.3f}% (plain {sp_p:.3f}%); launches over the run "
        f"{nsd_total}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7d: two micro-batches a step, summed in f32 ----------------------
    argv = LM_ARGS + ["--steps", str(LM_ACCUM_STEPS), "--grad-accum",
                      str(LM_ACCUM), "--program", LM_ACCUM_PROGRAM]
    log(f"phase 7d: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, accum_total, _ = run(argv, "7d")
    check(len(steps_seen) == LM_ACCUM_STEPS, f"7d: {len(steps_seen)} steps")
    want = {k: LM_ACCUM * v for k, v in LM_KERNEL_STEP.items()}
    for step, _, _, launched in steps_seen:
        check(launched == want, f"7d step {step}: launches {launched}, want {want}")
    log(f"phase 7d: launches over the run {accum_total}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s ({card})")
    ms_7a = [m for _, m, _, _ in seen_7a]
    paths = {f"gemma-2b kernel {LM_STEPS} steps ({LM_FIRST_KERNEL_STEP} off)": kernel_total,
             f"gemma-2b nsd {LM_NSD_STEPS} steps": nsd_total,
             f"gemma-2b kernel {LM_ACCUM_STEPS} steps, grad-accum {LM_ACCUM}":
                 accum_total}

    # -- phase 8: the quant: section (8-bit moments, a cotangent codec) ---
    t_phase = time.perf_counter()
    from repro_torch import quant
    from repro_torch.optim import optimizers as opt

    # 8a: the 7a program with m8 / u8 moments
    argv = LM_ARGS + ["--steps", str(LM_STEPS), "--program",
                      f"{LM_PROGRAM} {LM_QUANT_MOMENTS}"]
    log(f"phase 8a: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, quant_total, peak_8a = run(argv, "8a")
    check(len(steps_seen) == LM_STEPS, f"8a: {len(steps_seen)} steps")
    check((trainer.opt_cfg.mu_codec, trainer.opt_cfg.nu_codec) == ("m8", "u8"),
          f"8a: OptConfig {trainer.opt_cfg}")
    for (step, ms, loss, launched), (_, ms7, loss7, launched7) in zip(
            steps_seen, seen_7a):
        check(launched == launched7,
              f"8a step {step}: launches {launched}, 7a's {launched7}")
        log(f"phase 8a step {step}: loss {loss!r} (7a {loss7!r}), {ms:.3f} ms "
            f"on the host clock (7a {ms7:.3f} ms)")
    # the first update uses the fresh f32 moments: steps 0 and 1 are 7a's
    check([x[2] for x in steps_seen[:2]] == [x[2] for x in seen_7a[:2]],
          "8a: the losses of steps 0-1 differ from 7a's")
    params = dict(trainer.net.named_parameters())
    stored, want = {}, {}
    for k, mode in (("mu", "m8"), ("nu", "u8")):
        stored[k] = sum(getattr(e, f).numel() * getattr(e, f).element_size()
                        for e in trainer.opt_state[k].values()
                        for f in ("q", "scale"))
        want[k] = sum(quant.stored_nbytes(mode, p.shape, torch.float32)
                      for p in params.values())
        check(stored[k] == want[k], f"8a: {k} stores {stored[k]} B, "
              f"stored_nbytes {want[k]}")
    f32_state = 2 * 4 * LM_PARAMS
    ms8 = [m for _, m, _, _ in steps_seen]
    ms7 = [m for _, m, _, _ in seen_7a]
    log(f"phase 8a: mu {stored['mu']} B + nu {stored['nu']} B stored "
        f"({(stored['mu'] + stored['nu']) / f32_state:.4f} of the f32 state's "
        f"{f32_state} B); peak device memory {peak_8a / 2**30:.2f} GiB (7a "
        f"{peak_7a / 2**30:.2f} GiB); kernel steps "
        f"{min(ms8[3:]):.3f}-{max(ms8[3:]):.3f} ms (7a "
        f"{min(ms7[3:]):.3f}-{max(ms7[3:]):.3f} ms), off step 1 {ms8[1]:.3f} ms "
        f"(7a {ms7[1]:.3f} ms); launches over the run {quant_total} ({card})")

    # one update from the run's state and the next step's gradient, with f32
    # moments (the decoded state) and with m8 / u8: equal masters, and each
    # decoded moment within the codec's bound of the f32 moment
    batch = token_batch(tcfg, LM_STEPS, device=dev)
    for p in params.values():
        p.grad = None
    trainer.grads(batch, LM_STEPS)
    st = trainer.opt_state
    cfg8 = dataclasses.replace(trainer.opt_cfg, grad_clip=None)
    cfg32 = dataclasses.replace(cfg8, mu_codec=None, nu_codec=None)
    worst = {"mu": 0.0, "nu": 0.0}
    masters_equal = True
    for name, p in params.items():
        one = {}
        for cfg in (cfg32, cfg8):
            dec = cfg.mu_codec is None
            w = st["master"][name].clone()
            sub = {"step": st["step"], "master": {name: w},
                   "mu": {name: quant.decode("m8", st["mu"][name]) if dec
                          else dataclasses.replace(st["mu"][name])},
                   "nu": {name: quant.decode("u8", st["nu"][name]) if dec
                          else dataclasses.replace(st["nu"][name])}}
            if not dec:  # the row slices write into the container's tensors
                for k in ("mu", "nu"):
                    e = sub[k][name]
                    sub[k][name] = dataclasses.replace(e, q=e.q.clone(),
                                                       scale=e.scale.clone())
            opt.apply_updates({name: p.detach().clone()}, sub, cfg,
                              grads={name: p.grad})
            one[dec] = sub
        masters_equal &= torch.equal(one[True]["master"][name],
                                     one[False]["master"][name])
        for k, mode in (("mu", "m8"), ("nu", "u8")):
            enc = one[False][k][name]
            err = (quant.decode(mode, enc) - one[True][k][name]).abs()
            bound = quant.error_bound(mode, enc)
            worst[k] = max(worst[k], float((err / (bound + 1e-30)).max()))
        del one
    for p in params.values():
        p.grad = None
    check(masters_equal, "8a: the f32 masters of the two updates differ")
    batch = token_batch(tcfg, LM_FIRST_KERNEL_STEP, device=dev)
    profile_step(torch, lambda: trainer.train_step(batch, LM_FIRST_KERNEL_STEP),
                 card, "gemma-2b kernel step, m8 / u8 moments", steps=1,
                 phase="8a", what="one gemma-2b training step, variant=kernel, "
                 "AdamW with m8 / u8 moments (batch 8 x seq 128, bf16, remat)")
    check(max(worst.values()) <= QUANT_BOUND_SLACK,
          f"8a: a decoded moment outside its bound: {worst}")
    log(f"phase 8a: one update of all {len(params)} parameters from the run's "
        f"state and step {LM_STEPS}'s gradient, f32 moments vs m8 / u8: masters "
        f"equal bit for bit; worst |decoded - f32| / error_bound mu "
        f"{worst['mu']!r}, nu {worst['nu']!r}")
    del trainer, params, st
    gc.collect()
    torch.cuda.empty_cache()

    # 8b: int4 on the cotangent in place of the NSD kernel route
    argv = LM_ARGS + ["--steps", str(LM_FIRST_KERNEL_STEP + 2), "--program",
                      f"{LM_PROGRAM} {LM_QUANT_GRAD}"]
    log(f"phase 8b: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, grad_total, _ = run(argv, "8b")
    for step, _, _, launched in steps_seen:
        check(not launched, f"8b step {step}: launches {launched}")
    with_stats(trainer)
    batch = token_batch(tcfg, LM_FIRST_KERNEL_STEP + 2, device=dev)
    loss_b, _, rows_b, sp_b, _ = step_grads(trainer, batch,
                                            LM_FIRST_KERNEL_STEP + 2)
    check(not ops.KERNEL_FALLBACKS, f"8b: fallbacks {ops.KERNEL_FALLBACKS}")
    bits = sorted({int(b) for r in rows_b.values() for b in r[:, 1]})
    check(bits == [4], f"8b: telemetry bits {bits}")
    log(f"phase 8b: step {LM_FIRST_KERNEL_STEP + 2} loss {loss_b!r}, sparsity "
        f"{sp_b:.3f}% over {len(rows_b)} layers x 18 blocks, bits {bits}; no "
        f"NSD or int8 launch, no fallback ({card})")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 8c: the quant bench on the card against the reference's gates
    from repro_torch.bench import SuiteRun
    from repro_torch.train import quant_bench

    build.reset_launches()
    t0 = time.perf_counter()
    qb = quant_bench.bench(quick=True, device=dev)
    bench_total = dict(build.LAUNCHES)
    for r in qb:
        log(f"phase 8c: {r.name} {r.value!r} {r.unit} {json.dumps(r.derived)}")
    report = quant_bench.check(qb, SuiteRun.from_dict(json.loads(
        (Path(__file__).resolve().parent / QUANT_BASELINE).read_text())))
    log("phase 8c: " + report.render(verbose=True).replace("\n", "\nphase 8c: "))
    check(report.ok, "8c: the quant bench misses the reference's gates")
    log(f"phase 8c: quant_bench.bench(quick=True) {time.perf_counter() - t0:.1f} s; "
        f"launches {{{', '.join(f'{k!r}: {v}' for k, v in bench_total.items() if v)}}}")
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s ({card})")
    paths.update({
        f"gemma-2b kernel {LM_STEPS} steps, quant: mu=m8;nu=u8": quant_total,
        f"gemma-2b {LM_FIRST_KERNEL_STEP + 2} steps, quant: grad=int4@g32": grad_total,
        "quant_bench quick": bench_total})
    return paths, ms_7a


def phase9(torch, card, dev, ms_7a):
    """Phase 9: the run directory and the sparsity controller on gemma-2b
    (9a), the layer-sparsity bench and the classifier's kernel path under
    the controller (9b), the obs bench (9c). Returns the launches of each
    run by kernel, for the kernels line."""
    import gc
    import shutil
    import tempfile
    from collections import Counter

    import numpy as np

    from repro_torch.bench import SuiteRun
    from repro_torch.configs import paper_models
    from repro_torch.core import schedule as sched
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as lm_train
    from repro_torch.obs import metrics, report, runlog
    from repro_torch.train import classifier, layer_sparsity, obs_bench
    from repro_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent

    def baseline(path):
        return SuiteRun.from_dict(json.loads((root / path).read_text()))

    # -- 9a: gemma-2b under controller: with a run directory ---------------
    steps_seen, s_seen, ticks = [], [], []
    real_step = trainer_mod.Trainer.train_step
    real_qm = ops.quantize_and_mask
    real_update = sched.SparsityController.update

    def timed_step(self, batch, step):
        torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        s_seen.append([])
        t0 = time.perf_counter()
        out = real_step(self, batch, step)
        torch.cuda.synchronize()
        steps_seen.append((step, (time.perf_counter() - t0) * 1e3,
                           float(out["loss"]), dict(self._ctrl.state),
                           {k: v - before[k] for k, v in build.LAUNCHES.items()
                            if v != before[k]}))
        return out

    def recording_qm(g, noise, s):
        s_seen[-1].append(s)
        return real_qm(g, noise, s)

    def recording_update(self, state, measured):
        new = real_update(self, state, measured)
        ticks.append((dict(state), dict(measured), dict(new)))
        return new

    rd = tempfile.mkdtemp(prefix="chip_smoke_run")
    argv = LM_ARGS + ["--steps", str(LM_STEPS), "--run-dir", rd,
                      "--escalate-monitors", "--program", LM_CTRL_PROGRAM]
    log(f"phase 9a: python -m repro_torch.launch.train {' '.join(argv)}")
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    metrics.reset()
    trainer_mod.Trainer.train_step = timed_step
    ops.quantize_and_mask = recording_qm
    sched.SparsityController.update = recording_update
    t0 = time.perf_counter()
    try:
        trainer = lm_train.main(argv)
    finally:
        trainer_mod.Trainer.train_step = real_step
        ops.quantize_and_mask = real_qm
        sched.SparsityController.update = real_update
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctrl_total = dict(build.LAUNCHES)
    check(not ops.KERNEL_FALLBACKS, f"9a: fallbacks {ops.KERNEL_FALLBACKS}")
    check(len(steps_seen) == LM_STEPS, f"9a: {len(steps_seen)} steps")
    names = sorted(trainer._ctrl.state)
    check(names == sorted(LM_PROJECTIONS + ("lm_head",)),
          f"9a: controller names {names}")
    for (step, ms, loss, _, launched), ms7 in zip(steps_seen, ms_7a):
        want = LM_KERNEL_STEP if step >= LM_FIRST_KERNEL_STEP else {}
        check(math.isfinite(loss), f"9a step {step}: loss {loss}")
        check(launched == want, f"9a step {step}: launches {launched}, want {want}")
        log(f"phase 9a step {step}: {ms:.3f} ms on the host clock (7a "
            f"{ms7:.3f} ms), loss {loss:.4f}, launches {launched}")
    # the s of every NSD call: 2 x exp(log-scale) of its projection in f32,
    # under the state the step ran with (a step's tick runs after it)
    for (step, _, _, st, _), calls in zip(steps_seen, s_seen):
        want = Counter()
        if step >= LM_FIRST_KERNEL_STEP:
            for n in LM_PROJECTIONS:
                want[float(np.float32(2.0)
                           * np.float32(math.exp(float(st[n]))))] += LM_BLOCKS
        check(Counter(calls) == want,
              f"9a step {step}: NSD s {sorted(Counter(calls).items())}, want "
              f"{sorted(want.items())}")
    check(len(ticks) == LM_STEPS - LM_FIRST_KERNEL_STEP,
          f"9a: {len(ticks)} controller updates")
    lo, hi = (float(np.float32(math.log(b))) for b in (0.25, 4.0))
    for old, measured, new in ticks:
        check(sorted(measured) == sorted(LM_PROJECTIONS),
              f"9a: measured {sorted(measured)}")
        for n, sp in measured.items():
            moved = float(new[n]) - float(old[n])
            toward = (CTRL_TARGET - sp) * moved > 0 or (
                moved == 0 and (float(new[n]) in (lo, hi)
                                or abs(CTRL_TARGET - sp) < 1e-6))
            check(toward, f"9a: {n} log-scale {float(old[n])} -> "
                  f"{float(new[n])} at sparsity {sp}")
    log("phase 9a: log-scales after each tick: " + "; ".join(
        ", ".join(f"{n[2:]} {float(new[n]):+.4f} ({100 * m[n]:.2f}%)"
                  for n in LM_PROJECTIONS) for _, m, new in ticks))
    manifest, streams = runlog.read_run(rd)
    files = sorted(f for f in os.listdir(rd))
    for f in ("manifest.json", "dither.jsonl", "memory.jsonl", "phase.jsonl",
              "train.jsonl"):
        check(f in files, f"9a: {f} not in the run directory {files}")
    # remat reruns each block's forward in the backward; its memory rows
    # come from the first run only, one per dither row
    check(len(streams["memory"]) == len(streams["dither"]),
          f"9a: {len(streams['memory'])} memory rows, "
          f"{len(streams['dither'])} dither rows")
    spans = {}
    for r in streams["phase"]:
        spans.setdefault(r["tag"], []).append(int(r["step"]))
    check(sorted(spans) == list(PHASE_SPANS)
          and all(v == list(range(LM_STEPS)) for v in spans.values()),
          f"9a: phase rows {spans}")
    critical = [e for e in streams.get("monitor", [])
                if e["severity"] == "critical"]
    check(not critical and "fallback" not in streams,
          f"9a: critical events {critical}, streams {sorted(streams)}")
    text = report.render(rd)
    check("per-layer dither telemetry" in text
          and all(n in text for n in LM_PROJECTIONS), "9a: report table")
    cli = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", rd],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    check(cli.returncode == 0 and cli.stdout.strip() == text,
          f"9a: python -m repro_torch.obs.report: rc {cli.returncode} "
          f"{cli.stderr[-2000:]}")
    ms = [m for _, m, _, _, _ in steps_seen]
    log(f"phase 9a: {seconds:.1f} s for {LM_STEPS} steps with the model's build "
        f"and the layer-name discovery; kernel steps {min(ms[3:]):.3f}-"
        f"{max(ms[3:]):.3f} ms (7a {min(ms_7a[3:]):.3f}-{max(ms_7a[3:]):.3f} ms); "
        f"run directory {files}, {sum(len(v) for v in streams.values())} rows, "
        f"monitor events {Counter(e['kind'] for e in streams.get('monitor', []))}; "
        f"launches over the run {ctrl_total} ({card})")
    log("phase 9a: python -m repro_torch.obs.report RUN:\n" + text)
    shutil.rmtree(rd, ignore_errors=True)
    # what the telemetry costs a kernel step: its forward and backward with
    # the run's controller state, stats on (as run) and off, in turns
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch

    batch = token_batch(TokenStreamConfig(vocab=trainer.model.cfg.vocab,
                                          seq_len=128, batch=8),
                        LM_STEPS, device=dev)
    prog = trainer.program
    programs = {"stats on": prog, "stats off": prog.replace(
        base=prog.base.replace(collect_stats=False), controller=None)}
    wall = {k: [] for k in programs}
    for _ in range(STATS_PAIRS):
        for label, p in programs.items():
            trainer.program = p
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.grads(batch, LM_STEPS - 1)
            torch.cuda.synchronize()
            wall[label].append((time.perf_counter() - t0) * 1e3)
    trainer.program = prog
    metrics.reset()
    med = {k: statistics.median(v) for k, v in wall.items()}
    log(f"phase 9a: one kernel step's forward and backward (step "
        f"{LM_STEPS - 1}, the run's log-scales), median of {STATS_PAIRS} in "
        f"turns: stats on {med['stats on']:.3f} ms, off {med['stats off']:.3f} "
        f"ms ({med['stats on'] - med['stats off']:+.3f} ms); all "
        f"{ {k: [round(x, 3) for x in v] for k, v in wall.items()} } ({card})")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9b: the layer-sparsity bench; the kernel path under the controller
    t0 = time.perf_counter()
    build.reset_launches()
    ls = layer_sparsity.bench(quick=True, device=dev)
    ls_total = dict(build.LAUNCHES)
    for r in ls:
        log(f"phase 9b: {r.name} {r.value!r} {r.unit} {json.dumps(r.derived)}")
    rep = layer_sparsity.check(ls, baseline(LAYER_SPARSITY_BASELINE))
    log("phase 9b: " + rep.render(verbose=True).replace("\n", "\nphase 9b: "))
    check(rep.ok, "9b: the layer-sparsity bench misses the reference's gates")
    log(f"phase 9b: layer_sparsity.bench(quick=True) {time.perf_counter() - t0:.1f} s")
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    prog = sched.parse_program(LENET_CTRL_PROGRAM, DitherPolicy(s=2.0))
    res = classifier.train_classifier(paper_models.lenet300100(), prog,
                                      steps=LENET_CTRL_STEPS, device=dev)
    lenet_total = dict(build.LAUNCHES)
    launched = {k: v for k, v in lenet_total.items() if v}
    want = {k: LENET_CTRL_STEPS * v for k, v in NEW_MODELS["lenet300100"].items()}
    check(launched == want, f"9b: LeNet-300-100 launches {launched}, want {want}")
    check(not ops.KERNEL_FALLBACKS, f"9b: fallbacks {ops.KERNEL_FALLBACKS}")
    gaps = {t: abs(float(np.array_split(metrics.rows(t)[:, 0], 3)[-1].mean())
                   * 100 - 93.0) for t in metrics.tags()}
    check(sorted(gaps) == ["fc0", "fc1", "fc2"]
          and max(gaps.values()) <= CTRL_GAP, f"9b: final-window gaps {gaps}")
    log(f"phase 9b: LeNet-300-100 under {LENET_CTRL_PROGRAM!r}, "
        f"{LENET_CTRL_STEPS} steps: final-window |sparsity - 93%| "
        + ", ".join(f"{t} {g:.3f}" for t, g in sorted(gaps.items()))
        + f" points (gate {CTRL_GAP}); acc {res['acc']}, {res['ms_per_step']:.3f} "
        f"ms a step; launches {launched}, no fallback ({card})")

    # -- 9c: the obs bench -------------------------------------------------
    t0 = time.perf_counter()
    build.reset_launches()
    ob = obs_bench.bench(quick=True, device=dev)
    ob_total = dict(build.LAUNCHES)
    for r in ob:
        log(f"phase 9c: {r.name} {r.value!r} {r.unit} {json.dumps(r.derived)}")
    rep = obs_bench.check(ob, baseline(OBS_BASELINE))
    log("phase 9c: " + rep.render(verbose=True).replace("\n", "\nphase 9c: "))
    check(rep.ok, "9c: the obs bench misses the reference's gates")
    log(f"phase 9c: obs_bench.bench(quick=True) {time.perf_counter() - t0:.1f} s; "
        f"launches {{{', '.join(f'{k!r}: {v}' for k, v in ob_total.items() if v)}}}")
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {
        f"gemma-2b kernel {LM_STEPS} steps under controller: with --run-dir": ctrl_total,
        "layer_sparsity quick": ls_total,
        f"lenet300100 kernel {LENET_CTRL_STEPS} steps under controller:": lenet_total,
        "obs_bench quick": ob_total}


def phase10(torch, card, dev, same, time_ms, graph_ms):
    """Phase 10: serving. 10a the serve bench on the card against the
    reference's gates; 10b gemma-2b at full width with NSD pages through
    the serve launcher; 10c the same requests with fp32 pages and dense
    buffers. Returns the launches of each run by kernel, for the kernels
    line, and the paged expand's figures."""
    import shutil
    import tempfile

    from repro_torch.bench import SuiteRun
    from repro_torch.kernels import build, levels, ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs.bus import MetricsBus, set_bus
    from repro_torch.obs.runlog import read_run
    from repro_torch.quant import wire
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import kvcache
    from repro_torch.train import serve_bench

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent

    # -- 10a: the serve bench ----------------------------------------------
    build.reset_launches()
    res = serve_bench.bench(quick=True, device=dev)
    bench_total = dict(build.LAUNCHES)
    for r in res:
        log(f"phase 10a: {r.name} {r.value!r} {r.unit} {json.dumps(r.derived)}")
    rep = serve_bench.check(res, SuiteRun.from_dict(json.loads(
        (root / SERVE_BASELINE).read_text())))
    log("phase 10a: " + rep.render(verbose=True).replace("\n", "\nphase 10a: "))
    check(rep.ok, "10a: the serve bench misses the reference's gates")
    log(f"phase 10a: serve_bench.bench(quick=True) {time.perf_counter() - t_phase:.1f} s; "
        f"launches {{{', '.join(f'{k!r}: {v}' for k, v in bench_total.items() if v)}}} "
        f"({card})")

    # -- 10b and 10c: gemma-2b at full width through the launcher ----------
    real_step, real_seal = engine_mod.Engine.step, kvcache.PagedKV._seal
    real_run = engine_mod.Engine._run_chunk
    real_expand = levels.levels_expand_pages
    seen = {}

    def timed_step(self):
        t0 = time.perf_counter()
        real_step(self)
        seen["ticks"].append((time.perf_counter() - t0) * 1e3)

    def counted_run(self, tok_block, n_feed, pos0):
        seen["micro"] += tok_block.shape[1]
        return real_run(self, tok_block, n_feed, pos0)

    def counted_seal(self, rows):
        if self.key == kvcache.layer_key(0):
            seen["seals"] += len(rows)
        return real_seal(self, rows)

    def kept_expand(lv, bm, ids):
        seen["expand_call"] = (lv, bm, ids)  # the last: the most pages sealed
        return real_expand(lv, bm, ids)

    runs, totals = {}, {}
    for kv in ("kv=nsd;page=16", "kv=fp32;page=16", "page=0"):
        rd = tempfile.mkdtemp(prefix="chip_smoke_serve")
        argv = ["--serve", SERVE_SPEC.format(kv), *SERVE_ARGS, "--run-dir", rd]
        seen.update(ticks=[], micro=0, seals=0)
        ops.KERNEL_FALLBACKS.clear()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        engine_mod.Engine.step, engine_mod.Engine._run_chunk = timed_step, counted_run
        kvcache.PagedKV._seal, levels.levels_expand_pages = counted_seal, kept_expand
        set_bus(MetricsBus())  # the run directory gets this run's rows only
        t0 = time.perf_counter()
        try:
            sup = launch_serve.main(argv)
        finally:
            engine_mod.Engine.step, engine_mod.Engine._run_chunk = real_step, real_run
            kvcache.PagedKV._seal, levels.levels_expand_pages = real_seal, real_expand
            set_bus(None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        totals[kv] = launched = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        w = sup.workers["gemma-2b"]
        runs[kv] = w.results
        _, streams = read_run(rd)
        shutil.rmtree(rd, ignore_errors=True)
        check(sorted(w.results) == list(range(SERVE_REQUESTS))
              and all(len(v) == SERVE_NEW for v in w.results.values()),
              f"10b {kv}: served {sorted(w.results)}")
        check(not ops.KERNEL_FALLBACKS, f"10b {kv}: fallbacks {ops.KERNEL_FALLBACKS}")
        stalls = [e for e in streams.get("monitor", []) if e.get("kind") == "serve_stall"]
        check(not stalls, f"10b {kv}: {stalls}")
        rows = streams.get("serve", [])
        check(len(rows) == w.engine._tick
              and sum(r["gen_tokens"] for r in rows) == SERVE_REQUESTS * SERVE_NEW,
              f"10b {kv}: {len(rows)} serve rows for {w.engine._tick} ticks")
        want = {}
        if "nsd" in kv:
            enc = LM_BLOCKS + SERVE_ENCODES_PER_SEAL * seen["seals"]
            want = {"nsd_quant": enc, "levels_compact": enc,
                    "levels_expand": SERVE_EXPAND_PER_STEP * seen["micro"]}
        check({k: v for k, v in launched.items() if v} == want,
              f"10b {kv}: launches {launched}, want {want}")
        first, ticks = seen["ticks"][0], sorted(seen["ticks"][1:])
        log(f"phase 10b: python -m repro_torch.launch.serve {' '.join(argv)}: "
            f"{len(w.results)}/{SERVE_REQUESTS} requests, {w.engine._tick} ticks, "
            f"{seen['micro']} micro-steps, {seen['seals']} pages sealed a layer, "
            f"launches {{{', '.join(f'{k!r}: {v}' for k, v in launched.items() if v)}}} "
            f"(want {want}), no fallback, no serve_stall, {len(rows)} serve rows; "
            f"{SERVE_REQUESTS * SERVE_NEW / seconds:.2f} tokens/s over {seconds:.2f} s "
            f"(the model's build included); the first tick {first:.3f} ms, the "
            f"other {len(ticks)} median {statistics.median(ticks):.3f} ms, p99 "
            f"{ticks[min(len(ticks) - 1, int(0.99 * len(ticks)))]:.3f} ms; peak "
            f"device memory {(peak - held) / 2**30:.3f} GiB above the "
            f"{held / 2**30:.3f} GiB held before the run ({card})")
        del sup, w
        torch.cuda.empty_cache()
    check(runs["kv=fp32;page=16"] == runs["page=0"],
          "10c: fp32 pages and dense buffers disagree")
    dense = runs["page=0"]
    mism = sum(a != b for u in dense for a, b in zip(dense[u], runs["kv=nsd;page=16"][u]))
    log(f"phase 10c: fp32 pages and dense buffers give the same tokens for all "
        f"{SERVE_REQUESTS} requests; nsd pages disagree on {mism} of "
        f"{SERVE_REQUESTS * SERVE_NEW} tokens")

    # one paged expand of 10b at its shape: bit for bit, timed
    lv, bm, ids = seen["expand_call"]
    got = levels.levels_expand_pages(lv, bm, ids)
    same("levels_expand", (got,), (levels.levels_expand_pages_plain(lv, bm, ids),),
         "paged, phase 10b's call")
    M, C = ids.shape[0], bm.shape[1]
    live = int(wire.popcount_u8(bm[ids.long()]).sum())
    # read the ids, the bitmaps and the live levels of the M pages; write k
    nbytes = M * 4 + M * C * 32 + live + M * C * 256
    pages = {"launches": totals["kv=nsd;page=16"]["levels_expand"],
             "ms": time_ms(lambda: levels.levels_expand_pages(lv, bm, ids)),
             "graph_ms": graph_ms(lambda: levels.levels_expand_pages(lv, bm, ids)),
             "plain_ms": time_ms(lambda: levels.levels_expand_pages_plain(lv, bm, ids),
                                 launches=2, groups=3),
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": None}  # no one PyTorch call expands a stack
    log(f"phase 10b: the paged expand of one layer's view ({M} pages of {C} chunks, "
        f"{live} live levels): {pages['ms']:.4f} ms (device {pages['graph_ms']:.4f} ms "
        f"in graph replay), bound {pages['bound_ms']:.4f} ms (bytes), plain "
        f"{pages['plain_ms']:.4f} ms ({card})")
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"serve_bench quick": bench_total,
            **{f"gemma-2b serve {kv} 16 requests": n for kv, n in totals.items()}}, pages


def two_level_packs(topology: str, n: int, pods: int) -> int:
    """Packs (and as many unpacks) of one compressed leaf through the
    simulated hier or butterfly reduce of n nodes in ``pods`` pods: each
    pack one NSD and one wire compact launch, each unpack one wire expand."""
    G, P = pods, n // pods
    if topology == "hier":
        # G P (P-1) ring packs, P (G-1) tree packs, P final packs
        return n * P
    m = G.bit_length() - 1
    G2 = 1 << m
    # the ring's, the pre-fold's, the halving rounds' and the piece packs
    return G * P * (P - 1) + P * ((G - G2) + m * G2 + G2)


def phase11(torch, card, dev, plain_kernels):
    """Phase 11: the two-level reduces and overlap bucketing on both routes
    (11a), elastic SSGD on VGG11 at full width through resizes (11b), and
    gemma-2b's checkpointed launcher run resumed bit for bit (11c). Returns
    the launches of each path by kernel, for the kernels line."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import comm
    from repro_torch.configs import paper_models
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.data import ShardedLoader
    from repro_torch.data.synthetic import (ClassifConfig, TokenStreamConfig,
                                            classification_batch, token_batch)
    from repro_torch.kernels import build
    from repro_torch.launch import train as lm_train
    from repro_torch.models.cnn import CNN
    from repro_torch.obs.bus import get_bus
    from repro_torch.obs.streams import PHASE
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import ElasticSSGD, list_steps
    from repro_torch.utils.pytree import flatten_with_names

    path_launches = {}
    scratch = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t_phase = time.perf_counter()

    # -- 11a: phase 6a's node gradients through the hierarchy and the
    # butterfly, kernel route against plain route, bit for bit
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    grads = {name: torch.randn((8,) + shape, device=dev, generator=gen) * 1e-2
             for name, shape in REDUCE_LEAVES.items()}
    for topology, n, pods in TWO_LEVEL_REDUCES:
        pol = comm.CommPolicy(s=2.0, topology=topology, pods=pods,
                              overrides=REDUCE_OVERRIDES)
        g = {k: v[:n].contiguous() for k, v in grads.items()}
        label = f"11a {topology} N={n} pods={pods}"
        tele, packs, launches = reduce_both_routes(
            torch, plain_kernels, comm.reducer(pol, n_nodes=n), g, label)
        # int8 and topk_ef leaves travel as nsd on an all-reduce
        n_comp = sum(pol.mode_for(k, v[0].numel()) != "dense" for k, v in g.items())
        k = n_comp * two_level_packs(topology, n, pods)
        want = {"nsd_quant": k, "levels_compact": k, "levels_expand": k}
        check(nonzero(launches) == want,
              f"{label}: launches {nonzero(launches)}, want {want}")
        path_launches[f"reduce {topology} N={n} pods={pods}"] = launches
        log(f"phase 11a: {topology} N={n} pods={pods}: mean, levels, bitmap, deltas, "
            f"nnz and telemetry bit-exact between the kernel and plain routes over "
            f"{len(packs)} packs, the kernel route without a host sync: "
            + ", ".join(f"{f} {float(getattr(tele, f))}" for f in REDUCE_TELEMETRY)
            + f", packs_per_segment {tele.packs_per_segment}; launches "
            f"{nonzero(launches)}")
    # overlap: VGG11's gradient shapes at 4 nodes in 2 pods, bucketed at
    # OVERLAP_BUCKET_BYTES, against the blocking reduce (both on the kernel
    # route), then the bucketed reduce on both routes
    net = CNN(paper_models.MODELS["vgg11-cifar"](), seed=SEED, device=dev)
    g = {name: torch.randn((4,) + tuple(p.shape), device=dev, generator=gen) * 1e-2
         for name, p in net.named_parameters()}
    del net
    pol = comm.CommPolicy(s=2.0, topology="hier", pods=2)
    bucketed = comm.reducer(pol.replace(bucket_bytes=OVERLAP_BUCKET_BYTES), n_nodes=4)
    build.reset_launches()
    out_b, tele_b, _ = comm.reducer(pol, n_nodes=4).reduce(g, SEED, 1)
    blocking_launches = dict(build.LAUNCHES)
    tele_o, packs_o, launches = reduce_both_routes(
        torch, plain_kernels, bucketed, g, "11a overlap")
    out_o, _, _ = bucketed.reduce(g, SEED, 1)
    for name in g:
        check(torch.equal(out_o[name], out_b[name]),
              f"11a overlap: {name} differs from the blocking reduce")
    # the bucketed telemetry: the error bound is the max of the buckets', the
    # byte counts add up the same f32 terms bucket by bucket, which rounds
    # otherwise above 2^24 (VGG11's wire bytes at N=4 are ~3.1e7); the
    # buckets' peak_dcn_bytes is their max, the blocking reduce's the sum
    # over its leaves (the reference's accounting)
    check(float(tele_o.error_bound) == float(tele_b.error_bound),
          "11a overlap: error_bound differs from the blocking reduce's")
    for f in ("wire_bytes", "dense_bytes", "wire_ici_bytes", "wire_dcn_bytes"):
        o, b_ = float(getattr(tele_o, f)), float(getattr(tele_b, f))
        check(abs(o - b_) <= 1e-6 * b_,
              f"11a overlap: {f} {o} vs blocking {b_}")
    check(launches == blocking_launches,
          f"11a overlap: launches {nonzero(launches)}, blocking {nonzero(blocking_launches)}")
    plan = bucketed.plan_for(g)
    path_launches["reduce overlap hier N=4 pods=2 (VGG11 leaves)"] = launches
    log(f"phase 11a: overlap at bucket_bytes={OVERLAP_BUCKET_BYTES}: {plan.n_buckets} "
        f"buckets over VGG11's {len(g)} leaves at N=4 hier pods=2 (largest bucket "
        f"{max(plan.bucket_bytes)} B): every mean bit for bit and error_bound "
        f"{float(tele_o.error_bound)} equal to the blocking reduce's, wire_bytes "
        f"{float(tele_o.wire_bytes)} (blocking {float(tele_b.wire_bytes)}), and "
        f"bit-exact between the kernel and plain routes over {len(packs_o)} packs; "
        f"launches {nonzero(launches)}")
    del g, out_b, out_o

    # -- 11b: ElasticSSGD on VGG11 at full width, variant=kernel
    mcfg = paper_models.MODELS["vgg11-cifar"]()
    data = ClassifConfig(n_classes=mcfg.n_classes, img_size=mcfg.img_size,
                         channels=mcfg.in_channels, noise=0.5, seed=SEED)
    opt_cfg = OptConfig(name="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4,
                        grad_clip=None)
    bus = get_bus()

    def snapshot(el):
        return [(name, x.detach().clone() if isinstance(x, torch.Tensor) else x)
                for name, x in flatten_with_names(el._ckpt_tree())]

    def same_state(a, b, what):
        check([n for n, _ in a] == [n for n, _ in b], f"{what}: tree names differ")
        for (name, x), (_, y) in zip(a, b):
            ok = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            check(ok, f"{what}: {name} differs after the resize")

    def save_times():
        """The last save's blocking time (gather + drain) and its writer's
        time, ms, from the checkpoint's spans on the phase stream."""
        def last(tag):
            rows = bus.rows(PHASE.name, tag)
            return float(rows[-1, 1]) * 1e3 if len(rows) else 0.0
        return last("ckpt_gather") + last("ckpt_drain"), last("ckpt_write")

    def run_elastic(label, cpol, sizes, steps_at, ctrl=None):
        el = ElasticSSGD(CNN(mcfg, seed=SEED, device=dev), opt_cfg,
                         DitherPolicy(variant="kernel"), cpol,
                         ckpt_dir=os.path.join(scratch, label.replace(" ", "_")),
                         n_nodes=sizes[0], s_base=2.0, device=dev)
        el.init()
        total = {k: 0 for k in build.LAUNCHES}
        step = 0
        for i, n in enumerate(sizes):
            if i:
                before = snapshot(el)
                el.resize(n)
                blocking, writer = save_times()
                same_state(snapshot(el), before, f"11b {label} -> N={n}")
                log(f"phase 11b: {label}: resize to N={n}, pods "
                    f"{el.active_comm_policy.pods}: parameters, moments"
                    f"{', EF residuals' if el.comm_state else ''}"
                    f"{', ctrl' if el.ctrl_state else ''} equal to the saved state "
                    f"bit for bit; the save blocked {blocking:.1f} ms (gather + "
                    f"drain), its writer took {writer:.1f} ms ({card})")
            pods = el.active_comm_policy.pods
            n_comp = sum(cpol.mode_for(k, p.numel()) != "dense"
                         for k, p in el.params.items())
            packs = (n_comp * two_level_packs(cpol.topology, n, pods)
                     if cpol.topology in ("hier", "butterfly") else n * n_comp)
            if cpol.default == "topk_ef":
                packs = 0  # top-k keeps its residual server-side: no pack
            want = nonzero({"nsd_quant": n * PER_STEP["nsd_quant"] + packs,
                            "bsp_matmul_int8": n * PER_STEP["bsp_matmul_int8"],
                            "levels_compact": packs, "levels_expand": packs})
            for _ in range(steps_at[i]):
                b = classification_batch(data, step, SSGD_NODE_BATCH * n, device=dev)
                torch.cuda.synchronize()
                build.reset_launches()
                t0 = time.perf_counter()
                m = el.step(b, SEED)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got = dict(build.LAUNCHES)
                for k, v in got.items():
                    total[k] += v
                check(math.isfinite(float(m["loss"])), f"11b {label}: loss {m['loss']}")
                check(nonzero(got) == want,
                      f"11b {label} N={n} step {step}: launches {nonzero(got)}, want {want}")
                log(f"phase 11b: {label} N={n} pods={pods} step {step}: {ms:.1f} ms on "
                    f"the host clock, loss {float(m['loss']):.5f}, launches "
                    f"{nonzero(got)}, comm_wire_bytes {float(m['comm_wire_bytes'])}"
                    + (f", ICI {float(m['comm_wire_ici_bytes'])}, DCN "
                       f"{float(m['comm_wire_dcn_bytes'])}, peak DCN "
                       f"{float(m['comm_peak_dcn_bytes'])}"
                       if "comm_wire_ici_bytes" in m else "") + f" ({card})")
                step += 1
            if ctrl is not None and i == 0:
                el.ctrl_state = dict(ctrl)
        path_launches[f"elastic vgg11 {label}"] = total
        return el

    hier = comm.CommPolicy(default="nsd", s=2.0, topology="hier", pods=2)
    el = run_elastic("hier", hier, (8, 6, 3), (2, 1, 1),
                     ctrl={"c0": np.float32(0.125), "fc2": np.float32(-0.5)})
    check(el.active_comm_policy.pods == 1, "11b: pods did not snap to 1 at N=3")
    # the butterfly from the hier run's last checkpoint, one step at N=8
    ckpt_dir = el.ckpt.base
    el.save()
    bfly = ElasticSSGD(CNN(mcfg, seed=SEED + 1, device=dev), opt_cfg,
                       DitherPolicy(variant="kernel"),
                       comm.CommPolicy(default="nsd", s=2.0, topology="butterfly",
                                       pods=4),
                       ckpt_dir=ckpt_dir, n_nodes=8, s_base=2.0, device=dev)
    bfly.init()
    # a fresh driver restores params and opt (ctrl rides only a resize, as
    # in the reference: a fresh driver's tree has no ctrl subtree)
    same_state([x for x in snapshot(bfly) if not x[0].startswith("ctrl/")],
               [x for x in snapshot(el) if not x[0].startswith("ctrl/")],
               "11b butterfly restore of the hier run")
    del el
    n_comp = sum(bfly.comm_policy.mode_for(k, p.numel()) != "dense"
                 for k, p in bfly.params.items())
    packs = n_comp * two_level_packs("butterfly", 8, 4)
    b = classification_batch(data, 10, SSGD_NODE_BATCH * 8, device=dev)
    build.reset_launches()
    m = bfly.step(b, SEED)
    torch.cuda.synchronize()
    got = dict(build.LAUNCHES)
    want = {"nsd_quant": 8 * PER_STEP["nsd_quant"] + packs,
            "bsp_matmul_int8": 8 * PER_STEP["bsp_matmul_int8"],
            "levels_compact": packs, "levels_expand": packs}
    check(math.isfinite(float(m["loss"])) and nonzero(got) == want,
          f"11b butterfly: loss {float(m['loss'])}, launches {nonzero(got)}, want {want}")
    path_launches["elastic vgg11 butterfly N=8 pods=4"] = got
    log(f"phase 11b: butterfly N=8 pods=4 from the hier run's checkpoint (step "
        f"{bfly.opt_state['step'] - 1}): loss {float(m['loss']):.5f}, launches "
        f"{nonzero(got)}, comm_wire_bytes {float(m['comm_wire_bytes'])}, peak DCN "
        f"{float(m['comm_peak_dcn_bytes'])} ({card})")
    del bfly
    # top-k with error feedback under ps, 4 -> 2 -> 6 nodes
    topk = comm.CommPolicy(default="topk_ef", topk_frac=0.01)
    el = run_elastic("topk_ef ps", topk, (4, 2, 6), (1, 1, 1))
    check(el.comm_state and all(st.residual.any() for st in el.comm_state.values()),
          "11b topk_ef: no residual came through")
    del el
    log(f"phase 11b: {time.perf_counter() - t_phase:.1f} s since phase 11 began ({card})")

    # -- 11c: gemma-2b through the launcher with checkpoints; a trainer
    # resumed from step 2 on a step-indexed loader against the straight run
    d_run = os.path.join(scratch, "lm")
    argv = ["--arch", "gemma-2b", "--preset", "smoke", "--batch", str(LM_RESUME_BATCH),
            "--seq", str(LM_RESUME_SEQ), "--program", LM_PROGRAM, "--device", str(dev)]
    argv_ckpt = argv + ["--ckpt-every", "2"]
    build.reset_launches()
    straight = lm_train.main(argv_ckpt + ["--steps", "4", "--ckpt-dir", d_run])
    check(list_steps(d_run) == [2, 4], f"11c: checkpoints {list_steps(d_run)}")
    log(f"phase 11c: python -m repro_torch.launch.train {' '.join(argv_ckpt)} --steps 4 "
        f"--ckpt-dir DIR: checkpoints {list_steps(d_run)}, launches "
        f"{nonzero(build.LAUNCHES)}")
    d_resume = os.path.join(scratch, "lm_resume")
    os.makedirs(d_resume)
    shutil.copytree(os.path.join(d_run, "step_00000002"),
                    os.path.join(d_resume, "step_00000002"))
    resumed, _ = lm_train.build(lm_train.parse_args(
        argv_ckpt + ["--steps", "4", "--ckpt-dir", d_resume]))
    tcfg = TokenStreamConfig(vocab=resumed.model.cfg.vocab, seq_len=LM_RESUME_SEQ,
                             batch=LM_RESUME_BATCH)
    loader = ShardedLoader(lambda s: token_batch(tcfg, s, device="cpu"),
                           start_step=2, device=dev)
    build.reset_launches()
    try:
        resumed.fit(loader)
    finally:
        loader.close()
    resume_launches = dict(build.LAUNCHES)
    check(resumed.opt_state["step"] == straight.opt_state["step"] == 4,
          "11c: the runs did not end at step 4")
    a = [(n, x) for n, x in flatten_with_names(
        {"params": straight.params, "opt": straight.opt_state})]
    b = [(n, x) for n, x in flatten_with_names(
        {"params": resumed.params, "opt": resumed.opt_state})]
    check([n for n, _ in a] == [n for n, _ in b], "11c: state names differ")
    for (name, x), (_, y) in zip(a, b):
        ok = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        check(ok, f"11c: {name} of the resumed run differs from the straight run's")
    check(resume_launches["nsd_quant"] > 0 and resume_launches["bsp_matmul_int8"] > 0,
          f"11c: the resumed kernel steps launched {nonzero(resume_launches)}")
    path_launches["gemma-2b smoke resumed at step 2 (steps 2-3)"] = resume_launches
    log(f"phase 11c: a Trainer resumed from step 2 on a ShardedLoader(start_step=2): "
        f"step-4 parameters and moments equal the straight run's bit for bit over "
        f"{len(a)} leaves; launches {nonzero(resume_launches)} ({card})")
    # a preemption notice while batch 3 is fetched: the checkpoint lands at 4
    d_pre = os.path.join(scratch, "lm_preempt")
    pre, batches = lm_train.build(lm_train.parse_args(
        argv + ["--ckpt-every", "100", "--steps", "50", "--ckpt-dir", d_pre]))

    def preempted():
        for i, batch in enumerate(batches):
            if i == 3:
                pre.guard.trigger()
            yield batch

    pre.fit(preempted())
    check(pre.ckpt.latest_step() == 4 and pre.opt_state["step"] == 4,
          f"11c: the preemption checkpoint is at {pre.ckpt.latest_step()}")
    log(f"phase 11c: guard.trigger() while batch 3 is fetched: the run stops and "
        f"checkpoints at step {pre.ckpt.latest_step()}")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s ({card})")
    return path_launches


def lm_harness(torch, card, dev, plain_kernels, swapped, kernel, worst_rel):
    """The LM runs of phases 12 and 13: ``run`` drives a trainer with every
    step timed and its launches, the int8 products' K and the packs' masks
    recorded; ``grad_check`` holds a trainer's first kernel step against
    the plain versions; ``release`` frees the card. Launches are checked
    against :func:`zoo_kernel_step`."""
    import gc
    import types

    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as lm_train
    from repro_torch.obs import metrics
    from repro_torch.train import trainer as trainer_mod

    steps_seen, ks = [], []

    def n_blocks(n):
        return f"{n} block{'s' if n != 1 else ''}"
    packs = {"tiles": 0, "skipped": [], "slices": {}}
    real_step = trainer_mod.Trainer.train_step

    def timed_step(self, batch, step):
        """One step on the host clock, with its launches."""
        torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        out = real_step(self, batch, step)
        torch.cuda.synchronize()
        steps_seen.append((step, (time.perf_counter() - t0) * 1e3,
                           float(out["loss"]),
                           {k: v - before[k] for k, v in build.LAUNCHES.items()
                            if v != before[k]}))
        if "grad_norm" in out:  # the global norm of the step's gradients
            check(math.isfinite(float(out["grad_norm"])),
                  f"step {step}: gradient norm {float(out['grad_norm'])}")
        return out

    def recording_int8(a, b, scale, mask, *, trans_a=False, trans_b=False):
        ks.append(a.shape[0] if trans_a else a.shape[1])
        return kernel["bsp_matmul_int8"](a, b, scale, mask, trans_a=trans_a,
                                         trans_b=trans_b)

    def recording_pack(k, **kw):
        out = kernel["bitmap_pack"](k, **kw)
        if tuple(k.shape) not in packs["slices"]:  # the first of each shape
            packs["slices"][tuple(k.shape)] = (k.clone(), kw)
        packs["tiles"] += out[2].numel()
        packs["skipped"].append((out[2] == 0).sum())  # summed after the run
        return out

    def run(label, fn, n_params=None, want=None):
        """fn() -> a trainer, with every step timed and its launches, the
        int8 products' K and the packs' masks recorded; checks no fallback,
        finite losses, the K bound and each step's launches (``want(cfg,
        step)``; by default :func:`zoo_kernel_step` from the first kernel
        step on). Returns (trainer, launches over the run, peak device
        memory above what was held before)."""
        steps_seen.clear()
        ks.clear()
        packs.update(tiles=0, skipped=[], slices={})
        ops.KERNEL_FALLBACKS.clear()
        build.reset_launches()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer_mod.Trainer.train_step = timed_step
        try:
            with swapped({"bsp_matmul_int8": recording_int8,
                          "bitmap_pack": recording_pack}):
                trainer = fn()
        finally:
            trainer_mod.Trainer.train_step = real_step
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        total = dict(build.LAUNCHES)
        check(not ops.KERNEL_FALLBACKS, f"{label}: fallbacks {ops.KERNEL_FALLBACKS}")
        got_params = sum(p.numel() for p in trainer.net.parameters())
        if n_params is not None:
            check(got_params == n_params, f"{label}: {got_params} parameters")
        if want is None:
            def want(cfg, step):
                return zoo_kernel_step(cfg) if step >= ZOO_FIRST_KERNEL_STEP else {}
        for step, ms, loss, launched in steps_seen:
            check(math.isfinite(loss), f"{label} step {step}: loss {loss}")
            want_step = want(trainer.model.cfg, step)
            check(launched == want_step, f"{label} step {step}: launches "
                                         f"{launched}, want {want_step}")
            log(f"phase {label} step {step}: {ms:.3f} ms on the host clock, "
                f"loss {loss:.4f}, launches {launched}")
        check(max(ks, default=0) <= INT32_EXACT_K,
              f"{label}: an int8 product of K {max(ks, default=0)} > {INT32_EXACT_K}")
        cfg = trainer.model.cfg
        log(f"phase {label}: {cfg.name} {n_blocks(cfg.n_layers)}, {got_params} "
            f"parameters ({str(cfg.dtype).split('.')[-1]}"
            f"{', remat' if cfg.remat else ''}), {seconds:.1f} s for "
            f"{len(steps_seen)} steps with the model's build; int8 products' K "
            f"{sorted(set(ks))} (exact up to {INT32_EXACT_K}); no fallback; peak "
            f"device memory {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} "
            f"GiB held before ({card})")
        return trainer, total, peak

    def step_grads(trainer, batch, step):
        """Step ``step``'s loss, gradients (cloned) and dither sparsity, the
        program's base with stats on."""
        metrics.reset()
        for p in trainer.net.parameters():
            p.grad = None
        loss, _ = trainer.grads(batch, step)
        grads = {n: p.grad.clone() for n, p in trainer.net.named_parameters()}
        for p in trainer.net.parameters():
            p.grad = None
        return float(loss), grads, metrics.overall_sparsity() * 100

    def grad_check(trainer, label, seq=ZOO_SEQ):
        """The first kernel step's gradients on the kernels and on their
        plain versions (AdamW's state freed first: only the gradients are
        needed)."""
        trainer.opt_state = None
        gc.collect()
        torch.cuda.empty_cache()
        prog = trainer.program
        trainer.program = prog.replace(base=prog.base.replace(collect_stats=True))
        batch = lm_train.batch_fn_for(trainer.model, ZOO_BATCH, seq, dev)(
            ZOO_FIRST_KERNEL_STEP)
        build.reset_launches()
        loss_k, grads_k, sp_k = step_grads(trainer, batch, ZOO_FIRST_KERNEL_STEP)
        launched = nonzero(build.LAUNCHES)
        want = zoo_kernel_step(trainer.model.cfg)
        check(launched == want, f"{label}: launches {launched}, want {want}")
        t0 = time.perf_counter()
        with plain_kernels():
            build.reset_launches()
            loss_p, grads_p, sp_p = step_grads(trainer, batch, ZOO_FIRST_KERNEL_STEP)
            check(not any(build.LAUNCHES.values()),
                  f"{label}: the plain run launched a kernel")
        plain_s = time.perf_counter() - t0
        for n, g in list(grads_k.items()) + list(grads_p.items()):
            check(bool(torch.isfinite(g).all()), f"{label}: {n}'s gradient is not finite")
        worst = worst_rel(grads_k, grads_p, f"{label} {trainer.model.cfg.name}")
        check(abs(sp_k - sp_p) <= SPARSITY_BAND,
              f"{label}: sparsity {sp_k} vs plain {sp_p}")
        log(f"phase {label}: {trainer.model.cfg.name} step "
            f"{ZOO_FIRST_KERNEL_STEP} loss {loss_k:.6f} (plain {loss_p:.6f}); worst "
            f"relative L2 gradient difference kernel vs plain {worst} over "
            f"{len(grads_k)} parameters, every gradient finite; dither sparsity "
            f"{sp_k:.3f}% (plain {sp_p:.3f}%); the plain step {plain_s:.1f} s")
        return worst, sp_k

    def release(*objs):
        del objs
        gc.collect()
        torch.cuda.empty_cache()


    return types.SimpleNamespace(run=run, grad_check=grad_check, release=release,
                                 n_blocks=n_blocks, steps_seen=steps_seen,
                                 packs=packs, step_grads=step_grads)


def phase12(torch, card, dev, plain_kernels, swapped, kernel, plain, worst_rel,
            same, time_ms, graph_ms):
    """Phase 12: the rest of the LM zoo. 12a gemma3-4b at full width and
    depth through the launcher, 12b its first kernel step's gradients
    against the plain versions, 12c moonshot-v1-16b-a3b cut to 4 blocks
    (the pack kernel on the MoE path), 12d qwen2.5-32b and minitron-8b cut
    to 2 blocks and dbrx-132b's smoke preset, 12e serving. Returns the
    launches of each run by kernel, for the kernels line, and the pack's
    figures at the expert-slice shape."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_model, get_smoke_model
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.program import merge_legacy_flags
    from repro_torch.models.api import lm_model
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.serve import Engine, Request, ServeConfig, greedy_generate
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    h = lm_harness(torch, card, dev, plain_kernels, swapped, kernel, worst_rel)
    run, grad_check, release, n_blocks = h.run, h.grad_check, h.release, h.n_blocks
    steps_seen, packs = h.steps_seen, h.packs

    base = DitherPolicy(variant="paper", s=2.0)  # the launcher's defaults

    def cut_trainer(arch, blocks, steps, quant):
        """The arch's full configuration cut to ``blocks`` blocks, trained by
        ``repro_torch.train.Trainer`` as the launcher builds it (the
        ``quant:`` section's moment codecs into ``OptConfig``)."""
        full = get_model(arch)
        model = lm_model(dataclasses.replace(full.cfg, n_layers=blocks),
                         full.family)
        spec = merge_legacy_flags(f"{ZOO_PROGRAM} {quant}", "", "")
        qo = spec.quant_overrides()
        policy = spec.dither_program(base)
        trainer = trainer_mod.Trainer(
            model, OptConfig(name="adamw", lr=3e-4, schedule="cosine",
                             warmup_steps=max(steps // 20, 1), total_steps=steps,
                             mu_codec=qo.mu if qo is not None else None,
                             nu_codec=qo.nu if qo is not None else None),
            trainer_mod.TrainerConfig(total_steps=steps, log_every=1),
            policy=policy, device=dev)
        fn = lm_train.batch_fn_for(model, ZOO_BATCH, ZOO_SEQ, dev)
        trainer.fit(fn(i) for i in range(steps))
        return trainer

    paths = {}

    # -- 12a: gemma3-4b at full width and depth through the launcher -------
    argv = GEMMA3_ARGS + ["--steps", str(GEMMA3_STEPS), "--program", ZOO_PROGRAM]
    log(f"phase 12a: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, total, peak = run("12a", lambda: lm_train.main(argv), GEMMA3_PARAMS)
    cfg = trainer.model.cfg
    check(cfg.n_layers == 34 and cfg.window == 1024
          and sum(cfg.layer_is_local(i) for i in range(34)) == 29
          and all(p.dtype == torch.bfloat16 for p in trainer.net.parameters())
          and cfg.remat, "12a: not gemma3-4b's full configuration in bf16 with remat")
    check(len(steps_seen) == GEMMA3_STEPS, f"12a: {len(steps_seen)} steps")
    ms = [m for _, m, _, _ in steps_seen]
    log(f"phase 12a: AdamW moments f32; off step 0 {ms[0]:.3f} ms (first-use "
        f"costs), kernel steps {min(ms[2:]):.3f}-{max(ms[2:]):.3f} ms (step 1 "
        f"{ms[1]:.3f} ms); launches over the run {nonzero(total)}; peak device "
        f"memory {peak / 2**30:.2f} GiB ({card})")
    paths[f"gemma3-4b kernel {GEMMA3_STEPS} steps ({ZOO_FIRST_KERNEL_STEP} off)"] = total
    tcfg = TokenStreamConfig(vocab=cfg.vocab, seq_len=ZOO_SEQ, batch=ZOO_BATCH)
    batch = token_batch(tcfg, ZOO_FIRST_KERNEL_STEP, device=dev)
    profile_step(torch, lambda: trainer.train_step(batch, ZOO_FIRST_KERNEL_STEP),
                 card, "gemma3-4b kernel step", steps=1, phase="12a",
                 what="one gemma3-4b training step, variant=kernel (batch 8 x "
                      "seq 128, bf16, remat, AdamW)")
    # -- 12b: the first kernel step's gradients against the plain versions -
    grad_check(trainer, "12b")
    release(trainer)
    trainer = None

    # -- 12c and 12d: the depth-cut configurations -------------------------
    def pack_check(label, arch, trainer, total):
        """The expert slices' packs of the run: launched, the all-zero tiles
        counted, one captured slice of each shape (the gate and up einsums'
        (C, f), the down einsum's (C, d), C padded to 128) bit for bit
        against the plain version and timed."""
        check(total["bitmap_pack"] > 0, f"{label}: no pack launch")
        skipped = int(torch.stack(packs["skipped"]).sum())
        cfg = trainer.model.cfg
        per_step = zoo_kernel_step(cfg)["bitmap_pack"]
        log(f"phase {label}: {arch} {total['bitmap_pack']} pack launches "
            f"({per_step} a kernel step: {n_blocks(cfg.n_layers)} x 3 expert "
            f"einsums x {cfg.moe.n_experts} experts); the expert slices' 128 x "
            f"128 tiles: {packs['tiles']}, of which {skipped} all-zero (skipped "
            f"by both int8 products) ({card})")
        figs = {"tiles": packs["tiles"], "tiles_skipped": skipped}
        for (M, N), (kp, kw) in sorted(packs["slices"].items()):
            same("bitmap_pack", kernel["bitmap_pack"](kp, **kw),
                 plain["bitmap_pack"](kp, **kw), f"{label} expert slice {M}x{N}")
            nbytes = M * N + M * N // 8 + 2 * (M // 128) * (N // 128) * 4
            fig = figs[f"{M}x{N}"] = {
                "ms": time_ms(lambda: kernel["bitmap_pack"](kp, **kw)),
                "graph_ms": graph_ms(lambda: kernel["bitmap_pack"](kp, **kw)),
                "plain_ms": time_ms(lambda: plain["bitmap_pack"](kp, **kw),
                                    launches=2, groups=3),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": None}  # no one PyTorch call packs a bitmap
            log(f"phase {label}: {arch}'s pack at the expert-slice shape {M}x{N}: "
                f"bit for bit; {fig['ms']:.4f} ms (device {fig['graph_ms']:.4f} ms "
                f"in graph replay), bound {fig['bound_ms']:.5f} ms (bytes), "
                f"plain {fig['plain_ms']:.4f} ms ({card})")
        return figs

    pack_slices = {}
    for arch, blocks, steps, quant in ZOO_CUTS:
        label = "12c" if arch == "moonshot-v1-16b-a3b" else "12d"
        log(f"phase {label}: {arch} at full width cut to {n_blocks(blocks)}, "
            f"{steps} steps, {f'{ZOO_PROGRAM} {quant}'.strip()!r}")
        trainer, total, peak = run(
            label, lambda: cut_trainer(arch, blocks, steps, quant))
        paths[f"{arch} {n_blocks(blocks)} kernel {steps} "
              f"steps ({ZOO_FIRST_KERNEL_STEP} off){', ' + quant if quant else ''}"] = total
        if trainer.model.cfg.moe is not None:
            pack_slices[arch] = pack_check(label, arch, trainer, total)
        if label == "12c":
            tcfg = TokenStreamConfig(vocab=trainer.model.cfg.vocab,
                                     seq_len=ZOO_SEQ, batch=ZOO_BATCH)
            batch = token_batch(tcfg, ZOO_FIRST_KERNEL_STEP, device=dev)
            profile_step(torch, lambda: trainer.train_step(batch, ZOO_FIRST_KERNEL_STEP),
                         card, f"moonshot {blocks}-block kernel step", steps=1,
                         phase="12c",
                         what=f"one moonshot-v1-16b-a3b training step cut to "
                              f"{blocks} blocks, variant=kernel (batch 8 x seq "
                              f"128, bf16, remat, AdamW)")
        if trainer.model.cfg.moe is not None:
            grad_check(trainer, label)
        release(trainer)
        trainer = None
    argv = ["--arch", ZOO_SMOKE_TRAIN, "--preset", "smoke", "--batch",
            str(ZOO_BATCH), "--seq", str(ZOO_SEQ), "--steps", "2", "--program",
            ZOO_PROGRAM]
    log(f"phase 12d: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, total, _ = run("12d", lambda: lm_train.main(argv))
    paths[f"{ZOO_SMOKE_TRAIN} smoke kernel 2 steps (1 off)"] = total
    release(trainer)
    trainer = None

    # -- 12e: serving ---------------------------------------------------------
    real_tick = engine_mod.Engine.step
    ticks = []

    def timed_tick(self):
        t0 = time.perf_counter()
        real_tick(self)
        ticks.append((time.perf_counter() - t0) * 1e3)

    argv = ["--preset", "full", "--serve", ZOO_SERVE_SPEC, "--requests",
            str(ZOO_SERVE_REQUESTS), "--new-tokens", str(ZOO_SERVE_NEW)]
    build.reset_launches()
    engine_mod.Engine.step = timed_tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sup = launch_serve.main(argv)
    finally:
        engine_mod.Engine.step = real_tick
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    w = sup.workers["gemma3-4b"]
    check(sorted(w.results) == list(range(ZOO_SERVE_REQUESTS))
          and all(len(v) == ZOO_SERVE_NEW for v in w.results.values()),
          f"12e: served {sorted(w.results)}")
    check(not any(build.LAUNCHES.values()), "12e: a kernel launched in serving")
    bufs = [K.shape[1] for K, _ in w.engine.cache]
    rest = sorted(ticks[1:])
    log(f"phase 12e: python -m repro_torch.launch.serve {' '.join(argv)}: "
        f"{len(w.results)}/{ZOO_SERVE_REQUESTS} requests on dense buffers of "
        f"{sorted(set(bufs))} slots, {len(ticks)} ticks; "
        f"{ZOO_SERVE_REQUESTS * ZOO_SERVE_NEW / seconds:.2f} tokens/s over "
        f"{seconds:.2f} s (the model's build included); the first tick "
        f"{ticks[0]:.3f} ms, the other {len(rest)} median "
        f"{statistics.median(rest):.3f} ms ({card})")
    release(sup, w)

    def stepwise(m, net, prompt, n_new, max_len):
        """Greedy tokens from an empty cache, the prompt fed one token a
        step: the engine's routing at batch 1, chunk 1."""
        cache = m.init_cache(1, max_len, device=dev)
        out, tok = [], None
        for t in range(len(prompt) + n_new - 1):
            feed = (torch.tensor([[int(prompt[t])]], device=dev) if t < len(prompt)
                    else tok)
            logits, cache = m.decode_step(net, cache, feed, t)
            if t >= len(prompt) - 1:
                tok = torch.argmax(logits[:, -1:], dim=-1)
                out.append(int(tok))
        return out

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n) for n in (11, 9, 13, 10)]
    for arch, mb, chunk in (("gemma3-4b", 4, 8), ("moonshot-v1-16b-a3b", 1, 1)):
        m = get_smoke_model(arch)
        net = m.init(0, dev)
        eng = Engine(m, net, ServeConfig(max_batch=mb, max_len=64, chunk=chunk))
        for i, p in enumerate(prompts):
            check(eng.submit(Request(uid=i, prompt=p, max_new_tokens=16)),
                  f"12e {arch}: request {i} refused")
        done = eng.run(max_ticks=400)
        check(sorted(done) == list(range(len(prompts))), f"12e {arch}: {sorted(done)}")
        if m.cfg.window is not None:
            ref, what = [greedy_generate(m, net, p, 16, max_len=64)
                         for p in prompts], "greedy_generate's"
        else:
            ref = [stepwise(m, net, p, 16, 64) for p in prompts]
            what = "a token-by-token decode's"
        check([done[i] for i in range(len(prompts))] == ref,
              f"12e {arch}: the engine's tokens differ from {what}")
        greedy_same = sum(done[i] == greedy_generate(m, net, p, 16, max_len=64)
                          for i, p in enumerate(prompts))
        log(f"phase 12e: {arch} smoke in the engine (batch {mb}, chunk {chunk}, "
            f"prompts of {[len(p) for p in prompts]} tokens + 16, window "
            f"{m.cfg.window}): every request's tokens equal {what}; "
            f"greedy_generate agrees on {greedy_same} of {len(prompts)} requests")
        release(net, eng)
    for arch in ZOO_ARCHS:
        sup = launch_serve.main(["--arch", arch, "--requests", "3",
                                 "--new-tokens", "8", "--max-len", "64"])
        n_done = sum(h.finished for h in sup.health())
        check(n_done == 3, f"12e {arch}: served {n_done}/3")
        release(sup)
    log(f"phase 12e: the serve launcher served 3/3 requests for each of "
        f"{', '.join(ZOO_ARCHS)} (--preset smoke)")
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s ({card})")
    return paths, pack_slices

def phase13(torch, card, dev, plain_kernels, swapped, kernel, worst_rel):
    """Phase 13: the VLM, SSM and hybrid families. 13a mamba2-370m, 13b
    hymba-1.5b and 13c internvl2-2b at full width and depth through the
    launcher (the launches of a kernel step, the int8 products' K, no
    fallback, finite losses and gradient norms, host ms a step, peak
    memory, a profile of one kernel step with the int8 products' device
    time beside their bound and the SSD scan's share, the first kernel
    step's gradients against the plain versions); 13d serving: each arch
    at full width through the serve launcher (internvl2-2b on dense
    buffers and on nsd pages of 16), each smoke model and a 4-layer hybrid
    whose prompts run past its window in the engine against
    ``greedy_generate``. Returns the launches of each run by kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_model, get_smoke_model
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as lm_train
    from repro_torch.models import hybrid as hybrid_mod
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models.api import hybrid_model
    from repro_torch.serve import Engine, Request, ServeConfig, greedy_generate
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import kvcache

    t_phase = time.perf_counter()
    h = lm_harness(torch, card, dev, plain_kernels, swapped, kernel, worst_rel)
    paths = {}
    products = []  # (live tiles, the other operand's padded width) a call

    def counting_int8(a, b, scale, mask, *, trans_a=False, trans_b=False):
        products.append(((mask != 0).sum(), b.shape[1] if trans_a else b.shape[0]))
        return kernel["bsp_matmul_int8"](a, b, scale, mask, trans_a=trans_a,
                                         trans_b=trans_b)

    def ssd_ms(cfg, batch, seq):
        """One chunked SSD scan, forward and backward, at a mixer's shapes
        (x, B and C in the model's dtype, dt f32): (CUDA-event ms, device
        ms from torch.profiler, device kernels launched) a call."""
        from torch.profiler import ProfilerActivity, profile
        c = cfg.ssm
        g = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape, dtype=cfg.dtype, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev) * scale).to(
                dtype).requires_grad_()
        x = rnd(batch, seq, c.n_heads, c.head_dim)
        dt = (torch.rand(batch, seq, c.n_heads, generator=g, device=dev) * 0.1
              ).requires_grad_()
        A = -torch.linspace(1.0, 16.0, c.n_heads, device=dev)
        Bm, Cm = (rnd(batch, seq, c.n_groups, c.d_state) for _ in range(2))
        cot = torch.randn(batch, seq, c.n_heads, c.head_dim, generator=g, device=dev)

        def once():
            y, _ = mamba_mod._ssd_chunked(x, dt, A, Bm, Cm, c)
            torch.autograd.grad(y, (x, dt, Bm, Cm), cot)
        once()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(5):
            once()
        e1.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                once()
            torch.cuda.synchronize()
        dev_rows = [e for e in prof.key_averages()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        dev_us = sum(getattr(e, "self_device_time_total", 0) for e in dev_rows)
        return (e0.elapsed_time(e1) / 5, dev_us / 1e3 / 3,
                sum(e.count for e in dev_rows) // 3)

    for label, arch, blocks in FAMILY_RUNS:
        argv = ["--arch", arch, "--preset", "full", "--batch", str(ZOO_BATCH),
                "--seq", str(ZOO_SEQ), "--steps", str(FAMILY_STEPS), "--program",
                ZOO_PROGRAM]
        log(f"phase {label}: python -m repro_torch.launch.train {' '.join(argv)}")
        trainer, total, peak = h.run(label, lambda: lm_train.main(argv))
        model, cfg = trainer.model, trainer.model.cfg
        check(cfg == get_model(arch).cfg and cfg.n_layers == blocks
              and all(p.dtype == torch.bfloat16 for p in trainer.net.parameters()),
              f"{label}: not {arch}'s full configuration in bf16")
        check(len(h.steps_seen) == FAMILY_STEPS, f"{label}: {len(h.steps_seen)} steps")
        ms = [m for _, m, _, _ in h.steps_seen]
        n_params = sum(p.numel() for p in trainer.net.parameters())
        log(f"phase {label}: {arch} {n_params} parameters (the reference's count "
            f"{model.param_count}), remat {cfg.remat}; AdamW moments f32; off "
            f"step 0 {ms[0]:.3f} ms (first-use costs), kernel steps "
            f"{min(ms[2:]):.3f}-{max(ms[2:]):.3f} ms (step 1 {ms[1]:.3f} ms); "
            f"launches over the run {nonzero(total)}, "
            f"{zoo_kernel_step(cfg)} a kernel step; peak device memory "
            f"{peak / 2**30:.2f} GiB ({card})")
        paths[f"{arch} kernel {FAMILY_STEPS} steps ({ZOO_FIRST_KERNEL_STEP} off)"] = total
        batch = lm_train.batch_fn_for(model, ZOO_BATCH, ZOO_SEQ, dev)(
            ZOO_FIRST_KERNEL_STEP)
        tokens = int(batch["tokens"].numel()) + (
            ZOO_BATCH * cfg.vlm_patches if "patch_embeds" in batch else 0)
        products.clear()
        with swapped({"bsp_matmul_int8": counting_int8}):
            prof = profile_step(
                torch, lambda: trainer.train_step(batch, ZOO_FIRST_KERNEL_STEP),
                card, f"{arch} kernel step", steps=1, phase=label,
                what=f"one {arch} training step, variant=kernel ({ZOO_BATCH} x "
                     f"{tokens // ZOO_BATCH} positions, bf16, AdamW)", host=False)
        # the warm-up step and the profiled one: the same products
        ops_step = sum(2 * int(n) * 128 * 128 * w for n, w in products) / 2
        bound = ops_step / INT8_OPS_PER_S * 1e3
        if prof is not None:
            rows, wall = prof
            int8_ms = sum(r[0] for r in rows if "bsp_int8_kernel" in r[2])
            busy = sum(r[0] for r in rows)
            log(f"phase {label}: the int8 products of a kernel step: "
                f"{int8_ms:.3f} ms of device time over {len(products) // 2} "
                f"products, bound {bound:.3f} ms ({ops_step:.4g} operations on "
                f"the live 128 x 128 tiles at {INT8_OPS_PER_S / 1e12:.0f} TOP/s; "
                f"{100 * bound / int8_ms:.1f}% of peak) ({card})")
        else:
            busy = wall = None
            log(f"phase {label}: the int8 products' device time not measured; "
                f"bound {bound:.3f} ms ({card})")
        if hasattr(cfg, "ssm"):
            n_mixers = cfg.n_layers
            seq = ZOO_SEQ + getattr(cfg, "n_meta_tokens", 0)
            ev, one, n_k = ssd_ms(cfg, ZOO_BATCH, seq)
            share = (f"{100 * n_mixers * one / busy:.1f}% of the profiled step's "
                     f"{busy:.3f} ms of device time" if busy
                     else "the step's share not measured")
            log(f"phase {label}: the chunked SSD scan (its einsums, exps and "
                f"cumsum), forward and backward at {ZOO_BATCH} x {seq} positions, "
                f"{cfg.ssm.n_heads} heads, chunk {min(cfg.ssm.chunk, seq)}: "
                f"{one:.3f} ms of device time a mixer over {n_k} kernels "
                f"({ev:.3f} ms of CUDA-event time, host-bound), {n_mixers * one:.3f} "
                f"ms for the {n_mixers} mixers of a step: {share} ({card})")
        h.grad_check(trainer, label)
        h.release(trainer)
        trainer = None

    # -- 13d: serving ------------------------------------------------------
    real_tick, real_run = engine_mod.Engine.step, engine_mod.Engine._run_chunk
    real_seal = kvcache.PagedKV._seal
    real_boot = hybrid_mod.bootstrap_cache
    seen = {}

    def timed_boot(net, batch, max_len):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_boot(net, batch, max_len)
        torch.cuda.synchronize()
        seen["boot"] = time.perf_counter() - t0
        return out

    def timed_tick(self):
        t0 = time.perf_counter()
        real_tick(self)
        seen["ticks"].append((time.perf_counter() - t0) * 1e3)

    def counted_run(self, tok_block, n_feed, pos0):
        seen["micro"] += tok_block.shape[1]
        return real_run(self, tok_block, n_feed, pos0)

    def counted_seal(self, rows):
        if self.key == kvcache.layer_key(0):
            seen["seals"] += len(rows)
        return real_seal(self, rows)

    for arch, kv in (("mamba2-370m", ""), ("hymba-1.5b", ""), ("internvl2-2b", ""),
                     ("internvl2-2b", ";kv=nsd;page=16")):
        argv = ["--preset", "full", "--serve", FAMILY_SERVE_SPEC.format(arch, kv),
                "--requests", str(FAMILY_SERVE_REQUESTS), "--new-tokens",
                str(FAMILY_SERVE_NEW)]
        seen.update(ticks=[], micro=0, seals=0, boot=None)
        ops.KERNEL_FALLBACKS.clear()
        build.reset_launches()
        engine_mod.Engine.step, engine_mod.Engine._run_chunk = timed_tick, counted_run
        kvcache.PagedKV._seal, hybrid_mod.bootstrap_cache = counted_seal, timed_boot
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            sup = launch_serve.main(argv)
        finally:
            engine_mod.Engine.step, engine_mod.Engine._run_chunk = real_tick, real_run
            kvcache.PagedKV._seal, hybrid_mod.bootstrap_cache = real_seal, real_boot
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        w = sup.workers[arch]
        launched = nonzero(build.LAUNCHES)
        check(sorted(w.results) == list(range(FAMILY_SERVE_REQUESTS))
              and all(len(v) == FAMILY_SERVE_NEW for v in w.results.values()),
              f"13d {arch}{kv}: served {sorted(w.results)}")
        check(not ops.KERNEL_FALLBACKS, f"13d {arch}{kv}: fallbacks {ops.KERNEL_FALLBACKS}")
        want = {}
        if "nsd" in kv:
            n = w.model.cfg.n_layers
            enc = n + 2 * n * seen["seals"]
            want = {"nsd_quant": enc, "levels_compact": enc,
                    "levels_expand": 2 * n * seen["micro"]}
            paths[f"{arch} serve{kv.replace(';', ' ')} {FAMILY_SERVE_REQUESTS} "
                  f"requests"] = dict(build.LAUNCHES)
        check(launched == want, f"13d {arch}{kv}: launches {launched}, want {want}")
        rest = sorted(seen["ticks"][1:])
        log(f"phase 13d: python -m repro_torch.launch.serve {' '.join(argv)}: "
            f"{len(w.results)}/{FAMILY_SERVE_REQUESTS} requests, {w.engine._tick} "
            f"ticks, {seen['micro']} micro-steps, {seen['seals']} pages sealed a "
            f"layer, launches {launched} (want {want}), no fallback; "
            f"{FAMILY_SERVE_REQUESTS * FAMILY_SERVE_NEW / seconds:.2f} tokens/s over "
            f"{seconds:.2f} s (the model's build included"
            + (f"; the engine's meta bootstrap {seen['boot']:.2f} s" if seen["boot"]
               else "") + f"); the first tick {seen['ticks'][0]:.3f} ms, the other "
            f"{len(rest)} median {statistics.median(rest):.3f} ms ({card})")
        h.release(sup, w)

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n) for n in (11, 9, 13, 10)]
    hy_smoke = get_smoke_model("hymba-1.5b")
    local4 = hybrid_model(dataclasses.replace(hy_smoke.cfg, name="hymba-4-layer",
                                              n_layers=4))
    check([local4.cfg.layer_is_local(i) for i in range(4)] == [False, True, False, False],
          "13d: the 4-layer hybrid's layer 1 is not local")
    for m, kv in ((get_smoke_model("mamba2-370m"), ""), (hy_smoke, ""), (local4, ""),
                  (get_smoke_model("internvl2-2b"), ""),
                  (get_smoke_model("internvl2-2b"), "fp32 pages")):
        net = m.init(0, dev)
        scfg = ServeConfig(max_batch=4, max_len=64, chunk=8,
                           kv_page=16 if kv else 0)
        eng = Engine(m, net, scfg)
        for i, p in enumerate(prompts):
            check(eng.submit(Request(uid=i, prompt=p, max_new_tokens=16)),
                  f"13d {m.name}: request {i} refused")
        done = eng.run(max_ticks=400)
        check(sorted(done) == list(range(len(prompts))), f"13d {m.name}: {sorted(done)}")
        ref = [greedy_generate(m, net, p, 16, max_len=64) for p in prompts]
        check([done[i] for i in range(len(prompts))] == ref,
              f"13d {m.name} {kv}: the engine's tokens differ from greedy_generate's")
        window = getattr(m.cfg, "window", None)
        log(f"phase 13d: {m.name} in the engine (batch 4, chunk 8, {kv or 'dense state'}, "
            f"prompts of {[len(p) for p in prompts]} tokens + 16, window {window}"
            f"{', meta tokens %d' % m.cfg.n_meta_tokens if hasattr(m.cfg, 'n_meta_tokens') else ''}): "
            f"every request's tokens equal greedy_generate's")
        h.release(net, eng)
    for arch in ("mamba2-370m", "hymba-1.5b", "internvl2-2b"):
        sup = launch_serve.main(["--arch", arch, "--requests", "3",
                                 "--new-tokens", "8", "--max-len", "64"])
        n_done = sum(x.finished for x in sup.health())
        check(n_done == 3, f"13d {arch}: served {n_done}/3")
        h.release(sup)
    log("phase 13d: the serve launcher served 3/3 requests for each of "
        "mamba2-370m, hymba-1.5b, internvl2-2b (--preset smoke)")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s ({card})")
    return paths


def phase14(torch, card, dev, plain_kernels, swapped, kernel, plain, worst_rel,
            same):
    """Phase 14: the audio family. 14a whisper-small at full width and depth
    through the launcher (the launches of a kernel step, lm_head on the
    kernel, the int8 products' K, no fallback, finite losses and gradient
    norms, host ms a step, peak memory, a device-only profile of one kernel
    step with the int8 products' device time beside their bound; the NSD
    and int8 kernels at the ragged shapes of a kernel step bit for bit
    against their plain versions; the first kernel step's gradients against
    the plain versions); 14b two kernel steps under ``memory: default=nsd``;
    14c ``greedy_generate`` with encoder frames at full width, its logits
    against the teacher-forced forward's, and the engine's and the serve
    launcher's refusals. Returns the launches of each run by kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_model
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as lm_train
    from repro_torch.models.api import encdec_model
    from repro_torch.obs import metrics
    from repro_torch.serve import Engine, ServeConfig, greedy_generate

    t_phase = time.perf_counter()
    h = lm_harness(torch, card, dev, plain_kernels, swapped, kernel, worst_rel)
    paths = {}
    products = []  # (live tiles, the other operand's padded width) a call

    def counting_int8(a, b, scale, mask, *, trans_a=False, trans_b=False):
        products.append(((mask != 0).sum(), b.shape[1] if trans_a else b.shape[0]))
        return kernel["bsp_matmul_int8"](a, b, scale, mask, trans_a=trans_a,
                                         trans_b=trans_b)

    # -- 14a: the kernel program through the launcher ----------------------
    argv = ["--arch", AUDIO_ARCH, "--preset", "full", "--batch", str(ZOO_BATCH),
            "--seq", str(AUDIO_SEQ), "--steps", str(AUDIO_STEPS), "--program",
            AUDIO_PROGRAM]
    log(f"phase 14a: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, total, peak = h.run("14a", lambda: lm_train.main(argv),
                                 n_params=AUDIO_PARAMS)
    model, cfg = trainer.model, trainer.model.cfg
    check(cfg == get_model(AUDIO_ARCH).cfg and cfg.remat
          and all(p.dtype == torch.bfloat16 for p in trainer.net.parameters()),
          "14a: not whisper-small's full configuration in bf16 with remat")
    check(len(h.steps_seen) == AUDIO_STEPS, f"14a: {len(h.steps_seen)} steps")
    ms = [m for _, m, _, _ in h.steps_seen]
    log(f"phase 14a: {AUDIO_ARCH} (the reference's count {model.param_count}), "
        f"{cfg.n_layers} + {cfg.n_layers} blocks, {ZOO_BATCH} x {cfg.n_frames} "
        f"frames and {ZOO_BATCH} x {AUDIO_SEQ} tokens; AdamW moments f32; off "
        f"step 0 {ms[0]:.3f} ms (first-use costs), kernel steps "
        f"{min(ms[2:]):.3f}-{max(ms[2:]):.3f} ms (step 1 {ms[1]:.3f} ms); "
        f"launches over the run {nonzero(total)}, {zoo_kernel_step(cfg)} a kernel "
        f"step (lm_head on the kernel); peak device memory {peak / 2**30:.2f} "
        f"GiB ({card})")
    paths[f"{AUDIO_ARCH} kernel {AUDIO_STEPS} steps ({ZOO_FIRST_KERNEL_STEP} off)"] = total
    batch = lm_train.batch_fn_for(model, ZOO_BATCH, AUDIO_SEQ, dev)(
        ZOO_FIRST_KERNEL_STEP)
    products.clear()
    with swapped({"bsp_matmul_int8": counting_int8}):
        prof = profile_step(
            torch, lambda: trainer.train_step(batch, ZOO_FIRST_KERNEL_STEP),
            card, f"{AUDIO_ARCH} kernel step", steps=1, phase="14a",
            what=f"one {AUDIO_ARCH} training step, variant=kernel ({ZOO_BATCH} x "
                 f"{cfg.n_frames} frames, {ZOO_BATCH} x {AUDIO_SEQ} tokens, bf16, "
                 f"remat, AdamW)", host=False)
    # the warm-up step and the profiled one: the same products
    ops_step = sum(2 * int(n) * 128 * 128 * w for n, w in products) / 2
    bound = ops_step / INT8_OPS_PER_S * 1e3
    if prof is not None:
        rows, _ = prof
        int8_ms = sum(r[0] for r in rows if "bsp_int8_kernel" in r[2])
        log(f"phase 14a: the int8 products of a kernel step: {int8_ms:.3f} ms of "
            f"device time over {len(products) // 2} products, bound {bound:.3f} ms "
            f"({ops_step:.4g} operations on the live 128 x 128 tiles at "
            f"{INT8_OPS_PER_S / 1e12:.0f} TOP/s; {100 * bound / int8_ms:.1f}% of "
            f"peak) ({card})")
    else:
        log(f"phase 14a: the int8 products' device time not measured; bound "
            f"{bound:.3f} ms ({card})")

    # the kernels at the ragged shapes of a kernel step, captured and held
    # against their plain versions bit for bit
    ragged = (cfg.n_frames * ZOO_BATCH, cfg.vocab, -(-cfg.n_frames * ZOO_BATCH // 128) * 128,
              -(-cfg.vocab // 128) * 128)
    nsd_calls, int8_calls = {}, {}

    def capture_nsd(g, delta, **kw):
        if set(g.shape) & set(ragged) and tuple(g.shape) not in nsd_calls:
            nsd_calls[tuple(g.shape)] = (g.clone(), delta.clone(), dict(kw))
        return kernel["nsd_quant"](g, delta, **kw)

    def capture_int8(a, b, scale, mask, *, trans_a=False, trans_b=False):
        key = (tuple(a.shape), tuple(b.shape), trans_a)
        if (set(a.shape) | set(b.shape)) & set(ragged) and key not in int8_calls:
            int8_calls[key] = (a.clone(), b.clone(), scale.clone(), mask.clone(),
                               dict(trans_a=trans_a, trans_b=trans_b))
        return kernel["bsp_matmul_int8"](a, b, scale, mask, trans_a=trans_a,
                                         trans_b=trans_b)

    with swapped({"nsd_quant": capture_nsd, "bsp_matmul_int8": capture_int8}):
        h.step_grads(trainer, batch, ZOO_FIRST_KERNEL_STEP)
    for (T, N), (g, delta, kw) in sorted(nsd_calls.items()):
        same("nsd_quant", kernel["nsd_quant"](g, delta, **kw),
             plain["nsd_quant"](g, delta, **kw), f"14a whisper cotangent {T}x{N}")
    check(any(T == cfg.n_frames * ZOO_BATCH for T, _ in nsd_calls)
          and any(N == cfg.vocab for _, N in nsd_calls),
          f"14a: ragged cotangents captured {sorted(nsd_calls)}")
    ks_seen = []
    for (sa, sb, ta), (a, b, scale, mask, kw) in sorted(int8_calls.items()):
        K = sa[0] if ta else sa[1]
        ks_seen.append(K)
        same("bsp_matmul_int8", (kernel["bsp_matmul_int8"](a, b, scale, mask, **kw),),
             (plain["bsp_matmul_int8"](a, b, scale, mask, **kw),),
             f"14a whisper {'dW' if ta else 'dx'} A {sa} B {sb} K {K}")
    check({ragged[2], ragged[3]} <= set(ks_seen), f"14a: K captured {sorted(set(ks_seen))}")
    log(f"phase 14a: the NSD kernel at the ragged cotangents "
        f"{sorted(nsd_calls)} and the int8 product at {len(int8_calls)} ragged "
        f"shapes (K {sorted(set(ks_seen))}) bit for bit against their plain "
        f"versions")
    del nsd_calls, int8_calls
    h.grad_check(trainer, "14a", seq=AUDIO_SEQ)
    h.release(trainer)
    trainer = None

    # -- 14b: the nsd residual store ---------------------------------------
    n_dense = zoo_kernel_step(cfg)["nsd_quant"]
    # remat: each block's dense encodes its input in the forward and again
    # in the block's rerun; lm_head, outside the blocks, once
    nsd_step = {"nsd_quant": 3 * n_dense - 1, "bsp_matmul_int8": 2 * n_dense,
                "levels_compact": 2 * n_dense - 1, "levels_expand": n_dense}
    argv = ["--arch", AUDIO_ARCH, "--preset", "full", "--batch", str(ZOO_BATCH),
            "--seq", str(AUDIO_SEQ), "--steps", str(AUDIO_NSD_STEPS), "--program",
            AUDIO_NSD_PROGRAM]
    log(f"phase 14b: python -m repro_torch.launch.train {' '.join(argv)}")
    trainer, nsd_total, peak = h.run("14b", lambda: lm_train.main(argv),
                                     n_params=AUDIO_PARAMS,
                                     want=lambda cfg, step: nsd_step)
    paths[f"{AUDIO_ARCH} nsd {AUDIO_NSD_STEPS} steps"] = nsd_total
    trainer.opt_state = None
    prog = trainer.program
    trainer.program = prog.replace(base=prog.base.replace(collect_stats=True))
    batch = lm_train.batch_fn_for(model, ZOO_BATCH, AUDIO_SEQ, dev)(AUDIO_NSD_STEPS)
    _, grads_k, sp_k = h.step_grads(trainer, batch, AUDIO_NSD_STEPS)
    comp_k = metrics.overall_residual_compression()
    with plain_kernels():
        build.reset_launches()
        _, grads_p, sp_p = h.step_grads(trainer, batch, AUDIO_NSD_STEPS)
        comp_p = metrics.overall_residual_compression()
        check(not any(build.LAUNCHES.values()), "14b: the plain run launched a kernel")
    worst = worst_rel(grads_k, grads_p, f"14b {AUDIO_ARCH} nsd residuals")
    check(abs(comp_k - comp_p) <= COMPRESSION_BAND * comp_p,
          f"14b: residual_compression {comp_k} vs plain {comp_p}")
    check(abs(sp_k - sp_p) <= SPARSITY_BAND, f"14b: sparsity {sp_k} vs plain {sp_p}")
    log(f"phase 14b: {nsd_step} a step (the cotangents, two encodes a block's "
        f"dense, one for lm_head's; one decode a dense); launches over the run "
        f"{nonzero(nsd_total)}; residual_compression {comp_k} (plain versions "
        f"{comp_p}); sparsity {sp_k:.3f}% (plain {sp_p:.3f}%); worst relative L2 "
        f"gradient difference kernel vs plain {worst}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({card})")
    h.release(trainer, grads_k, grads_p)
    trainer = grads_k = grads_p = None

    # -- 14c: serving through greedy_generate ------------------------------
    net = model.init(0, dev)
    frames = lm_train.batch_fn_for(model, 1, AUDIO_PROMPT, dev)(0)["frames"]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=AUDIO_PROMPT)
    build.reset_launches()
    greedy_generate(model, net, prompt, 2, max_len=64, frames=frames)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = greedy_generate(model, net, prompt, AUDIO_NEW, max_len=64, frames=frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(toks) == AUDIO_NEW and all(0 <= t < cfg.vocab for t in toks),
          f"14c: tokens {toks}")
    check(not any(build.LAUNCHES.values()), "14c: a kernel launched in serving")
    t0 = time.perf_counter()
    with torch.no_grad():
        model.prefill(net, torch.as_tensor(prompt[None], device=dev), 64, frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    log(f"phase 14c: greedy_generate(whisper-small, prompt of {AUDIO_PROMPT}, "
        f"{AUDIO_NEW} new tokens, frames 1 x {cfg.n_frames} x {cfg.d_model}): "
        f"{AUDIO_NEW / seconds:.2f} tokens/s over {seconds:.3f} s (the encoder, the "
        f"cross K/V and the prompt's prefill {prefill_s:.3f} s of it) ({card})")
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]])[None], device=dev)
    for dtype, m_, net_ in (("bf16", model, net), ("f32", None, None)):
        if m_ is None:
            m_ = encdec_model(dataclasses.replace(cfg, dtype=torch.float32))
            net_ = m_.init(0, dev)
            net_.load_state_dict(net.state_dict())
        with torch.no_grad():
            lg, cache, t = m_.prefill(net_, seq[:, :AUDIO_PROMPT], 64, frames)
            stepped = [lg[0]]
            for i in range(AUDIO_PROMPT, seq.shape[1]):
                t += 1
                lg, cache = m_.decode_step(net_, cache, seq[:, i:i + 1], t)
                stepped.append(lg[0])
            stepped = torch.cat(stepped).float()
            full = m_.forward(net_, {"frames": frames, "tokens": seq})[0].float()
        check(bool(torch.isfinite(stepped).all() and torch.isfinite(full).all()),
              f"14c {dtype}: logits not finite")
        rel = float((stepped - full).norm() / full.norm())
        worst_pos = float(((stepped - full).norm(dim=-1) / full.norm(dim=-1)).max())
        agree = int((stepped.argmax(-1) == full.argmax(-1)).sum())
        check(rel <= AUDIO_LOGIT_BAND[dtype],
              f"14c {dtype}: prefill + decode logits relative L2 {rel} from the "
              f"forward's > {AUDIO_LOGIT_BAND[dtype]}")
        if dtype == "bf16":
            check(stepped[AUDIO_PROMPT - 1:].argmax(-1).tolist() == toks,
                  "14c: the decode's argmax differs from greedy_generate's tokens")
        log(f"phase 14c: {dtype} prefill + {seq.shape[1] - AUDIO_PROMPT} decode steps "
            f"against the teacher-forced forward over the same {seq.shape[1]} "
            f"tokens: logits relative L2 {rel:.3e} (band {AUDIO_LOGIT_BAND[dtype]}), "
            f"worst position {worst_pos:.3e}, argmax equal at {agree} of "
            f"{seq.shape[1]} positions")
    m_ = net_ = cache = stepped = full = None
    try:
        Engine(model, net, ServeConfig(max_batch=1, max_len=64))
    except ValueError as e:
        check("greedy_generate" in str(e), f"14c: the engine raised {e}")
    else:
        check(False, "14c: the engine accepted the audio family")
    h.release(net)
    net = None
    try:
        launch_serve.main(["--arch", AUDIO_ARCH, "--preset", "full"])
    except ValueError as e:
        check("greedy_generate" in str(e), f"14c: the serve launcher raised {e}")
    else:
        check(False, "14c: the serve launcher served the audio family")
    log("phase 14c: Engine and python -m repro_torch.launch.serve --arch "
        "whisper-small --preset full each raise the reference's ValueError "
        "(serve through greedy_generate(model, ..., frames=...))")
    h.release()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s ({card})")
    return paths


def host_state(torch, net, state):
    """The parameters and the optimizer state (flattened) on the host."""
    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = (v.detach().to("cpu", copy=True)
                                   if isinstance(v, torch.Tensor) else v)
        return out
    return {"params": {k: p.detach().to("cpu", copy=True)
                       for k, p in net.named_parameters()},
            "state": flat(state)}


def mesh_rank_launches(topology: str, n: int, pods: int, index: int):
    """(packs, unpacks) of one compressed leaf on rank ``index`` of a
    process reduce: each pack one NSD and one wire compact launch, each
    unpack one wire expand launch. The ring: N - 1 reduce-scatter packs and
    the gather pack; N - 1 unpacks of what arrives, then all N segments.
    The hierarchy: P packs on every rank (the ring's P - 1 and one tree
    pack: up from a pod > 0, the root's from pod 0); P - 1 + P unpacks and
    one a tree round in which the pod receives. The butterfly: the ring's,
    the pre-fold's (ragged pods), the halving rounds' and the piece pack
    (core pods); unpacks of the ring, the pre-fold received, the halving
    rounds and phase 4's G2 pieces of each of the P segments."""
    G, P = pods, n // pods
    g = index // P
    if topology == "ring":
        return n, 2 * n - 1
    if topology == "hier":
        recv = sum(1 for r in range((G - 1).bit_length() if G > 1 else 0)
                   if g % (2 << r) == 0 and g + (1 << r) < G)
        return P, 2 * P - 1 + recv
    m = G.bit_length() - 1
    G2 = 1 << m
    core = g < G2
    packs = (P - 1) + (0 if core else 1) + ((m + 1) if core else 0)
    unpacks = (P - 1) + (1 if g < G - G2 else 0) + (m if core else 0) + P * G2
    return packs, unpacks


def phase15_rank(rank, world, store_path, spec_path, out_dir):
    """One rank of phase 15: joins the gloo group, runs 15a's reduces and
    15b's SSGD steps (ranks beyond a case's size skip it), checks every
    result against the simulation's, and saves its launches, bytes and
    times. Any mismatch raises, which fails the whole spawn."""
    import torch
    import torch.distributed as dist

    from repro_torch import comm
    from repro_torch.comm.p2p import TRAFFIC
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import NodeTopology
    from repro_torch.train.classifier import repeatable_f32

    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", 0)  # the ranks share the one card
    torch.set_num_threads(1)  # the ranks share the host's cores
    if cuda:
        torch.cuda.set_device(dev)
        repeatable_f32()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {}
    try:
        # -- 15a: the process reduces of phase 6a's leaves
        grads = {k: v.to(dev) for k, v in spec["grads"].items()}
        for (topology, n, pods), sim in zip(spec["reduces"], spec["sims"]):
            group = None if n == world else dist.new_group(list(range(n)))
            if rank >= n:
                continue
            mesh = NodeTopology(pods=pods, nodes_per_pod=n // pods).mesh(group)
            pol = comm.CommPolicy(s=2.0, topology=topology, pods=pods,
                                  overrides=REDUCE_OVERRIDES)
            red = comm.reducer(pol, mesh)
            g = {k: v[rank].contiguous() for k, v in grads.items()}
            label = f"15a {topology} N={n} pods={pods} rank {rank}"
            TRAFFIC.reset()
            sync()
            build.reset_launches()
            t0 = time.perf_counter()
            means, tele, _ = red.reduce(g, SEED, 1)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(build.LAUNCHES)
            for k, m in means.items():
                check(torch.equal(m.cpu(), sim["means"][k]),
                      f"{label}: mean of {k} differs from the simulation's")
            for f in REDUCE_TELEMETRY:
                got, want = float(getattr(tele, f)), sim["tele"][f]
                check(got == want, f"{label}: {f} {got}, simulation {want}")
            check((tele.n_hops, tele.packs_per_segment) == sim["hops"],
                  f"{label}: hops {(tele.n_hops, tele.packs_per_segment)}")
            if cuda:
                n_comp = sum(pol.mode_for(k, v.numel()) != "dense"
                             for k, v in g.items())
                packs, unpacks = mesh_rank_launches(topology, n, pods, rank)
                want = {"nsd_quant": n_comp * packs,
                        "levels_compact": n_comp * packs,
                        "levels_expand": n_comp * unpacks}
                check(nonzero(launches) == want,
                      f"{label}: launches {nonzero(launches)}, want {want}")
            out[("15a", topology, n, pods)] = {
                "ms": ms, "launches": launches, "pack_bytes": TRAFFIC.pack_bytes,
                "dense_bytes": TRAFFIC.dense_bytes, "packs": len(TRAFFIC.packs)}
        del grads

        # -- 15b: 6b's VGG11 ring run, one node a rank
        out.update(phase15b_rank(torch, dist, rank, world, spec, dev, sync))
        dist.barrier()
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def phase15b_rank(torch, dist, rank, world, spec, dev, sync):
    """15b on one rank: ``make_ssgd_step(mesh=)`` on VGG11-CIFAR, node
    ``rank`` of 4, its batches through ``ShardedLoader(mesh=)``; after each
    step its parameters and optimizer state against 6b's simulated step."""
    import contextlib

    from repro_torch import comm
    from repro_torch.comm.p2p import TRAFFIC
    from repro_torch.configs import paper_models
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.data import ShardedLoader
    from repro_torch.data.synthetic import ClassifConfig, classification_batch
    from repro_torch.distributed import SSGDConfig, make_ssgd_step
    from repro_torch.distributed import ssgd as ssgd_mod
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import NodeTopology
    from repro_torch.models.cnn import CNN
    from repro_torch.optim.optimizers import OptConfig, init_opt_state

    mname, n, topology, steps = spec["ssgd_run"]
    node_batch = spec["node_batch"]
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return {}
    mesh = NodeTopology.flat(n).mesh(group)
    mcfg = paper_models.MODELS[mname]()
    net = CNN(mcfg, seed=SEED, device=dev)
    dcfg = SSGDConfig(n_nodes=n, s_schedule="sqrt", s_base=2.0)
    cpol = comm.CommPolicy(default="nsd", s=dcfg.s_for_n(), topology=topology)
    opt_cfg = OptConfig(name="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4,
                        grad_clip=None)
    step, _ = make_ssgd_step(net, opt_cfg, dcfg, DitherPolicy(variant="kernel"),
                             cpol, device=dev, mesh=mesh)
    data = ClassifConfig(n_classes=mcfg.n_classes, img_size=mcfg.img_size,
                         channels=mcfg.in_channels, noise=0.5, seed=SEED)
    state = init_opt_state(dict(net.named_parameters()), opt_cfg)
    n_comp = sum(cpol.mode_for(k, p.numel()) != "dense"
                 for k, p in net.named_parameters())
    packs, unpacks = mesh_rank_launches(topology, n, 1, rank)
    per_node = SSGD_PER_NODE[mname]
    want = {"nsd_quant": per_node["nsd_quant"] + n_comp * packs,
            "bsp_matmul_int8": per_node["bsp_matmul_int8"],
            "levels_compact": n_comp * packs, "levels_expand": n_comp * unpacks}
    cuda = dev.type == "cuda"
    spans = []
    real_span = ssgd_mod.annotate

    @contextlib.contextmanager
    def timed_span(name):
        if not cuda:
            with real_span(name):
                yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with real_span(name):
            a.record()
            yield
            b.record()
        spans.append((name.split("/")[-1], a, b))

    loader = ShardedLoader(lambda i: classification_batch(
        data, i, node_batch * n, device="cpu"), mesh=mesh, device=dev)
    rows = []
    ssgd_mod.annotate = timed_span
    try:
        for i in range(steps):
            _, batch = next(loader)
            sync()
            spans.clear()
            TRAFFIC.reset()
            build.reset_launches()
            t0 = time.perf_counter()
            m, _ = step(state, batch, SEED)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            got = dict(build.LAUNCHES)
            label = f"15b {mname} {topology} N={n} rank {rank} step {i}"
            if cuda:
                check(nonzero(got) == want,
                      f"{label}: launches {nonzero(got)}, want {want}")
            sim = spec["ssgd"][i]
            for k, p in net.named_parameters():
                p = p.detach().cpu()
                check(torch.equal(p, sim["params"][k]),
                      f"{label}: parameter {k} differs from 6b's simulated step "
                      f"(max |diff| {float((p - sim['params'][k]).abs().max())})")
            mine = host_state(torch, net, state)["state"]
            for k, v in sim["state"].items():
                same_v = (torch.equal(mine[k], v) if isinstance(v, torch.Tensor)
                          else mine[k] == v)
                check(same_v, f"{label}: optimizer state {k} differs")
            rows.append({"ms": wall, "launches": got,
                         "spans": {nm: a.elapsed_time(b) for nm, a, b in spans},
                         "pack_bytes": TRAFFIC.pack_bytes,
                         "dense_bytes": TRAFFIC.dense_bytes,
                         "loss": float(m["loss"]),
                         "comm_wire_bytes": float(m["comm_wire_bytes"])})
    finally:
        ssgd_mod.annotate = real_span
        loader.close()
    return {("15b",): rows}


def phase15(torch, card, dev):
    """Phase 15: data-parallel over processes. 15a and 15b spawn
    ``MESH_WORLD`` gloo ranks on ``dev`` (the ranks share the card); 15c
    runs the launcher with ``--distributed`` at world size 1 on NCCL.
    Returns the launches of each path by kernel (summed over the ranks),
    for the kernels line."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch import comm
    from repro_torch.launch import train as lm_train

    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    # 15a's inputs and the one-process simulation of each reduce
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    grads = {name: torch.randn((MESH_WORLD,) + shape, device=dev, generator=gen) * 1e-2
             for name, shape in REDUCE_LEAVES.items()}
    sims = []
    for topology, n, pods in MESH_REDUCES:
        pol = comm.CommPolicy(s=2.0, topology=topology, pods=pods,
                              overrides=REDUCE_OVERRIDES)
        g = {k: v[:n].contiguous() for k, v in grads.items()}
        means, tele, _ = comm.reducer(pol, n_nodes=n).reduce(g, SEED, 1)
        sims.append({"means": {k: v.cpu() for k, v in means.items()},
                     "tele": {f: float(getattr(tele, f)) for f in REDUCE_TELEMETRY},
                     "hops": (tele.n_hops, tele.packs_per_segment)})
    check(len(SIM_SSGD_STEPS) == MESH_SSGD[3],
          f"15b: phase 6b left {len(SIM_SSGD_STEPS)} simulated steps")
    spec = os.path.join(scratch, "spec.pt")
    torch.save({"device": str(dev), "grads": {k: v.cpu() for k, v in grads.items()},
                "reduces": MESH_REDUCES, "sims": sims, "ssgd_run": MESH_SSGD,
                "node_batch": SSGD_NODE_BATCH, "ssgd": SIM_SSGD_STEPS}, spec)
    del grads
    t0 = time.perf_counter()
    try:
        mp.spawn(phase15_rank, args=(MESH_WORLD, os.path.join(scratch, "store"),
                                     spec, scratch), nprocs=MESH_WORLD, join=True)
    except Exception as e:  # a rank's failure fails the phase
        errs = {r: open(os.path.join(scratch, f"rank{r}.err")).read()
                for r in range(MESH_WORLD)
                if os.path.exists(os.path.join(scratch, f"rank{r}.err"))}
        # the rank that failed first, not those its exit disconnected
        first = [t for t in errs.values() if "Connection closed by peer" not in t]
        raise SmokeFailure(f"phase 15: a rank failed: "
                           f"{(first or list(errs.values()) or [str(e)])[0]}") from e
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(scratch, f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_WORLD)]
    path_launches = {}
    for (topology, n, pods), sim in zip(MESH_REDUCES, sims):
        res = [ranks[r][("15a", topology, n, pods)] for r in range(n)]
        dense = sum(float(comm.reducer(comm.CommPolicy(
                        s=2.0, topology=topology, pods=pods,
                        overrides=REDUCE_OVERRIDES), n_nodes=n)._topo_dense_bytes(
                        math.prod(shape)))
                    for k, shape in REDUCE_LEAVES.items()
                    if comm.CommPolicy(overrides=REDUCE_OVERRIDES).mode_for(
                        k, math.prod(shape)) == "dense")
        received = sum(r["pack_bytes"] for r in res)
        check(received == sim["tele"]["wire_bytes"] - dense,
              f"15a {topology} N={n}: the ranks received {received} B of packs, "
              f"the telemetry counts {sim['tele']['wire_bytes'] - dense}")
        total = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
        path_launches[f"dp-process reduce {topology} N={n} pods={pods} "
                      f"(phase 6a leaves, all ranks)"] = total
        log(f"phase 15a: {topology} N={n} pods={pods} over {n} gloo ranks on "
            f"{dev}: every rank's means, wire, dense, ICI, DCN and peak-DCN "
            f"bytes, bound, hops and packs_per_segment equal the one-process "
            f"simulation's bit for bit (wire_bytes {sim['tele']['wire_bytes']}, "
            f"error_bound {sim['tele']['error_bound']}); packs received "
            f"{received} B = wire_bytes less the dense leaves' {dense} B "
            f"(dense leaves gathered: {sum(r['dense_bytes'] for r in res)} B); "
            f"per rank ms {[round(r['ms'], 3) for r in res]}, launches "
            f"{[nonzero(r['launches']) for r in res]} ({card})")
    mname, n, topology, steps = MESH_SSGD
    rows = [ranks[r][("15b",)] for r in range(n)]
    total = {k: sum(rows[r][i]["launches"][k] for r in range(n) for i in range(steps))
             for k in rows[0][0]["launches"]}
    path_launches[f"dp-process ssgd {mname} {topology} N={n} kernel "
                  f"(all ranks)"] = total
    for i in range(steps):
        log(f"phase 15b: {mname} {topology} N={n} kernel step {i}: every rank's "
            f"parameters and momenta equal 6b's simulated step bit for bit; loss "
            f"{rows[0][i]['loss']:.5f}; per rank host ms "
            f"{[round(rows[r][i]['ms'], 3) for r in range(n)]}, spans (CUDA events) "
            f"{[{k: round(v, 3) for k, v in rows[r][i]['spans'].items()} for r in range(n)]}, "
            f"packs received {[rows[r][i]['pack_bytes'] for r in range(n)]} B "
            f"(sum {sum(rows[r][i]['pack_bytes'] for r in range(n))}, "
            f"comm_wire_bytes {rows[0][i]['comm_wire_bytes']}), dense "
            f"{[rows[r][i]['dense_bytes'] for r in range(n)]} B; launches per rank "
            f"{[nonzero(rows[r][i]['launches']) for r in range(n)]} ({card})")
    log(f"phase 15a/b: {MESH_WORLD} ranks spawned, run and joined in "
        f"{spawn_s:.1f} s ({card})")

    # -- 15c: the launcher's --distributed at world size 1 on NCCL
    t0 = time.perf_counter()
    plain = lm_train.main(MESH_LM_ARGS)
    plain_s = time.perf_counter() - t0
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parent / "src"),
                    str(Path(__file__).resolve().parent)]))
    out_json = os.path.join(scratch, "dist.json")
    # the launcher's main, as ``python -m repro_torch.launch.train`` runs
    # it, with the losses written out unrounded
    code = ("import json, sys; import chip_smoke; "
            "from repro_torch.launch import train; "
            "t = train.main(sys.argv[2:]); a = sys.argv; "
            "m = chip_smoke.nccl_mesh_check("
            "a[a.index('--device') + 1] if '--device' in a else None); "
            "json.dump([[h['loss'] for h in t.history], m], "
            "open(sys.argv[1], 'w'))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, out_json, *MESH_LM_ARGS,
                           "--distributed"], env=env, capture_output=True,
                          text=True, timeout=600)
    dist_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"15c: --distributed failed: {proc.stderr[-2000:]}")
    got, nccl_mesh = json.load(open(out_json))
    want = [h["loss"] for h in plain.history]
    check(got == want, f"15c: losses {got} vs {want}")
    joined = ("distributed: nccl rank 0 of 1 on cuda:0" if dev.type == "cuda"
              else "distributed: gloo rank 0 of 1 on cpu")
    check(joined in proc.stderr, f"15c: no {joined!r} in its log")
    log(f"phase 15c: python -m repro_torch.launch.train {' '.join(MESH_LM_ARGS)} "
        f"--distributed (RANK=0 WORLD_SIZE=1 LOCAL_RANK=0): '{joined}', "
        f"losses {got} equal to the run without the flag; "
        f"{dist_s:.1f} s in its own process, {plain_s:.1f} s in this one ({card})")
    log(f"phase 15c: a NodeMesh on {nccl_mesh['backend']} at world size 1 "
        f"(on NCCL it runs one barrier first) reduced phase 6a's leaves under "
        f"{nccl_mesh['topologies']} equal to the one-process reduce of the one "
        f"node bit for bit (means and wire_bytes); NCCL meshes of more than one "
        f"rank cannot run on this one-card machine ({card})")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s ({card})")
    return path_launches


def phase16(torch, card, dev, plain_kernels):
    """Phase 16: the trainer's gradient wire on gemma-2b at full width
    through the launcher. 16a: 7a's program with ``comm:
    default=nsd;s=2.0;stats=1``: each step's launches (7a's plus an NSD, a
    wire compact and a wire expand a leaf), host ms, loss beside 7a's,
    wire and dense bytes (the comm telemetry's row a step, totals equal
    to the history's), the peak device memory; then step 2's gradients
    reduced on the kernel route and on the plain versions' route, every
    pack's levels, bitmap, deltas and nnz and the reduced gradients bit for
    bit. 16b: the same model (built once) for 2 steps under ``quant:
    wire=int4@g32``: no launch, the wire bytes the codec's measured bytes.
    16c: ``comm: default=topk_ef;topk_frac=0.01`` at the smoke preset with
    ``--ckpt-dir``: a trainer resumed from step 2 ends with the straight
    run's parameters, moments and error-feedback residuals bit for bit.
    Returns the launches of each run by kernel, for the kernels line."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import comm, quant
    from repro_torch.data import ShardedLoader
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as lm_train
    from repro_torch.train import list_steps
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.utils.pytree import flatten_with_names

    t_phase = time.perf_counter()
    seen, parts = [], {}
    real_step, real_grads = trainer_mod.Trainer.train_step, trainer_mod.Trainer.grads
    real_comm, real_update = trainer_mod.Trainer.comm, trainer_mod.apply_updates

    def timed_step(self, batch, step):
        torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        out = real_step(self, batch, step)
        torch.cuda.synchronize()
        seen.append((step, (time.perf_counter() - t0) * 1e3, float(out["loss"]),
                     float(out["comm_wire_bytes"]), float(out["comm_dense_bytes"]),
                     {k: v - before[k] for k, v in build.LAUNCHES.items()
                      if v != before[k]}))
        return out

    def timed(fn, part):
        """``fn`` with its host time between device syncs appended to
        ``parts[part]``: the step's backward, wire and update."""
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts.setdefault(part, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def run(train, label):
        """``train()`` with every step timed: the launches, the peak device
        memory above what was held before, and that."""
        seen.clear()
        parts.clear()
        ops.KERNEL_FALLBACKS.clear()
        build.reset_launches()
        comm.telemetry.reset()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer_mod.Trainer.train_step = timed_step
        trainer_mod.Trainer.grads = timed(real_grads, "grads")
        trainer_mod.Trainer.comm = timed(real_comm, "comm")
        trainer_mod.apply_updates = timed(real_update, "update")
        try:
            trainer = train()
        finally:
            trainer_mod.Trainer.train_step = real_step
            trainer_mod.Trainer.grads = real_grads
            trainer_mod.Trainer.comm = real_comm
            trainer_mod.apply_updates = real_update
        torch.cuda.synchronize()
        check(not ops.KERNEL_FALLBACKS, f"{label}: fallbacks {ops.KERNEL_FALLBACKS}")
        return (trainer, dict(build.LAUNCHES),
                torch.cuda.max_memory_allocated() - held, held)

    # -- 16a: 7a's run with the NSD wire ----------------------------------
    argv = LM_ARGS + ["--steps", str(LM_STEPS), "--program",
                      f"{LM_PROGRAM} {LM_COMM}"]
    log(f"phase 16a: python -m repro_torch.launch.train {' '.join(argv)}")
    t0 = time.perf_counter()
    trainer, total_a, peak, held = run(lambda: lm_train.main(argv), "16a")
    seconds = time.perf_counter() - t0
    leaves = trainer_mod.wire_leaves({n: p.detach().to("meta")
                                      for n, p in trainer.params.items()})
    packed = sorted(n for n, t in leaves.items()
                    if t.numel() >= trainer.comm_policy.min_leaf_size)
    check(len(packed) == LM_WIRE_LEAVES, f"16a: {len(packed)} leaves on the wire")
    per_leaf = {"nsd_quant": LM_WIRE_LEAVES, "levels_compact": LM_WIRE_LEAVES,
                "levels_expand": LM_WIRE_LEAVES}
    dense = 4.0 * LM_PARAMS
    check(len(seen) == len(LM_7A_STEPS) == LM_STEPS, f"16a: {len(seen)} steps")
    check(all(len(parts.get(k, ())) == LM_STEPS for k in ("grads", "comm", "update")),
          f"16a: timed parts {({k: len(v) for k, v in parts.items()})}")
    for (step, ms, loss, wire, dense_b, launched), (_, ms7, loss7, _), gms, cms, ums in zip(
            seen, LM_7A_STEPS, parts["grads"], parts["comm"], parts["update"]):
        want = dict(per_leaf)
        if step >= LM_FIRST_KERNEL_STEP:
            want = {k: want.get(k, 0) + LM_KERNEL_STEP.get(k, 0)
                    for k in set(want) | set(LM_KERNEL_STEP)}
        check(launched == want, f"16a step {step}: launches {launched}, want {want}")
        check(math.isfinite(loss), f"16a step {step}: loss {loss}")
        check(math.isclose(dense_b, dense, rel_tol=1e-6) and 0 < wire < dense_b,
              f"16a step {step}: wire {wire} B, dense {dense_b} B")
        log(f"phase 16a step {step}: {ms:.3f} ms on the host clock (7a {ms7:.3f}; "
            f"the backward {gms:.3f}, the wire {cms:.3f}, the update {ums:.3f} ms), loss {loss:.4f} (7a {loss7:.4f}), launches "
            f"{launched}, wire "
            f"{wire:.0f} B of dense {dense_b:.0f} B (ratio {wire / dense_b:.5f}; "
            f"{comm.telemetry.wire_seconds(wire) * 1e3:.3f} ms on one NVLink at its "
            f"450 GB/s spec rate)")
    check(seen[0][2] == LM_7A_STEPS[0][2], "16a: step 0's loss differs from 7a's")
    summ, tot = comm.telemetry.summary(), comm.telemetry.totals()
    check(list(summ) == ["comm/"] and tot.n_records == LM_STEPS,
          f"16a: comm telemetry {summ}")
    wires = [w for _, _, _, w, _, _ in seen]
    check(math.isclose(tot.wire_bytes, sum(wires), rel_tol=1e-6),
          f"16a: telemetry wire {tot.wire_bytes} vs steps {sum(wires)}")
    check([r["comm_wire_mb"] for r in trainer.history] == [w / 1e6 for w in wires],
          "16a: the history's comm_wire_mb differs from the steps' wire bytes")
    ms = [m for _, m, _, _, _, _ in seen]
    log(f"phase 16a: {len(packed)} leaves on the wire {packed}; {seconds:.1f} s "
        f"for {LM_STEPS} steps with the model's build; off steps {ms[1]:.3f} ms, "
        f"kernel steps {min(ms[3:]):.3f}-{max(ms[3:]):.3f} ms; wire/dense "
        f"{tot.ratio:.5f} over the run; peak device memory "
        f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before "
        f"(7a in phase 7's log); launches over the run {nonzero(total_a)} ({card})")

    # step 2's gradients through the wire on both routes
    net = trainer.net
    trainer.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = TokenStreamConfig(vocab=trainer.model.cfg.vocab, seq_len=128, batch=8)
    for p in net.parameters():
        p.grad = None
    trainer.grads(token_batch(tcfg, LM_FIRST_KERNEL_STEP, device=dev),
                  LM_FIRST_KERNEL_STEP)
    g = trainer_mod.wire_leaves({n: p.grad for n, p in trainer.params.items()})
    for p in net.parameters():
        p.grad = None
    tele, packs, launched = reduce_both_routes(
        torch, plain_kernels, trainer._reducer, g, "16a step 2",
        key=trainer.comm_key, step=LM_FIRST_KERNEL_STEP)
    check(launched == {**{k: 0 for k in build.LAUNCHES}, **per_leaf},
          f"16a step 2: the reduce launched {nonzero(launched)}")
    check(len(packs) == len(packed), f"16a step 2: {len(packs)} packs")
    log(f"phase 16a: step {LM_FIRST_KERNEL_STEP}'s reduce bit for bit between the "
        f"kernel and plain routes over {len(packs)} packs (levels, bitmap, "
        f"deltas, nnz, the reduced gradients); non-zero k by leaf "
        + ", ".join(f"{n} {int(p.nnz.sum())} of {g[n].numel()}"
                    for n, p in zip(packed, packs))
        + f"; wire {float(tele.wire_bytes):.0f} B ({card})")
    del g, packs, tele
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16b: int4 on the wire, the same model ----------------------------
    argv = LM_ARGS + ["--steps", str(LM_WIRE_STEPS), "--program",
                      f"{LM_PROGRAM} quant: wire={LM_WIRE_CODEC}"]
    log(f"phase 16b: python -m repro_torch.launch.train {' '.join(argv)} "
        f"(on 16a's model)")
    trainer, batches = lm_train.build(lm_train.parse_args(argv), dev)
    check(trainer.comm_policy.default == LM_WIRE_CODEC,
          f"16b: comm policy {trainer.comm_policy}")
    _, total_b, peak_b, _ = run(lambda: trainer.fit(batches, params=net), "16b")
    # the codec's measured bytes are its static capacity, added in f32 in
    # the leaves' order
    want = np.float32(0)
    for name in sorted(leaves):
        t = leaves[name]
        dense_leaf = trainer.comm_policy.mode_for(name, t.numel()) == "dense"
        want = np.float32(want + np.float32(
            4 * t.numel() if dense_leaf else
            quant.stored_nbytes(LM_WIRE_CODEC, t.shape, torch.float32)))
    for (step, ms, loss, wire, dense_b, launched), cms in zip(seen, parts["comm"]):
        check(not launched, f"16b step {step}: launches {launched}")
        check(wire == float(want) and math.isfinite(loss),
              f"16b step {step}: wire {wire} B, want {float(want)}; loss {loss}")
        log(f"phase 16b step {step}: {ms:.3f} ms on the host clock (the wire "
            f"{cms:.3f} ms), loss "
            f"{loss:.4f}, wire {wire:.0f} B of dense {dense_b:.0f} B (ratio "
            f"{wire / dense_b:.5f}), launches {launched}")
    log(f"phase 16b: peak device memory {peak_b / 2**30:.2f} GiB ({card})")
    del trainer, net, batches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16c: topk_ef at the smoke preset, a 2 + 2 resume ------------------
    scratch = tempfile.mkdtemp(prefix="chip_smoke_16c_")
    d_run, d_resume = os.path.join(scratch, "run"), os.path.join(scratch, "resume")
    argv = ["--arch", "gemma-2b", "--preset", "smoke", "--batch",
            str(LM_RESUME_BATCH), "--seq", str(LM_RESUME_SEQ), "--program",
            f"{LM_PROGRAM} {LM_TOPK_COMM}", "--device", str(dev),
            "--ckpt-every", "2"]
    build.reset_launches()
    straight = lm_train.main(argv + ["--steps", "4", "--ckpt-dir", d_run])
    total_c = dict(build.LAUNCHES)
    check(list_steps(d_run) == [2, 4], f"16c: checkpoints {list_steps(d_run)}")
    os.makedirs(d_resume)
    shutil.copytree(os.path.join(d_run, "step_00000002"),
                    os.path.join(d_resume, "step_00000002"))
    resumed, _ = lm_train.build(lm_train.parse_args(
        argv + ["--steps", "4", "--ckpt-dir", d_resume]))
    tcfg = TokenStreamConfig(vocab=resumed.model.cfg.vocab, seq_len=LM_RESUME_SEQ,
                             batch=LM_RESUME_BATCH)
    loader = ShardedLoader(lambda s: token_batch(tcfg, s, device="cpu"),
                           start_step=2, device=dev)
    try:
        resumed.fit(loader)
    finally:
        loader.close()
    check(resumed.opt_state["step"] == straight.opt_state["step"] == 4,
          "16c: the runs did not end at step 4")
    a, b = ([(n, x) for n, x in flatten_with_names(
        {"params": t.params, "opt": t.opt_state, "comm": t._comm_state})]
        for t in (straight, resumed))
    check([n for n, _ in a] == [n for n, _ in b], "16c: state names differ")
    residuals = sorted({n.split("/.")[0][len("comm/"):] for n, _ in a
                        if n.startswith("comm/")})
    topk = sorted(n for n, t in trainer_mod.wire_leaves(
        {n: p.detach() for n, p in resumed.params.items()}).items()
        if t.numel() >= resumed.comm_policy.min_leaf_size)
    check(residuals == topk, f"16c: residuals {residuals}, want {topk}")
    for (name, x), (_, y) in zip(a, b):
        ok = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        check(ok, f"16c: {name} of the resumed run differs from the straight run's")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 16c: python -m repro_torch.launch.train {' '.join(argv)} --steps 4 "
        f"--ckpt-dir DIR, and a Trainer resumed from step 2: step-4 parameters, "
        f"moments and {len(residuals)} error-feedback residuals equal bit for "
        f"bit over {len(a)} leaves; launches of the straight run "
        f"{nonzero(total_c)} ({card})")
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {f"gemma-2b comm nsd {LM_STEPS} steps ({LM_FIRST_KERNEL_STEP} off)": total_a,
            f"gemma-2b quant: wire={LM_WIRE_CODEC} {LM_WIRE_STEPS} steps": total_b,
            "gemma-2b smoke comm topk_ef 4 steps": total_c}


def nccl_mesh_check(device=None):
    """15c's second half, in the launcher's process after its run: one
    ``NodeMesh`` over the process group of torchrun's environment (NCCL on
    the card, world size 1; gloo when ``device`` is the CPU), phase 6a's
    leaves reduced over it under ``ps`` and ``ring``, each held bit for bit
    against the one-process reduce of the same one node. Returns the
    backend and the topologies."""
    import torch
    import torch.distributed as dist

    from repro_torch import comm
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.mesh import NodeTopology

    dev = lm_train.init_distributed(device)
    try:
        mesh = NodeTopology.flat(1).mesh()
        gen = torch.Generator(device=dev).manual_seed(SEED + 15)
        grads = {k: torch.randn(shape, device=dev, generator=gen) * 1e-2
                 for k, shape in REDUCE_LEAVES.items()}
        done = []
        for topology in ("ps", "ring"):
            pol = comm.CommPolicy(s=2.0, topology=topology,
                                  overrides=REDUCE_OVERRIDES)
            got, tele, _ = comm.reducer(pol, mesh).reduce(grads, SEED, 1)
            want, wtele, _ = comm.reducer(pol, n_nodes=1).reduce(
                {k: v[None] for k, v in grads.items()}, SEED, 1)
            for k in grads:
                check(torch.equal(got[k], want[k]),
                      f"15c: {topology} over the NCCL mesh: {k} differs")
            check(float(tele.wire_bytes) == float(wtele.wire_bytes),
                  f"15c: {topology} over the NCCL mesh: wire_bytes "
                  f"{float(tele.wire_bytes)} vs {float(wtele.wire_bytes)}")
            done.append(topology)
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "topologies": done}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch

    # -- phase 1 ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.int8 import absmax_int8
    from repro_torch.kernels import build, bsp_matmul, levels, nsd_quant, ops, pack
    from repro_torch.quant import wire

    # every wrapper, its module and its plain version
    modules = {"nsd_quant": (nsd_quant, "nsd_quantize"),
               "bitmap_pack": (pack, "bitmap_pack_blocked"),
               "bsp_matmul_int8": (bsp_matmul, "bsp_matmul_int8"),
               "bitmap_unpack": (pack, "bitmap_unpack"),
               "levels_compact": (levels, "levels_compact_wire"),
               "levels_expand": (levels, "levels_expand_wire"),
               "bsp_matmul_dequant": (bsp_matmul, "bsp_matmul"),
               "philox_uniform": (nsd_quant, "philox_uniform")}
    kernel = {k: getattr(m, a) for k, (m, a) in modules.items()}
    plain = {k: getattr(m, a + "_plain") for k, (m, a) in modules.items()}

    @contextlib.contextmanager
    def swapped(fns):
        """Route the named wrappers through other functions for a while."""
        saved = {k: getattr(*modules[k]) for k in fns}
        for k, fn in fns.items():
            setattr(*modules[k], fn)
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(*modules[k], fn)

    def plain_kernels():
        """Route the ops through the kernels' plain versions (on the card)."""
        return swapped(plain)

    # -- phase 2 ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"phase 2: built the kernels in {time.perf_counter() - t0:.1f} s")

    max_err = {k: 0.0 for k in modules}

    def same(kname, got, want, what):
        for g, w in zip(got, want):
            if g is None or w is None:  # an output not asked for (the bitmap)
                check(g is None and w is None, f"{kname} {what}: one output missing")
                continue
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{kname} {what}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            err = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
            max_err[kname] = max(max_err[kname], err)
            check(torch.equal(g, w), f"{kname} {what}: differs from the plain "
                                     f"version (max abs err {err})")

    def banded(kname, got, want, K, what):
        """got within the f32 band of want (a K-long contraction); exact
        zeros where want is all zero (an empty mask)."""
        check(got.shape == want.shape, f"{kname} {what}: {got.shape} vs {want.shape}")
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        max_err[kname] = max(max_err[kname], err)
        ref = float(want.double().norm())
        if ref == 0.0:
            check(not got.any(), f"{kname} {what}: non-zero output, want zeros")
            return 0.0
        rel = float((got.double() - want.double()).norm()) / ref
        check(rel <= f32_band(K), f"{kname} {what}: relative L2 {rel} > "
                                  f"{f32_band(K)} (K = {K})")
        return rel

    # -- phase 3 ----------------------------------------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    key = 0x9E3779B97F4A7C15
    for name, (T, N) in COTANGENTS.items():
        g = torch.randn(T, N, device=dev, generator=gen) * 1e-3
        for s in (2.0, 0.0):
            delta = (s * torch.std(g, correction=0)).reshape(())
            nu = nsd_quant.philox_uniform_plain(key, (T, N), device=dev) * delta
            what = f"{name} delta={'0' if s == 0 else 's*std'}"
            got = nsd_quant.nsd_quantize(g, delta, key=key)
            same("nsd_quant", got, nsd_quant.nsd_quantize_plain(g, delta, key=key),
                 f"{what} key route")
            fed = nsd_quant.nsd_quantize(g, delta, noise=nu)
            same("nsd_quant", fed, nsd_quant.nsd_quantize_plain(g, delta, noise=nu),
                 f"{what} fed route")
            same("nsd_quant", fed, got, f"{what}: fed draw against the key")
            same("nsd_quant", got[1:], pack.bitmap_pack_blocked_plain(got.k),
                 f"{what}: bitmap, nnz, mask against the pack's")
            check(not got.k[T:].any() and not got.k[:, N:].any(),
                  f"nsd_quant {what}: non-zero padding")
        same("philox_uniform", (nsd_quant.philox_uniform(key, (T, N), device=dev),),
             (nsd_quant.philox_uniform_plain(key, (T, N), device=dev),), name)
    # c0's padded k (the largest pack the path would run), and c1 and c5
    # with an empty tile; the int8 matmul on c1's and c5's k
    kc0 = nsd_quant.nsd_quantize(torch.randn(131072, 64, device=dev, generator=gen),
                                 torch.tensor(2.0, device=dev), key=key).k
    same("bitmap_pack", pack.bitmap_pack_blocked(kc0), pack.bitmap_pack_blocked_plain(kc0),
         "c0")
    del kc0
    # (T, K_in, N_out) padded to 128: c1 (16x16x64 -> 128), c5 (4x4x512 -> 512)
    for name, (T, K, N) in {"c1": (32768, 640, 128), "c5": (2048, 4608, 512)}.items():
        g = torch.randn(T, N, device=dev, generator=gen) * 1e-3
        x = torch.randn(T, K, device=dev, generator=gen)
        w = torch.randn(K, N, device=dev, generator=gen)
        delta = 2.0 * torch.std(g, correction=0)
        k = nsd_quant.nsd_quantize(g, delta, key=key).k
        k[:128, :128] = 0  # an empty tile
        same("bitmap_pack", pack.bitmap_pack_blocked(k),
             pack.bitmap_pack_blocked_plain(k), name)
        _, _, mask = pack.bitmap_pack_blocked(k)
        check(int(mask[0, 0]) == 0, "empty tile not masked")
        xq = absmax_int8(x).q
        wq = absmax_int8(w).q
        scale = delta * 1e-2
        for mname, m in (("bitmap", mask), ("full", torch.ones_like(mask)),
                         ("empty", torch.zeros_like(mask))):
            for ta, b in ((False, wq), (True, xq)):
                args = (k, b, scale, m)
                kw = dict(trans_a=ta, trans_b=not ta)
                same("bsp_matmul_int8", (bsp_matmul.bsp_matmul_int8(*args, **kw),),
                     (bsp_matmul.bsp_matmul_int8_plain(*args, **kw),),
                     f"{name} {'dW' if ta else 'dx'} mask={mname}")
    torch.cuda.synchronize()
    log(f"phase 3: kernels bit-exact against their plain versions "
        f"(max abs err {max(max_err.values())}); NSD on both routes at "
        f"{', '.join(f'{n} {t}x{c}' for n, (t, c) in COTANGENTS.items())}")

    # -- phase 3b ---------------------------------------------------------
    def sparse_levels(C, density):
        vals = torch.randint(1, 128, (C, 256), device=dev, generator=gen)
        sign = torch.randint(0, 2, (C, 256), device=dev, generator=gen) * 2 - 1
        keep = torch.rand((C, 256), device=dev, generator=gen) < density
        return torch.where(keep, vals * sign, 0).to(torch.int8)

    # c1's residual at batch 128 (128 x 16 x 16 x 64 = 8,192 chunks) at the
    # non-zero share NSD gives at s = 1, an all-zero and an all-non-zero chunk
    k = sparse_levels(8192, 0.6)
    k[0] = 0
    k[1] = sparse_levels(1, 1.0)[0]
    for what, kk in (("c1 residual", k), ("one chunk", sparse_levels(1, 0.4))):
        got = levels.levels_compact(kk)
        same("levels_compact", got, levels.levels_compact_plain(kk), what)
        mask = (kk != 0).to(torch.int8)
        out = levels.levels_expand(got[0], mask)
        same("levels_expand", (out,), (levels.levels_expand_plain(got[0], mask),), what)
        check(torch.equal(out, kk), f"levels_expand {what}: not the inverse of compact")
        bitmap = pack.bitmap_pack_blocked(torch.nn.functional.pad(
            kk, (0, 0, 0, (-kk.shape[0]) % 128)))[0][:kk.shape[0]]
        unpacked = pack.bitmap_unpack(bitmap)
        same("bitmap_unpack", (unpacked,), (pack.bitmap_unpack_plain(bitmap),), what)
        check(torch.equal(unpacked, mask), f"bitmap_unpack {what}: not the mask")
    counts = levels.levels_compact(k)[1]
    check(int(counts[0]) == 0 and int(counts[1]) == 256, "edge chunk counts")
    # the wire kernels: the whole chunk stream in one launch each way
    # (2^18 chunks: 8,192 blocks, more than the card holds at once)
    for what, kk in (("c1 residual", k), ("all-zero c1 residual", torch.zeros_like(k)),
                     ("all-non-zero c1 residual", sparse_levels(8192, 1.0)),
                     ("one chunk", sparse_levels(1, 0.4)),
                     ("2^18 chunks", sparse_levels(1 << 18, 0.6))):
        got = levels.levels_compact_wire(kk)
        same("levels_compact", got, levels.levels_compact_wire_plain(kk), f"wire {what}")
        check(int(got[2]) == int((kk != 0).sum()), f"levels_compact wire {what}: nnz")
        out = levels.levels_expand_wire(got[0], got[1])
        same("levels_expand", (out,), (levels.levels_expand_wire_plain(got[0], got[1]),),
             f"wire {what}")
        check(torch.equal(out, kk), f"levels_expand wire {what}: not the inverse of compact")
    del got, out, kk
    # the paged expand: a stack of wire containers, the ids in the grid;
    # gemma-2b's KV pages (16 x 1 x 256 f32: 16 chunks), the 8 x 8 pages of
    # a layer's view and a 4,096-page stack, and 1- and 40-chunk pages
    for what, (n_pg, c_pg, m_pg) in (("gemma-2b pages", (64, 16, 64)),
                                     ("4096 pages", (4096, 16, 4096)),
                                     ("1-chunk pages", (9, 1, 17)),
                                     ("40-chunk pages", (20, 40, 33))):
        kk = sparse_levels(n_pg * c_pg, 0.6).reshape(n_pg, c_pg, 256)
        kk[0] = 0
        kk[1] = sparse_levels(c_pg, 1.0)
        lv_pg = torch.empty(n_pg, c_pg * 256, dtype=torch.int8, device=dev)
        bm_pg = torch.empty(n_pg, c_pg, 32, dtype=torch.uint8, device=dev)
        for i in range(n_pg):
            lv_pg[i], bm_pg[i], _ = levels.levels_compact_wire_plain(kk[i])
        ids = torch.randint(0, n_pg, (m_pg,), device=dev, generator=gen)
        ids[:3] = torch.tensor([0, 1, 1], device=dev)  # repeated ids
        out = levels.levels_expand_pages(lv_pg, bm_pg, ids)
        same("levels_expand", (out,),
             (levels.levels_expand_pages_plain(lv_pg, bm_pg, ids),), f"paged {what}")
        check(torch.equal(out, kk[ids.long()]), f"levels_expand paged {what}: "
                                                f"not the inverse of compact")
    del kk, out, lv_pg, bm_pg
    for n in (1000, 2_097_152):  # not a chunk multiple; c1's residual size
        xr = torch.relu(torch.randn(n, device=dev, generator=gen))
        ur = torch.rand(n, device=dev, generator=gen) - 0.5
        for noise in (ur, 12345):  # fed, and the stream key's draw
            pk = wire.pack_nsd(xr, noise, 1.0)
            pp = wire.pack_nsd(xr, noise, 1.0, backend="plain")
            for f in ("levels", "bitmap", "deltas", "nnz"):
                check(torch.equal(getattr(pk, f), getattr(pp, f)),
                      f"wire container n={n}: {f} differs from the plain route")
            check(torch.equal(wire.unpack_nsd(pk), wire.unpack_nsd(pp, backend="plain")),
                  f"wire decode n={n} differs from the plain route")

    # the dequant product at the c1 and c5 dx and dW shapes: (T, N, K_in)
    rels = []
    for name, (T, N, K) in {"c1": (32768, 128, 640), "c5": (2048, 512, 4608)}.items():
        kq = torch.where(torch.rand(T, N, device=dev, generator=gen) < 0.2,
                         torch.randint(-6, 7, (T, N), device=dev, generator=gen),
                         0).to(torch.int8)
        _, _, mask = pack.bitmap_pack_blocked(kq)
        w_t = torch.randn(N, K, device=dev, generator=gen)  # w^T, (N, K)
        x = torch.relu(torch.randn(T, K, device=dev, generator=gen))
        d = torch.tensor(3e-3, device=dev)
        partial = (torch.rand(mask.shape, device=dev, generator=gen) < 0.5).to(torch.int32)
        for mname, m in (("full", torch.ones_like(mask)), ("partial", partial),
                         ("empty", torch.zeros_like(mask))):
            for ta, b, contraction in ((False, w_t, N), (True, x, T)):
                got = bsp_matmul.bsp_matmul(kq, d, b, m, trans_a=ta)
                want = bsp_matmul.bsp_matmul_plain(kq, d, b, m, trans_a=ta)
                rels.append(banded("bsp_matmul_dequant", got, want, contraction,
                                   f"{name} {'dW' if ta else 'dx'} mask={mname}"))
    torch.cuda.synchronize()
    log(f"phase 3b: compact, expand (chunk-local, wire and paged) and unpack bit-exact "
        f"against their plain versions (max abs err "
        f"{max(max_err[k] for k in ('levels_compact', 'levels_expand', 'bitmap_unpack'))}), "
        f"wire container n=1000 and n=2097152 identical on both routes (fed and "
        f"key draws); dequant "
        f"within its band (worst relative L2 {max(rels):.3e}, max abs err "
        f"{max_err['bsp_matmul_dequant']:.3e})")

    # -- phase 4 ----------------------------------------------------------
    from repro_torch.configs.paper_models import vgg11_cifar
    from repro_torch.core import dithered
    from repro_torch.core.policy import DitherCtx, DitherPolicy
    from repro_torch.data.synthetic import ClassifConfig, classification_batch
    from repro_torch.memory.policy import as_memory_policy
    from repro_torch.models.cnn import CNN, loss_fn
    from repro_torch.obs import metrics
    from repro_torch.train.classifier import train_classifier

    cfg = vgg11_cifar()
    policy = DitherPolicy(variant="kernel", s=2.0, collect_stats=True)
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    res = train_classifier(cfg, policy, steps=STEPS, batch=BATCH, seed=SEED)
    launches = dict(build.LAUNCHES)
    log(f"phase 4: kernel path {json.dumps(res)}")
    log(f"phase 4: launches over {STEPS} steps {launches}")
    check(math.isfinite(res["final_loss"]), f"loss {res['final_loss']}")
    for kname, n in PER_STEP.items():
        check(launches[kname] == n * STEPS,
              f"{kname}: {launches[kname]} launches, want {n} x {STEPS}")
    check(not ops.KERNEL_FALLBACKS, f"fallbacks {ops.KERNEL_FALLBACKS}")

    with plain_kernels():
        build.reset_launches()
        res_plain = train_classifier(cfg, policy, steps=STEPS, batch=BATCH,
                                     seed=SEED)
        check(not any(build.LAUNCHES.values()), "plain run launched a kernel")
    log(f"phase 4: plain versions {json.dumps(res_plain)}")
    check(abs(res["sparsity"] - res_plain["sparsity"]) <= SPARSITY_BAND,
          f"sparsity {res['sparsity']} vs plain {res_plain['sparsity']}")

    dcfg = ClassifConfig(n_classes=cfg.n_classes, img_size=cfg.img_size,
                         channels=cfg.in_channels, noise=0.5, seed=SEED)
    batch0 = classification_batch(dcfg, 0, BATCH)

    def step1(memory=None, collect=False):
        """Step 1's loss, gradients and dither telemetry rows."""
        net = CNN(cfg, seed=SEED)
        ctx = DitherCtx(policy.replace(collect_stats=collect), seed=SEED,
                        step=0, memory=as_memory_policy(memory))
        metrics.reset()
        loss = loss_fn(net, batch0, ctx=ctx)
        loss.backward()
        rows = {t: metrics.rows(t) for t in metrics.tags()}
        return (float(loss.detach()),
                {n: p.grad for n, p in net.named_parameters()}, rows)

    def worst_rel(grads, ref_grads, what):
        worst = 0.0
        for n, gk in grads.items():
            check(bool(torch.isfinite(gk).all()), f"{what}: non-finite gradient {n}")
            ref = float(ref_grads[n].float().norm())
            rel = (float((gk.float() - ref_grads[n].float()).norm()) / ref if ref
                   else float(gk.float().norm()))
            worst = max(worst, rel)
            check(rel <= GRAD_BAND, f"{what}: step-1 gradient {n}: rel L2 {rel}")
        return worst

    loss_k, grads_k, _ = step1()
    with plain_kernels():
        loss_p, grads_p, _ = step1()
    worst = worst_rel(grads_k, grads_p, "fp32 residuals")
    log(f"phase 4: step-1 loss {loss_k} (plain {loss_p}); worst relative L2 "
        f"gradient difference kernel vs plain {worst}")

    # -- phase 4b: the same training with NSD-encoded residuals ------------
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    res_nsd = train_classifier(cfg, policy, steps=STEPS, batch=BATCH, seed=SEED,
                               memory=MEMORY)
    launches_nsd = dict(build.LAUNCHES)
    log(f"phase 4b: memory={MEMORY!r} kernel path {json.dumps(res_nsd)}")
    log(f"phase 4b: launches over {STEPS} steps {launches_nsd}")
    check(math.isfinite(res_nsd["final_loss"]), f"loss {res_nsd['final_loss']}")
    for kname, n in NSD_PER_STEP.items():
        check(launches_nsd[kname] == n * STEPS,
              f"{kname}: {launches_nsd[kname]} launches, want {n} x {STEPS}")
    check(not ops.KERNEL_FALLBACKS, f"fallbacks {ops.KERNEL_FALLBACKS}")
    check("residual_compression" in res_nsd, "no residual_compression in the result")
    with plain_kernels():
        build.reset_launches()
        res_nsd_plain = train_classifier(cfg, policy, steps=STEPS, batch=BATCH,
                                         seed=SEED, memory=MEMORY)
        check(not any(build.LAUNCHES.values()), "plain run launched a kernel")
    log(f"phase 4b: plain versions {json.dumps(res_nsd_plain)}")
    comp, comp_plain = res_nsd["residual_compression"], res_nsd_plain["residual_compression"]
    check(abs(comp - comp_plain) <= COMPRESSION_BAND * comp_plain,
          f"residual_compression {comp} vs plain {comp_plain}")
    check(abs(res_nsd["sparsity"] - res["sparsity"]) <= SPARSITY_BAND,
          f"sparsity {res_nsd['sparsity']} vs fp32 residuals {res['sparsity']}")

    loss_n, grads_n, _ = step1(MEMORY)
    with plain_kernels():
        _, grads_np, _ = step1(MEMORY)
    worst_n = worst_rel(grads_n, grads_np, "nsd residuals")
    _, grads_fc, rows_fc = step1(None, collect=True)
    _, grads_nc, rows_nc = step1(MEMORY, collect=True)
    moved = 0
    for n, g in grads_nc.items():
        if n.endswith("_w"):
            moved += not torch.equal(g, grads_fc[n])
        else:
            check(torch.equal(g, grads_fc[n]),
                  f"nsd residuals moved the BatchNorm/bias gradient {n}")
    check(rows_nc.keys() == rows_fc.keys() and all(
        (rows_nc[t] == rows_fc[t]).all() for t in rows_fc),
        "nsd residuals changed the dither telemetry")
    log(f"phase 4b: residual_compression {comp} (plain versions {comp_plain}); "
        f"step-1 loss {loss_n}; worst relative L2 gradient difference kernel vs "
        f"plain {worst_n}; BatchNorm/bias gradients and {len(rows_fc)} telemetry "
        f"rows identical to the fp32-residual step, {moved} of 11 weight "
        f"gradients moved; step time {res_nsd['ms_per_step']:.2f} ms vs "
        f"{res['ms_per_step']:.2f} ms with fp32 residuals ({card})")

    # -- phase 4c: the f32-operand backward (int8_operands=False) ----------
    captured = {}
    real_products = dithered._kernel_products

    def capturing(g2d, x2d, w, noise, pol, name, need_dx):
        # noise: the layer's stream key (an int)
        captured[name] = (g2d.detach().clone(), x2d.detach().clone(),
                          w.detach().clone(), noise, pol.s)
        return real_products(g2d, x2d, w, noise, pol, name, need_dx)

    dithered._kernel_products = capturing
    try:
        step1()
    finally:
        dithered._kernel_products = real_products
    check(len(captured) == 11, f"captured {len(captured)} layers")
    calls = {k: [] for k in KERNELS}

    def recorder(kname, fn, store=calls):
        def rec(*args, **kw):
            store[kname].append(([a.clone() if torch.is_tensor(a) else a
                                  for a in args], dict(kw)))
            return fn(*args, **kw)
        return rec

    build.reset_launches()
    with swapped({"bsp_matmul_dequant": recorder("bsp_matmul_dequant",
                                                 kernel["bsp_matmul_dequant"])}):
        outs = {n: ops.dithered_backward_matmuls(g, x, w, u, s, int8_operands=False)
                for n, (g, x, w, u, s) in captured.items()}
        torch.cuda.synchronize()
    launches_f32 = dict(build.LAUNCHES)
    for kname in build.LAUNCHES:
        want = F32_OPERAND_LAUNCHES.get(kname, 0)
        check(launches_f32[kname] == want,
              f"f32-operand backward: {kname} {launches_f32[kname]} launches, want {want}")
    worst_plain = worst_paper = 0.0
    for n, (g, x, w, u, s) in captured.items():
        with plain_kernels():
            dx_p, dw_p = ops.dithered_backward_matmuls(g, x, w, u, s,
                                                       int8_operands=False)
        q = ops.quantize_and_mask(g, u, s)
        gq = q.k[:g.shape[0], :g.shape[1]].to(torch.float32) * q.delta
        dx, dw = outs[n]
        T, N = g.shape
        for got, plain_v, paper_v, K, what in (
                (dx, dx_p, gq @ w.t(), N, "dx"), (dw, dw_p, x.t() @ gq, T, "dW")):
            worst_plain = max(worst_plain, banded(
                "bsp_matmul_dequant", got, plain_v, K, f"{n} {what} vs plain"))
            rel = float((got - paper_v).norm() / paper_v.norm())
            check(rel <= f32_band(K), f"{n} {what}: rel L2 {rel} against the paper "
                                      f"variant's f32 product")
            worst_paper = max(worst_paper, rel)
    log(f"phase 4c: f32-operand backward of the 11 layers: launches "
        f"{ {k: v for k, v in launches_f32.items() if v} }; worst relative L2 "
        f"against the plain versions {worst_plain:.3e}, against the paper "
        f"variant's f32 products {worst_paper:.3e}")
    del outs

    # -- phase 4d: the paper variant (its unit draws on the Philox kernel) --
    build.reset_launches()
    res_paper = train_classifier(cfg, policy.replace(variant="paper"), steps=STEPS,
                                 batch=BATCH, seed=SEED)
    launches_paper = dict(build.LAUNCHES)
    check(math.isfinite(res_paper["final_loss"]), f"loss {res_paper['final_loss']}")
    for kname in build.LAUNCHES:
        want = PAPER_PER_STEP.get(kname, 0) * STEPS
        check(launches_paper[kname] == want,
              f"paper variant: {kname} {launches_paper[kname]} launches, want {want}")
    log(f"phase 4d: paper variant {json.dumps(res_paper)}; launches over {STEPS} "
        f"steps { {k: v for k, v in launches_paper.items() if v} } ({card})")

    # -- phase 4e: the other five Table-1 models, variant=kernel -----------
    from repro_torch.configs import paper_models
    from repro_torch.train import table1

    def model_batch(mcfg, step=0):
        return classification_batch(ClassifConfig(
            n_classes=mcfg.n_classes, img_size=mcfg.img_size,
            channels=mcfg.in_channels, noise=0.5, seed=SEED), step, BATCH)

    def first_step(mcfg, pol, memory=None):
        """Step 1's loss and gradients of model ``mcfg`` under ``pol``, and
        the quantized cotangents (k, mask) of its layers."""
        net = CNN(mcfg, seed=SEED)
        ctx = DitherCtx(pol, seed=SEED, step=0, memory=as_memory_policy(memory))
        qs = []
        real_q = ops.quantize_and_mask

        def rec(*a, **kw):
            qs.append(real_q(*a, **kw))
            return qs[-1]

        ops.quantize_and_mask = rec
        try:
            loss = loss_fn(net, model_batch(mcfg), ctx=ctx)
            loss.backward()
        finally:
            ops.quantize_and_mask = real_q
        return (float(loss.detach()), {n: q.grad for n, q in net.named_parameters()},
                qs)

    def skipped_tiles(qs):
        """(live tiles whose mask is 0, live tiles) over quantized
        cotangents: a tile is live where it meets the unpadded (T, N)."""
        skipped = live = 0
        for q in qs:
            T, N = q.shape
            m = q.mask[:-(-T // 128), :-(-N // 128)]
            live += m.numel()
            skipped += int((m == 0).sum())
        return skipped, live

    model_launches = {}  # path -> its launches, for the kernels line
    kernel_pol = policy.replace(collect_stats=True)
    for mname, per_step in NEW_MODELS.items():
        t_model = time.perf_counter()
        mcfg = paper_models.MODELS[mname]()
        qs_run = []
        real_q = ops.quantize_and_mask

        def rec_run(*a, **kw):
            qs_run.append(real_q(*a, **kw))
            return qs_run[-1]

        ops.KERNEL_FALLBACKS.clear()
        build.reset_launches()
        ops.quantize_and_mask = rec_run
        try:
            res_m = train_classifier(mcfg, kernel_pol, steps=STEPS, batch=BATCH,
                                     seed=SEED)
        finally:
            ops.quantize_and_mask = real_q
        got = dict(build.LAUNCHES)
        model_launches[f"{mname} kernel"] = got
        check(math.isfinite(res_m["final_loss"]), f"{mname}: loss {res_m['final_loss']}")
        check(not ops.KERNEL_FALLBACKS, f"{mname}: fallbacks {ops.KERNEL_FALLBACKS}")
        for kname in build.LAUNCHES:
            want = per_step.get(kname, 0) * STEPS
            check(got[kname] == want, f"{mname}: {kname} {got[kname]} launches, "
                                      f"want {want}")
        skipped, live = skipped_tiles(qs_run)
        del qs_run
        with plain_kernels():
            build.reset_launches()
            res_mp = train_classifier(mcfg, kernel_pol, steps=STEPS, batch=BATCH,
                                      seed=SEED)
            check(not any(build.LAUNCHES.values()), "plain run launched a kernel")
        check(abs(res_m["sparsity"] - res_mp["sparsity"]) <= SPARSITY_BAND,
              f"{mname}: sparsity {res_m['sparsity']} vs plain {res_mp['sparsity']}")
        loss_mk, grads_mk, _ = first_step(mcfg, policy)
        with plain_kernels():
            loss_mp, grads_mp, _ = first_step(mcfg, policy)
        worst_m = worst_rel(grads_mk, grads_mp, f"{mname} kernel")
        log(f"phase 4e: {mname} kernel path {json.dumps(res_m)}; plain versions "
            f"{json.dumps(res_mp)}")
        log(f"phase 4e: {mname} launches per step "
            f"{ {k: v // STEPS for k, v in got.items() if v} }; step-1 loss "
            f"{loss_mk} (plain {loss_mp}), worst relative L2 gradient difference "
            f"{worst_m}; live tiles skipped by the masks over {STEPS} steps: "
            f"{skipped} of {live} ({100 * skipped / live:.3f}%); "
            f"{time.perf_counter() - t_model:.1f} s ({card})")

    # ResNet18 with NSD-encoded residuals; both steps' peak memory and a
    # profile of one fp32-residual step
    t_phase = time.perf_counter()
    rcfg = paper_models.resnet18_cifar()
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    res_rn = train_classifier(rcfg, kernel_pol, steps=STEPS, batch=BATCH, seed=SEED,
                              memory=MEMORY)
    got = dict(build.LAUNCHES)
    model_launches["resnet18-cifar kernel nsd"] = got
    check(math.isfinite(res_rn["final_loss"]), f"resnet18 nsd: loss {res_rn['final_loss']}")
    check(not ops.KERNEL_FALLBACKS, f"resnet18 nsd: fallbacks {ops.KERNEL_FALLBACKS}")
    for kname in build.LAUNCHES:
        want = RESNET_NSD_PER_STEP.get(kname, 0) * STEPS
        check(got[kname] == want, f"resnet18 nsd: {kname} {got[kname]} launches, "
                                  f"want {want}")
    with plain_kernels():
        build.reset_launches()
        res_rnp = train_classifier(rcfg, kernel_pol, steps=STEPS, batch=BATCH,
                                   seed=SEED, memory=MEMORY)
        check(not any(build.LAUNCHES.values()), "plain run launched a kernel")
    comp, comp_plain = res_rn["residual_compression"], res_rnp["residual_compression"]
    check(abs(comp - comp_plain) <= COMPRESSION_BAND * comp_plain,
          f"resnet18 residual_compression {comp} vs plain {comp_plain}")
    log(f"phase 4e: resnet18-cifar memory={MEMORY!r} {json.dumps(res_rn)}; plain "
        f"versions {json.dumps(res_rnp)}; launches per step "
        f"{ {k: v // STEPS for k, v in got.items() if v} }")
    rbatch = model_batch(rcfg)
    for label, memory in (("fp32 residuals", None), (f"memory={MEMORY!r}", MEMORY)):
        net = CNN(rcfg, seed=SEED)
        ctx = DitherCtx(policy, seed=SEED, step=0, memory=as_memory_policy(memory))

        def fwd_bwd(net=net, ctx=ctx):
            for q in net.parameters():
                q.grad = None
            loss_fn(net, rbatch, ctx=ctx).backward()

        if memory is None:
            profile_step(torch, fwd_bwd, card, f"resnet18-cifar, {label}")
        fwd_bwd()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 4e: resnet18-cifar ({label}): peak device memory of one "
            f"batch-{BATCH} step {peak / 2**20:.1f} MiB, "
            f"{(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB "
            f"held between steps ({card})")
        del net, ctx, fwd_bwd
    log(f"phase 4e: resnet18-cifar nsd, memory and profile: "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- phase 4f: the int8 variant (dense products on the int8 kernel,
    # convolutions on the generic path with the draw kernel) -------------
    t_phase = time.perf_counter()
    int8_pol = policy.replace(variant="int8", collect_stats=True)
    for mname, per_step in INT8_MODELS.items():
        mcfg = paper_models.MODELS[mname]()
        build.reset_launches()
        res_i = train_classifier(mcfg, int8_pol, steps=INT8_STEPS, batch=BATCH,
                                 seed=SEED)
        got = dict(build.LAUNCHES)
        model_launches[f"{mname} int8"] = got
        check(math.isfinite(res_i["final_loss"]), f"{mname} int8: loss")
        for kname in build.LAUNCHES:
            want = per_step.get(kname, 0) * INT8_STEPS
            check(got[kname] == want, f"{mname} int8: {kname} {got[kname]} "
                                      f"launches, want {want}")
        # the convolutions' products run on cuDNN: its deterministic
        # algorithms, so that two runs on equal inputs give equal bits
        torch.backends.cudnn.deterministic = True
        try:
            loss_ik, grads_ik, qs_k = first_step(mcfg, int8_pol.replace(
                collect_stats=False))
            with plain_kernels():
                loss_ip, grads_ip, qs_p = first_step(mcfg, int8_pol.replace(
                    collect_stats=False))
        finally:
            torch.backends.cudnn.deterministic = False
        check(len(qs_k) == len(qs_p) == per_step["nsd_quant"], f"{mname} int8: "
              f"{len(qs_k)} quantized layers")
        for qk, qp in zip(qs_k, qs_p):
            check(torch.equal(qk.k, qp.k) and torch.equal(qk.mask, qp.mask),
                  f"{mname} int8: k differs from the plain versions'")
        worst_i = worst_rel(grads_ik, grads_ip, f"{mname} int8")
        log(f"phase 4f: {mname} int8 {json.dumps(res_i)}; launches per step "
            f"{ {k: v // INT8_STEPS for k, v in got.items() if v} }; k equal to the "
            f"plain versions' on {len(qs_k)} layers, step-1 loss {loss_ik} (plain "
            f"{loss_ip}), worst relative L2 gradient difference {worst_i}")
    log(f"phase 4f: {time.perf_counter() - t_phase:.1f} s ({card})")

    # -- phase 4g: Table 1 over the six models (the reference's recipe) ----
    t_phase = time.perf_counter()
    from repro_torch.bench import SuiteRun

    t1_rows = table1.run(quick=False)
    for row in t1_rows:
        log(f"phase 4g: table1 {json.dumps(row)}")
    baseline = SuiteRun.from_dict(json.loads(
        (src.parent / "benchmarks" / "baselines" / "BENCH_table1_sparsity.json"
         ).read_text()))
    report = table1.check(table1.results(t1_rows), baseline)
    log("phase 4g: " + report.render(verbose=True).replace("\n", "\nphase 4g: "))
    check(report.ok and len(report.findings) > len(baseline.results),
          "Table 1: the MNIST rows miss the reference's gates")
    for row in t1_rows:
        if (row["model"] in table1.QUICK_MODELS
                or row["model"] in TABLE1_MEAN_MODELS):
            continue
        for m in ("dithered", "int8+dith"):
            check(row[f"{m}_acc"] >= row["baseline_acc"] - TABLE1_ACC_BAND,
                  f"Table 1 {row['model']}: {m} accuracy {row[f'{m}_acc']} vs "
                  f"baseline {row['baseline_acc']}")
    # AlexNet and VGG11: one 50-step run's accuracy is mostly seed noise (tens
    # of points apart across seeds, in both packages), so its mean over
    # TABLE1_SEEDS is held to the reference's mean over its rows
    ref_all = json.loads((src.parent / TABLE1_REFERENCE).read_text())["rows"]
    for name in TABLE1_MEAN_MODELS:
        ref_rows = [r for r in ref_all if r["model"] == name]
        check(len({r["seed"] for r in ref_rows}) == TABLE1_REFERENCE_SEEDS,
              f"{TABLE1_REFERENCE}: {len(ref_rows)} {name} rows, want "
              f"{TABLE1_REFERENCE_SEEDS} seeds")
        t1_row = next(r for r in t1_rows if r["model"] == name)
        cfg = table1._model(name)
        for m, variant in (("dithered", "paper"), ("int8+dith", "int8")):
            accs = [t1_row[f"{m}_acc"]] + [
                train_classifier(cfg, DitherPolicy(variant=variant, s=2.0),
                                 steps=50, seed=seed)["acc"]
                for seed in TABLE1_SEEDS[1:]]
            mean = statistics.fmean(accs)
            ref_mean = statistics.fmean(r[f"{m}_acc"] for r in ref_rows)
            log(f"phase 4g: {name} {m} accuracy at seeds "
                f"0-{TABLE1_SEEDS[-1]}: {accs}, mean {mean} (the reference on "
                f"the CPU at {len(ref_rows)} seeds: "
                f"{[r[f'{m}_acc'] for r in ref_rows]}, mean {ref_mean}) ({card})")
            check(mean >= ref_mean - TABLE1_ACC_BAND,
                  f"Table 1 {name}: {m} mean accuracy {mean} vs the "
                  f"reference's {ref_mean}")
    log(f"phase 4g: Table 1, six models x 3 trainings of 50 steps at batch 64, "
        f"and AlexNet and VGG11 x 2 at {len(TABLE1_SEEDS) - 1} more seeds: "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")

    # -- phase 4h: the classifier trainer repeats on the card --------------
    # cuDNN's default convolution backward algorithms sum in an order that
    # changes run to run; train_classifier asks for its deterministic ones
    # (classifier.repeatable_f32). Two trainings from one seed must then
    # agree bit for bit; two without the request are timed beside them.
    t_phase = time.perf_counter()
    from repro_torch.train import classifier

    real_cnn, real_settings = classifier.CNN, classifier.repeatable_f32
    nets = []

    def recording_cnn(*a, **kw):
        nets.append(real_cnn(*a, **kw))
        return nets[-1]

    def library_default():
        real_settings()
        torch.backends.cudnn.deterministic = False

    alexnet = table1._model("alexnet-c10")
    for variant in ("paper", "int8"):
        runs = {"deterministic": [], "default": []}
        for mode in ("deterministic", "default", "default", "deterministic"):
            nets.clear()
            classifier.CNN = recording_cnn
            if mode == "default":
                classifier.repeatable_f32 = library_default
            try:
                res = train_classifier(alexnet, DitherPolicy(variant=variant, s=2.0),
                                       steps=REPEAT_STEPS, seed=0)
            finally:
                classifier.CNN, classifier.repeatable_f32 = real_cnn, real_settings
            runs[mode].append((res, {n: p.detach().clone()
                                     for n, p in nets[0].named_parameters()}))
        same_bits = {}
        for mode, ((r1, p1), (r2, p2)) in runs.items():
            same_bits[mode] = (all(torch.equal(p1[n], p2[n]) for n in p1)
                               and r1["final_loss"] == r2["final_loss"])
        check(same_bits["deterministic"],
              f"4h: two {variant} trainings from seed 0 differ")
        ms = {m: [r["ms_per_step"] for r, _ in v] for m, v in runs.items()}
        log(f"phase 4h: alexnet-c10 {variant}, seed 0, {REPEAT_STEPS} steps at "
            f"batch 64: deterministic cuDNN twice acc "
            f"{[r['acc'] for r, _ in runs['deterministic']]}, final loss "
            f"{[r['final_loss'] for r, _ in runs['deterministic']]}, every "
            f"parameter equal bit for bit; the library's default twice acc "
            f"{[r['acc'] for r, _ in runs['default']]}, final loss "
            f"{[r['final_loss'] for r, _ in runs['default']]}, parameters "
            f"{'equal' if same_bits['default'] else 'differ'}; ms a step "
            f"deterministic {ms['deterministic']} vs default {ms['default']} "
            f"(in turns: deterministic, default, default, deterministic) ({card})")
    log(f"phase 4h: {time.perf_counter() - t_phase:.1f} s ({card})")

    # -- phase 5 ----------------------------------------------------------
    old = ("nsd_quant", "bsp_matmul_int8")
    resid = ("levels_compact", "levels_expand")
    # the NSD calls of the nsd step's residual encode, on the (n_chunks,
    # 256) views: the cotangents' calls are those of ``old``
    encode_calls = {"nsd_quant": []}
    real_pack_nsd = wire.pack_nsd

    def recording_pack_nsd(*a, **kw):
        with swapped({k: recorder(k, kernel[k], encode_calls) for k in encode_calls}):
            return real_pack_nsd(*a, **kw)

    with swapped({k: recorder(k, kernel[k]) for k in old}):
        step1()
    wire.pack_nsd = recording_pack_nsd
    try:
        with swapped({k: recorder(k, kernel[k]) for k in resid}):
            step1(MEMORY)
    finally:
        wire.pack_nsd = real_pack_nsd
    # no path launches the pack and unpack kernels: they are held and timed
    # on the fp32 step's k and on the bitmaps of the nsd step's decodes; the
    # draw kernel on the fp32 step's keys and cotangent shapes
    calls["bitmap_unpack"] = [([bm], {}) for (_, bm), _ in calls["levels_expand"]]
    calls["bitmap_pack"] = [([kernel["nsd_quant"](*a, **kw).k], {})
                            for a, kw in calls["nsd_quant"]]
    calls["philox_uniform"] = [([kw["key"], tuple(a[0].shape)], {"device": dev})
                               for a, kw in calls["nsd_quant"]]
    n_cot = PER_STEP["nsd_quant"]
    for kname, n in {"nsd_quant": n_cot, "bsp_matmul_int8": PER_STEP["bsp_matmul_int8"],
                     "bitmap_pack": n_cot, "philox_uniform": n_cot,
                     **{k: NSD_PER_STEP[k] for k in resid},
                     "bitmap_unpack": NSD_PER_STEP["levels_expand"],
                     "bsp_matmul_dequant": F32_OPERAND_LAUNCHES["bsp_matmul_dequant"]}.items():
        check(len(calls[kname]) == n, f"captured {len(calls[kname])} {kname} calls")
    for kname, got in encode_calls.items():
        want = NSD_PER_STEP[kname] - PER_STEP[kname]
        check(len(got) == want, f"captured {len(got)} {kname} residual-encode "
                                f"calls, want {want}")

    def time_ms(fn, launches=10, groups=5):
        """Median over groups of (CUDA-event time of back-to-back launches)
        / launches: device time where the device is the bottleneck, host
        dispatch time where a kernel is shorter than its launch."""
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(groups):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(launches):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / launches)
        return statistics.median(per)

    def capture(fn, launches):
        """A CUDA graph of ``launches`` calls of fn (after one warm-up call
        on a side stream), replayed once, and the last call's outputs."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                out = fn()
        graph.replay()
        torch.cuda.synchronize()
        return graph, out

    def graph_ms(fn, launches=10, groups=5):
        """Device time per launch without the host's dispatch: ``launches``
        calls captured in one CUDA graph, whose replays are timed with CUDA
        events (median over groups)."""
        graph, _ = capture(fn, launches)
        per = []
        for _ in range(groups):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / launches)
        return statistics.median(per)

    def graph_outputs(fn):
        """fn's outputs from a CUDA graph of one call, after two replays."""
        graph, out = capture(fn, 1)
        graph.replay()
        torch.cuda.synchronize()
        return out if isinstance(out, tuple) else (out,)

    def int_mm_fn(a, b):
        """torch._int_mm on the dense operands, in the layout it accepts."""
        for bb in (b, b.t().contiguous().t()):
            try:
                torch._int_mm(a, bb)
                return lambda: torch._int_mm(a, bb)
            except RuntimeError as e:
                err = e
        log(f"  library yardstick unavailable: {err}")
        return None

    def check_call(kname, args, kw, i):
        got, want = kernel[kname](*args, **kw), plain[kname](*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if kname == "bsp_matmul_dequant":
            k_st = args[0]
            K = k_st.shape[0] if kw.get("trans_a") else k_st.shape[1]
            banded(kname, got[0], want[0], K, f"path call {i}")
            check(torch.equal(got[0], kernel[kname](*args, **kw)),
                  f"{kname} path call {i}: two launches differ")
        else:
            same(kname, got, want, f"path call {i}")
        if kname in resid:
            again = kernel[kname](*args, **kw)
            again = again if isinstance(again, tuple) else (again,)
            replayed = graph_outputs(lambda: kernel[kname](*args, **kw))
            for g, a, r in zip(got, again, replayed):
                check(torch.equal(g, a), f"{kname} path call {i}: two launches differ")
                check(torch.equal(g, r), f"{kname} path call {i}: graph replay differs")

    libraries = {
        "bsp_matmul_int8": "torch._int_mm on the dense int8 operands",
        "levels_compact": "torch.masked_select(k, k != 0): the wire levels",
        "levels_expand": "masked_scatter of the wire levels into zeros",
        "bsp_matmul_dequant": "torch.matmul on the dense dequantized f32 operands, TF32 off",
    }

    def measure(kname, call_list, label=""):
        """Check each recorded call against the plain version and sum the
        kernel, plain, library and bound times over the calls."""
        tot = dict(ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0, library_ms=0.0,
                   local_ms=0.0, graph_ms=0.0, old_bound_ms=0.0)
        have_library = kname in libraries
        for i, (args, kw) in enumerate(call_list):
            check_call(kname, args, kw, i)
            ms = time_ms(lambda: kernel[kname](*args, **kw))
            pms = time_ms(lambda: plain[kname](*args, **kw), launches=2, groups=3)
            lib = local = None
            # every kernel but unpack: its device time per call, from graph
            # replays
            gms = (graph_ms(lambda: kernel[kname](*args, **kw))
                   if kname != "bitmap_unpack" else None)
            if gms is not None:
                tot["graph_ms"] += gms
            if kname == "nsd_quant":
                # read x (and a fed nu) once over its live elements; write k,
                # the bitmap (when asked) and the tile counts and mask over
                # the 128-padded view
                x_in = args[0]
                fed = kw.get("noise") is not None
                cols = kw.get("cols") or x_in.shape[-1]
                n = x_in.numel()
                rows = -(-n // cols)
                Tp, Np = -(-rows // 128) * 128, -(-cols // 128) * 128
                tiles = (Tp // 128) * (Np // 128)
                nbytes = (n * 4 * (2 if fed else 1) + Tp * Np
                          + (Tp * Np // 8 if kw.get("bitmap", True) else 0)
                          + tiles * 8 + 4)
                # the padded definition, for the kernel that took padded
                # copies: x and nu read, k written over the padded shape,
                # the counts
                tot["old_bound_ms"] += (Tp * Np * 9 + tiles * 4 + 4) / HBM_BYTES_PER_S * 1e3
                nops, rate = 5 * n, FP32_OPS_PER_S
                shape = f"{rows}x{cols} ({'fed' if fed else 'key'})"
            elif kname == "philox_uniform":
                rows_u, cols_u = args[1]
                nbytes, nops, rate = rows_u * cols_u * 4, 0, INT8_OPS_PER_S
                shape = f"{rows_u}x{cols_u}"
            elif kname == "bitmap_pack":
                M, N = args[0].shape
                nbytes = M * N + M * N // 8 + 2 * (M // 128) * (N // 128) * 4
                nops, rate = 0, INT8_OPS_PER_S
                shape = f"{M}x{N}"
            elif kname == "bitmap_unpack":
                M, NB = args[0].shape
                nbytes = M * NB + M * NB * 8
                nops, rate = 0, INT8_OPS_PER_S
                shape = f"{M}x{NB * 8}"
            elif kname == "levels_compact":
                # the wire kernel: read k, write the levels, bitmap and nnz
                k_c = args[0]
                C = k_c.shape[0]
                nbytes, nops, rate = C * 256 * 2 + C * 32 + 4, 0, INT8_OPS_PER_S
                shape = f"{C} chunks"
                flat = k_c.reshape(-1)
                lib = time_ms(lambda: torch.masked_select(flat, flat != 0))
                local = time_ms(lambda: levels.levels_compact(k_c))
            elif kname == "levels_expand":
                # the wire kernel: read the bitmap and the live levels, write k
                lv, bm = args
                C = bm.shape[0]
                nnz = int(wire.popcount_u8(bm).sum())
                nbytes, nops, rate = C * 32 + nnz + C * 256, 0, INT8_OPS_PER_S
                shape = f"{C} chunks, {nnz} levels"
                occ = wire.unpack_bitmap(bm).reshape(-1)
                glob = lv[:nnz]
                lib = time_ms(lambda: torch.zeros(C * 256, dtype=torch.int8, device=dev
                                                  ).masked_scatter_(occ, glob))
                k_full = levels.levels_expand_wire(lv, bm)
                lv_local, _ = levels.levels_compact(k_full)
                m_local = (k_full != 0).to(torch.int8)
                local = time_ms(lambda: levels.levels_expand(lv_local, m_local))
            elif kname == "bsp_matmul_dequant":
                k_st, d, b_op, mask = args
                ta = kw.get("trans_a", False)
                a_op = k_st.t() if ta else k_st
                m_op = (mask.t() if ta else mask) != 0
                M, K = a_op.shape
                N = b_op.shape[1]
                occupied = int(m_op.sum())
                k_needed = int(m_op.any(0).sum())
                nbytes = (occupied * 128 * 128 + k_needed * 128 * N * 4 + M * N * 4
                          + mask.numel() * 4 + 4)
                # two TF32 products (B_hi, B_lo) per multiply-add
                nops, rate = 2 * 2 * occupied * 128 * 128 * N, TF32_OPS_PER_S
                shape = (f"{M}x{K}x{N} {'dW' if ta else 'dx'} "
                         f"{occupied}/{m_op.numel()} tiles, split "
                         f"{bsp_matmul.splits_for(M, N, K, dev)}")
                a_f = a_op.to(torch.float32) * d
                lib = time_ms(lambda: torch.matmul(a_f, b_op))
                del a_f
            else:
                a, b, scale, mask = args
                ta, tb = kw.get("trans_a", False), kw.get("trans_b", False)
                a_op = a.t() if ta else a
                m_op = (mask.t() if ta else mask) != 0
                b_op = b.t() if tb else b
                M, K = a_op.shape
                N = b_op.shape[1]
                occupied = int(m_op.sum())
                k_needed = int(m_op.any(0).sum())
                nbytes = (occupied * 128 * 128 + k_needed * 128 * N + M * N * 4
                          + mask.numel() * 4 + 4)
                nops, rate = 2 * occupied * 128 * 128 * N, INT8_OPS_PER_S
                shape = (f"{M}x{K}x{N} {'dW' if ta else 'dx'} "
                         f"{occupied}/{m_op.numel()} tiles, split "
                         f"{bsp_matmul.splits_for(M, N, K, dev)}")
                fn = int_mm_fn(a_op.contiguous(), b_op.contiguous())
                lib = time_ms(fn) if fn is not None else None
            if have_library:
                if lib is None:
                    have_library = False
                else:
                    tot["library_ms"] += lib
            if local is not None:
                tot["local_ms"] += local
            t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / rate * 1e3
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["t_bytes"] += t_b
            tot["t_ops"] += t_o
            log(f"  {kname}{label} {shape}: {ms:.4f} ms "
                + (f"(device {gms:.4f} ms in graph replay), " if gms is not None else "")
                + f"(bound {max(t_b, t_o):.4f} ms, plain {pms:.4f} ms"
                + (f", library {lib:.4f} ms)" if lib is not None else ")"))
        tot["bound_ms"] = max(tot["t_bytes"], tot["t_ops"])
        tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
        tot["library_ms"] = tot["library_ms"] if have_library else None
        log(f"  {kname}{label}: {len(call_list)} calls, {tot['ms']:.4f} ms, "
            + (f"device {tot['graph_ms']:.4f} ms in graph replay, " if tot["graph_ms"] else "")
            + f"bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}"
            + (f"; {tot['old_bound_ms']:.4f} ms by the padded definition"
               if tot["old_bound_ms"] else "")
            + f"), plain "
            f"{tot['plain_ms']:.4f} ms"
            + (f", library {tot['library_ms']:.4f} ms ({libraries[kname]})"
               if have_library else ", library none"))
        if tot["local_ms"]:
            log(f"  {kname}{label}: the chunk-local kernel on the same chunks, "
                f"{len(call_list)} calls, {tot['local_ms']:.4f} ms")
        return tot

    # -- phase 5a: the split-K edges of both matmuls, A stored (K, M) as dW
    # reads it: c0's dW shape, a K-tile count the split does not divide, a
    # split with every K-tile masked, the last K-tile alone, and no K-tile
    for case, k_tiles in (("c0 dW", 1024), ("ragged", 37), ("masked split", 37),
                          ("last tile only", 37), ("all masked", 37)):
        M, N, K = 128, 128, 128 * k_tiles
        splits = bsp_matmul.splits_for(M, N, K, dev)
        check(splits > 1, f"{case}: not split")
        if case == "c0 dW":
            check(splits >= 100, f"c0 dW: split {splits}")
        else:
            check(k_tiles % splits, f"{case}: {splits} divides {k_tiles}")
        mask = torch.ones(k_tiles, 1, dtype=torch.int32, device=dev)
        if case == "masked split":
            lo, hi = bsp_matmul.split_bounds(k_tiles, splits)[1]
            mask[lo:hi] = 0
        elif case == "last tile only":
            mask.zero_()
            mask[-1] = 1
        elif case == "all masked":
            mask.zero_()
        a8 = torch.randint(-127, 128, (K, M), device=dev, generator=gen,
                           dtype=torch.int8)
        b8 = torch.randint(-127, 128, (K, N), device=dev, generator=gen,
                           dtype=torch.int8)
        scale = torch.tensor(3e-3, device=dev)
        same("bsp_matmul_int8",
             (bsp_matmul.bsp_matmul_int8(a8, b8, scale, mask, trans_a=True),),
             (bsp_matmul.bsp_matmul_int8_plain(a8, b8, scale, mask, trans_a=True),),
             f"split edge {case}")
        kq = torch.randint(-6, 7, (K, M), device=dev, generator=gen, dtype=torch.int8)
        bf = torch.randn(K, N, device=dev, generator=gen)
        got = bsp_matmul.bsp_matmul(kq, scale, bf, mask, trans_a=True)
        rel = banded("bsp_matmul_dequant", got, bsp_matmul.bsp_matmul_plain(
            kq, scale, bf, mask, trans_a=True), K, f"split edge {case}")
        check(torch.equal(got, bsp_matmul.bsp_matmul(kq, scale, bf, mask, trans_a=True)),
              f"bsp_matmul_dequant split edge {case}: two launches differ")
        log(f"phase 5a: {case} ({M}x{K}x{N}, {int(mask.sum())}/{k_tiles} K-tiles, "
            f"split {splits}): int8 bit-exact, dequant relative L2 {rel:.3e} and "
            f"equal over two launches")

    rows = []
    for kname in KERNELS:
        tot = measure(kname, calls[kname])
        path_launches = (launches if kname in PER_STEP else launches_f32
                         if kname == "bsp_matmul_dequant" else launches_nsd)[kname]
        row = {"name": kname, "route": "cuda", "source": KERNELS[kname][0],
               "replaces": KERNELS[kname][1], "launches": path_launches,
               "max_abs_err": max_err[kname],
               **{k: tot[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
               # the launches of phases 4e and 4f's runs, by model and variant
               "launches_by_path": {p: n[kname] for p, n in model_launches.items()}}
        if tot["graph_ms"]:
            row["graph_ms"] = tot["graph_ms"]  # device time, no host dispatch
        if kname == "bitmap_unpack":
            row["note"] = ("no path launches it: the wire expand reads the bitmap "
                           "itself; held and timed on the nsd step's decode bitmaps")
        if kname == "bitmap_pack":
            row["note"] = ("no path launches it: the NSD kernel writes the bitmap, "
                           "nnz and mask itself; held and timed on the fp32 step's k")
        if kname in encode_calls:
            # the same kernel's calls in the nsd step's residual encode, with
            # their launches over phase 4b's run
            enc = measure(kname, encode_calls[kname], " (nsd residual encode)")
            row["nsd_residual_encode"] = {
                "launches": launches_nsd[kname] - launches[kname],
                **{k: enc[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "graph_ms")}}
        if kname == "nsd_quant":
            # the draw-only entry of the same source, on the fp32 step's
            # cotangent shapes, with its launches over phase 4d's paper run
            drw = measure("philox_uniform", calls["philox_uniform"])
            row["philox_uniform"] = {
                "launches": launches_paper["philox_uniform"],
                "max_abs_err": max_err["philox_uniform"],
                **{k: drw[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "graph_ms")}}
        rows.append(row)
    torch.cuda.synchronize()
    log(f"phase 5: per-kernel times are sums over the launches of one "
        f"batch-{BATCH} step (the f32-operand backward's 22 products for the "
        f"dequant kernel; the NSD row's cotangent calls of the fp32 step, its "
        f"residual-encode calls of the nsd step apart; the pack row the fp32 "
        f"step's k; the compact and expand rows the nsd step's wire calls); "
        f"paper variant {res_paper['ms_per_step']:.2f} ms; step time kernel "
        f"path {res['ms_per_step']:.2f} ms, "
        f"plain versions {res_plain['ms_per_step']:.2f} ms; with nsd residuals "
        f"{res_nsd['ms_per_step']:.2f} ms, plain versions "
        f"{res_nsd_plain['ms_per_step']:.2f} ms ({card})")

    # -- phase 5b: where one step's device time goes (torch.profiler) -----
    # -- phase 5c: one step's peak device memory ---------------------------
    def make_step(memory):
        net = CNN(cfg, seed=SEED)
        ctx = DitherCtx(policy.replace(collect_stats=False), seed=SEED, step=0,
                        memory=as_memory_policy(memory))

        def fwd_bwd():
            for p in net.parameters():
                p.grad = None
            loss_fn(net, batch0, ctx=ctx).backward()
        return fwd_bwd

    configs = (("fp32 residuals", None), (f"memory={MEMORY!r}", MEMORY))
    for label, memory in configs:
        fwd_bwd = make_step(memory)
        profile_step(torch, fwd_bwd, card, label)
        fwd_bwd()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 5c ({label}): peak device memory of one batch-{BATCH} step "
            f"{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB above the "
            f"{base / 2**20:.1f} MiB held between steps ({card})")

    # -- phase 5d: the nsd step's cost over fp32 residuals, on the host
    # clock, the two steps taken in turns so that both see the same host
    steps = {label: make_step(memory) for label, memory in configs}
    wall = {label: [] for label in steps}
    for _ in range(STEP_PAIRS):
        for label, fwd_bwd in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd_bwd()
            torch.cuda.synchronize()
            wall[label].append((time.perf_counter() - t0) * 1e3)
    med = {label: statistics.median(w) for label, w in wall.items()}
    fp32_ms, nsd_ms = med.values()
    log(f"phase 5d: forward+backward of one batch-{BATCH} step, median of "
        f"{STEP_PAIRS} taken in turns: fp32 residuals {fp32_ms:.3f} ms, "
        f"memory={MEMORY!r} {nsd_ms:.3f} ms, excess {nsd_ms - fp32_ms:+.3f} ms ({card})")

    # the f32-operand backward of phase 4c: the dequant row's device time
    def f32_operand_backward():
        for g, x, w, u, s in captured.values():
            ops.dithered_backward_matmuls(g, x, w, u, s, int8_operands=False)

    profile_step(torch, f32_operand_backward, card,
                 "f32-operand backward of the 11 layers")

    # -- phase 6: data-parallel SSGD on simulated nodes, the comm wire -----
    t_phase = time.perf_counter()
    ssgd_launches = phase6(torch, card, dev, plain_kernels, worst_rel)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in ssgd_launches.items()})
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s ({card})")

    # -- phases 7 and 8: gemma-2b at full width through the LM launcher ----
    lm_launches, ms_7a = phase7(torch, card, dev, plain_kernels, swapped,
                                kernel, worst_rel)
    # -- phase 9: the run directory and the sparsity controller -----------
    lm_launches.update(phase9(torch, card, dev, ms_7a))
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in lm_launches.items()})

    # -- phase 10: serving ---------------------------------------------------
    serve_launches, pages = phase10(torch, card, dev, same, time_ms, graph_ms)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in serve_launches.items()})
        if row["name"] == "levels_expand":
            row["serve_pages"] = pages

    # -- phase 11: checkpoints, resume and elastic SSGD ------------------
    ft_launches = phase11(torch, card, dev, plain_kernels)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in ft_launches.items()})

    # -- phase 12: the rest of the LM zoo ----------------------------------
    zoo_launches, pack_slices = phase12(torch, card, dev, plain_kernels, swapped,
                                       kernel, plain, worst_rel, same, time_ms,
                                       graph_ms)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in zoo_launches.items()})
        if row["name"] == "bitmap_pack":
            row["note"] = ("launched on the MoE path (phases 12c and 12d: one "
                           "launch per expert slice of each expert einsum); the "
                           "figures above are the fp32 step's k, those at the "
                           "expert-slice shapes under moe_expert_slice, by arch")
            row["moe_expert_slice"] = pack_slices

    # -- phase 13: the VLM, SSM and hybrid families --------------------------
    family_launches = phase13(torch, card, dev, plain_kernels, swapped, kernel,
                              worst_rel)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in family_launches.items()})

    # -- phase 14: the audio family -----------------------------------------
    audio_launches = phase14(torch, card, dev, plain_kernels, swapped, kernel,
                             plain, worst_rel, same)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in audio_launches.items()})

    # -- phase 15: data-parallel over processes --------------------------
    mesh_launches = phase15(torch, card, dev)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in mesh_launches.items()})

    # -- phase 16: the trainer's gradient wire ------------------------------
    wire_launches = phase16(torch, card, dev, plain_kernels)
    for row in rows:
        row["launches_by_path"].update(
            {p: n[row["name"]] for p, n in wire_launches.items()})

    # -- phases 17 and 18 --------------------------------------------------
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
