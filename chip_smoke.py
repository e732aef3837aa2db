#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

1. Setup: prints the card's name and power limit (nvidia-smi), builds the
   hand-written kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` and prints the build time and, per kernel, ptxas's
   registers, static shared memory and spills.
2. Kernels vs plain versions on the card: ``fused_pyramid_stage0`` (base
   224, chunk 256, levels {112, 56, 28}; grid extremes, the 56 px rgb 2x32
   case and the planned stage-0s, each f32 and int8: levels ``torch.equal``,
   scores within SCORE_TOL; each timed on both clocks) and ``matmul`` (random f32/bf16 at ragged
   shapes and both evaluator shapes, within the reference test's
   tolerances, each rerun bit-identical: split-K adds in a fixed order),
   with kernel, plain, bound and library times.
3. Query path: the scanned data of this phase and the next (corpus,
   stream, cameras) is drawn on the card (``synth``:
   ``repro_torch.data.synthetic``'s image model with torch's generator);
   the training splits are the generators' own, on the host, as the
   learning floors were set on them. Three predicates, each initialized
   on the card by ``initialize_system``: a 361-model bank over the paper grid (18
   architectures x {28, 56, 112, 224} px x 5 colors, plus the trusted
   model) trained with BCE + AdamW (90 steps, batch 16, lr 3e-3; the
   trusted model 270; ``initialize_system``'s default is 120, cut for
   the run's time limit) on 1024 frames, thresholds from a 512-frame config
   split, scores on a 512-frame eval split, and the per-model inference
   costs pinned in COSTS (measured again and printed beside them). Each
   bank is held to the learning floors (best model and trusted model
   eval accuracy); the streaming cascade-space evaluator runs through the
   matmul kernel (checked against the dense evaluator), then a joint
   plan and ``ScanEngine`` over 8192 dyadic 224 px frames resident on
   the card, fused through the pyramid+stage-0 kernel, f32 and int8,
   each held against ``naive_scan``. Launch counts are reset just before
   training and read just after the scans; a kernel of the path with 0
   launches fails. Per predicate: training time and steps/s,
   accuracies, the Pareto frontier's size and the paper's Fig. 6/7
   speedups over the trusted model (core/alc, INFER_ONLY and CAMERA,
   modeled from the pinned costs). The dense evaluator's acc and time of
   every planned and frontier cascade are held to the per-image oracles
   (``simulate_cascade``, ``cascade_time_naive``). The f32 scan is then
   rerun under ``torch.profiler``: device time by kernel and the device's
   idle share. ``fit_cnn``'s loop (a CUDA graph on the card) must equal
   its step run eagerly, and the planned stage-0 model and the trusted
   model, trained again from the same seed, the bank's, bit for bit; a
   short training run of each is profiled. The evaluator's two products,
   (128, 512) @ (512, A) and (128, 512) @ (512, M) on its 0/1 matrices,
   are exact; kernel and ``torch.matmul`` in alternating order, each on
   two clocks (CUDA events around back-to-back calls, the clock of every
   ``ms`` in the kernels line, and profiler device time, per launch too;
   median and spread), plain and bound; a 2048^3 probe compares the
   kernel's inner loop with cuBLAS's.
   Ingest and algebra, on the same trained systems, plan and corpus
   (nothing trained again): a 4096-frame 224 px camera stream (scenes
   held 1-4 frames, +-1/256 sensor jitter) arrives on the host in batches
   of 512 and goes through ``build_ingest_pipeline(plan.cascades, chunk
   256, skip_threshold=None)``: the skip detector on the host, the
   references' stage 0 through the pyramid+stage-0 kernel (the anchor
   concept) and ``models/cnn`` (the others). Launch counts are reset
   just before and read just after: one kernel launch per scored chunk.
   Aliases stay inside their scene, one reference per scene after
   calibration, and the anchor's ingest scores equal the kernel's on
   the same padded chunk. Re-planned with ``index=``, the stream (on the
   card) is scanned by ``indexed_execute`` (exact), cold, by
   ``naive_scan`` and in approx mode (measured recall per concept); three
   expression trees over the 8192-frame corpus run through
   ``execute_tree`` optimized and not, against ``naive_tree_rows``; a
   ``Join(a, a, delta_t=2)`` over two 2048-frame cameras runs through
   ``execute_join`` against ``naive_join_pairs``. Row sets and pairs
   must be equal apart from counted threshold-boundary rows (two routes'
   level-0 scores within SCORE_TOL across a threshold). The kernels
   line's stage-0 launches add the phase's (``ingest_launches`` names the
   ingest path's).
   Sharded scans, on the same systems, plan, corpus and stream: the
   stage-0 kernel scores the same 16 rows at every slab width 16-256
   (``torch.equal`` with the 256-wide launch, f32 and int8), and every
   model a flush runs through ``cnn_forward`` is scored at those widths
   too (rows that differ and the largest difference, printed). Then
   ``ShardedScanEngine`` at SHARD_RUNS (1, 2 and 8 shards, range and
   hash, as lanes on CUDA streams; the serial backend at 8), each row
   set held against the serial scan's and ``naive_scan``'s; the 8-shard
   engine again on its merged store (no superstep, no launch); the first
   tree and the stream's exact indexed scan on 8 shards against the
   phase before. Launch counts are reset just before and read just
   after; a row that differs must be a threshold-boundary row at one of
   the slab widths (``straddles(widths=)``). It prints each scan's ms,
   supersteps, lanes, rows per shard, balance, stage-0 slabs by width
   and peak memory, and profiles the 8- and 1-shard lockstep and the
   serial scan. The kernels line's stage-0 launches add the phase's
   (``sharded_launches``).
   Serving, on the same systems, plan, corpus, stream and index: the
   planned scan through ``ScanEngine(repcache=)`` (rows equal to the
   serial scan's), timed beside a fresh engine without a cache and a
   second engine on the warm cache; ``build_cascade_service`` (async,
   batch 32, max wait 5 ms) over a 4096-request stream of the plan's
   three concepts, half of it re-asking a hot set (the reference's
   ``bench_serve.make_stream``), at 1 and 8 shards (lanes on CUDA streams
   of the one card), first on the scan's store and cache, then fresh (the
   from-base flush is the ``fused_pyramid_stage0`` kernel), and at 8
   lanes on a fresh store with the scan's warm cache and with none; the
   sync ``CascadeService`` on the
   same stream; the wall-clock event host on a paced stream; an unpaced
   burst on the deepest cascade's concept against ``queue_limit`` 64
   with ``overload="degrade"`` and its ``compiled_ladder``; the fault
   drill at 8 lanes (lane 3 failing every dispatch, lane 5 dead, two
   transient errors, a batch timeout, on a manual clock: every request
   ends, labels equal the unfaulted run's, lanes [3, 5] failed); and a
   service over the stream seeded by its ingest index (index-decided
   rows answered with no batch). Every served label is held against
   ``naive_scan``'s column of the cascade or rung that answered it,
   apart from counted threshold-boundary rows at the flush widths
   (``straddles(widths=)``). It prints requests/s, latency
   percentiles, store hit rates, each run's own repcache hit rate,
   flushes by reason, padded
   slots, lanes, peak memory and a device profile of the 8-lane run.
   Launch counts are reset just before and read just after: the stage-0
   launches must equal the scan's chunks plus the services' "base"
   executions (flushes, re-dispatches, warmup) plus the sync batches
   (``serving_launches``).
4. LM serve path: zamba2-1.2b at full width (38 Mamba-2 layers, the shared
   attention+MLP block after every 6th; random bf16 weights from a seeded
   generator) serves 8 prompts of 512 tokens with 32 greedy decode steps
   and bf16 KV through ``launch.serve.serve``. Launch counts are reset just
   before the timed serve and read just after it: one prefill must launch
   ``flash_attention`` 6 times and ``ssd_scan`` 38 times. Both kernels are
   then held against their plain versions on the card at the path's shapes
   and at the reference tests' shapes, flash on contiguous (B,H,S,D) inputs
   and on the (B,S,H,D).transpose(1, 2) views the model passes (its output
   laid out like q); kernel, plain, bound and library times (flash on the
   model's views, beside SDPA on the same views, on both clocks). The prefill is profiled
   (its copy kernels listed), one prefill under an operator hook must make
   no (B,S,H,D) <-> (B,H,S,D) copy, a decode step is profiled, and an f32
   copy of the model must give the same logits from
   ``prefill`` on the first 256 tokens + one ``decode_step`` as from
   ``forward`` over all 512 tokens at that position (the kernel path
   against the plain decode recurrences). ``ssd_scan`` is also held
   against its plain version at mamba2-130m's shape (24 heads, N 128) and
   at the reference tests' shapes in bf16 (the tensor-core kernel) as well
   as f32 (the FFMA kernel), and timed at both model shapes.
   Dense LM path: deepseek-7b at full width and depth (30 layers,
   d_model 4096, 32 heads of 128, d_ff 11008, vocab 102400; ~6.9 B random
   bf16 parameters from a seeded generator) serves 8 prompts of 512 tokens
   with 32 greedy steps and bf16 KV through ``launch.serve.serve``. Launch
   counts are reset just before the timed serve and read just after: one
   prefill must launch ``flash_attention`` 30 times (the kernels line's
   flash launches add them, ``dense_launches``). The prefill and one
   decode step are profiled. The flash kernel at head width 128 is held
   against its plain version at the path's shape (bf16 causal, on the
   model's views and contiguous; not causal), at a ragged S != T and in
   f32 (the FFMA kernel), and timed beside SDPA on the same views. An f32
   copy cut to 4 layers gives the same logits from ``prefill`` + one
   ``decode_step`` as from ``forward``; minitron-4b (GQA), granite-20b
   (MQA) and qwen2.5-32b (QKV bias) do the same at full width and depth 2
   in bf16 (DENSE_BF16_CONSIST_TOL). Greedy speculative decoding with
   deepseek-7b as the target (gamma 4, 32 tokens) self-drafted accepts
   every proposal in 7 target calls, and drafted by deepseek-7b's config
   cut to 4 layers gives ``generate_greedy``'s tokens; ``ContinuousBatcher``
   (8 slots of 640 tokens, 24 requests of 32-512 prompt tokens and 4-32
   new tokens) gives every request its own B = 1 greedy decode; each apart
   from a first divergence at a counted bf16 near-tie (NEAR_TIE_BF16). The
   LM cascade (minitron-4b on the last 128 tokens, then deepseek-7b, random
   weights) is calibrated on 256 rows of tests/test_lm_cascade.py's task
   at 512 tokens and run over 256 more in batches of 32: labels and levels
   equal a host oracle routing each row from the levels' scores, apart
   from counted rows within SCORE_TOL of a threshold; it prints each
   level's seconds per row and ``expected_cost``.
   moe, MLA, vlm and audio LM paths (FAMILY_MODELS), one model at a time,
   built, used and freed, widths as published and depth cut as printed
   beside the published depth (random bf16 weights from a seeded
   generator, drawn layer by layer into preallocated stacks; the init
   peak is printed beside the weights): phi3.5-moe at 16 of 32 layers,
   deepseek-v2 (MLA + MoE with shared experts) at 4 of 60, qwen2-vl at 4
   of 80 (a 256-patch ``vision_embeds`` prefix and (t, h, w) M-RoPE
   positions) and whisper-tiny whole (1500 encoder frames), each serving
   8 prompts (512 tokens; whisper 128) with 32 greedy steps and bf16 KV
   through ``launch.serve.serve``. Launch counts are reset just before
   each timed serve and read just after: one prefill launches
   ``flash_attention`` 16, 0 (MLA's attention is plain: its q/k and v
   heads differ in width), 4 and 12 times (whisper: 4 encoder, 4 decoder
   self, 4 cross), and no other kernel (the kernels line's flash
   launches add them, ``families_launches``). Each prints prefill ms,
   decode ms/step, tok/s and peak memory. The flash kernel is held
   against its plain version at each model's shapes on its views (qwen2-vl
   (8,64,512,128) causal; whisper (8,6,1500,64) not causal, (8,6,128,64)
   causal, 128 queries on 1500 frames not causal; FLASH_BF16_TOL) and
   timed beside SDPA on the same views (rows of the flash entry's
   ``other_shapes``). Each row's launches are the serve's, as the wrapper
   counted them by problem (``ops.FLASH_SHAPES``): one per layer of the
   row's role, and the rows together hold every launch. phi3.5's prefill is profiled,
   with one ``apply_moe``'s device time split into GEMMs and routing,
   gather and combine; one deepseek-v2 decode step (the absorbed MLA
   decode) is profiled. For the two MoE archs: the first layer's
   ``apply_moe`` in f32 with no token dropped equals a per-token float64
   loop on the card (MOE_LOOP_TOL; router near-ties counted); at the
   published capacity factor, 0.5 and 0.1 each expert keeps min(routed,
   capacity) tokens and a token every expert dropped gets exactly the
   shared experts' output (zero for phi3.5), and some factor must drop
   such a token; two bf16 prefills give
   ``torch.equal`` logits and caches. For qwen2-vl and whisper the served
   greedy tokens are held against ``forward``'s argmax over the prompt
   and the served tokens, differing only at counted near-ties. Then in
   f32 (capacity factor E/k, ``no_drops``): ``prefill`` + one
   ``decode_step`` ==
   ``forward`` (CONSIST_TOL) for phi3.5 at 2 layers, deepseek-v2 at 1
   (the absorbed decode against the full path), qwen2-vl at 2 (patches
   and M-RoPE) and whisper whole, batch 2 x 512 tokens.
   LM training: zamba2-1.2b at full width and depth (random bf16 weights
   from a generator seeded with 0) trains 3 steps of 8 x 512 tokens of
   ``lm_token_batches`` (lr 3e-4, cosine schedule, AdamW, remat "full",
   8 micro-batches) through ``launch.train`` (``setup`` and the runtime's
   loop, as ``main`` runs them) on a mesh of one rank, with one final
   checkpoint. Launch counts are reset just before step COUNTED_STEP and
   read just after it: ``ssd_scan`` 8 x 38 x 2 (the checkpoint recomputes
   each SSD layer's forward) and ``flash_attention`` 8 x 6 (the shared
   block is not checkpointed, as in the reference; both backwards
   recompute the plain versions); the kernels line's launches add them
   (``training_launches``). Every loss must be finite, and step 0's
   first sequence, through the trained model, ``loss_drop`` below its
   loss before training (fresh batches of uniform tokens teach little in
   3 steps: their losses are printed), and no step may fail and be
   replayed by the runtime; it prints steps/s, tokens/s, ms per step,
   model TFLOP/s (6 N tokens over the step), peak memory, the final
   checkpoint's bytes and seconds, one more step profiled whole (device
   time by kernel, idle share against the run's median step), and the
   gradient norms of the SSD-only leaves, which must be nonzero. Then
   ``ssd_scan`` under autograd (``_SSD``) at the training shape in bf16
   and f32: outputs within SSD_TOL of ``ssd_scan_ref``, its
   gradients of all five operands equal; an f32 zamba2 cut to 6 layers
   (one shared-block pass) at 1 x 256 tokens: gradients through the
   kernels on the card against its CPU copy's (plain versions), leaf by
   leaf within TRAIN_GRAD_TOL. The recovery drill (zamba2 at full width cut
   to 6 layers, 6 steps of 1 x 512, a checkpoint every 2 steps) runs
   uninterrupted and with failures injected at steps 2 and 4 (checkpoints
   through ``AsyncSaver``) under ``torch.use_deterministic_algorithms``
   (CUBLAS_WORKSPACE_CONFIG set at start): 2 recoveries, and params and
   optimizer state ``torch.equal`` to the uninterrupted run's, and the
   checkpoint ``AsyncSaver`` wrote at the last step byte for byte the
   uninterrupted run's; a leaf changed in place right after
   ``AsyncSaver.save`` returns restores as it was. One step each with
   ``--compress topk`` and ``int8``: error feedback holds on the step's
   gradients, and each step is timed. Last, the training step's
   kernel shapes as rows of the kernels line (flash q/k/v (1,32,512,64)
   bf16 causal beside SDPA; ``ssd_scan`` x (1,512,64,64) bf16, N 64), each
   held against its plain version, with kernel, device, plain and bound
   times and its launches in the counted step. The phase's checkpoints
   go under ``build/ckpt`` and are removed at its end.
   Fleet tooling (no kernel): ``launch/hw``'s peaks for this card beside
   nvidia-smi's line; ``launch/costing``'s FLOPs of the training step
   above, counted on CPU fake tensors (one micro-batch's forward,
   recompute and backward times the micro-batches, plus AdamW), its
   matmul-class share beside 6 N D, ``analytic_bytes``, and against the
   phase's median step the achieved FLOP/s, the roofline bound on ``hw``'s
   figures and the share of it reached; the dry-run CLI for one cell
   (zamba2-1.2b x decode_32k x single: 256 fake ranks, a process of its
   own; a nonzero exit fails the run) with its three terms; and
   ``pipeline_forward`` on two NCCL ranks, a card each, against the stack
   run without a pipeline, where the machine has two cards (with one it
   prints that the pipeline did not run and why).
   Tensor parallel: two ranks spawned on the one card (gloo: NCCL
   refuses two ranks on one card; the collectives' CUDA tensors stage
   through the host) on a (data 1, model 2) mesh. Each
   probes the collectives of the model code on its tensors, then serves
   through ``launch/steps``, random bf16 weights at published widths,
   zamba2-1.2b whole (8 prompts x 512 tokens, 8 greedy steps; 32 before
   the moe and audio families joined, a cut printed), deepseek-7b at 4
   of its 30 layers, phi3.5-moe at 2 of 32, deepseek-v2 at 1 of 60 (8 x
   512, 8 steps each) and whisper-tiny whole (1500 frames, 8 x 128, 8
   steps), the MoE models at the capacity factor that drops no token
   (``no_drops``): each rank's parameter bytes against the one-rank
   path's, its peak memory, its launches (counts reset just before, read
   just after: flash and SSD at the per-rank shapes, a layer each) and,
   on rank 0, the one-rank path on the same card: prefill logits within
   TP_LOGIT_TOL of the largest, greedy tokens printed; then the same
   weights widened to f32, logits within CONSIST_TOL and greedy tokens
   equal but for first differences at near-ties. For the MoE models the
   routing at the default capacity factor (``apply_moe`` on the first
   layer's experts, one input on every rank, tokens dropped; and the
   served warm-up prefill's every layer): hashes of each rank's top-k
   experts, kept tokens and slots gathered, equal on every rank and to
   the one-rank path's, and the output within MOE_TP_TOL. Then one f32
   train step of zamba2-1.2b (8 x 512 tokens) and of phi3.5-moe (1 layer,
   2 x 256, aux loss included) on the mesh against the one-rank step on
   every rank: loss within TP_LOSS_TOL relative, each leaf's gradient
   (the ranks' shards together, ``w_router`` included) within
   TRAIN_GRAD_TOL. Each per-rank flash and SSD shape is then held
   against its plain version and timed (rows of the kernels line;
   ``tp_launches`` both ranks' launches).
   Context parallel: two gloo ranks on the one card on a (data 2, model
   1) mesh, zamba2-1.2b whole (random bf16 weights at published widths)
   at long_500k: batch 1, the decode cache's 524288 positions split over
   'data', 262144 a rank, as the reference's ``cache_pspecs`` splits
   them (``launch/steps``: each rank prefills the 512-token prompt whole
   through the flash and SSD kernels and keeps its block). Each rank
   takes 4 greedy steps from position 512 (rank 1's block holds no
   valid key), then, positions [0, 262140) filled from the seed at the
   prefill's k/v RMS and the prompt's SSM state kept, 8 greedy steps
   across the edge of rank 0's block. The weights are ZeRO over 'data'
   (the reference's long_500k placement) for the prefill and the short
   steps, which gather a layer's leaves as the layer runs, then gathered
   whole once and placed whole for the long steps (the reason printed). It prints each rank's cache against the
   whole (0.500 of the k/v), its peak memory, its decode ms a step (gloo
   through the host: a correctness phase, not speed), the combine's
   collectives a step, one gather's ms and its launches (counts reset
   just before the prefill, read after the last step). After the
   ranks exit, the one-rank path (the whole cache) on the same card:
   logits within CP_LOGIT_TOL of the largest and greedy tokens equal but
   for a first difference at a near-tie; then the same in f32 at
   seq_len 65536 (weights whole on every rank, the reason printed):
   logits within 1e-5 of the largest and tokens equal. The prefill's
   per-rank flash and SSD shapes are held against their plain versions
   and timed (``cp_launches`` both ranks' launches).
   ZeRO layers: two gloo ranks on the one card on a (data 2, model 1)
   mesh (started before the fleet phase, which runs on the host alone,
   and waited for after it), zamba2-1.2b (random weights at published widths) placed by
   ``sharding.policy.place`` under the policy's ZeRO placements: each
   rank holds its shard of the parameters and of AdamW's m and v, and
   the train step (``launch/steps``) gathers each layer's leaves over
   'data' as the layer runs, again in the backward's recompute, and
   reduce-scatters the layer's gradient into the rank's f32
   accumulator. A bf16 step at full depth (global batch 4 x 512, one row
   a rank and micro-batch, 2 micro-batches, remat "full"): the rank's
   memory peak is reset just before the gradients and read just after,
   and its rise over what was allocated before must stay under the
   whole weights gathered plus an f32 accumulator of the rank's shard
   (a route that gathers the whole model needs more); it is printed
   beside the count of the shard's accumulator and one layer's gathered
   leaves with those outside the stacks (``launch/dryrun.zero_bytes``).
   The all-gathers and reduce-scatters a micro-batch (counted at the
   policy's collectives) must equal the count from the specs, the flash
   and SSD launches (counts reset just before the gradients, read just
   after) theirs, and the step's and the gathers' ms are printed (gloo
   through the host: a correctness phase, not speed). Then an f32 step
   at one segment's depth (6 SSM layers and the shared block), held
   after the ranks exit against the one-rank path on the same card: the
   loss within TP_LOSS_TOL relative, each leaf's gradient, its
   parameter after one AdamW step (eps ZERO_ADAMW_EPS) and its m and v
   within TRAIN_GRAD_TOL of the leaf's largest. The step's per-rank
   flash and SSD shapes are held against their plain versions and timed
   (``zero_launches`` both ranks' bf16 launches).
5. Kernel entry points (``kernels/ops``), the twin of the reference's
   ``bench_transform_kernel`` at the query path's width: a chunk of 256
   dyadic 224 px frames through ``pyramid_transform_op`` with all 20
   (resolution, color) specs of the bank's representation space in one
   launch, and through ``transform_op`` once per spec. Launch counts are
   reset just before and read just after: 20 ``fused_transform`` and 1
   ``fused_pyramid_transform``. Every output is held against its plain
   version (rgb/r/g/b ``torch.equal``, gray within TRANSFORM_GRAY_TOL), and
   again on ``torch.rand`` frames within TRANSFORM_TOL; then kernel (on
   two clocks: CUDA events and profiler device time), plain, bound and
   library (``F.conv2d``) times and the pyramid kernel's TB/s. Then
   ``fused_pyramid_transform``'s other paths (``pyramid_cases``: a plan
   that is no chain, a (3, 3) projection that is no identity, a chain at
   a base no multiple of 16, frames off 16-byte alignment, B = 1, B =
   chunk + 1), each held against the plain
   version the same way on dyadic frames and timed.
6. The card's name and power limit again, one ``{"kernels": [...]}``
   line, then the result line ``{"ok": true, "device": {...}}``.

Any failed check raises and the run exits non-zero. Without a CUDA device,
or outside a checkout of the repo, it exits non-zero and prints no result.
``--rehearse`` runs the same phases at toy sizes on the CPU (plain
versions only; exits 3 and never prints a result).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# per-model inference costs the query phase plans with (measured on the
# card by benchmarks/torch_infer_costs.py)
COSTS = SRC / "repro_torch" / "configs" / "infer_costs_h100.json"

SCORE_TOL = 1e-4   # |kernel - plain| on sigmoid scores: f32 sums in another
#                    order (conv dot products of up to 9*48 terms, dense of up
#                    to 6272); an indexing fault shows as O(0.1)
MM_TOL = {"float32": 1e-3, "bfloat16": 3e-2}   # tests/test_kernels.py
FLASH_TOL = 2e-3    # f32 kernel vs f32 plain, atol = rtol: same tests
# bf16 kernel vs the plain version on the same inputs widened to f32, atol
# and rtol. The kernel's scores are f32 sums of exact bf16 products; what
# it rounds is P to bf16 before P V and the output to bf16. The first adds
# at most 2^-9 * sum_j p_j |v_j| / l over the keys whose p is not exactly
# 1: 2^-10 max|v| (~2.6e-3 for the 0.5-scaled inputs below) on a row of
# two keys, less over many. The second is half an ulp, <= 2^-8 of |out|.
# A KV tile dropped or rescaled wrongly moves the later rows by ~1e-2.
FLASH_BF16_TOL = (4e-3, 2.0 ** -8)
SSD_TOL = (5e-4, 5e-3)       # atol, rtol: tests/test_kernels.py::test_ssd_*
# prefill + decode_step vs forward, f32 at full width: max |diff| over the
# largest |logit|. f32 sums run in other orders (the chunked SSD kernel vs
# the decode recurrence through 38 layers, the flash kernel vs sdpa over
# the cache); a state, position or mask fault moves logits by O(1).
CONSIST_TOL = 1e-3
# prefill + decode_step vs forward in bf16 at full width (minitron-4b,
# granite-20b, qwen2.5-32b at depth 2): max |diff| over the largest |logit|.
# The two paths round differently in bf16: the flash kernel rounds P and
# its output, decode's sdpa rounds the scores before the softmax (2^-9 of a
# score of up to ~10 moves a probability by ~1%), and every layer rounds
# its outputs; ~1% of the logits' scale after two layers, 2^-5 with room.
DENSE_BF16_CONSIST_TOL = 2.0 ** -5
# bf16 logits' near-ties (atol, rtol against the top logit): where two
# greedy paths of one bf16 model (other GEMM shapes, flash kernel vs sdpa
# over the cache) may rightly pick different tokens. Each path rounds the
# top two logits to bf16 (2^-8 relative each, so the gap moves by up to
# 2^-7 of the top logit) and carries its own rounding through the layers
# (the bf16 consistency lines print the decode path's: ~1% of the largest
# logit at depth 2). A random model's logits are ~N(0, 1): the top two of
# 10^5 are ~0.2 apart, so a good share of positions are near-ties; each
# is counted and printed, and only the first divergence of a sequence
# may be one.
NEAR_TIE_BF16 = (2.0 ** -6, 2.0 ** -6)
# apply_moe in f32 vs a per-token float64 loop (tests/test_ssm_moe_attention
# .py's atol, rtol): f32 sums of up to 5120 terms in another order
MOE_LOOP_TOL = (1e-4, 1e-3)
# a router near-tie: the k-th and (k+1)-th router probabilities (float64)
# closer than this, relative; the f32 router's logits (sums of 5120 f32
# products, ~1e-6 relative) may then rank the other expert k-th. Such a
# token is counted and printed, and held to the loop only if its experts
# agree.
MOE_ROUTER_TIE = 1e-5
MOE_SESSIONS = 5    # profiler sessions of one apply_moe call (its split)
# transform kernels vs plain versions. On dyadic (k/256) pixels the pooled
# sums are exact and x1/x0 projections too, so rgb/r/g/b must be equal;
# gray sums three products in another order (|err| <= ~2 ulp of 1, x4 by
# the normalization); on torch.rand pixels, tests/test_kernels.py's atol.
TRANSFORM_GRAY_TOL = 1e-6
TRANSFORM_TOL = 1e-5
FLASH_TEST_SHAPES = ((1, 2, 64, 32), (2, 3, 128, 64), (1, 1, 256, 16))
SSD_TEST_SHAPES = ((1, 64, 2, 8, 16), (2, 128, 3, 16, 32))
PROFILER_SESSIONS = 3   # device_ms: sessions tried before it gives up
# the LM training phase: the runtime's step whose launches are counted
# (0-based; the first steps warm the allocator up), and the gradients of
# an f32 zamba2 through the kernels against its CPU copy: max |diff| over
# the leaf's largest |g|. The two forwards sum in other orders (the SSD
# and flash kernels, cuBLAS against the CPU's GEMMs), ~1e-6 relative a
# layer; an indexing or layout fault moves a leaf's gradient by O(1).
COUNTED_STEP = 2
TRAIN_GRAD_TOL = 1e-3
# the tensor-parallel phase. Served in bf16, a rank's row-parallel
# products are two bf16 partial sums added (where one card rounds one f32
# sum once), so every block's output moves by an ulp or two (2^-8
# relative) and the two paths drift apart through zamba2's 44 blocks:
# prefill logits' max |diff| over the largest |logit|, within 2^-3; a
# head, vocab or shard fault, or a reduction missed, moves logits by
# their whole scale. The bf16 greedy tokens are printed beside the
# one-rank path's; their first differences are held in f32, where the
# two paths differ in the order of their sums only: the same weights
# widened to f32, prefill logits within CONSIST_TOL of the largest, and
# each row's greedy tokens equal but for a first difference at a
# near-tie (NEAR_TIE_BF16). The f32 train step likewise: the loss within
# TP_LOSS_TOL relative, each leaf's gradient within TRAIN_GRAD_TOL of its
# largest |g|.
TP_LOGIT_TOL = 2.0 ** -3
TP_LOSS_TOL = 1e-5
# apply_moe in bf16 on a rank's experts (the ranks' f32 partial sums
# all-reduced, cast once) against one card on the same input and
# routing: max |diff| over the largest |out|. The rank's batched expert
# GEMMs run at another batch count, so cuBLAS may round their bf16
# outputs otherwise (an ulp, 2^-8); a token lost or counted twice moves
# its output by its whole scale.
MOE_TP_TOL = 2.0 ** -6
# the tensor-parallel phase serves its MoE models' prefill (8 x 512
# prompt tokens, one routing group) at capacity factor 4: the busiest
# expert of a random router takes ~1.2x the mean, so no routed token is
# dropped, where no_drops's E/k (every expert a slot for every token of
# the group) would hold deepseek-v2's 160 experts x 4096 slots x 5120 (13
# GB a tensor in f32). Decode steps (8 tokens) take no_drops. The
# prefill's dropped choices are counted and printed.
TP_MOE_PREFILL_FACTOR = 4.0

# the context-parallel phase against the one-rank path: logits within
# this share of the largest |logit| (bf16: the two paths' softmax sums
# over 262144 positions a rank round in another order; f32: the order
# alone)
CP_LOGIT_TOL = {"bfloat16": 0.05, "float32": 1e-5}
# the ZeRO phase's AdamW eps: its first step moves a parameter by
# lr g / (|g| + eps), and at the default 1e-8 a gradient within f32
# rounding of 0 moves it by up to lr either way (a zero-initialized bias
# by its whole largest |x|); at 1e-3 the step is smooth in g, and an
# order-of-sums difference in g moves the parameter by less than it
ZERO_ADAMW_EPS = 1e-3
CP_WHOLE_WHY = ("gathering zamba2-1.2b's 2.34 GB of bf16 weights through "
                "the host each step (two gloo ranks on one card: the "
                "gather's ms are printed below) would take most of the "
                "phase's time")
# the moe/MLA/vlm/audio phase: (arch, depth served, depth of the f32
# consistency check); None: the published depth. phi3.5-moe's 16 layers
# are ~42 GB of bf16 weights, deepseek-v2's 4 ~34 GB, qwen2-vl's 4 ~12 GB.
FAMILY_MODELS = (("phi3.5-moe-42b-a6.6b", 16, 2), ("deepseek-v2-236b", 4, 1),
                 ("qwen2-vl-72b", 4, 2), ("whisper-tiny", None, None))
# floors: the least eval accuracy of the best model and of the trusted
# model (tests/test_system.py's)
FULL = dict(base=224, chunk=256, out_res=(112, 56, 28), split=512,
            train=1024, steps=90, floors=(0.85, 0.80), pinned=True,
            profile_steps=10, corpus=8192, gen_batch=512, stream=4096,
            stream_batch=512, join=2048,
            serve=dict(requests=4096, hot=64, host=512, pace=0.0005,
                       burst=2048, limit=64, faults=1024, ingest=256,
                       budget=256 << 20),
            resolutions=(28, 56, 112, 224),
            small_grid=False, mm_shapes=((33, 17, 65), (256, 64, 130),
                                         (128, 512, 1805), (128, 512, 361)),
            mm_probe=2048, iters=10,
            lm=dict(arch="zamba2-1.2b", full=True, batch=8, prompt=512,
                    gen=32, check_at=256),
            dense=dict(full=True, batch=8, prompt=512, gen=32, check_at=256,
                       check_layers=4, other_layers=2, spec_prompt=128,
                       spec_tokens=32, gamma=4, draft_layers=4, slots=8,
                       capacity=640, requests=24, prompt_range=(32, 512),
                       budget_range=(4, 32), context=128, calib=256,
                       eval=256, cascade_batch=32,
                       flash_shapes=(((2, 8, 200, 128), (2, 8, 333, 128)),
                                     ((2, 8, 333, 128), (2, 8, 200, 128)))),
            families=dict(full=True, models=FAMILY_MODELS, batch=8,
                          prompt=512, audio_prompt=128, gen=32,
                          check_batch=2, check_prompt=512, check_at=256,
                          moe_tokens=64, iters=10),
            # zamba2-1.2b training: 3 steps of 8 x 512 tokens at full
            # width and depth (step 0's first sequence, measured again
            # after training, must have lost loss_drop nats: on an
            # NVIDIA H100 80GB HBM3 at 700 W it went 10.94 -> 5.19 in 20
            # steps, -> 4.12 in 8, -> 3.50 in 5; 3, the fewest that reach
            # COUNTED_STEP, and the drill's 6 steps keep the run inside
            # its time limit on a slow host); the drill at 6 layers, batch
            # 1, 6 steps, a checkpoint every 2, failures at steps 2 and 4
            lm_train=dict(full=True, steps=3, batch=8, seq=512, lr=3e-4,
                          loss_drop=1.0, drill_layers=6, drill_batch=1,
                          drill_steps=6, every=2, fail_at=(2, 4),
                          grad_seq=256),
            # the fleet phase: one dry-run cell (256 fake ranks on the
            # host, ~15-30 s) and the two-rank pipeline where there are two
            # cards
            fleet=dict(dryrun=("zamba2-1.2b", "decode_32k"), timeout=300,
                       pipe=dict(n_micro=8, mb=256, d=4096, timeout=180)),
            # the tensor-parallel phase: (arch, layers served (None: its
            # published depth), batch, prompt, greedy steps, greedy steps
            # of the f32 check), and f32 train steps (layers, batch,
            # seq), on a (data 1, model 2) mesh; ``cuts`` printed
            tp=dict(full=True, model=2, timeout=480,
                    serve=(("zamba2-1.2b", None, 8, 512, 8, 4),
                           ("deepseek-7b", 4, 8, 512, 8, 8),
                           ("phi3.5-moe-42b-a6.6b", 2, 8, 512, 8, 8),
                           ("deepseek-v2-236b", 1, 8, 512, 8, 8),
                           ("whisper-tiny", None, 8, 128, 8, 8)),
                    cuts=("zamba2-1.2b's greedy steps 32 -> 8 and its f32 "
                          "check 8 -> 4 (the phase's time for the moe and "
                          "audio models)",),
                    train=(dict(arch="zamba2-1.2b", layers=None, batch=8,
                                seq=512),
                           dict(arch="phi3.5-moe-42b-a6.6b", layers=1,
                                batch=2, seq=256))),
            # the context-parallel phase: zamba2-1.2b whole at long_500k
            # (batch 1) on a (data 2, model 1) mesh, its bf16 cache at
            # seq_len 524288 (12.9 GB a rank), the f32 check at 65536
            # (3.2 GB a rank); a prompt, greedy steps from the prompt's end
            # and from the middle of the sequence; the weights' placement
            cp=dict(full=True, arch="zamba2-1.2b", data=2, prompt=512,
                    short=4, steps=8, chunk=8192, timeout=420,
                    seq={"bfloat16": 524288, "float32": 65536},
                    zero={"bfloat16": True, "float32": False}),
            # the ZeRO phase: zamba2-1.2b on a (data 2, model 1) mesh, a
            # train step of batch x seq tokens, one row a rank and
            # micro-batch; bf16 at full depth (at 19 of its 38 layers the
            # depth-independent activations put the rise at 92% of its
            # bound), f32 at one segment's depth
            zero=dict(full=True, arch="zamba2-1.2b", data=2, batch=4,
                      seq=512, lr=1e-5, timeout=300))
# the rehearsal's few steps teach its toy models little: no learning floor
REHEARSE = dict(base=32, chunk=32, out_res=(16, 8, 4), split=48, train=48,
                steps=3, floors=(0.0, 0.0), pinned=False, corpus=96,
                gen_batch=48, stream=96, stream_batch=40, join=48,
                serve=dict(requests=180, hot=8, host=24, pace=0.0005,
                           burst=40, limit=2, faults=90, ingest=8,
                           budget=8 << 20),
                resolutions=(4, 8, 16, 32), small_grid=True,
                mm_shapes=((33, 17, 65),), mm_probe=64, iters=1,
                lm=dict(arch="zamba2-1.2b", full=False, batch=2, prompt=64,
                        gen=4, check_at=32),
                dense=dict(full=False, batch=2, prompt=64, gen=4, check_at=32,
                           check_layers=2, other_layers=2, spec_prompt=16,
                           spec_tokens=8, gamma=4, draft_layers=1, slots=3,
                           capacity=80, requests=6, prompt_range=(8, 48),
                           budget_range=(2, 6), context=16, calib=48,
                           eval=32, cascade_batch=16,
                           flash_shapes=(((1, 2, 20, 128), (1, 2, 33, 128)),
                                         ((1, 2, 33, 128), (1, 2, 20, 128)))),
                families=dict(full=False, models=FAMILY_MODELS, batch=2,
                              prompt=32, audio_prompt=16, gen=4,
                              check_batch=2, check_prompt=32, check_at=16,
                              moe_tokens=16, iters=1),
                lm_train=dict(full=False, steps=4, batch=4, seq=32,
                              lr=3e-3, loss_drop=0.0, drill_layers=None,
                              drill_batch=2, drill_steps=6, every=2,
                              fail_at=(2, 4), grad_seq=32),
                fleet=dict(dryrun=("mamba2-130m", "decode_32k"), timeout=300,
                           pipe=dict(n_micro=3, mb=4, d=16, timeout=120)),
                tp=dict(full=False, model=2, timeout=300,
                        serve=(("zamba2-1.2b", None, 2, 64, 4, 2),
                               ("deepseek-7b", 2, 2, 64, 4, 2),
                               ("phi3.5-moe-42b-a6.6b", None, 2, 64, 4, 2),
                               ("deepseek-v2-236b", None, 2, 64, 4, 2),
                               ("whisper-tiny", None, 2, 16, 4, 2)),
                        cuts=(),
                        train=(dict(arch="zamba2-1.2b", layers=None,
                                    batch=4, seq=64),
                               dict(arch="phi3.5-moe-42b-a6.6b", layers=1,
                                    batch=2, seq=32))),
                cp=dict(full=False, arch="zamba2-1.2b", data=2, prompt=8,
                        short=4, steps=8, chunk=8, timeout=300,
                        seq={"bfloat16": 64, "float32": 32},
                        zero={"bfloat16": True, "float32": False}),
                zero=dict(full=False, arch="zamba2-1.2b", data=2, batch=4,
                          seq=32, lr=1e-5, timeout=300))


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # cuBLAS reads this once, at its first handle: with it, the training
    # drill's GEMMs are deterministic (torch.use_deterministic_algorithms).
    # The first handle comes phases before the drill, so it is set for the
    # whole run; on sm_90 it names the workspace PyTorch gives cuBLAS
    # there anyway (8 buffers of 4096 KiB), so the earlier phases' timed
    # cuBLAS comparisons run as they would without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repo "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    if not args.rehearse and not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    cfg = REHEARSE if args.rehearse else FULL
    dev = torch.device("cpu" if args.rehearse else "cuda")

    t_run = time.perf_counter()

    def phase(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)")
        return out
    card = phase(setup, dev)
    kern = phase(check_kernels, dev, cfg, card, args.seed)
    try:
        launches, query = phase(query_path, dev, cfg, card, kern, args.seed)
        ingest, before = phase(ingest_algebra_path, dev, cfg, kern,
                               args.seed, query)
        sharded = phase(sharded_path, dev, cfg, kern, query, before)
        serving = phase(serving_path, dev, cfg, card, kern, query, before)
        del query, before
        launches["fused_pyramid_stage0"] += ingest + sharded + serving
        launches.update(phase(lm_path, dev, cfg, card, kern, args.seed))
        kern["flash_attention"]["dense_launches"] = phase(
            dense_lm_path, dev, cfg, card, kern, args.seed)
        launches["flash_attention"] += \
            kern["flash_attention"]["dense_launches"]
        kern["flash_attention"]["families_launches"] = phase(
            families_lm_path, dev, cfg, card, kern, args.seed)
        launches["flash_attention"] += \
            kern["flash_attention"]["families_launches"]
        counted, train = phase(lm_training_path, dev, cfg, card, kern,
                               args.seed)
        for name, n in counted.items():
            kern[name]["training_launches"] = n
            launches[name] += n
        # the ZeRO ranks run on the card beside the fleet phase, which runs
        # on the host alone
        zero = zero_spawn(dev, cfg["zero"], "gloo", args.seed + 41)
        zero["beside"] = "beside the fleet phase"
        phase(fleet_tooling, dev, cfg, card, train)
        # the card to itself again before the next phases time their rows
        t0 = time.perf_counter()
        ranks_wait(zero)
        log(f"  (the ZeRO ranks, {zero['beside']}: waited for "
            f"{time.perf_counter() - t0:.1f} s after it)")
        for name, n in phase(tensor_parallel_path, dev, cfg, card, kern,
                             args.seed).items():
            kern[name]["tp_launches"] = n
            launches[name] += n
        for name, n in phase(context_parallel_path, dev, cfg, card, kern,
                             args.seed).items():
            kern[name]["cp_launches"] = n
            launches[name] += n
        for name, n in phase(zero_layers_path, dev, cfg, card, kern,
                             args.seed, zero).items():
            kern[name]["zero_launches"] = n
            launches[name] += n
    finally:
        ranks_stop()
    launches.update(phase(ops_path, dev, cfg, card, kern, args.seed))
    log(f"all phases: {time.perf_counter() - t_run:.1f} s")
    if "smi" in card:    # again near the end: the card beside the numbers
        log(card["smi"])
    kernels_line(kern, launches)
    if args.rehearse:
        log("rehearsal on the CPU: plain versions only, no result")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------------------ phase 1 --
def setup(dev):
    import torch

    from repro_torch.device import resolve_device
    resolve_device(dev)                 # TF32 off, cudnn.benchmark off
    if dev.type != "cuda":
        return {"name": "cpu", "bw": 1.0, "flops": 1.0, "bf16": 1.0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    # the bounds' peaks: memory bytes/s, f32 FLOP/s outside the tensor
    # cores (f32 FFMA), and dense bf16 tensor-core FLOP/s (the least time
    # attention's bf16 products could take), from launch/hw's table
    from repro_torch.launch import hw
    row = hw.peaks(name)
    bw, flops, bf16 = row.hbm_bw, row.f32_flops, row.bf16_flops
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks used "
        f"for bounds (launch/hw, {row.part}): {bw / 1e12:.2f} TB/s, "
        f"{flops / 1e12:.0f} TFLOP/s f32, {bf16 / 1e12:.0f} TFLOP/s bf16 "
        f"tensor cores")
    from repro_torch.kernels import build
    build.build_all()
    info = build.BUILD_INFO
    log(f"kernel build: {info['seconds']:.1f} s into {info['dir']} "
        f"(built {info['built']})")
    for stem, text in info["logs"].items():
        for fn, props in ptxas_by_function(text):
            log(f"  ptxas {stem}: {fn}: {props}")
    return {"name": name, "smi": smi, "bw": bw, "flops": flops, "bf16": bf16}


def ptxas_by_function(text):
    """[(kernel, "R registers, S bytes smem, spill stores/loads")] from
    nvcc's -Xptxas -v output, kernel names demangled where c++filt is
    installed (dynamic shared memory is not in ptxas's count)."""
    import re
    import shutil
    rows, fn, props = [], None, {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, props = m.group(1), {}
            rows.append((fn, props))
        elif fn and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            props["spills"] = f"spills {m.group(1)}/{m.group(2)} bytes"
        elif fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            props["regs"] = (f"{regs} registers, "
                             f"{smem.group(1) if smem else 0} bytes smem")
    names = [f for f, _ in rows]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True
                               ).stdout.splitlines() or names
    return [(n, ", ".join(p[k] for k in ("regs", "spills") if k in p))
            for n, (_, p) in zip(names, rows)]


# ------------------------------------------------------------ phase 2 --
def time_ms(fn, dev, iters: int) -> float:
    import torch
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, dev, iters: int, launches=None):
    """Device time of one ``fn()``: for each kernel (or memset) it
    launches, the median duration of its launches times its launches per
    call, from torch.profiler over ``iters`` calls. Host time between
    launches is not in it, so a call whose host work outlasts its kernels
    is not host-bound here (time_ms shows that). CUPTI tracing, at times,
    loses device events: the medians and the rounded launches per call
    stand up to a lost part; a session that recorded no event at all is
    opened again, at most PROFILER_SESSIONS in all, and then the device
    time is None (not measured: the CUDA-event clock, time_ms, still is).
    With a dict ``launches``, each launch's duration (us) is appended to
    ``launches[kernel name]``. On the CPU (rehearsal) it is time_ms."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return time_ms(fn, dev, iters)
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if by_name:
            break
    else:
        log(f"    (device time not measured: {PROFILER_SESSIONS} profiler "
            f"sessions recorded no device event)")
        return None
    if any(len(us) % iters for us in by_name.values()):
        log(f"    (the profiler lost device events: "
            f"{sum(map(len, by_name.values()))} for {iters} calls of "
            f"{len(by_name)} kernels; per-launch medians used)")
    for name, us in by_name.items() if launches is not None else ():
        launches.setdefault(name, []).extend(us)
    return sum(statistics.median(us) * max(1, round(len(us) / iters))
               for us in by_name.values()) / 1e3


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def alternating(label, fns, dev, iters, reps=3):
    """Two functions timed in the order a, b, b, a (``reps`` times) on two
    clocks: CUDA events around ``iters`` back-to-back calls (time_ms, the
    host included where it is the slower side: the clock of every ``ms``
    in the kernels line) and device time (device_ms). Prints each clock's
    runs in order with median and spread, and each kernel's per-launch
    device time. -> {name: {"ms": (median, spread), "device_ms": (median,
    spread)}}."""
    import statistics
    got = {name: {"ms": [], "device_ms": [], "launches": {}}
           for name, _ in fns}
    for _ in range(reps):
        for name, fn in (fns[0], fns[1], fns[1], fns[0]):
            g = got[name]
            g["ms"].append(time_ms(fn, dev, iters))
            g["device_ms"].append(device_ms(fn, dev, iters, g["launches"]))
    out = {}
    log(f"  {label} ({reps} x kernel, library, library, kernel):")
    for name, g in got.items():
        out[name] = {}
        for c, what in (("ms", "CUDA events, host included"
                         if dev.type == "cuda" else "host time"),
                        ("device_ms", "device time" if dev.type == "cuda"
                         else "host time, rehearsal")):
            runs = [x for x in g[c] if x is not None]
            m, sp = ((statistics.median(runs), max(runs) - min(runs))
                     if runs else (None, None))
            out[name][c] = (m, sp)
            log(f"    {name} {what}: median {_ms(m)} ms, spread {_ms(sp)} "
                f"(runs {' '.join(_ms(x) for x in g[c])})")
        for kname, us in g["launches"].items():
            us = sorted(us)
            log(f"      {name} launch {kname[:70]}: {len(us)}x, min "
                f"{us[0]:.2f} us, p10 {us[len(us) // 10]:.2f}, median "
                f"{statistics.median(us):.2f}, p90 "
                f"{us[len(us) * 9 // 10]:.2f}, max {us[-1]:.2f}")
    return out


def stage0_for(arch, rep, gen, dev):
    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.core.executor import Stage0
    from repro_torch.models.cnn import init_cnn, quantize_cnn
    cfg = TahomaCNNConfig(arch[0], arch[1], arch[2], input_hw=rep.resolution,
                          input_channels=rep.channels)
    params = init_cnn(gen, cfg, device=dev)
    return Stage0(params, rep, quantize_cnn(params)), cfg


def dyadic(n, hw, gen, dev):
    import torch
    return torch.randint(0, 256, (n, hw, hw, 3), generator=gen,
                         device=gen.device).to(dev).float() / 256.0


def check_stage0(imgs, out_res, s0, label) -> float:
    """Kernel vs plain version, f32 and int8: levels torch.equal, scores
    within SCORE_TOL. Returns the largest score deviation."""
    import torch

    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    worst = 0.0
    for qp, kind in ((None, "f32"), (s0.qparams, "int8")):
        lv, sc = fused_pyramid_stage0(imgs, out_res, s0.params, s0.rep,
                                      qparams=qp)
        rl, rs = fused_pyramid_stage0_ref(imgs, out_res, s0.params, s0.rep,
                                          qparams=qp)
        for r in out_res:
            if not torch.equal(lv[r], rl[r]):
                raise AssertionError(f"{label} {kind}: level {r} differs "
                                     f"from the plain version")
        if sc.shape != rs.shape or not torch.isfinite(sc).all():
            raise AssertionError(f"{label} {kind}: bad scores")
        err = float((sc - rs).abs().max())
        log(f"  fused_pyramid_stage0 {label} {kind}: levels equal, "
            f"max |score err| {err:.3g}")
        if err > SCORE_TOL:
            raise AssertionError(f"{label} {kind}: score error {err} > "
                                 f"{SCORE_TOL}")
        worst = max(worst, err)
    return worst


def stage0_bound_ms(card, b, base, out_res, s0, cfg) -> tuple[float, str]:
    """Least time for one chunk: each input byte read once (frames and
    weights), each output written once, vs the f32 FLOPs of the pooling
    adds, color projection and CNN."""
    from repro_torch.core.transforms import plan_pyramid
    from repro_torch.models.cnn import cnn_flops
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(s0.params))
    nbytes = (b * base * base * 3 * 4 + wbytes + b * 4
              + sum(b * r * r * 3 * 4 for r in out_res))
    steps = plan_pyramid(set(out_res) | {s0.rep.resolution}, base)
    ops = b * (sum(st.source ** 2 * 3 for st in steps)
               + 5 * s0.rep.resolution ** 2 + cnn_flops(cfg))
    t_mem, t_ops = nbytes / card["bw"], ops / card["flops"]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem > t_ops else "operations"


def _leaves(tree):
    import torch
    if torch.is_tensor(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def check_kernels(dev, cfg, card, seed):
    import torch

    from repro_torch.core.transforms import Representation
    from repro_torch.kernels.bindings import matmul_plan
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ref import matmul_ref
    log("== kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, base = cfg["chunk"], cfg["base"]
    res = cfg["resolutions"]
    imgs = dyadic(b, base, gen, dev)
    out_res = list(cfg["out_res"])
    # grid extremes, the main-path-sized case, the trusted model, and
    # widths that are no multiple of 4 (the one-channel conv and the
    # unvectorized dense pass)
    cases = [((1, 16, 16), Representation(res[0], "gray")),
             ((4, 32, 64), Representation(res[3], "rgb")),
             ((2, 32, 64), Representation(res[1], "rgb")),
             ((3, 48, 64), Representation(res[3], "rgb")),
             ((1, 15, 13), Representation(res[0], "rgb"))]
    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    worst = 0.0
    for arch, rep in cases:
        s0, s0cfg = stage0_for(arch, rep, gen, dev)
        worst = max(worst, check_stage0(imgs, out_res, s0,
                                        f"{rep.name} {arch}"))
        ms = time_ms(lambda: fused_pyramid_stage0(imgs, out_res, s0.params,
                                                  s0.rep), dev, cfg["iters"])
        dms = device_ms(lambda: fused_pyramid_stage0(imgs, out_res,
                                                     s0.params, s0.rep),
                        dev, cfg["iters"])
        plain = time_ms(lambda: fused_pyramid_stage0_ref(imgs, out_res,
                                                         s0.params, s0.rep),
                        dev, cfg["iters"])
        bound, by = stage0_bound_ms(card, b, base, out_res, s0, s0cfg)
        log(f"  fused_pyramid_stage0 {rep.name} {arch} chunk {b} f32: "
            f"kernel {ms:.4f} ms (device {_ms(dms)}), plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")

    # the pooling kernel's other paths: levels that are no chain 2, 4, 8
    # times smaller than the base (pooled in shared memory, tiles narrower
    # than a row), and frames whose rows are not 16-byte aligned (loaded
    # without the bulk-copy ring)
    s0, _ = stage0_for((1, 16, 16), Representation(res[0], "gray"), gen, dev)
    worst = max(worst, check_stage0(imgs, [res[2], base // 16], s0,
                                    "levels no chain"))
    shifted = torch.empty(imgs.numel() + 1, device=dev)[1:].view_as(imgs)
    shifted.copy_(imgs)
    worst = max(worst, check_stage0(shifted, out_res, s0,
                                    "frames 4 bytes off 16-byte alignment"))

    mm = {"max_abs_err": 0.0}
    for m, k, n in cfg["mm_shapes"]:
        for dt, out_dt in ((torch.float32, torch.float32),
                           (torch.bfloat16, torch.bfloat16),
                           (torch.bfloat16, torch.float32)):
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            bm = torch.randn((k, n), generator=gen, device=dev).to(dt)
            got = matmul(a, bm, out_dtype=out_dt).float()
            again = matmul(a, bm, out_dtype=out_dt).float()
            want = matmul_ref(a, bm, out_dt).float()
            tol = MM_TOL[str(dt).split(".")[1]]
            bad = (got - want).abs() > tol + tol * want.abs()
            err = float((got - want).abs().max())
            log(f"  matmul ({m},{k})@({k},{n}) {dt}->{out_dt}: max |err| "
                f"{err:.3g} (tol {tol}), plan {matmul_plan(m, n, k)}, rerun "
                f"bit-identical: {torch.equal(got, again)}")
            if bad.any():
                raise AssertionError(f"matmul {m},{k},{n} {dt}: {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"matmul {m},{k},{n} {dt}: a rerun "
                                     f"differs (split-K order not fixed)")
    return {"stage0": {"worst": worst}, "matmul": mm}


# ------------------------------------------------------------ phase 3 --
def synth(gen, labels, specs, hw, quantize=True):
    """Frames (N, hw, hw, 3) carrying ``labels``' (N, K) bool predicate
    signals, drawn on ``gen``'s device: ``repro_torch.data.synthetic``'s
    image model (8 x 8 blocks of N(0, 0.8) clutter repeated to hw px
    plus N(0, 0.18) a pixel; spec k's sinusoid of ``freq`` cycles at a
    uniform angle and phase added, ``amplitude`` high, to channel
    ``channel`` of its positive rows; 0.5 + 0.18 x clipped to [0, 1];
    with ``quantize`` floored to k/256 dyadics, so pyramid derivation
    stays bit-exact) with torch's generator for numpy's. The run's
    ~22500 frames take the card a second; numpy took the host ~170 s."""
    import torch
    dev, n = gen.device, len(labels)
    k = hw // 8
    x = (torch.randn((n, 8, 8, 3), generator=gen, device=dev) * 0.8
         ).repeat_interleave(k, 1).repeat_interleave(k, 2)
    x += 0.18 * torch.randn((n, hw, hw, 3), generator=gen, device=dev)
    yy, xx = torch.meshgrid(*[torch.arange(hw, device=dev,
                                           dtype=torch.float32)] * 2,
                            indexing="ij")
    for j, spec in enumerate(specs):
        phase = torch.rand(n, generator=gen, device=dev) * (2 * math.pi)
        theta = torch.rand(n, generator=gen, device=dev) * math.pi
        rows = labels[:, j].nonzero()[:, 0]
        c, s, p = (t[rows, None, None] for t in (theta.cos(), theta.sin(),
                                                  phase))
        x[rows, :, :, spec.channel] += spec.amplitude * torch.sin(
            2 * math.pi * spec.freq * (c * xx + s * yy) / hw + p)
    x = (0.5 + 0.18 * x).clamp_(0.0, 1.0)
    if quantize:
        x = (x * 256).floor_().clamp_(max=255) / 256
    return x


def _gen(dev, seed):
    import torch
    return torch.Generator(device=dev).manual_seed(seed)


def stream_on(dev, specs, n, hw, seed, hold_max=4):
    """``make_camera_stream``'s piecewise-constant scenes, drawn on the
    card: each scene a dyadic frame (its predicates positive at 0.5) held
    for 1..hold_max frames, each held repeat with independent +-1/256
    jitter a pixel. -> (frames float32, labels int32, scene id int64),
    numpy on the host."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 1_000_003)
    holds = []
    while sum(holds) < n:
        holds.append(int(rng.integers(1, max(2, hold_max + 1))))
    scene = np.repeat(np.arange(len(holds)), holds)[:n]
    gen = _gen(dev, seed)
    lab = torch.rand((len(holds), len(specs)), generator=gen,
                     device=dev) < 0.5
    sid = torch.from_numpy(scene).to(dev)
    frames = synth(gen, lab, specs, hw)[sid]
    held = torch.from_numpy(np.r_[False, scene[1:] == scene[:-1]]).to(dev)
    jitter = torch.randint(-1, 2, (int(held.sum()), hw, hw, 3),
                           generator=gen, device=dev, dtype=torch.int8)
    frames[held] = (frames[held] + jitter / 256).clamp_(0.0, 1.0)
    return (frames.cpu().numpy(), lab[sid].int().cpu().numpy(),
            scene.astype(np.int64))


def cameras_on(dev, specs, n, hw, seed, positive_rate=0.4, corr=0.6,
               dt_max=2, gap=8):
    """``make_two_camera_corpus``'s two correlated cameras: its labels and
    timestamps (the same numpy draws), each camera's dyadic frames drawn
    on the card; -> ((frames on the card, labels, t), ...), each camera
    sorted by its timestamps."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 7_654_321)
    t_a = (np.arange(n, dtype=np.int64) * gap
           + rng.integers(0, max(gap // 2, 1), size=n))
    lab_a = (rng.random((n, len(specs))) < positive_rate).astype(np.int32)
    paired = rng.random(n) < corr
    lab_b = np.empty_like(lab_a)
    t_b = np.empty(n, np.int64)
    lab_b[paired] = lab_a[paired]
    t_b[paired] = t_a[paired] + rng.integers(-dt_max, dt_max + 1,
                                             size=int(paired.sum()))
    free = ~paired
    lab_b[free] = (rng.random((int(free.sum()), len(specs)))
                   < positive_rate).astype(np.int32)
    t_b[free] = (rng.integers(0, n, size=int(free.sum())) * gap
                 + gap // 2)
    out = []
    for cam, (labels, t) in enumerate(((lab_a, t_a), (lab_b, t_b))):
        x = synth(_gen(dev, seed + 31 * (cam + 1)),
                  torch.from_numpy(labels).to(dev).bool(), specs, hw)
        order = np.argsort(t, kind="stable")
        out.append((x[torch.from_numpy(order).to(dev)], labels[order],
                    t[order]))
    return out[0], out[1]


def grid(cfg):
    """The query phase's model grid: its architectures, its
    representations ({resolutions} x five colors), and {entry name: sized
    config} in ``train_model_grid``'s order, the trusted model last."""
    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.configs.tahoma_cnn import architecture_space
    from repro_torch.core.transforms import COLOR_REPS, Representation
    archs = architecture_space(small=cfg["small_grid"])
    reps = [Representation(r, c) for r in cfg["resolutions"]
            for c in COLOR_REPS]
    sized = {}
    for a in archs:
        for rep in reps:
            c = TahomaCNNConfig(a.n_conv_layers, a.conv_nodes, a.dense_nodes,
                                input_hw=rep.resolution,
                                input_channels=rep.channels)
            sized[f"{c.arch_id}_{rep.name}"] = c
    t = TahomaCNNConfig(3, 48, 64, input_hw=cfg["base"], input_channels=3)
    sized[f"trusted_{t.arch_id}"] = t
    return archs, reps, sized


def pinned_costs(cfg, sized):
    """The per-model inference costs (s/image) the query phase plans with:
    COSTS (measured by benchmarks/torch_infer_costs.py on the card named
    in it) at full size, raising on a name missing or extra; at the
    rehearsal's toy grid, each model's FLOPs at 1 TFLOP/s."""
    from repro_torch.models.cnn import cnn_flops
    if not cfg["pinned"]:
        log("  pinned inference costs: rehearsal grid, FLOPs at 1 TFLOP/s")
        return {n: cnn_flops(c) / 1e12 for n, c in sized.items()}, "toy"
    data = json.loads(COSTS.read_text())
    missing = sorted(set(sized) - set(data["infer_s"]))
    extra = sorted(set(data["infer_s"]) - set(sized))
    if missing or extra:
        raise AssertionError(f"{COSTS.name}: missing {missing}, extra "
                             f"{extra}")
    label = f"{data['card']}, {data['power_limit']}"
    log(f"  pinned inference costs: {COSTS.relative_to(ROOT)} ({label}; "
        f"{data['method']})")
    return {n: float(data["infer_s"][n]) for n in sized}, label


def train_systems(dev, cfg, seed, specs, archs, reps, sized, infer_s):
    """``initialize_system`` per predicate on the card: the grid and the
    trusted model trained on a ``cfg["train"]``-frame split, thresholds
    from the config split, eval scores, costs pinned to ``infer_s``. Prints training time, steps/s and
    accuracies and holds them to the learning floors (check a); also
    measures the costs once more and prints them against the pinned ones.
    -> ({name: system}, {name: host train split})."""
    import numpy as np

    from repro_torch.core.pipeline import (initialize_system,
                                           profile_infer_costs)
    from repro_torch.data.synthetic import make_corpus
    base, steps = cfg["base"], cfg["steps"]
    n_steps = len(archs) * len(reps) * steps + 3 * steps
    floor_best, floor_trusted = cfg["floors"]
    systems, train = {}, {}
    for spec in specs:
        t0 = time.perf_counter()
        tr = make_corpus(spec, cfg["train"], hw=base, seed=seed + 30)
        cf = make_corpus(spec, cfg["split"], hw=base, seed=seed + 10)
        ev = make_corpus(spec, cfg["split"], hw=base, seed=seed + 20)
        t_data = time.perf_counter() - t0
        marks = []

        def mark(_msg):
            _sync(dev)      # each model's steps end on the card, not the host
            marks.append(time.perf_counter())

        _sync(dev)
        t0 = time.perf_counter()
        system = initialize_system(tr, cf, ev, archs, reps, steps=steps,
                                   seed=seed, log=mark, infer_s=infer_s,
                                   device=dev)
        t_all = time.perf_counter() - t0
        t_train = marks[-1] - t0
        if system.bank.names != list(sized):
            raise AssertionError(f"{spec.name}: bank names differ from the "
                                 f"grid's")
        secs = np.diff([t0] + marks)
        by_res = {r: float(sum(d for d, e in zip(secs, system.bank.entries)
                               if e.rep.resolution == r and not e.trusted))
                  for r in cfg["resolutions"]}
        acc = ((system.eval_scores >= 0.5)
               == system.eval_truth[None].astype(bool)).mean(1)
        ti = system.bank.trusted_index
        best = int(np.argmax(acc))
        log(f"  {spec.name}: {len(system.bank.entries)} models trained on "
            f"{cfg['train']} frames ({cfg['split']}-frame config and eval "
            f"splits, made in {t_data:.1f} s): {n_steps} steps in "
            f"{t_train:.2f} s ({n_steps / t_train:.0f} steps/s), then "
            f"thresholds and eval scores in {t_all - t_train:.2f} s; "
            f"training seconds by input size "
            f"{ {r: round(d, 2) for r, d in by_res.items()} }, trusted "
            f"{secs[-1]:.2f}")
        log(f"  {spec.name}: eval accuracy best {acc[best]:.4f} "
            f"({system.bank.names[best]}), trusted {acc[ti]:.4f}, bank mean "
            f"{acc.mean():.4f} (floors: best > {floor_best}, trusted > "
            f"{floor_trusted})")
        if not (acc[best] > floor_best and acc[ti] > floor_trusted):
            raise AssertionError(f"{spec.name}: the models did not learn")
        measured = profile_infer_costs(system.bank, ev[0])
        ratio = sorted(measured[n] / infer_s[n] for n in sized)
        log(f"  {spec.name}: inference costs measured in this run / pinned: "
            f"min {ratio[0]:.3f}, median {ratio[len(ratio) // 2]:.3f}, max "
            f"{ratio[-1]:.3f} (the plan uses the pinned ones)")
        systems[spec.name] = system
        train[spec.name] = tr
    return systems, train


def paper_figures(name, system, cost_label):
    """The paper's Fig. 6 and Fig. 7 figures of one predicate's trained
    system through core/alc: the cascade that best matches the trusted
    model's accuracy, and the fastest cascade, each over the trusted
    model alone, under INFER_ONLY and CAMERA (dense spaces), and the
    CAMERA Pareto frontier's size."""
    import numpy as np

    from repro_torch.core.alc import best_matching
    from repro_torch.core.selector import pareto_set
    ti = system.bank.trusted_index
    log(f"  {name}: Pareto frontier (CAMERA) "
        f"{len(pareto_set(system.cascade_space('CAMERA')))} cascades")
    for scen in ("INFER_ONLY", "CAMERA"):
        sp = system.cascade_space(scen)
        j = best_matching(sp.acc, sp.throughput, sp.acc[ti])
        f = int(np.argmax(sp.throughput))
        log(f"  {name} {scen}, modeled from the pinned costs ({cost_label}): "
            f"Fig. 6 best match at the trusted model's accuracy "
            f"{sp.acc[ti]:.4f}: {sp.throughput[j] / sp.throughput[ti]:.2f}x "
            f"the trusted model (acc {sp.acc[j]:.4f}, "
            f"{sp.describe(j, system.bank.names, system.targets)}); Fig. 7 "
            f"fastest cascade {sp.throughput[f] / sp.throughput[ti]:.2f}x "
            f"(acc {sp.acc[f]:.4f})")


def check_oracles(plan, systems):
    """Check c: for every cascade of the plan and of each predicate's CAMERA
    Pareto frontier, the dense evaluator's acc and time on the trained
    eval scores equal the per-image oracles ``simulate_cascade`` and
    ``cascade_time_naive`` (abs 1e-5 on acc, rel 1e-5 on time:
    tests/test_cascade.py's tolerances)."""
    import numpy as np

    from repro_torch.core.cascade import (cascade_time_naive,
                                          simulate_cascade, spec_levels)
    from repro_torch.core.selector import pareto_set
    worst = [0.0, 0.0]
    n = 0
    for name, system in systems.items():
        sp = system.cascade_space(plan.scenario)
        picks = {int(p.selection.index) for p in plan.predicates
                 if p.cascade.concept == name}
        infer = np.array([system.infer_s[m] for m in system.bank.names])
        for i in sorted(picks | {int(i) for i in pareto_set(sp)}):
            levels = spec_levels(sp, i, system.p_low, system.p_high)
            acc, _ = simulate_cascade(levels, system.eval_scores,
                                      system.eval_truth)
            t = cascade_time_naive(levels, system.eval_scores,
                                   system.bank.reps, infer, system.profile,
                                   plan.scenario)
            e_acc, e_t = abs(sp.acc[i] - acc), abs(sp.time_s[i] - t) / t
            if e_acc > 1e-5 or e_t > 1e-5:
                raise AssertionError(f"{name}: cascade {i} acc {sp.acc[i]} "
                                     f"vs {acc}, time {sp.time_s[i]} vs {t}")
            worst = [max(worst[0], e_acc), max(worst[1], e_t)]
            n += 1
    log(f"  per-image oracles: {n} cascades (the plan's and every CAMERA "
        f"frontier's): dense evaluator == simulate_cascade / "
        f"cascade_time_naive, max |acc err| {worst[0]:.3g}, max rel time "
        f"err {worst[1]:.3g}")


def check_retrain(dev, cfg, seed, system, train_split, casc0, reps):
    """Check b: the planned stage-0 model and the trusted model of the first
    planned predicate, trained again from the same seed on the same
    split, are bit for bit the bank's; then one of their training runs is
    profiled (idle share, top kernels)."""
    import torch

    from repro_torch.core.pipeline import train_cnn
    from repro_torch.core.transforms import materialize_representations
    from repro_torch.train.optimizer import tree_leaves
    bank = system.bank
    x, y = train_split
    raw = torch.as_tensor(x, device=dev)
    loop_check(dev, raw, y, reps, cfg["steps"])
    reps_x = materialize_representations(raw, reps)
    m0 = next(m for m, e in enumerate(bank.entries)
              if e.params is casc0.stage0.params)
    steps = cfg["steps"]
    for m in sorted({m0, bank.trusted_index}):
        e = bank.entries[m]
        if e.trusted:
            inputs, kw = raw, dict(steps=steps * 3, seed=seed + 999)
        else:
            inputs, kw = reps_x[e.rep], dict(steps=steps,
                                             seed=seed + m // len(reps))
        _sync(dev)
        t0 = time.perf_counter()
        again = train_cnn(e.arch, inputs, y, device=dev, **kw)
        _sync(dev)
        secs = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(again), tree_leaves(e.params)))
        log(f"  {casc0.concept} {e.name} trained again ({kw['steps']} steps "
            f"in {secs:.3f} s): bit-identical to the bank's: {same}")
        if not same:
            raise AssertionError(f"{e.name}: training is not deterministic")
        if dev.type == "cuda":
            n = cfg["profile_steps"]
            kw["steps"] = n
            _sync(dev)
            t0 = time.perf_counter()
            train_cnn(e.arch, inputs, y, device=dev, **kw)
            _sync(dev)
            device_profile(lambda: train_cnn(e.arch, inputs, y, device=dev,
                                             **kw), dev,
                           time.perf_counter() - t0,
                           f"training profile ({e.name}, {n} steps)")


def loop_check(dev, raw, y, reps, steps):
    """``fit_cnn``'s loop (on a card: one step captured in a CUDA graph and
    replayed) against the same step run eagerly, ``steps`` times, for a
    grid model (cnn_l1_c16_d16 in gray at the smallest size) from the
    same initial weights: bit-identical, or the capture changed what a
    step computes (a counter, batch or reset fault)."""
    import torch

    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.core.pipeline import (_deterministic_cudnn,
                                           _training_step, fit_cnn)
    from repro_torch.core.transforms import (Representation,
                                             materialize_representations)
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.optimizer import tree_leaves
    rep = Representation(min(r.resolution for r in reps), "gray")
    x = materialize_representations(raw, reps)[rep]
    cfg = TahomaCNNConfig(1, 16, 16, input_hw=rep.resolution,
                          input_channels=1)
    init = init_cnn(torch.Generator(device=dev).manual_seed(7), cfg,
                    device=dev)
    looped = tree_leaves(fit_cnn(init, x, y, steps=steps, device=dev))
    eager, _, step = _training_step(init, x, y, steps=steps, batch=16,
                                    lr=3e-3, seed=0, device=dev)
    with _deterministic_cudnn():
        for _ in range(steps):
            step()
    same = all(torch.equal(a, b.detach()) for a, b in zip(looped, eager))
    log(f"  fit_cnn's loop on {dev.type} vs its step run eagerly, "
        f"{cfg.arch_id} at {rep.name}, {steps} steps: bit-identical: {same}")
    if not same:
        raise AssertionError("the training loop differs from its step run "
                             "eagerly")


def make_corpus_on(dev, cfg, specs, seed):
    """``make_multi_corpus``'s dyadic multi-predicate corpus (each
    predicate positive at 0.4), drawn on the card in batches into one
    tensor."""
    import torch
    n, hw, gb = cfg["corpus"], cfg["base"], cfg["gen_batch"]
    corpus = torch.empty((n, hw, hw, 3), device=dev)
    for i, lo in enumerate(range(0, n, gb)):
        gen = _gen(dev, seed + 100 + i)
        lab = torch.rand((min(gb, n - lo), len(specs)), generator=gen,
                         device=dev) < 0.4
        corpus[lo:lo + len(lab)] = synth(gen, lab, specs, hw)
    return corpus


def check_stream_vs_dense(name, system):
    """The streaming frontier (kernel path) against the dense evaluator:
    every dense-frontier cascade is in the streaming survivor set (or
    tied with one to 1e-6), and matched cascades agree to f32 tolerance
    (the reference's test_streaming_matches_dense)."""
    from repro_torch.core.pareto import pareto_indices
    st = system.space_cache[("CAMERA", 3, True)]
    sp = system.cascade_space("CAMERA")
    if st.evaluated != len(sp):
        raise AssertionError(f"{name}: streaming scored {st.evaluated} "
                             f"cascades, dense {len(sp)}")
    lookup = {(int(k), int(a), int(b)): j for j, (k, a, b) in
              enumerate(zip(sp.kind, sp.i1, sp.i2))}
    for j in range(len(st)):
        d = lookup[(int(st.kind[j]), int(st.i1[j]), int(st.i2[j]))]
        if abs(st.acc[j] - sp.acc[d]) > 1e-5 or \
                abs(st.time_s[j] - sp.time_s[d]) > 2e-5 * sp.time_s[d]:
            raise AssertionError(f"{name}: cascade {d} differs")
    ids = {(int(k), int(a), int(b)) for k, a, b in
           zip(st.kind, st.i1, st.i2)}
    for i in pareto_indices(sp.acc, sp.throughput):
        ident = (int(sp.kind[i]), int(sp.i1[i]), int(sp.i2[i]))
        if ident not in ids and not any(
                abs(sp.acc[i] - st.acc[j]) < 1e-6
                and abs(sp.time_s[i] - st.time_s[j]) < 1e-6 * sp.time_s[i]
                for j in range(len(st))):
            raise AssertionError(f"{name}: frontier cascade {ident} lost")
    log(f"  {name}: streaming frontier ({len(st)} of {st.evaluated} "
        f"cascades) == dense frontier")


def _at_width(corpus, rows, width, score):
    """score(imgs) for each of ``rows``, launched in slabs of ``width``
    rows (each padded by repeating its last row, as the engines pad)."""
    import numpy as np
    import torch
    out = []
    for lo in range(0, len(rows), width):
        part = rows[lo:lo + width]
        idx = np.concatenate([part, np.repeat(part[-1:], width - len(part))])
        imgs = corpus[torch.as_tensor(idx, device=corpus.device)]
        out += score(imgs)[:len(part)].tolist()
    return out


def straddles(corpus, cascades, rows, chunk, *, int8=False, index=None,
              widths=()):
    """{row: (where, scores)} for the rows of ``rows`` on which two
    routes of some cascade's level give scores on opposite sides of one
    of that level's f32 thresholds and within SCORE_TOL of each other.
    Level 0's routes: the fused kernel and the plain version, each at the
    scan's batch width ``chunk``, and, with an ingest ``index``, the
    score it recorded for the row (a reference frame scored at ingest).
    With ``widths`` (a sharded scan's slab widths), level 0 is also
    scored by both routes at each of them, and every later level through
    its model at ``chunk`` and at each of them. ``int8`` scores the first
    cascade on its int8 weights."""
    import numpy as np

    from repro_torch.core.transforms import color_transform, resize_area
    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    out = {}
    rows = np.asarray(rows, np.int64)
    if not len(rows):
        return out
    for pos, casc in enumerate(cascades):
        s0 = casc.stage0
        qp = s0.qparams if int8 and pos == 0 else None
        for lvl in range(len(casc.model_fns) if widths else 1):
            lo, hi = casc.thresholds[lvl]
            ts = [float(np.float32(t)) for t in ([0.5] if lo is None
                                                else [lo, hi])]
            routes = []
            for w in (chunk, *widths):
                if lvl == 0:
                    for fn in (fused_pyramid_stage0,
                               fused_pyramid_stage0_ref):
                        routes.append(_at_width(
                            corpus, rows, w,
                            lambda x, fn=fn: fn(x, [], s0.params, s0.rep,
                                                qparams=qp)[1]))
                else:
                    rep, model = casc.reps[lvl], casc.model_fns[lvl]
                    routes.append(_at_width(
                        corpus, rows, w,
                        lambda x, rep=rep, model=model: model(color_transform(
                            resize_area(x, rep.resolution), rep.color))))
            ing = None
            if lvl == 0 and index is not None and \
                    index.cascade_keys.get(casc.concept) == casc.key:
                ing = index.scores[casc.concept]
            where = casc.concept if lvl == 0 else f"{casc.concept}@{lvl}"
            for i, r in enumerate(rows.tolist()):
                got = [rt[i] for rt in routes]
                if ing is not None and not np.isnan(ing[r]):
                    got.append(float(ing[r]))
                if any(abs(x - y) <= SCORE_TOL
                       and ((x >= t) != (y >= t) or (x <= t) != (y <= t))
                       for x in got for y in got for t in ts):
                    out.setdefault(r, (where, tuple(got)))
    return out


def boundary_rows(corpus, cascades, rows, chunk, *, int8=False, index=None,
                  widths=()):
    """Of ``rows`` (where two paths disagree), each must be a threshold-
    boundary row of one of ``cascades`` (``straddles``): a flip explained
    by the stated f32 score tolerance. Raises on any other row; returns
    [(row, where, scores)]."""
    found = straddles(corpus, cascades, rows, chunk, int8=int8, index=index,
                      widths=widths)
    for r in rows:
        if int(r) not in found:
            raise AssertionError(
                f"row {int(r)}: the two paths differ and no cascade of "
                f"{[c.concept for c in cascades]} has scores of two "
                f"routes within {SCORE_TOL} across a threshold")
    return [(r, *found[r]) for r in sorted(found)]


def query_path(dev, cfg, card, kern, seed):
    """-> (launch counts on the path, what the later phases reuse: the
    trained systems, the joint plan, the corpus on the device, the
    predicate specs, the query, the f32 scan's rows and seconds and
    naive_scan's f32 rows)."""
    import numpy as np

    from repro_torch.data.synthetic import DEFAULT_PREDICATES
    from repro_torch.engine.planner import (PredicateClause, QuerySpec,
                                            plan_query)
    from repro_torch.engine.scan import ScanEngine, level_schedule, naive_scan
    from repro_torch.kernels import ops

    log("== query path")
    specs = DEFAULT_PREDICATES[:3]
    t0 = time.perf_counter()
    corpus = make_corpus_on(dev, cfg, specs, seed)
    _sync(dev)
    log(f"  corpus {tuple(corpus.shape)} on {corpus.device}: "
        f"{corpus.numel() * 4 / 1e9:.2f} GB, made on {dev.type} in "
        f"{time.perf_counter() - t0:.1f} s")
    query = QuerySpec(predicates=[PredicateClause(s.name) for s in specs])
    archs, reps, sized = grid(cfg)
    infer_s, cost_label = pinned_costs(cfg, sized)

    # ---- the main path, with the launch counts read around it: train ->
    # calibrate -> profile -> evaluate -> plan -> scan
    ops.reset_launch_counts()
    systems, train = train_systems(dev, cfg, seed, specs, archs, reps,
                                   sized, infer_s)
    _sync(dev)
    t0 = time.perf_counter()
    for system in systems.values():      # the matmul kernel's caller
        system.cascade_space("CAMERA", streaming=True)
    _sync(dev)
    t_eval = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_query(systems, query, scenario="CAMERA", joint=True)
    t_plan = time.perf_counter() - t0
    runs = {}
    for int8 in (False, True):
        # a cold scan, then the timed one on a fresh store (same work; the
        # first also pays one-time allocator and library set-up)
        eng = ScanEngine(corpus, chunk=cfg["chunk"], int8=int8, device=dev)
        cold = eng.execute(plan.cascades)
        eng.reset_cache()
        _sync(dev)
        t0 = time.perf_counter()
        res = eng.execute(plan.cascades)
        _sync(dev)
        runs[int8] = (res, time.perf_counter() - t0, eng)
        if not np.array_equal(cold.indices, res.indices):
            raise AssertionError("a re-run on a fresh store differs")
    launches = dict(ops.LAUNCHES)
    log(f"  streaming evaluation (3 concepts): {t_eval:.3f} s; joint plan "
        f"(dense numpy spaces): {t_plan:.2f} s")
    log(plan.explain(n_rows=cfg["corpus"], base_hw=cfg["base"],
                     actual=runs[False][0].stats))
    launches = {k: launches[k] for k in ("fused_pyramid_stage0", "matmul")}
    log(f"  launches on the main path: {launches}")
    if dev.type == "cuda":
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"{name} was not launched on the path")

    for name, system in systems.items():
        check_stream_vs_dense(name, system)
        paper_figures(name, system, cost_label)
    check_oracles(plan, systems)
    casc0 = plan.cascades[0]
    naive_rows = {}
    for int8, (res, secs, _) in runs.items():
        st = res.stats
        kind = "int8" if int8 else "f32"
        log(f"  scan {kind}: {len(res.indices)} rows of {cfg['corpus']}, "
            f"{st.chunks} chunks, {secs * 1e3 / st.chunks:.3f} ms/chunk, "
            f"{cfg['corpus'] / secs:.0f} rows/s, rows evaluated per stage "
            f"{[s.rows_evaluated for s in st.stages]}, level rows "
            f"{st.level_rows}")
        t0 = time.perf_counter()
        ref = naive_scan(corpus, plan.cascades, chunk=cfg["chunk"],
                         int8=int8, device=dev)
        t_naive = time.perf_counter() - t0
        naive_rows[int8] = ref
        diff = np.setxor1d(res.indices, ref)
        exempt = boundary_rows(corpus, [casc0], diff, cfg["chunk"],
                               int8=int8)
        log(f"  naive_scan {kind}: {len(ref)} rows in {t_naive:.2f} s; "
            f"identical rows: {not len(diff)}"
            + (f" except {len(exempt)} threshold-boundary rows "
               f"{exempt}" if exempt else ""))
    if dev.type == "cuda":
        _, secs, eng = runs[False]
        eng.reset_cache()      # rerun the timed scan: fresh store, same work
        device_profile(lambda: eng.execute(plan.cascades), dev, secs,
                       "scan profile (f32)")
    check_retrain(dev, cfg, seed, systems[casc0.concept],
                  train[casc0.concept], casc0, reps)

    # the kernel's time and bound at the main path's own stage-0 shapes
    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    base = cfg["base"]
    _, carry, _ = level_schedule(plan.cascades, base, True)
    out_res = sorted(({r.resolution for r in casc0.reps}
                      | set(carry[1] if len(carry) > 1 else ())) - {base},
                     reverse=True)
    imgs = corpus[:cfg["chunk"]]
    s0 = casc0.stage0
    worst = check_stage0(imgs, out_res, s0, f"main path {s0.rep.name}")
    k0 = next(e for e in systems[casc0.concept].bank.entries
              if e.params is s0.params)
    ms = time_ms(lambda: fused_pyramid_stage0(imgs, out_res, s0.params,
                                              s0.rep), dev, cfg["iters"])
    dms = device_ms(lambda: fused_pyramid_stage0(imgs, out_res, s0.params,
                                                 s0.rep), dev, cfg["iters"])
    plain = time_ms(lambda: fused_pyramid_stage0_ref(imgs, out_res,
                                                     s0.params, s0.rep),
                    dev, cfg["iters"])
    bound, by = stage0_bound_ms(card, cfg["chunk"], base, out_res, s0,
                                k0.arch)
    kern["stage0"].update(ms=ms, device_ms=dms, plain_ms=plain,
                          bound_ms=bound, bound_by=by,
                          max_abs_err=max(worst, kern["stage0"]["worst"]),
                          shape=f"{k0.name} chunk {cfg['chunk']} base {base} "
                                f"levels {out_res}")
    log(f"  fused_pyramid_stage0 main path ({k0.name}, levels {out_res}): "
        f"kernel {ms:.4f} ms (device {_ms(dms)}), plain {plain:.4f} ms, "
        f"bound {bound:.4f} ms ({by})")
    matmul_main_path(dev, cfg, card, kern, systems[casc0.concept])
    return launches, dict(systems=systems, plan=plan, corpus=corpus,
                          specs=specs, query=query,
                          serial=(runs[False][0].indices, runs[False][1]),
                          naive=naive_rows[False])


def device_profile(run, dev, wall_s, label, top=12, cpu_ops=True):
    """Where ``run()``'s device time goes: torch.profiler over it, device
    time summed by kernel name, and the device's idle share against the
    unprofiled run's wall time ``wall_s`` (the profiler slows the host, not
    the kernels). Returns {kernel name: [launches, us]}, or None when the
    profiler saw no device events. ``cpu_ops=False`` records the device's
    activity alone: a training step's ~10^5 operators otherwise take the
    profiler minutes to record. The device events are read from the
    profiler's raw results, not ``prof.events()``, whose tree of
    FunctionEvents is slow to build for a training step's ~10^5
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_ops
                                      else [])
    with profile(activities=acts) as prof:
        run()
        _sync(dev)
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    if not spans:
        log(f"  {label}: the profiler saw no device events; the breakdown "
            f"and idle share are not measured")
        return
    busy, end = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))   # union of device intervals
        end = max(end, e)
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e - s
    log(f"  {label}: device busy {busy / 1e3:.3f} ms of the unprofiled "
        f"run's {wall_s * 1e3:.3f} ms wall; device idle share "
        f"{1 - busy / (wall_s * 1e6):.3f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                )[:top]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% {n:6d}x "
            f"{name[:90]}")
    return by_name


def matmul_main_path(dev, cfg, card, kern, system):
    """The evaluator's own products: (128, I) @ (I, M) and (128, I) @
    (I, A) on its 0/1 indicator matrices, exact against the plain version;
    at both, kernel and torch.matmul in alternating order on both clocks,
    the plain version's time and the bound; then a large square product that
    shows the kernel's inner loop against cuBLAS's."""
    import numpy as np
    import torch

    from repro_torch.core.cascade import _certainty_stats
    from repro_torch.kernels.bindings import matmul_plan
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ref import matmul_ref
    st = _certainty_stats(system.eval_scores, system.eval_truth,
                          system.p_low, system.p_high)
    c = torch.as_tensor(st["c"], device=dev)
    ca = c[:128].contiguous()
    c_t = c.T.contiguous()
    cf_t = torch.as_tensor(np.ascontiguousarray(st["corr_final"].T),
                           device=dev)
    err = 0.0
    for b in (cf_t, c_t):
        got, want = matmul(ca, b, out_dtype=torch.float32), matmul_ref(ca, b)
        e = float((got - want).abs().max())
        log(f"  matmul evaluator {tuple(ca.shape)}@{tuple(b.shape)} 0/1: "
            f"max |err| {e}")
        if e != 0.0:
            raise AssertionError("matmul on 0/1 indicators is not exact")
        err = max(err, e)
    it = max(cfg["iters"], 1) * 10
    rows = []
    for b in (c_t, cf_t):
        m, k = ca.shape
        n = b.shape[1]
        t = alternating(
            f"matmul ({m},{k})@({k},{n}) f32",
            (("kernel", lambda: matmul(ca, b, out_dtype=torch.float32)),
             ("torch.matmul", lambda: torch.matmul(ca, b))), dev, it)
        plain = time_ms(lambda: matmul_ref(ca, b), dev, it)
        t_mem = (m * k + k * n + m * n) * 4 / card["bw"]
        t_ops = 2.0 * m * n * k / card["flops"]
        row = {"ms": t["kernel"]["ms"][0], "plain_ms": plain,
               "library_ms": t["torch.matmul"]["ms"][0],
               "device_ms": t["kernel"]["device_ms"][0],
               "library_device_ms": t["torch.matmul"]["device_ms"][0],
               "bound_ms": max(t_mem, t_ops) * 1e3,
               "bound_by": "bytes" if t_mem > t_ops else "operations",
               "shape": f"({m},{k})@({k},{n}) f32, plan "
                        f"{matmul_plan(m, n, k)}"}
        rows.append(row)
        log(f"  matmul {row['shape']}: kernel {row['ms']:.4f} ms, plain "
            f"{plain:.4f} ms, torch.matmul {row['library_ms']:.4f} ms "
            f"(CUDA events); device time kernel {_ms(row['device_ms'])} ms, "
            f"torch.matmul {_ms(row['library_device_ms'])} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    kern["matmul"].update(rows[0], max_abs_err=err, other_shapes=rows[1:])
    s = cfg["mm_probe"]
    gen = torch.Generator(device=dev).manual_seed(5)
    a, b = (torch.randn((s, s), generator=gen, device=dev) for _ in "ab")
    ms = device_ms(lambda: matmul(a, b), dev, 3)
    lib = device_ms(lambda: torch.matmul(a, b), dev, 3)

    def rate(t):
        return "" if t is None else f" ({2 * s ** 3 / t / 1e9:.1f} TFLOP/s)"

    log(f"  matmul inner-loop probe ({s},{s})@({s},{s}) f32: kernel "
        f"{_ms(ms)} ms{rate(ms)}, torch.matmul {_ms(lib)} ms{rate(lib)}")


# ---------------------------------------------------------- phase 3b --
def ingest_algebra_path(dev, cfg, kern, seed, query):
    """Streaming ingest and the query algebra on the query path's trained
    systems and plan (nothing is trained again): (a) a camera stream
    through ``build_ingest_pipeline`` with the plan's cascades; (b)
    indexed queries on the stream, exact and approx; (c) boolean trees
    on the query corpus; (d) a temporal join over two cameras. Launch
    counts are reset just before the phase's work and read just after
    it, before any launch that compares a kernel with its plain version;
    ``fused_pyramid_stage0`` must launch once per scored ingest chunk.
    Row sets are held against cold scans and the naive oracles, apart
    from counted threshold-boundary rows. Returns the phase's
    ``fused_pyramid_stage0`` launches and what the sharded phase runs
    again: the stream, its index and exact plan with the indexed, cold
    and naive rows, and the first tree with its rows and oracle."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import build_ingest_pipeline
    from repro_torch.engine.algebra import (And, Join, Not, Or, Pred,
                                            execute_join, execute_tree,
                                            naive_join_pairs,
                                            naive_tree_rows)
    from repro_torch.engine.ingest import indexed_execute
    from repro_torch.engine.planner import QuerySpec, plan_query
    from repro_torch.engine.scan import ScanEngine, naive_scan
    from repro_torch.kernels import ops
    log("== ingest and algebra")
    t_phase = time.perf_counter()
    systems, plan, corpus = query["systems"], query["plan"], query["corpus"]
    specs, chunk = query["specs"], cfg["chunk"]
    n, batch = cfg["stream"], cfg["stream_batch"]
    t0 = time.perf_counter()
    frames, labels, scene = stream_on(dev, specs, n, cfg["base"],
                                      seed + 200)
    log(f"  camera stream {frames.shape} on the host ({frames.nbytes / 1e9:.2f}"
        f" GB, {int(scene.max()) + 1} scenes), made on {dev.type} in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = np.arange(n, dtype=np.int64)
    pending = []        # (label, rows, cascades, corpus, index): explained
    #                     after the counts are read (those launches compare)

    # ---- (a) ingest, as a stream arrives
    ops.reset_launch_counts()
    pipe = build_ingest_pipeline(plan.cascades, n, chunk=chunk, skip=True,
                                 skip_threshold=None, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        pipe.ingest(frames[lo:lo + batch], ids[lo:lo + batch])
    _sync(dev)
    t_ingest = time.perf_counter() - t0
    ingest_launches = ops.LAUNCHES["fused_pyramid_stage0"]
    st, index = pipe.stats, pipe.index
    log(f"  ingest: {n} frames in batches of {batch}, chunk {chunk}: "
        f"{t_ingest:.3f} s ({n / t_ingest:.0f} frames/s); refs {st.refs}, "
        f"skipped {st.skipped}, decided labels {st.decided_labels}, stage-0 "
        f"scores {st.stage0_scores}, chunks {st.chunks}; calibrated skip "
        f"threshold {pipe.skip_threshold!r} (from the first "
        f"{pipe.calib_frames} diffs); fused_pyramid_stage0 launches "
        f"{ingest_launches}")
    if dev.type == "cuda" and (ingest_launches != st.chunks
                               or ingest_launches == 0):
        raise AssertionError(f"ingest launched fused_pyramid_stage0 "
                             f"{ingest_launches} times for {st.chunks} "
                             f"scored chunks")
    if not np.array_equal(scene[index.alias], scene):
        raise AssertionError("a skip-alias crosses a scene boundary")
    ref = index.alias == ids
    cal = pipe.calib_frames
    change = np.concatenate([[True], scene[1:] != scene[:-1]])
    if not (ref[:cal].all() and np.array_equal(ref[cal:], change[cal:])):
        raise AssertionError("not one reference per scene after "
                             "calibration")
    # the scored chunks, as ingest split the batches: the first and the
    # last are held against the kernel and the plain version at the end
    scored = [g[ref[g]] for lo in range(0, n, batch)
              for at in range(lo, min(lo + batch, n), chunk)
              for g in (ids[at:min(at + chunk, lo + batch, n)],)
              if ref[g].any()]
    if len(scored) != st.chunks:
        raise AssertionError(f"{len(scored)} chunks hold references, "
                             f"{st.chunks} were scored")
    kept = [(g, frames[g].copy()) for g in (scored[0], scored[-1])]

    # ---- (b) indexed queries on the stream, exact and approx
    stream = torch.from_numpy(frames).to(dev)
    all_ids = ids
    plans = {m: plan_query(systems, query["query"], scenario="CAMERA",
                           joint=True, index=index, index_mode=m)
             for m in ("exact", "approx")}
    px = plans["exact"]
    held = sum(index.cascade_keys.get(c.concept) == c.key
               for c in px.cascades)
    log(f"  re-planned with the index: "
        f"{[c.concept for c in px.cascades]} (ingest order "
        f"{index.concepts}); the index holds {held} of its "
        f"{len(px.cascades)} cascade keys")
    log(px.explain(n_rows=n))
    scans = {}
    for label, run in (
            ("indexed", lambda e: indexed_execute(e, px)),
            ("cold", lambda e: e.execute(px.cascades)),
            ("approx", lambda e: indexed_execute(e, plans["approx"]))):
        eng = ScanEngine(stream, chunk=chunk, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        res = run(eng)
        _sync(dev)
        scans[label] = (res, time.perf_counter() - t0)
    t0 = time.perf_counter()
    naive = naive_scan(stream, px.cascades, chunk=chunk, device=dev)
    t_naive = time.perf_counter() - t0
    for label, (res, secs) in scans.items():
        s = res.stats
        log(f"  {label} scan of the stream: {len(res.indices)} rows, rows "
            f"evaluated {s.rows_evaluated} (per stage "
            f"{[g.rows_evaluated for g in s.stages]}), {s.chunks} chunks, "
            f"{secs:.3f} s"
            + (f", {secs * 1e3 / s.chunks:.3f} ms/chunk" if s.chunks else ""))
    log(f"  naive_scan of the stream: {len(naive)} rows in {t_naive:.2f} s")
    got = scans["indexed"][0].indices
    pending.append(("exact indexed vs cold", np.setxor1d(
        got, scans["cold"][0].indices), px.cascades, stream, index))
    pending.append(("exact indexed vs naive_scan",
                    np.setxor1d(got, naive), px.cascades, stream, index))
    approx = plans["approx"]
    cold_rows = scans["cold"][0].indices
    a_rows = scans["approx"][0].indices
    recall = {c: index.measured_recall(
        c, labels[:, [s.name for s in specs].index(c)])
        for c in index.concepts}
    log(f"  approx: prefilter keeps {len(approx.index_prefilter(all_ids))} "
        f"of {n} rows (exact: {len(px.index_prefilter(all_ids))}); "
        f"measured recall against the stream's labels {recall}; "
        f"{len(a_rows)} rows, {len(np.intersect1d(a_rows, cold_rows))} of "
        f"the cold scan's {len(cold_rows)}")
    del scans, stream

    # ---- (c) boolean trees on the query corpus
    names = [s.name for s in specs]
    a, b, c = (Pred(x) for x in names)
    nq = int(corpus.shape[0])
    meta = {"cam": np.arange(nq) % 2, "t": 3 * np.arange(nq, dtype=np.int64)}
    fn_cache: dict = {}
    trees = []
    for tree, eq in ((Or(And(a, Not(b)), c), {}),
                     (And(a, Or(b, Not(c))), {"cam": 0}),
                     (Not(Or(a, b)), {})):
        tp = plan_query(systems, QuerySpec(metadata_eq=eq, where=tree),
                        metadata=meta)
        out = {}
        for opt in (True, False):
            eng = ScanEngine(corpus, meta, chunk=chunk, device=dev)
            res = execute_tree(eng, tp, optimize=opt)
            _sync(dev)
            out[opt] = res
            if opt:
                log(tp.explain(n_rows=nq))
        t0 = time.perf_counter()
        oracle = naive_tree_rows(corpus, tree, tp.cascade_map(), meta, eq,
                                 chunk=chunk, device=dev, _fn_cache=fn_cache)
        t_naive = time.perf_counter() - t0
        for opt, res in out.items():
            log(f"  tree {expr(tree)} {eq or ''} optimized={opt}: "
                f"{len(res.indices)} rows, {res.engine_calls} engine calls, "
                f"rows evaluated {res.rows_evaluated}, {res.seconds:.3f} s")
            pending.append((f"tree {expr(tree)} optimized={opt} vs "
                            f"naive_tree_rows",
                            np.setxor1d(res.indices, oracle), tp.cascades,
                            corpus, None))
        log(f"  naive_tree_rows: {len(oracle)} rows in {t_naive:.2f} s")
        trees.append((tree, eq, out[True].indices, oracle))

    # ---- (d) a temporal join over two cameras
    t0 = time.perf_counter()
    (xa, _, tma), (xb, _, tmb) = cameras_on(dev, specs, cfg["join"],
                                            cfg["base"], seed + 300)
    _sync(dev)
    log(f"  two cameras {tuple(xa.shape)} + {tuple(xb.shape)}, int64 "
        f"timestamps, made on {dev.type} in {time.perf_counter() - t0:.1f} s")
    cams = [xa, xb]
    del xa, xb
    metas = ({"t": tma}, {"t": tmb})
    join = Join(a, a, delta_t=2)
    jp = plan_query(systems, QuerySpec(where=join), metadata=metas)
    engines = [ScanEngine(x, m, chunk=chunk, device=dev)
               for x, m in zip(cams, metas)]
    res = execute_join(engines, jp)
    _sync(dev)
    launches = ops.LAUNCHES["fused_pyramid_stage0"]
    log(jp.explain())
    t0 = time.perf_counter()
    rows = [naive_tree_rows(x, side, sp.cascade_map(), chunk=chunk,
                            device=dev, _fn_cache=fn_cache)
            for x, side, sp in zip(cams, (join.left, join.right),
                                   (jp.left, jp.right))]
    want = naive_join_pairs((rows[0], tma), (rows[1], tmb), join.delta_t)
    t_naive = time.perf_counter() - t0
    log(f"  join {expr(join.left)} x {expr(join.right)} within "
        f"{join.delta_t}: {len(res.pairs)} pairs, build side "
        f"{'left' if jp.build_side == 0 else 'right'}, probe rows left "
        f"after the window pushdown {jp.window_kept} of {len(tmb)}, "
        f"{res.seconds:.3f} s (left {res.left.rows_evaluated} rows "
        f"evaluated, right {res.right.rows_evaluated}); naive "
        f"{len(want)} pairs in {t_naive:.2f} s")
    log(f"  fused_pyramid_stage0 launches in the phase: {launches} "
        f"({ingest_launches} on the ingest path)")

    # ---- exactness: every differing row a counted boundary row
    for label, diff, cascades, data, idx in pending:
        exempt = boundary_rows(data, cascades, diff, chunk, index=idx)
        log(f"  {label}: identical rows: {not len(diff)}"
            + (f" except {len(exempt)} threshold-boundary rows {exempt}"
               if exempt else ""))
    pairs = {tuple(p) for p in res.pairs.tolist()}
    wanted = {tuple(p) for p in want.tolist()}
    diff = sorted(pairs ^ wanted)
    if diff:
        bl = straddles(cams[0], jp.left.cascades, [p[0] for p in diff], chunk)
        br = straddles(cams[1], jp.right.cascades, [p[1] for p in diff],
                       chunk)
        bad = [p for p in diff if p[0] not in bl and p[1] not in br]
        if bad:
            raise AssertionError(f"join pairs differ from naive_join_pairs "
                                 f"off the threshold boundary: {bad[:8]}")
    log(f"  join vs naive_join_pairs: identical pairs: {not diff}"
        + (f" except {len(diff)} pairs on threshold-boundary rows"
           if diff else ""))
    check_ingest_scores(pipe, kept)
    ingest_profile(dev, plan, frames, ids, pipe, batch, t_ingest)
    kern["stage0"]["ingest_launches"] = ingest_launches
    log(f"  the phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(frames=frames, index=index, plan=px, indexed=got,
                          cold=cold_rows, naive=naive, tree=trees[0],
                          meta=meta)


def ingest_profile(dev, plan, frames, ids, pipe, batch, t_ingest):
    """Where the ingest's time goes: the host's frame signatures alone
    (the skip detector's feature, per chunk as ingest computes them),
    then a second ingest of the same stream through a fresh pipeline
    under torch.profiler (device busy time and idle share against the
    first ingest's wall time)."""
    from repro_torch.core.pipeline import build_ingest_pipeline
    from repro_torch.engine.ingest import frame_signature
    t0 = time.perf_counter()
    for lo in range(0, len(ids), pipe.chunk):
        frame_signature(frames[lo:lo + pipe.chunk], pipe.skip_res)
    t_sig = time.perf_counter() - t0
    log(f"  ingest's frame signatures alone (host): {t_sig:.3f} s of its "
        f"{t_ingest:.3f} s")
    if dev.type != "cuda":
        return

    def run():
        again = build_ingest_pipeline(plan.cascades, len(ids),
                                      chunk=pipe.chunk, skip=True,
                                      skip_threshold=None, device=dev)
        for lo in range(0, len(ids), batch):
            again.ingest(frames[lo:lo + batch], ids[lo:lo + batch])
    device_profile(run, dev, t_ingest, "ingest profile", top=6)


# ---------------------------------------------------------- phase 3c --
SHARD_RUNS = ((1, "range", True), (1, "hash", True), (2, "range", True),
              (2, "hash", True), (8, "range", True), (8, "hash", True),
              (8, "range", False))   # (shards, strategy, lockstep)


def sharded_path(dev, cfg, kern, query, before):
    """Row-sharded scans on the query path's trained systems, plan and
    corpus, nothing trained again: (a) the stage-0 kernel's scores of the
    same rows at every slab width the lockstep issues (``torch.equal``,
    f32 and int8) and the ``cnn_forward`` levels' at the same widths
    (printed); (b) ``ShardedScanEngine`` at SHARD_RUNS, each row set held
    against the serial engine's and ``naive_scan``'s, the 8-shard engine
    run again on its merged store (no superstep, no launch); (c) a tree
    and the stream's exact indexed scan on an 8-shard engine against the
    phase before. Launch counts are reset just before (b) and (c) and
    read just after, before any launch that explains a differing row.
    Returns the phase's ``fused_pyramid_stage0`` launches."""
    import numpy as np
    import torch

    from repro_torch.core.transforms import color_transform, resize_area
    from repro_torch.engine.algebra import execute_tree
    from repro_torch.engine.ingest import indexed_execute
    from repro_torch.engine.planner import QuerySpec, plan_query
    from repro_torch.engine.scan import ScanEngine
    from repro_torch.engine.sharded import ShardedScanEngine, slab_width
    from repro_torch.kernels import image_transform, ops
    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    log("== sharded scan")
    t_phase = time.perf_counter()
    systems, plan, corpus = query["systems"], query["plan"], query["corpus"]
    chunk, base = cfg["chunk"], cfg["base"]
    widths = []
    w = slab_width(1, chunk)
    while w <= chunk:
        widths.append(w)
        w *= 2
    n_rows = min(16, widths[0])

    # ---- (a) the same rows at every slab width
    casc0 = plan.cascades[0]
    s0 = casc0.stage0
    for label, qp in (("f32", None), ("int8", s0.qparams)):
        full = fused_pyramid_stage0(corpus[:chunk], [], s0.params, s0.rep,
                                    qparams=qp)[1][:n_rows]
        same = all(torch.equal(fused_pyramid_stage0(
            corpus[:w], [], s0.params, s0.rep, qparams=qp)[1][:n_rows], full)
            for w in widths)
        log(f"  fused_pyramid_stage0 {label}, {s0.rep.name}: the first "
            f"{n_rows} rows' scores at launch widths {widths} equal to the "
            f"{chunk}-wide launch's: {same}")
        # the CPU runs the plain version, whose sums may follow the width
        if not same and dev.type == "cuda":
            raise AssertionError("stage-0 scores depend on the launch width")
    for pos, casc in enumerate(plan.cascades):
        for lvl in range(1 if pos == 0 else 0, len(casc.model_fns)):
            rep, model = casc.reps[lvl], casc.model_fns[lvl]

            def score(x, rep=rep, model=model):
                return model(color_transform(resize_area(x, rep.resolution),
                                             rep.color))[:n_rows]
            full = score(corpus[:chunk])
            diff = [(score(corpus[:w]) - full).abs() for w in widths]
            n_diff = [int((d > 0).sum()) for d in diff]
            worst = max(float(d.max()) for d in diff)
            log(f"  cnn_forward {casc.concept} level {lvl} ({rep.name}): "
                f"rows of {n_rows} differing from the {chunk}-wide batch at "
                f"widths {widths}: {n_diff}; max |diff| {worst:.3g}")

    # ---- (b) sharded scans against the serial scan and naive_scan
    serial_rows, serial_s = query["serial"]
    naive = query["naive"]
    ops.reset_launch_counts()
    runs = {}
    for shards, strategy, lock in SHARD_RUNS:
        eng = ShardedScanEngine(corpus, shards=shards, chunk=chunk,
                                strategy=strategy, device=dev)
        eng.execute(plan.cascades, parallel=lock)     # cold: set-up paid
        eng.reset_cache()
        _sync(dev)
        mem0 = _peak_reset(dev)
        t0 = time.perf_counter()
        res = eng.execute(plan.cascades, parallel=lock)
        _sync(dev)
        secs = time.perf_counter() - t0
        runs[(shards, strategy, lock)] = (eng, res, secs,
                                          _peak_extra(dev, mem0))
    merged = runs[(8, "range", True)][0]
    n0 = ops.LAUNCHES["fused_pyramid_stage0"]
    again = merged.execute(plan.cascades)
    rerun_launches = ops.LAUNCHES["fused_pyramid_stage0"] - n0

    # ---- (c) a tree and the stream's exact indexed scan, 8 shards
    tree, eq, tree_rows, oracle = before["tree"]
    tp = plan_query(systems, QuerySpec(metadata_eq=eq, where=tree),
                    metadata=before["meta"])
    t0 = time.perf_counter()
    tres = execute_tree(ShardedScanEngine(corpus, before["meta"], shards=8,
                                          chunk=chunk, device=dev), tp)
    _sync(dev)
    t_tree = time.perf_counter() - t0
    stream = torch.from_numpy(before["frames"]).to(dev)
    seng = ShardedScanEngine(stream, shards=8, chunk=chunk, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    ires = indexed_execute(seng, before["plan"])
    _sync(dev)
    t_idx = time.perf_counter() - t0
    launches = ops.LAUNCHES["fused_pyramid_stage0"]
    if dev.type == "cuda" and launches == 0:
        raise AssertionError("fused_pyramid_stage0 was not launched on the "
                             "sharded path")

    # ---- prints, then every differing row explained
    serial = ScanEngine(corpus, chunk=chunk, device=dev)
    _sync(dev)
    mem0 = _peak_reset(dev)
    serial.execute(plan.cascades)
    _sync(dev)
    mem_serial = _peak_extra(dev, mem0)
    log(f"  serial ScanEngine (query path): {serial_s * 1e3:.3f} ms, "
        f"{len(serial_rows)} rows; peak memory above the corpus "
        f"{_mb(mem_serial)}")
    pending = []
    for (shards, strategy, lock), (eng, res, secs, mem) in runs.items():
        st = res.stats
        slabs0 = {b: n for (s, b), n in sorted(st.slabs.items()) if s == 0}
        log(f"  {shards} shards {strategy} {st.backend}: {secs * 1e3:.3f} ms "
            f"({secs / serial_s:.2f}x serial), {len(res.indices)} rows, "
            f"supersteps {st.supersteps}, lanes {st.lanes}, devices "
            f"{st.n_devices}, rows per shard {st.plan.sizes}, balance "
            f"{st.plan.balance:.3f}, rows evaluated "
            f"{[g.rows_evaluated for g in st.stages]}, stage-0 slabs by "
            f"width {slabs0}, later slabs {sum(st.slabs.values()) - sum(slabs0.values())}; "
            f"peak memory above the corpus {_mb(mem)}")
        label = f"{shards} shards {strategy} {st.backend}"
        pending.append((f"{label} vs the serial scan",
                        np.setxor1d(res.indices, serial_rows),
                        plan.cascades, corpus))
        pending.append((f"{label} vs naive_scan",
                        np.setxor1d(res.indices, naive), plan.cascades,
                        corpus))
    log(f"  8 shards range lockstep again on its merged store: "
        f"{len(again.indices)} rows, supersteps {again.stats.supersteps}, "
        f"rows evaluated {again.stats.rows_evaluated}, fused_pyramid_stage0 "
        f"launches {rerun_launches}")
    if again.stats.supersteps or rerun_launches or \
            not np.array_equal(again.indices,
                               runs[(8, "range", True)][1].indices):
        raise AssertionError("the re-run on the merged store did work or "
                             "changed the rows")
    log(f"  tree {expr(tree)} on 8 shards: {len(tres.indices)} rows, "
        f"{tres.engine_calls} engine calls, rows evaluated "
        f"{tres.rows_evaluated}, {t_tree:.3f} s")
    pending.append((f"tree {expr(tree)} 8 shards vs the phase before",
                    np.setxor1d(tres.indices, tree_rows), tp.cascades,
                    corpus))
    pending.append((f"tree {expr(tree)} 8 shards vs naive_tree_rows",
                    np.setxor1d(tres.indices, oracle), tp.cascades, corpus))
    ist = ires.stats
    log(f"  exact indexed scan of the stream on 8 shards: "
        f"{len(ires.indices)} rows, rows evaluated {ist.rows_evaluated}, "
        f"supersteps {ist.supersteps}, {t_idx:.3f} s")
    for label, rows in (("indexed", before["indexed"]),
                        ("cold", before["cold"]),
                        ("naive_scan", before["naive"])):
        pending.append((f"stream 8 shards vs the {label} scan before",
                        np.setxor1d(ires.indices, rows),
                        before["plan"].cascades, stream))
    log(f"  fused_pyramid_stage0 launches in the phase: {launches}; launch "
        f"set-ups cached {len(image_transform._SETUP_CACHE)} of "
        f"{image_transform._SETUP_CACHE_SIZE}")
    for label, diff, cascades, data in pending:
        exempt = boundary_rows(data, cascades, diff, chunk, widths=widths,
                               index=before["index"] if data is stream
                               else None)
        log(f"  {label}: identical rows: {not len(diff)}"
            + (f" except {len(exempt)} threshold-boundary rows {exempt}"
               if exempt else ""))
    if dev.type == "cuda":
        for key in ((8, "range", True), (1, "range", True)):
            eng, _, secs, _ = runs[key]
            eng.reset_cache()
            device_profile(lambda: eng.execute(plan.cascades), dev, secs,
                           f"profile, {key[0]} shards lockstep", top=6)
        serial.reset_cache()
        device_profile(lambda: serial.execute(plan.cascades), dev, serial_s,
                       "profile, serial scan", top=6)
    kern["stage0"]["sharded_launches"] = launches
    log(f"  the phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------- phase 3d --
def make_stream(n_requests, n_corpus, concepts, *, hot=64, repeat=0.5,
                seed=13):
    """The interactive mixed stream of the reference's
    benchmarks/bench_serve.py (``make_stream``, copied): every concept is
    asked about every frame the session walks, and ``repeat`` of the
    requests after the first ``2 * hot`` re-ask a frame of the hot set.
    -> [(concept, row)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    stream = []
    for i in range(n_requests):
        c = concepts[i % len(concepts)]
        if i >= 2 * hot and rng.uniform() < repeat:
            row = int(rng.integers(0, hot))
        else:
            row = (i // len(concepts)) % n_corpus
        stream.append((c, row))
    return stream


SERVE_BATCH = 32


def serving_path(dev, cfg, card, kern, query, before):
    """Cascade serving on the query path's trained systems, plan and
    corpus, and the ingest phase's stream and index (nothing trained
    again). (a) the planned scan through ``ScanEngine(repcache=)``, rows
    equal to the serial scan's; (b) ``build_cascade_service`` (async,
    batch 32, max wait 5 ms) over the mixed stream at 1 and 8 shards,
    first on the scan's store and cache, then on a fresh store and cache
    (flushes run: the from-base flush is ``fused_pyramid_stage0``), and
    the sync ``CascadeService`` on the same stream; (c) the event host,
    paced; (d) overload: an unpaced burst on the deepest cascade's
    concept with ``queue_limit`` 64 below a batch of 128 (so queues fill),
    ``overload="degrade"`` and its ``compiled_ladder``; (e) the fault
    drill at 8 lanes on a manual clock; (f) a service over the ingest
    stream seeded by its index. Every label is held against
    ``naive_scan``'s column of the cascade (or rung) that answered it,
    apart from counted threshold-boundary rows at the flush widths.
    Launch counts are reset just before (a) and read just after (f): the
    stage-0 launches must equal the scan's chunks, the services' "base"
    executions (flushes, re-dispatches and warmup) and the sync batches.
    Returns the phase's ``fused_pyramid_stage0`` launches."""
    import numpy as np

    from repro_torch.core.pipeline import build_cascade_service
    from repro_torch.engine.scan import ScanEngine, VirtualColumnStore, \
        naive_scan
    from repro_torch.engine.sharded import slab_width
    from repro_torch.kernels import ops
    from repro_torch.serve import (FaultInjector, FaultPlan, ManualClock,
                                   RepresentationCache, Request, Shed,
                                   TimedOut, is_label)
    log("== serving")
    t_phase = time.perf_counter()
    on = card.get("smi", "cpu")
    systems, plan, corpus = query["systems"], query["plan"], query["corpus"]
    chunk, sc = cfg["chunk"], cfg["serve"]
    cascades = {c.concept: c for c in plan.cascades}
    stream = make_stream(sc["requests"], cfg["corpus"], list(cascades),
                         hot=sc["hot"])
    widths = sorted({slab_width(n, SERVE_BATCH)
                     for n in range(1, SERVE_BATCH + 1)})
    asked = max(r for _, r in stream) + 1
    deep = max(plan.cascades, key=lambda c: len(c.model_fns)).concept
    burst = np.arange(asked, min(cfg["corpus"], asked + sc["burst"]))
    pred = next(p for p in plan.predicates if p.cascade.concept == deep)
    ladder = systems[deep].compiled_ladder(
        systems[deep].cascade_space("CAMERA"), pred.selection.index,
        concept=deep, max_rungs=2)
    t0 = time.perf_counter()
    cols = {}            # cascade key -> naive_scan's labels (-1: not run)

    def column(casc, lo, hi):
        col = cols.setdefault(casc.key, np.full(cfg["corpus"], -1, np.int8))
        col[lo:hi] = 0
        col[lo + naive_scan(corpus[lo:hi], [casc], chunk=chunk,
                            device=dev)] = 1
    for casc in plan.cascades:
        column(casc, 0, asked)
    for casc in [cascades[deep], *ladder]:
        column(casc, int(burst[0]), int(burst[-1]) + 1)
    log(f"  stream: {len(stream)} requests over {len(cascades)} concepts, "
        f"rows 0..{asked - 1}, {sum(r < sc['hot'] for _, r in stream)} "
        f"on the {sc['hot']}-row hot set; naive_scan columns "
        f"{time.perf_counter() - t0:.2f} s; {deep}'s ladder "
        f"{[c.cascade_id for c in ladder]}; flush widths {widths} [{on}]")
    checks = []          # (label, [(casc, row, label)], widths)
    ops.reset_launch_counts()

    # ---- (a) the planned scan through a repcache-backed engine, beside
    # a fresh engine without one; then a second engine on the warm cache
    def timed_scan(engine):
        _sync(dev)
        t0 = time.perf_counter()
        res = engine.execute(plan.cascades)
        _sync(dev)
        return res, time.perf_counter() - t0
    cache = RepresentationCache(sc["budget"])
    plain, t_plain = timed_scan(ScanEngine(corpus, chunk=chunk, device=dev))
    eng = ScanEngine(corpus, chunk=chunk, repcache=cache, device=dev)
    sres, t_scan = timed_scan(eng)
    filled = cache.stats()
    wres, t_warm = timed_scan(ScanEngine(corpus, chunk=chunk, repcache=cache,
                                         device=dev))
    serial_rows = query["serial"][0]
    log(f"  ScanEngine(repcache=) scan: {len(sres.indices)} rows in "
        f"{t_scan * 1e3:.3f} ms ({t_scan / t_plain:.3f}x a fresh engine "
        f"without a cache: {t_plain * 1e3:.3f} ms), {sres.stats.chunks} "
        f"chunks; cache {filled}, slabs on {cache.device}; again on the "
        f"warm cache: {t_warm * 1e3:.3f} ms ({t_warm / t_plain:.3f}x), "
        f"rows from the cache {wres.stats.rep_rows_cached}, chunks "
        f"{wres.stats.chunks} [{on}]")
    scan_diff = np.setxor1d(sres.indices, serial_rows)
    scan_diff = np.union1d(scan_diff, np.setxor1d(wres.indices, serial_rows))
    scan_diff = np.union1d(scan_diff, np.setxor1d(plain.indices, serial_rows))

    # ---- (b) async at 1 and 8 shards, warm then fresh; sync baseline
    def serve(label, shards, profile_against=None, **kw):
        """One async service over the stream (after its warmup); with
        ``profile_against`` (a run's seconds) the stream runs under the
        profiler instead, and nothing is printed or checked."""
        kw.setdefault("repcache_bytes", sc["budget"])
        svc = build_cascade_service(corpus, cascades, mode="async",
                                    shards=shards, batch_size=SERVE_BATCH,
                                    max_wait_s=0.005, device=dev, **kw)
        n_warm = svc.warmup()
        rc0 = svc.repcache.stats() if svc.repcache is not None else None
        reqs = []

        def run():
            for i, (c, row) in enumerate(stream):
                reqs.append(Request(i, row))
                svc.submit(c, reqs[-1])
                svc.poll()
            svc.drain()
        _sync(dev)
        if profile_against is not None:
            return device_profile(run, dev, profile_against, label, top=8)
        mem0 = _peak_reset(dev)
        t0 = time.perf_counter()
        run()
        _sync(dev)
        secs = time.perf_counter() - t0
        mem = _peak_extra(dev, mem0)
        s = svc.summary()
        rate = None       # the run's own lookups, not the scan's before it
        if rc0 is not None:
            hits = s["repcache"]["hits"] - rc0["hits"]
            looked = hits + s["repcache"]["misses"] - rc0["misses"]
            rate = f"{hits / looked:.4f} of {looked}" if looked else "-"
        log(f"  {label}: {len(stream)} requests in {secs * 1e3:.3f} ms "
            f"({len(stream) / secs:.0f} requests/s) [{on}]; latency ms "
            f"p50/p95/p99 {s['latency_ms']['p50']}/{s['latency_ms']['p95']}"
            f"/{s['latency_ms']['p99']}; store hit rate "
            f"{s['store_hit_rate']:.4f}; repcache hit rate {rate} "
            f"entry lookups, rep_hit_rows {s['rep_hit_rows']}; "
            f"flushes size/deadline/drain {s['size_flushes']}/"
            f"{s['deadline_flushes']}/{s['drain_flushes']}, batches "
            f"{s['batches']}, padded slots {s['padded_slots']}, rows "
            f"evaluated {s['rows_evaluated']}; lanes {s['lanes']}, devices "
            f"{s['devices']}, in flight max {s['in_flight']['max']}; warmup "
            f"{n_warm} executions; stage-0 runs {svc.stage0_runs}; peak "
            f"memory above the corpus {_mb(mem)}")
        checks.append((label, [(cascades[c], row, r.result)
                               for (c, row), r in zip(stream, reqs)],
                       widths))
        return svc, reqs, secs

    def scan_store():
        st = VirtualColumnStore(cfg["corpus"])
        st.merge_from(eng.store)
        return st

    services = []
    for shards in (1, 8):
        services.append(serve(f"async {shards} lanes on the scan's store "
                              f"and cache", shards, store=scan_store(),
                              repcache=cache))
    fresh = {}
    for shards in (1, 8):
        fresh[shards] = serve(f"async {shards} lanes, fresh store and "
                              f"cache", shards)
        services.append(fresh[shards])
    # does the cache pay for itself? a fresh store (flushes run) on the
    # scan's warm cache, and with no cache, alternated (ABBAAB) since the
    # host clock moves between runs
    paired = {"warm": [], "none": []}
    for side in ("none", "warm", "warm", "none", "none", "warm"):
        kw = {"repcache": cache} if side == "warm" else {"repcache_bytes": 0}
        what = "the scan's warm cache" if side == "warm" else "no cache"
        services.append(serve(f"async 8 lanes, fresh store, {what}", 8,
                              **kw))
        paired[side].append(services[-1][2])
    med = {k: float(np.median(v)) * 1e3 for k, v in paired.items()}
    log(f"  8 lanes, fresh store, the scan's warm cache against no cache: "
        f"median {med['warm']:.3f} against {med['none']:.3f} ms "
        f"({med['none'] / med['warm']:.3f}x the requests/s), runs "
        f"{[round(t * 1e3, 3) for t in paired['warm']]} against "
        f"{[round(t * 1e3, 3) for t in paired['none']]} [{on}]")
    sync = build_cascade_service(corpus, cascades, mode="sync",
                                 batch_size=SERVE_BATCH, max_wait_s=0.005,
                                 device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    sreqs = []
    for i, (c, row) in enumerate(stream):
        sreqs.append(Request(i, corpus[row]))
        sync.submit(c, sreqs[-1])
        sync.poll()
    sync.drain()
    _sync(dev)
    t_sync = time.perf_counter() - t0
    lat = np.asarray(sync.latencies()) * 1e3
    sync_batches = sum(s.batches for s in sync.stats.values())
    log(f"  sync CascadeService: {len(stream)} requests in "
        f"{t_sync * 1e3:.3f} ms ({len(stream) / t_sync:.0f} requests/s) "
        f"[{on}]; latency ms p50/p95/p99 {np.percentile(lat, 50):.3f}/"
        f"{np.percentile(lat, 95):.3f}/{np.percentile(lat, 99):.3f}; "
        f"batches {sync_batches}, padded slots "
        f"{sum(s.padded_slots for s in sync.stats.values())}")
    checks.append(("sync CascadeService", [
        (cascades[c], row, r.result) for (c, row), r in zip(stream, sreqs)],
        (SERVE_BATCH,)))

    # ---- (c) the event host, paced: deadlines fire without the caller
    host = build_cascade_service(corpus, cascades, shards=8,
                                 batch_size=SERVE_BATCH, max_wait_s=0.005,
                                 repcache_bytes=sc["budget"], device=dev,
                                 host=True)
    hreqs = []
    t0 = time.perf_counter()
    try:
        for i, (c, row) in enumerate(stream[:sc["host"]]):
            hreqs.append(Request(i, row))
            host.submit(c, hreqs[-1])
            time.sleep(sc["pace"])
        idle = host.wait_idle(60.0)
    finally:
        host.stop()
    t_host = time.perf_counter() - t0
    hs = host.service.summary()
    log(f"  event host (WallTimer, 8 lanes): {len(hreqs)} requests paced "
        f"{sc['pace'] * 1e3:.1f} ms apart, served in {t_host:.3f} s [{on}]; "
        f"idle {idle}, host steps {host.steps}; flushes size/deadline/"
        f"drain {hs['size_flushes']}/{hs['deadline_flushes']}/"
        f"{hs['drain_flushes']}; latency ms p50/p95/p99 "
        f"{hs['latency_ms']['p50']}/{hs['latency_ms']['p95']}/"
        f"{hs['latency_ms']['p99']}")
    if not idle or hs["deadline_flushes"] == 0 or hs["drain_flushes"] or \
            any(r.result is None for r in hreqs):
        raise AssertionError("the event host did not serve the paced "
                             "stream by its own deadlines")
    checks.append(("event host", [(cascades[c], row, r.result) for (c, row), r
                                  in zip(stream, hreqs)], widths))

    # ---- (d) overload: an unpaced burst, queues bounded, ladder stepped
    # (a batch of twice the queue limit, so a queue fills before it
    # would flush by size)
    limit = sc["limit"]
    over = build_cascade_service(
        corpus, {deep: cascades[deep]}, shards=8, batch_size=2 * limit,
        max_wait_s=0.005, repcache_bytes=sc["budget"], device=dev,
        queue_limit=limit, overload="degrade", ladders={deep: ladder})
    over.warmup()
    breqs = [Request(i, int(row)) for i, row in enumerate(burst)]
    t0 = time.perf_counter()
    for r in breqs:
        over.submit(deep, r)
    over.drain()
    _sync(dev)
    t_over = time.perf_counter() - t0
    os_ = over.summary()
    rungs = [cascades[deep], *ladder]
    answered = []
    for r in breqs:
        if is_label(r.result):
            by = next(c for c in rungs
                      if over.store.column(c.key)[r.payload] >= 0)
            answered.append((by, r.payload, r.result))
    log(f"  overload ({deep}, 8 lanes, batch {2 * limit}, queue limit "
        f"{limit}, degrade over {len(ladder)} rungs): {len(breqs)} "
        f"requests unpaced in {t_over * 1e3:.3f} ms [{on}]; shed "
        f"{os_['shed']}, served {len(answered)}, degraded rows "
        f"{os_['degraded_rows']}, degrade steps {os_['degrade_steps']}, "
        f"active levels {os_['active_levels']}, queue depth max "
        f"{os_['queue_depth']['max']}")
    if os_["shed"] == 0 or os_["shed"] + len(answered) != len(breqs) or (
            ladder and not os_["degraded_rows"]):
        raise AssertionError("the burst was neither shed nor degraded")
    checks.append(("overload", answered,
                   sorted({slab_width(n, 2 * limit)
                           for n in range(1, limit + 1)})))

    # ---- (e) the fault drill at 8 lanes on a manual clock
    dt = 2.0 ** -10

    def drill(plan_):
        clk = ManualClock()
        faults = (None if plan_ is None
                  else FaultInjector(plan_, clock=clk))
        svc = build_cascade_service(
            corpus, cascades, shards=8, batch_size=SERVE_BATCH,
            max_wait_s=5 * dt, clock=clk, repcache_bytes=sc["budget"],
            device=dev, batch_timeout_s=dt / 2, faults=faults)
        reqs = []
        for i, (c, row) in enumerate(stream[:sc["faults"]]):
            reqs.append(Request(i, row))
            svc.submit(c, reqs[-1])
            # the card finishes every healthy batch before virtual time
            # moves: only the dead lane's batch can outlive the timeout
            _sync(dev)
            clk.advance(dt)
            svc.poll()
        while svc.busy():      # one deadline comes due per step
            _sync(dev)
            clk.advance(dt)
            svc.poll()
        return svc, reqs

    t0 = time.perf_counter()
    fsvc, freqs = drill(FaultPlan(fail_dispatch={3: -1}, dead_devices={5},
                                  transient_errors=2))
    clean, creqs = drill(None)
    t_drill = time.perf_counter() - t0
    fs = fsvc.summary()
    ended = sum(is_label(r.result) or isinstance(r.result, (Shed, TimedOut))
                for r in freqs)
    same = all(r.result == c.result for r, c in zip(freqs, creqs)
               if is_label(r.result))
    log(f"  fault drill (8 lanes, lane 3 failing every dispatch, lane 5 "
        f"dead, 2 transient errors, batch timeout {dt / 2:.3g} virtual s): "
        f"{len(freqs)} requests, {ended} ended (labels "
        f"{sum(is_label(r.result) for r in freqs)}, shed {fs['shed']}, "
        f"timed out {fs['timeouts']}); retries {fs['retries']}; "
        f"failed_devices {fs['failed_devices']}; faults injected "
        f"{fs['faults_injected']}; labels equal the unfaulted run's: {same}; "
        f"both runs {t_drill:.2f} s [{on}]")
    if ended != len(freqs) or not same or fs["failed_devices"] != [3, 5]:
        raise AssertionError("the fault drill left a request unended, "
                             "changed a label or failed other lanes")
    checks.append(("fault drill", [(cascades[c], row, r.result)
                                   for (c, row), r in zip(stream, freqs)
                                   if is_label(r.result)], widths))

    # ---- (f) a service seeded by the ingest index: 0 model invocations
    index, iplan = before["index"], before["plan"]
    held = {c.concept: c for c in iplan.cascades
            if index.cascade_keys.get(c.concept) == c.key}
    isvc = build_cascade_service(before["frames"], held, shards=8,
                                 batch_size=SERVE_BATCH, repcache_bytes=0,
                                 device=dev, ingest_index=index)
    ireqs = []
    for c, casc in held.items():
        col = index.decided.column(casc.key)
        for row in np.where(col >= 0)[0][:sc["ingest"]]:
            ireqs.append((c, int(col[row]), Request(len(ireqs), int(row))))
            isvc.submit(c, ireqs[-1][2])
    ist = isvc.summary()
    log(f"  ingest-seeded service over the stream: {len(ireqs)} requests "
        f"on index-decided rows of {list(held)}; store hits "
        f"{ist['store_hits']}, batches {ist['batches']}, stage-0 runs "
        f"{isvc.stage0_runs}")
    if not ireqs or ist["store_hits"] != len(ireqs) or ist["batches"] or \
            any(r.result != want for _, want, r in ireqs):
        raise AssertionError("ingest-decided rows were not answered from "
                             "the seeded store")
    del isvc

    launches = ops.LAUNCHES["fused_pyramid_stage0"]
    runs = [s for s, _, _ in services] + [host.service, over, fsvc, clean]
    scan_chunks = [r.stats.chunks for r in (plain, sres, wres)]
    expect = sum(scan_chunks) + sum(s.stage0_runs for s in runs) \
        + sync_batches
    log(f"  fused_pyramid_stage0 launches in the phase: {launches} (scan "
        f"chunks {scan_chunks} + services' base runs "
        f"{[s.stage0_runs for s in runs]} + sync batches {sync_batches} = "
        f"{expect})")
    if dev.type == "cuda" and (launches != expect or launches == 0):
        raise AssertionError("stage-0 launches do not match the serving "
                             "path's base runs")

    # ---- every label against naive_scan's, boundary rows counted
    exempt = boundary_rows(corpus, plan.cascades, scan_diff, chunk,
                           widths=widths)
    log(f"  ScanEngine(repcache=) vs the serial scan: identical rows: "
        f"{not len(scan_diff)}" + (f" except {len(exempt)} threshold-"
                                   f"boundary rows {exempt}" if exempt
                                   else ""))
    for label, got, w in checks:
        bad = {}
        for casc, row, lab in got:
            if lab != int(cols[casc.key][row]):
                bad.setdefault(casc.key, (casc, set()))[1].add(row)
        found = []
        for casc, rows in bad.values():
            found += boundary_rows(corpus, [casc], sorted(rows), chunk,
                                   widths=tuple(w))
        log(f"  {label}: {len(got)} labels vs naive_scan: identical: "
            f"{not found}" + (f" except {len(found)} threshold-boundary "
                              f"rows {found}" if found else ""))
    if dev.type == "cuda":
        serve("profile, serving 8 lanes (fresh store and cache)", 8,
              profile_against=fresh[8][2])
    kern["stage0"]["serving_launches"] = launches
    log(f"  the phase: {time.perf_counter() - t_phase:.1f} s [{on}]")
    return launches


def _peak_reset(dev):
    import torch
    if dev.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_extra(dev, mem0):
    import torch
    return None if mem0 is None else \
        torch.cuda.max_memory_allocated(dev) - mem0


def _mb(nbytes) -> str:
    return "not measured" if nbytes is None else f"{nbytes / 1e6:.1f} MB"


def expr(tree) -> str:
    """An expression tree in one short line: And(acorn, Not(ferret))."""
    from repro_torch.engine.algebra import Pred
    if isinstance(tree, Pred):
        return tree.concept
    kids = getattr(tree, "children", None) or (tree.child,)
    return f"{type(tree).__name__}({', '.join(expr(k) for k in kids)})"


def check_ingest_scores(pipe, chunks):
    """(a)'s score check: on each of ``chunks`` ([(row ids, their
    frames)], one scored ingest chunk's references each), the anchor's
    recorded ingest scores equal the kernel's own on the same padded
    chunk (same levels requested, same width), and stay within
    SCORE_TOL of the plain version's."""
    import numpy as np
    import torch

    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    c0 = pipe.cascades[0]
    s0 = c0.stage0
    need = {c0.reps[0].resolution} | {c.reps[0].resolution
                                      for c in pipe.cascades[1:]}
    for rids, x in chunks:
        nv = len(rids)
        x = np.concatenate([x, np.repeat(x[-1:], pipe.chunk - nv, axis=0)])
        imgs = torch.from_numpy(x).to(pipe.device)
        pooled = sorted(need - {imgs.shape[1]})
        _, sk = fused_pyramid_stage0(imgs, pooled, s0.params, s0.rep)
        _, sp = fused_pyramid_stage0_ref(imgs, pooled, s0.params, s0.rep)
        got = pipe.index.scores[c0.concept][rids]
        sk = sk[:nv].cpu().numpy()
        same = np.array_equal(sk, got)
        err = float(np.abs(sk - sp[:nv].cpu().numpy()).max())
        log(f"  ingest scores of {c0.concept} on a chunk of {nv} references "
            f"(rows {int(rids[0])}..{int(rids[-1])}): equal to the kernel's "
            f"on the padded chunk: {same}; max |kernel - plain| {err:.3g}")
        if not same or err > SCORE_TOL:
            raise AssertionError("ingest scores differ from the kernel's "
                                 "own, or the kernel from the plain version")


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------ phase 4 --
def lm_path(dev, cfg, card, kern, seed):
    """zamba2-1.2b prefill + greedy decode through ``launch.serve.serve``;
    returns the launch counts of the timed serve."""
    import torch

    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.factory import build_model, count_params
    lm = cfg["lm"]
    log("== LM serve path")
    arch = get_arch(lm["arch"]) if lm["full"] else smoke_config(lm["arch"])
    model = build_model(arch)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    _sync(dev)
    log(f"  {arch.name}: {count_params(params):,} parameters ({arch.dtype}), "
        f"d_model {arch.d_model}, {arch.n_layers} Mamba-2 layers, the shared "
        f"attention block after every {arch.hybrid_attn_every}; random "
        f"weights in {time.perf_counter() - t0:.3f} s")
    b, s, n_gen = lm["batch"], lm["prompt"], lm["gen"]
    prompts = torch.randint(0, arch.vocab_size, (b, s), generator=gen,
                            device=dev)
    serve(model, params, prompts, 2, "bfloat16", device=dev)   # warm-up

    # ---- the main path, with the launch counts read around it
    ops.reset_launch_counts()
    res = serve(model, params, prompts, n_gen, "bfloat16", device=dev)
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "ssd_scan")}
    expect = {"flash_attention": arch.n_layers // arch.hybrid_attn_every,
              "ssd_scan": arch.n_layers}
    log(f"  served {b} prompts x {s} tokens + {n_gen} greedy decode steps, "
        f"bf16 KV: prefill {res.prefill_s * 1e3:.3f} ms "
        f"({b * s / res.prefill_s:.0f} prompt tok/s), decode "
        f"{res.decode_s * 1e3 / n_gen:.3f} ms/step "
        f"({b * n_gen / res.decode_s:.1f} tok/s)")
    log(f"  launches on the serve path: {launches} (one prefill; expected "
        f"{expect})")
    if dev.type == "cuda" and launches != expect:
        raise AssertionError(f"serve path launches {launches} != {expect}")
    toks, lg = res.tokens, res.logits
    if tuple(toks.shape) != (b, n_gen + 1) or not torch.isfinite(lg).all() \
            or int(toks.max()) >= arch.vocab_size or int(toks.min()) < 0:
        raise AssertionError("serve produced bad tokens or logits")
    log(f"  sample tokens: {toks[0, :8].tolist()}")
    check_lm_kernels(dev, cfg, card, kern, arch, gen)
    def prefill():
        return serve(model, params, prompts, 0, "bfloat16", device=dev)

    if dev.type == "cuda":
        kernels = device_profile(prefill, dev, res.prefill_s,
                                 "prefill profile (bf16)") or {}
        for name, (n, us) in sorted(kernels.items(), key=lambda kv:
                                    -kv[1][1]):
            if "copy" in name.lower():
                log(f"    copy kernel in prefill: {us / 1e3:9.3f} ms {n:6d}x "
                    f"{name[:90]}")
    perms = permute_copies(prefill, (b, arch.n_heads, s, arch.head_dim))
    log(f"  (B,S,H,D) <-> (B,H,S,D) copies in one prefill: {perms} (the "
        f"flash kernel takes the model's views and returns its layout; "
        f"{expect['flash_attention']} flash calls)")
    if dev.type == "cuda" and perms:
        raise AssertionError(f"prefill made {perms} permute copies around "
                             f"the flash kernel")
    if dev.type == "cuda":
        steps = 4
        t0 = time.perf_counter()
        serve(model, params, prompts[:, :8], steps, device=dev)
        log(f"  (decode profile: {steps} steps after an 8-token prefill)")
        device_profile(lambda: serve(model, params, prompts[:, :8], steps,
                                     device=dev), dev,
                       time.perf_counter() - t0, "prefill(8) + decode profile")
    consistency(lm["check_at"], arch, params, prompts)
    return launches


def permute_copies(run, bhsd):
    """How many copies ``run()`` makes of a non-contiguous tensor shaped
    like the attention's (B,H,S,D) or (B,S,H,D) operands: the permutes a
    layout change around the flash kernel costs. Counted at the operator
    level (clone, copy_, _to_copy), through a dispatch mode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    b, h, s, d = bhsd
    shapes = {(b, h, s, d), (b, s, h, d)}
    aten = torch.ops.aten
    copies = {aten.clone.default, aten.copy_.default, aten._to_copy.default}
    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in copies:
                src = args[1] if func is aten.copy_.default else args[0]
                if torch.is_tensor(src) and tuple(src.shape) in shapes \
                        and not src.is_contiguous():
                    count[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        run()
    return count[0]


def _close(got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    return err, ok


def check_lm_kernels(dev, cfg, card, kern, arch, gen):
    """Both LM kernels against their plain versions at the serve path's
    shapes and at the reference tests' shapes, and their times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.bindings import ssd_heads_per_block
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    lm = cfg["lm"]
    b, s = lm["batch"], lm["prompt"]
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    fl = {"max_abs_err": 0.0}
    path = (b, arch.n_heads, s, arch.head_dim)
    cases = [(shp, c, dt) for shp, c in [(path, True)] + [
        (shp, c) for shp in FLASH_TEST_SHAPES for c in (True, False)]
        for dt in (torch.float32, bf)]
    for (bb, h, sl, d), causal, dt in cases:
        for layout in ("(B,H,S,D)", "(B,S,H,D).transpose(1, 2)"):
            if layout == "(B,H,S,D)":
                q, k, v = (randn(bb, h, sl, d, dtype=dt, scale=0.5)
                           for _ in range(3))
            else:      # the strided views the model passes
                q, k, v = (randn(bb, sl, h, d, dtype=dt, scale=0.5
                                 ).transpose(1, 2) for _ in range(3))
            # bf16 is held against the plain version in f32, which rounds
            # neither the scores nor P: see FLASH_BF16_TOL
            tol = FLASH_BF16_TOL if dt == bf else (FLASH_TOL, FLASH_TOL)
            want = flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal)
            out = flash_attention(q, k, v, causal=causal)
            err, ok = _close(out, want, *tol)
            same = (out.is_contiguous() if layout == "(B,H,S,D)"
                    else out.transpose(1, 2).is_contiguous())
            log(f"  flash_attention {(bb, h, sl, d)} {layout} {dt} "
                f"causal={causal}: max |err| {err:.3g} (atol, rtol "
                f"{tol[0]:.3g}, {tol[1]:.3g}; mean |out| "
                f"{float(want.abs().mean()):.3g}); output in q's layout: "
                f"{same}")
            if not ok:
                raise AssertionError(f"flash_attention {path} {layout} {dt}: "
                                     f"{err}")
            if dev.type == "cuda" and not same:
                raise AssertionError(f"flash_attention {layout}: the output "
                                     f"is not laid out like q")
            fl["max_abs_err"] = max(fl["max_abs_err"], err)
    # the main path's input: (B,S,H,D) tensors seen as (B,H,S,D)
    q, k, v = (randn(b, s, arch.n_heads, arch.head_dim, dtype=bf
                     ).transpose(1, 2) for _ in range(3))
    it = cfg["iters"]
    t = alternating(
        f"flash_attention {path} bf16 causal on (B,S,H,D) views",
        (("kernel", lambda: flash_attention(q, k, v)),
         ("sdpa", lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True))),
        dev, it)
    fl.update(ms=t["kernel"]["ms"][0], library_ms=t["sdpa"]["ms"][0],
              device_ms=t["kernel"]["device_ms"][0],
              library_device_ms=t["sdpa"]["device_ms"][0],
              plain_ms=time_ms(lambda: flash_attention_ref(q, k, v), dev, it))
    bb, h, _, d = path
    t_ops = 4.0 * bb * h * d * s * (s + 1) / 2 / card["bf16"]
    t_mem = 4.0 * bb * h * s * d * 2 / card["bw"]
    fl.update(bound_ms=max(t_ops, t_mem) * 1e3,
              bound_by="operations" if t_ops > t_mem else "bytes",
              shape=f"q,k,v {path} bf16 causal, (B,S,H,D).transpose(1, 2) "
                    f"views")
    log(f"  flash_attention {path} bf16 causal: kernel {fl['ms']:.4f} ms, "
        f"plain {fl['plain_ms']:.4f} ms, sdpa {fl['library_ms']:.4f} ms "
        f"(CUDA events); device time kernel {_ms(fl['device_ms'])} ms, sdpa "
        f"{_ms(fl['library_device_ms'])} ms; bound {fl['bound_ms']:.4f} ms "
        f"({fl['bound_by']})")

    ss = {"max_abs_err": 0.0}
    h, p, n = arch.ssm_heads, arch.ssm.head_dim, arch.ssm.d_state
    chunk = arch.ssm.chunk_size

    def ssd_inputs(bb, sl, hh, pp, nn, dt):
        return (randn(bb, sl, hh, pp, dtype=dt, scale=0.5),
                torch.rand((bb, sl, hh), generator=gen, device=dev) * 0.1,
                -torch.rand((hh,), generator=gen, device=dev) * 2,
                randn(bb, sl, nn, dtype=dt, scale=0.3),
                randn(bb, sl, nn, dtype=dt, scale=0.3))

    # the serving path's shape, mamba2-130m's (N 128, several heads a
    # block on the tensor cores), and the reference tests' shapes in f32
    # (the FFMA kernel) and bf16 (the tensor-core kernel's ragged P and N)
    m130 = get_arch("mamba2-130m")
    m130_shape = (b, s, m130.ssm_heads, m130.ssm.head_dim, m130.ssm.d_state)
    cases = [((b, s, h, p, n), chunk, bf), (m130_shape, chunk, bf)] + [
        (shp, c, dt) for shp in SSD_TEST_SHAPES for c in (16, 32, 64)
        for dt in (torch.float32, bf)]
    for shp, c, dt in cases:
        args = ssd_inputs(*shp, dt)
        (y, fin), (yr, fr) = (ssd_scan(*args, chunk=c),
                              ssd_scan_ref(*args, chunk=c))
        ey, oky = _close(y, yr, *SSD_TOL)
        ef, okf = _close(fin, fr, *SSD_TOL)
        bb, _, hh, pp, nn = shp
        hb = ssd_heads_per_block(bb, hh, pp, nn, dt == bf)
        log(f"  ssd_scan x {shp[:4]} N {shp[4]} {dt} chunk {c}: max |err| "
            f"y {ey:.3g}, final state {ef:.3g} (tol {SSD_TOL}); "
            + (f"tensor cores, {hb} heads a block" if hb else "f32 FFMA"))
        if not (oky and okf):
            raise AssertionError(f"ssd_scan {shp} chunk {c}: {ey}, {ef}")
        ss["max_abs_err"] = max(ss["max_abs_err"], ey, ef)
    rows = []
    for (bb, sl, hh, pp, nn) in ((b, s, h, p, n), m130_shape):
        args = ssd_inputs(bb, sl, hh, pp, nn, bf)
        row = {"ms": time_ms(lambda: ssd_scan(*args, chunk=chunk), dev, it),
               "device_ms": device_ms(lambda: ssd_scan(*args, chunk=chunk),
                                      dev, it),
               "plain_ms": time_ms(lambda: ssd_scan_ref(*args, chunk=chunk),
                                   dev, it)}
        # the least work: the state update and the output contraction, on
        # the unit the kernel uses (bf16 tensor cores), against the bytes
        # (x, B, C in bf16, dt and a in f32 read; y and the final state in
        # f32 written)
        t_ops = 4.0 * bb * sl * hh * pp * nn / card["bf16"]
        nbytes = (bb * sl * hh * pp * 2 + bb * sl * hh * 4 + hh * 4
                  + 2 * bb * sl * nn * 2 + bb * sl * hh * pp * 4
                  + bb * hh * pp * nn * 4)
        t_mem = nbytes / card["bw"]
        row.update(bound_ms=max(t_ops, t_mem) * 1e3,
                   bound_by="operations" if t_ops > t_mem else "bytes",
                   library_ms=None,
                   shape=f"x ({bb},{sl},{hh},{pp}) bf16, N {nn}, chunk "
                         f"{chunk}, {ssd_heads_per_block(bb, hh, pp, nn)} "
                         f"heads a block")
        log(f"  ssd_scan {row['shape']}: kernel {row['ms']:.4f} ms (device "
            f"{_ms(row['device_ms'])}), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); no single "
            f"PyTorch call computes it")
        rows.append(row)
    ss.update(rows[0], other_shapes=rows[1:])
    kern["flash_attention"], kern["ssd_scan"] = fl, ss


def consistency(c, arch, params, prompts, *, dtype="float32",
                tol=CONSIST_TOL, extras=None):
    """In a ``dtype`` copy of the model: ``prefill`` on the first ``c``
    tokens, then one ``decode_step``, against ``forward`` over all of them
    at those positions (the kernel path vs the plain decode recurrences).
    ``extras``: the family's other inputs over the whole sequence
    (``enc_frames``, ``vision_embeds``, ``mrope_positions`` (3,B,S), cut
    to the prefix and the step). In bf16 a row's argmax may differ only at
    a near-tie (NEAR_TIE_BF16), counted and printed."""
    import torch

    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.common import DTYPES
    from repro_torch.models.factory import build_model
    m = build_model(arch.replace(dtype=dtype))
    p = _cast(params, DTYPES[dtype])
    extras = extras or {}
    pre, one = dict(extras, tokens=prompts[:, :c]), {
        "tokens": prompts[:, c:c + 1]}
    if "mrope_positions" in extras:
        pre["mrope_positions"] = extras["mrope_positions"][:, :, :c]
        one["mrope_positions"] = extras["mrope_positions"][:, :, c:c + 1]
    full, _, _ = m.forward(p, dict(extras, tokens=prompts))
    last, cache = m.prefill(p, pre, kv_dtype=dtype)
    step, _ = m.decode(p, grow_cache(cache, 1), one)
    for name, got, want in (("prefill", last, full[:, c - 1]),
                            ("decode_step", step, full[:, c])):
        got, want = got.float(), want.float()
        rel = float((got - want).abs().max() / want.abs().max())
        differ = (got.argmax(-1) != want.argmax(-1)).nonzero()[:, 0].tolist()
        ties = near_ties(want.topk(2, -1).values) if dtype != "float32" \
            else torch.zeros(len(want), dtype=torch.bool)
        log(f"  {dtype} {arch.name} ({arch.n_layers} layers) {name} at "
            f"position {c - (name == 'prefill')} vs forward over "
            f"{prompts.shape[1]} tokens: max |diff| / max |logit| {rel:.3g} "
            f"(tol {tol:.3g}), argmax differs in rows {differ} (near-ties "
            f"among the {len(want)} rows: {ties.nonzero()[:, 0].tolist()})")
        if rel > tol or any(not ties[r] for r in differ) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"{arch.name} {name} disagrees with "
                                 f"forward: {rel}, rows {differ}")
    log(f"  prefill + decode_step == forward ({dtype}, kernel path vs the "
        f"plain decode recurrences)")


def near_ties(top2, tol=NEAR_TIE_BF16):
    """(..., 2) top-two logits (descending) -> bool: the gap lies within
    the bf16 near-tie tolerance."""
    return top2[..., 0] - top2[..., 1] <= tol[0] + tol[1] * top2[..., 0].abs()


# ----------------------------------------------------------- phase 4b --
def dense_lm_path(dev, cfg, card, kern, seed):
    """deepseek-7b served through ``launch.serve.serve``, the flash kernel
    at head width 128, prefill/decode consistency of the four dense archs,
    speculative decoding, continuous batching and the LM cascade. Returns
    the serve's ``flash_attention`` launches."""
    import torch

    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import grow_cache, serve
    from repro_torch.models.factory import build_model, count_params
    dn = cfg["dense"]
    log("== dense LM path")

    def arch_of(name):
        return get_arch(name) if dn["full"] else smoke_config(name)

    arch = arch_of("deepseek-7b")
    model = build_model(arch)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    _sync(dev)
    log(f"  {arch.name}: {count_params(params):,} parameters ({arch.dtype}), "
        f"{arch.n_layers} layers, d_model {arch.d_model}, {arch.n_heads} "
        f"heads of {arch.head_dim} ({arch.n_kv_heads} KV heads), d_ff "
        f"{arch.d_ff}, vocab {arch.vocab_size}; random weights in "
        f"{time.perf_counter() - t0:.3f} s")
    b, s, n_gen = dn["batch"], dn["prompt"], dn["gen"]
    prompts = torch.randint(0, arch.vocab_size, (b, s), generator=gen,
                            device=dev)
    serve(model, params, prompts, 2, "bfloat16", device=dev)   # warm-up

    # ---- the main path, with the launch counts read around it
    mem0 = _peak_reset(dev)
    ops.reset_launch_counts()
    res = serve(model, params, prompts, n_gen, "bfloat16", device=dev)
    launches = dict(ops.LAUNCHES)
    served = dict(ops.FLASH_SHAPES)
    peak = _peak_extra(dev, mem0)
    expect = {k: (arch.n_layers if k == "flash_attention" else 0)
              for k in launches}
    log(f"  served {b} prompts x {s} tokens + {n_gen} greedy decode steps, "
        f"bf16 KV: prefill {res.prefill_s * 1e3:.3f} ms "
        f"({b * s / res.prefill_s:.0f} prompt tok/s), decode "
        f"{res.decode_s * 1e3 / n_gen:.3f} ms/step "
        f"({b * n_gen / res.decode_s:.1f} tok/s); peak memory above the "
        f"weights {_mb(peak)}")
    log(f"  launches on the serve path: {launches} (one prefill; expected "
        f"flash_attention {arch.n_layers})")
    if dev.type == "cuda" and launches != expect:
        raise AssertionError(f"dense serve path launches {launches} != "
                             f"{expect}")
    toks, lg = res.tokens, res.logits
    if tuple(toks.shape) != (b, n_gen + 1) or not torch.isfinite(lg).all() \
            or int(toks.max()) >= arch.vocab_size or int(toks.min()) < 0:
        raise AssertionError("dense serve produced bad tokens or logits")
    log(f"  sample tokens: {toks[0, :8].tolist()}")
    if dev.type == "cuda":
        device_profile(lambda: serve(model, params, prompts, 0, device=dev),
                       dev, res.prefill_s, "prefill profile (bf16)")
        _, cache = model.prefill(params, {"tokens": prompts})
        cache = grow_cache(cache, 2)
        step_in = {"tokens": toks[:, :1]}
        _sync(dev)
        t0 = time.perf_counter()
        model.decode(params, cache, step_in)
        _sync(dev)
        device_profile(lambda: model.decode(params, cache, step_in), dev,
                       time.perf_counter() - t0,
                       f"decode step profile (batch {b}, {s + 1} cached "
                       f"tokens)")
        del cache
    check_flash_128(dev, cfg, card, kern, arch, gen, served)
    dense_consistency(dn, arch_of, arch, params, prompts, gen, dev)
    del res, lg
    speculative_check(dn, arch, model, params, prompts, dev, seed)
    batching_check(dn, arch, model, params, dev, seed)
    cascade_check(dn, arch_of, model, params, dev, seed)
    return launches["flash_attention"]


def check_flash_128(dev, cfg, card, kern, arch, gen, served):
    """The flash kernel at head width 128 against its plain version: the
    serve path's shape on the model's (B,S,H,D) views and contiguous,
    without the causal mask, ragged S != T, and f32 (the FFMA kernel);
    then kernel, plain, bound and SDPA times at the path's shape, with
    its launches in the serve (``served``: the serve's
    ``ops.FLASH_SHAPES``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    dn = cfg["dense"]
    b, s, h, d = dn["batch"], dn["prompt"], arch.n_heads, arch.head_dim
    bf = torch.bfloat16
    path = (b, h, s, d)

    def inputs(qshape, kshape, dt, view):
        def one(shape):
            bb, hh, sl, dd = shape
            x = torch.randn((bb, sl, hh, dd) if view else shape,
                            generator=gen, device=dev) * 0.5
            return x.to(dt).transpose(1, 2) if view else x.to(dt)
        return one(qshape), one(kshape), one(kshape)

    cases = [(path, path, True, bf, True), (path, path, True, bf, False),
             (path, path, False, bf, True)]
    cases += [(q, k, c, bf, False) for (q, k), c in
              zip(dn["flash_shapes"], (False, True))]
    f32 = (2, 8, 512, 128) if dn["full"] else (1, 2, 64, 128)
    cases += [(f32, f32, True, torch.float32, False)]
    cases += [(q, k, c, torch.float32, False) for (q, k), c in
              zip(dn["flash_shapes"], (False, True))]
    fl = kern["flash_attention"]
    for qs, ks, causal, dt, view in cases:
        q, k, v = inputs(qs, ks, dt, view)
        tol = FLASH_BF16_TOL if dt == bf else (FLASH_TOL, FLASH_TOL)
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal)
        out = flash_attention(q, k, v, causal=causal)
        err, ok = _close(out, want, *tol)
        same = (out.transpose(1, 2).is_contiguous() if view
                else out.is_contiguous())
        log(f"  flash_attention D={qs[3]} q {qs} k/v {ks} "
            f"{'(B,S,H,D).transpose(1, 2)' if view else '(B,H,S,D)'} {dt} "
            f"causal={causal}: max |err| {err:.3g} (atol, rtol {tol[0]:.3g}, "
            f"{tol[1]:.3g}; mean |out| {float(want.abs().mean()):.3g}); "
            f"output in q's layout: {same}")
        if not ok or (dev.type == "cuda" and not same):
            raise AssertionError(f"flash_attention {qs} {ks} {dt}: "
                                 f"{err}, layout {same}")
        fl["max_abs_err"] = max(fl["max_abs_err"], err)
    # under autograd (a model trained on the card): the kernel's forward,
    # the plain version's backward
    from repro_torch.kernels import ops
    q, k, v = (t.float().requires_grad_() for t in inputs(
        dn["flash_shapes"][0][0], dn["flash_shapes"][0][0], bf, False))
    w = torch.randn(q.shape, generator=gen, device=dev)
    ops.reset_launch_counts()
    out = flash_attention(q, k, v)
    n_fwd = ops.LAUNCHES["flash_attention"]
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad((flash_attention_ref(q, k, v) * w).sum(),
                               (q, k, v))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  flash_attention under autograd, q/k/v {tuple(q.shape)} f32: "
        f"forward by the kernel ({n_fwd} launch), gradients equal the plain "
        f"version's: {same}")
    if not same or (dev.type == "cuda" and n_fwd != 1):
        raise AssertionError("flash_attention's autograd path")
    q, k, v = inputs(path, path, bf, True)
    it = cfg["iters"]
    t = alternating(
        f"flash_attention {path} bf16 causal on (B,S,H,D) views",
        (("kernel", lambda: flash_attention(q, k, v)),
         ("sdpa", lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True))),
        dev, it)
    row = dict(ms=t["kernel"]["ms"][0], library_ms=t["sdpa"]["ms"][0],
               device_ms=t["kernel"]["device_ms"][0],
               library_device_ms=t["sdpa"]["device_ms"][0],
               plain_ms=time_ms(lambda: flash_attention_ref(q, k, v), dev,
                                it))
    t_ops = 4.0 * b * h * d * s * (s + 1) / 2 / card["bf16"]
    t_mem = 4.0 * b * h * s * d * 2 / card["bw"]
    n = served.get((b, h, s, s, d, True), 0)
    if dev.type == "cuda" and n != arch.n_layers:
        raise AssertionError(f"{arch.name} serve: {n} flash launches at "
                             f"{path} causal, not {arch.n_layers} "
                             f"({served})")
    row.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops > t_mem else "bytes",
               launches=n,
               shape=f"q,k,v {path} bf16 causal, (B,S,H,D).transpose(1, 2) "
                     f"views ({arch.name}, {n} launches in the serve's "
                     f"prefill)")
    log(f"  flash_attention {path} bf16 causal: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
        f"(CUDA events); device time kernel {_ms(row['device_ms'])} ms, sdpa "
        f"{_ms(row['library_device_ms'])} ms; bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    fl.setdefault("other_shapes", []).append(row)


def dense_consistency(dn, arch_of, arch, params, prompts, gen, dev):
    """prefill + decode_step == forward: an f32 copy of deepseek-7b cut to
    ``check_layers``, then minitron-4b (GQA), granite-20b (MQA) and
    qwen2.5-32b (QKV bias, random biases) at full width and
    ``other_layers`` in bf16, with random weights."""
    from repro_torch.models.factory import build_model
    c, n = dn["check_at"], dn["check_layers"]

    def first_layers(tree):
        if isinstance(tree, dict):
            return {k: first_layers(v) for k, v in tree.items()}
        return tree[:n]

    cut = dict(params, layers=first_layers(params["layers"]))
    consistency(c, arch.replace(n_layers=n), cut, prompts)
    del cut
    for name in ("minitron-4b", "granite-20b", "qwen2.5-32b"):
        other = arch_of(name).replace(n_layers=dn["other_layers"])
        p = build_model(other).init(gen, device=dev)
        if other.qkv_bias:     # zeros at init: give the biases a value
            for key in ("bq", "bk", "bv"):
                p["layers"]["attn"][key].normal_(0.0, 0.5, generator=gen)
        toks = prompts % other.vocab_size
        consistency(c, other, p, toks, dtype="bfloat16",
                    tol=DENSE_BF16_CONSIST_TOL)
        del p


def _recording(model, calls):
    """``model`` whose forward appends, for batch row 0, the input tokens
    and the top two logits (values, ids) of every output row to
    ``calls``."""
    def forward(p, batch, **kw):
        out = model.forward(p, batch, **kw)
        top = out[0][0].float().topk(2, dim=-1)
        calls.append((batch["tokens"][0].tolist(), top.values.cpu(),
                      top.indices.cpu()))
        return out
    return model._replace(forward=forward)


def first_divergence(got, want, top2_want):
    """-> (index of the first token where ``got`` leaves ``want`` or None,
    whether the reference's top two logits there are a near-tie)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if int(g) != int(w):
            return i, bool(near_ties(top2_want[i]))
    return None, False


def speculative_check(dn, arch, model, params, prompts, dev, seed):
    """Greedy speculative decoding with deepseek-7b as the target: drafted
    by itself (every proposal accepted, apart from counted near-ties) and
    by an independent model, deepseek-7b's config cut to ``draft_layers``
    with its own seed. Both outputs equal ``generate_greedy``'s, apart
    from a first divergence at a counted near-tie."""
    import torch

    from repro_torch.models.factory import build_model
    from repro_torch.serve.speculative import (generate_greedy,
                                               generate_speculative)
    n, g = dn["spec_tokens"], dn["gamma"]
    prompt = prompts[0, :dn["spec_prompt"]].cpu().numpy()
    greedy_calls: list = []
    t0 = time.perf_counter()
    want = generate_greedy(_recording(model, greedy_calls), params, prompt,
                           n, device=dev)
    t_greedy = time.perf_counter() - t0
    top2 = [c[1][-1] for c in greedy_calls]     # position len(prompt) + i
    ties = int(near_ties(torch.stack(top2)).sum())
    log(f"  generate_greedy {arch.name}, prompt {len(prompt)}, {n} tokens: "
        f"{t_greedy:.3f} s ({len(greedy_calls)} forwards); near-ties among "
        f"its {n} positions: {ties}")
    dcfg = arch.replace(n_layers=dn["draft_layers"])
    draft = build_model(dcfg)
    dparams = draft.init(torch.Generator(device=dev).manual_seed(seed + 6),
                         device=dev)
    fails = []
    for label, dm, dp in (("self-draft", model, params),
                          (f"draft {arch.name} cut to {dcfg.n_layers} "
                           f"layers", draft, dparams)):
        calls: list = []
        target = _recording(model, calls)
        if dm is model:
            dm = target
        _sync(dev)
        t0 = time.perf_counter()
        out, st = generate_speculative(dm, dp, target, params, prompt, n,
                                       gamma=g, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        at, tie = first_divergence(out, want, top2)
        rej = verify_rejections(calls, len(prompt), n)
        log(f"  speculative, {label}, gamma {g}: acceptance "
            f"{st.acceptance_rate:.3f} ({st.accepted} of {st.proposed}), "
            f"target calls {st.target_calls}, draft calls {st.draft_calls}; "
            f"{wall:.3f} s vs generate_greedy's {t_greedy:.3f} s "
            f"({t_greedy / wall:.2f}x); output equals generate_greedy's: "
            + ("True" if at is None else
               f"up to token {at}, where greedy's top two logits are "
               f"{'a near-tie' if tie else 'NOT a near-tie'}")
            + f"; rejected proposals at (position, near-tie): {rej}")
        if at is not None and not tie:
            fails.append(f"{label}: output leaves greedy's at {at}")
        if dm is target and (any(not t for _, t in rej) or not rej and (
                st.acceptance_rate != 1.0
                or st.target_calls != -(-n // (g + 1)))):
            fails.append(f"self-draft: {st}, rejected {rej}")
    del draft, dparams
    if fails:
        raise AssertionError("; ".join(fails))


def verify_rejections(calls, n_prompt, n_tokens):
    """Replays the target's verification forwards (recorded by
    ``_recording``; the draft's have one output row): -> [(position of a
    rejected proposal, whether the target's top two logits there are a
    near-tie)]."""
    out_len, rejected = 0, []
    for toks, top2, ids in calls:
        if len(ids) != len(toks):
            continue                      # a draft call (last row only)
        base = n_prompt + out_len - 1
        props = toks[n_prompt + out_len:]
        n_acc = 0
        while n_acc < len(props) and props[n_acc] == int(ids[base + n_acc,
                                                              0]):
            n_acc += 1
        if n_acc < len(props):
            rejected.append((base + n_acc + 1,
                             bool(near_ties(top2[base + n_acc]))))
        out_len = min(n_tokens, out_len + n_acc + 1)
    return rejected


def batching_check(dn, arch, model, params, dev, seed):
    """``ContinuousBatcher`` with ``slots`` slots of ``capacity`` tokens
    over ``requests`` requests (prompt lengths and budgets drawn from the
    seed): every request's tokens equal its own B = 1 ``generate_greedy``,
    apart from a first divergence at a counted near-tie."""
    import numpy as np
    import torch

    from repro_torch.serve.continuous_batching import (ContinuousBatcher,
                                                       GenRequest)
    from repro_torch.serve.speculative import generate_greedy
    rng = np.random.default_rng(seed + 7)
    lo, hi = dn["prompt_range"]
    blo, bhi = dn["budget_range"]
    reqs = [GenRequest(i, rng.integers(0, arch.vocab_size,
                                       int(rng.integers(lo, hi + 1))
                                       ).astype(np.int32),
                       int(rng.integers(blo, bhi + 1)))
            for i in range(dn["requests"])]
    eng = ContinuousBatcher(model, params, n_slots=dn["slots"],
                            capacity=dn["capacity"], device=dev)
    for r in reqs:
        eng.submit(r)
    _sync(dev)
    t0 = time.perf_counter()
    st = eng.run_to_completion()
    _sync(dev)
    wall = time.perf_counter() - t0
    made = sum(len(r.out) for r in reqs)
    log(f"  continuous batching, {dn['slots']} slots x {dn['capacity']} "
        f"tokens, {len(reqs)} requests (prompts {lo}-{hi}, budgets "
        f"{blo}-{bhi}): {st.steps} steps, mean slot occupancy "
        f"{st.mean_occupancy:.3f}, {made} tokens in {wall:.3f} s "
        f"({made / wall:.1f} tok/s, prefills included), finished "
        f"{st.finished}")
    if st.finished != len(reqs) or any(not r.done for r in reqs):
        raise AssertionError(f"continuous batching left requests: {st}")
    diverged, bad, agree_noise = [], [], 0.0
    for r in reqs:
        calls: list = []
        want = generate_greedy(_recording(model, calls), params, r.prompt,
                               r.max_new, device=dev)
        top2 = [c[1][-1] for c in calls]
        at, tie = first_divergence(r.out, want, top2)
        if at is not None:
            (diverged if tie else bad).append((r.rid, at, len(r.out)))
    log(f"  every request's tokens equal its own B = 1 greedy decode: "
        f"{len(reqs) - len(diverged) - len(bad)} of {len(reqs)} to the "
        f"last token; first divergence at a near-tie (request, token, of): "
        f"{diverged}; elsewhere: {bad}")
    if bad:
        raise AssertionError(f"continuous batching left greedy away from a "
                             f"near-tie: {bad}")


def cascade_check(dn, arch_of, trusted_model, trusted_params, dev, seed):
    """The LM predicate cascade: minitron-4b reading the last ``context``
    tokens as the cheap level, deepseek-7b as the trusted level (random
    weights), tests/test_lm_cascade.py's task at ``prompt`` tokens;
    calibrated on ``calib`` rows (prec_target 0.8), run over ``eval`` rows
    in batches of ``cascade_batch``. Labels and levels equal a host oracle
    that routes each row from the levels' own scores; rows whose cheap
    score lies within SCORE_TOL of a threshold are counted."""
    import numpy as np
    import torch

    from repro_torch.core.lm_cascade import (LMLevel, calibrate,
                                             expected_cost,
                                             lm_predicate_score,
                                             run_lm_cascade)
    from repro_torch.models.factory import build_model
    yes, no = 7, 13
    cheap_arch = arch_of("minitron-4b")
    cheap = build_model(cheap_arch)
    cparams = cheap.init(torch.Generator(device=dev).manual_seed(seed + 8),
                         device=dev)
    rng = np.random.default_rng(seed + 9)
    n, seq = dn["calib"] + dn["eval"], dn["prompt"]
    toks = rng.integers(0, arch_of("deepseek-7b").vocab_size,
                        (n, seq)).astype(np.int32)
    toks[toks == yes] = yes + 1
    truth = rng.integers(0, 2, n).astype(np.int32)
    for i in np.where(truth == 1)[0]:
        toks[i, rng.integers(0, seq - 1, size=3)] = yes
    levels = [LMLevel(cheap, cparams, yes, no, max_context=dn["context"]),
              LMLevel(trusted_model, trusted_params, yes, no)]
    ca = dn["calib"]
    calibrate(levels, toks[:ca], truth[:ca], prec_target=0.8, device=dev)
    lv0 = levels[0]
    bs = dn["cascade_batch"]
    labels, used, scores, secs = [], [], [[], []], [0.0, 0.0]
    t_run = 0.0
    for i in range(ca, n, bs):
        batch = toks[i:i + bs]
        _sync(dev)
        t0 = time.perf_counter()
        lab, u = run_lm_cascade(levels, batch, device=dev)
        t_run += time.perf_counter() - t0
        labels.append(lab)
        used.append(u)
        for li, lvl in enumerate(levels):
            t0 = time.perf_counter()
            scores[li].append(lm_predicate_score(lvl, batch, device=dev))
            secs[li] += time.perf_counter() - t0
    labels, used = np.concatenate(labels), np.concatenate(used)
    s0, s1 = (np.concatenate(x) for x in scores)
    certain = (s0 <= lv0.p_low) | (s0 >= lv0.p_high)
    o_used = np.where(certain, 0, 1).astype(np.int32)
    o_labels = np.where(certain, s0 >= lv0.p_high, s1 >= 0.5).astype(np.int32)
    near = np.minimum(np.abs(s0 - lv0.p_low), np.abs(s0 - lv0.p_high)
                      ) <= SCORE_TOL
    differ = (labels != o_labels) | (used != o_used)
    per_row = [x / dn["eval"] for x in secs]
    ev = truth[ca:]
    log(f"  LM cascade: {cheap_arch.name} on the last {dn['context']} "
        f"tokens, then {arch_of('deepseek-7b').name} on {seq}; calibrated "
        f"on {ca} rows (prec_target 0.8): p_low {lv0.p_low:.2f}, p_high "
        f"{lv0.p_high:.2f}; {dn['eval']} rows in batches of {bs}: "
        f"{int((used == 0).sum())} exit at level 0; accuracy vs the task's "
        f"labels {float((labels == ev).mean()):.3f} (random weights); "
        f"cascade run {t_run:.3f} s")
    log(f"  LM cascade seconds per row: level 0 {per_row[0] * 1e3:.4f} ms, "
        f"level 1 {per_row[1] * 1e3:.4f} ms (whole batches, measured); "
        f"expected_cost {expected_cost(levels, used, per_row) * 1e3:.4f} ms "
        f"a row vs the trusted level alone {per_row[1] * 1e3:.4f} ms")
    log(f"  labels and levels equal the host oracle's: "
        f"{not differ.any()} ({int(differ.sum())} rows differ, "
        f"{int((differ & near).sum())} of them within {SCORE_TOL} of a "
        f"threshold; rows that near a threshold: {int(near.sum())})")
    if (differ & ~near).any():
        raise AssertionError(f"LM cascade rows {np.nonzero(differ & ~near)}"
                             f" differ from the oracle")
    del levels, cparams


# ----------------------------------------------------------- phase 4c --
def families_lm_path(dev, cfg, card, kern, seed):
    """The moe (phi3.5-moe), MLA + moe (deepseek-v2), vlm (qwen2-vl) and
    audio (whisper-tiny) LM families at published widths, one model at a
    time, built, used and freed. Returns their serves' flash launches."""
    import torch

    from repro_torch.configs.registry import get_arch, smoke_config
    fm = cfg["families"]
    log("== moe, MLA, vlm and audio LM paths")
    t_phase = time.perf_counter()
    flash = 0
    if dev.type == "cuda":     # the earlier phases' cached blocks
        torch.cuda.empty_cache()
    for name, depth, check_depth in fm["models"]:
        published = get_arch(name)
        base = published if fm["full"] else smoke_config(name)
        arch = base.replace(n_layers=min(depth or base.n_layers,
                                         base.n_layers))
        log(f"  -- {name} ({published.family}): "
            + (f"{arch.n_layers} of {published.n_layers} layers (depth cut; "
               f"widths as published)" if arch.n_layers < published.n_layers
               else f"all {published.n_layers} layers")
            + ("" if arch.encoder is None else
               f" + {arch.encoder.n_layers} of "
               f"{published.encoder.n_layers} encoder layers")
            + ("" if fm["full"] else " (smoke config)"))
        flash += family_model(dev, fm, card, kern, arch, base, check_depth,
                              seed)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(f"  the phase: {time.perf_counter() - t_phase:.1f} s")
    return flash


def family_model(dev, fm, card, kern, arch, base, check_depth, seed):
    """One model of the phase: init (its peak memory), the timed serve
    with its launch counts, the flash kernel at its shapes, a profile,
    the consistency check, the MoE checks or the greedy tokens' second
    route. Returns the serve's flash launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.factory import build_model, count_params
    model = build_model(arch)
    gen = torch.Generator(device=dev).manual_seed(
        seed + 10 + sum(map(ord, arch.name)))
    mem0 = _peak_reset(dev)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    n = count_params(params)
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  {arch.name}: {n:,} parameters ({arch.dtype}, {_mb(wbytes)}), "
        f"d_model {arch.d_model}, {arch.n_heads} heads of {arch.head_dim} "
        f"({arch.n_kv_heads} KV heads), vocab {arch.vocab_size}"
        + ("" if arch.moe is None else
           f", {arch.moe.num_experts} experts top-{arch.moe.top_k} of width "
           f"{arch.moe.d_ff_expert} + {arch.moe.num_shared_experts} shared, "
           f"capacity factor {arch.moe.capacity_factor}")
        + ("" if arch.mla is None else
           f", MLA kv_lora {arch.mla.kv_lora_rank} q_lora "
           f"{arch.mla.q_lora_rank} heads {arch.mla.qk_nope_head_dim}+"
           f"{arch.mla.qk_rope_head_dim} (v {arch.mla.v_head_dim})")
        + f"; random weights in {t_init:.3f} s, init peak "
        f"{_mb(_peak_extra(dev, mem0))} for {_mb(wbytes)} of weights")
    audio = arch.family == "audio"
    b, s, n_gen = fm["batch"], fm["audio_prompt" if audio else "prompt"], \
        fm["gen"]
    prompts, extras = family_inputs(arch, b, s, gen, dev)
    serve(model, params, prompts, 2, device=dev, **extras)     # warm-up

    # ---- the main path, with the launch counts read around it
    mem0 = _peak_reset(dev)
    ops.reset_launch_counts()
    res = serve(model, params, prompts, n_gen, "bfloat16", device=dev,
                **extras)
    launches = dict(ops.LAUNCHES)
    served = dict(ops.FLASH_SHAPES)
    peak = _peak_extra(dev, mem0)
    # MLA none; whisper its encoder's self-attention, then per decoder
    # layer self and cross; every other layer one
    want = (0 if arch.mla is not None else
            arch.encoder.n_layers + 2 * arch.n_layers if audio
            else arch.n_layers)
    expect = {k: (want if k == "flash_attention" else 0) for k in launches}
    log(f"  served {b} prompts x {s} tokens"
        + (f" ({arch.encoder.n_frames} encoder frames)" if audio else "")
        + (f" ({arch.vision.n_patches}-patch prefix, (t, h, w) M-RoPE)"
           if arch.family == "vlm" else "")
        + f" + {n_gen} greedy decode steps, bf16 KV: prefill "
        f"{res.prefill_s * 1e3:.3f} ms ({b * s / res.prefill_s:.0f} prompt "
        f"tok/s), decode {res.decode_s * 1e3 / n_gen:.3f} ms/step "
        f"({b * n_gen / res.decode_s:.1f} tok/s); serve peak above the "
        f"weights {_mb(peak)}")
    log(f"  launches on the serve path: {launches} (one prefill; expected "
        f"flash_attention {want}"
        + (": MLA's attention is plain, its q/k and v heads differ in "
           "width" if arch.mla is not None else "")
        + ")")
    if dev.type == "cuda" and launches != expect:
        raise AssertionError(f"{arch.name} serve path launches {launches} "
                             f"!= {expect}")
    toks, lg = res.tokens, res.logits
    # greedy may pick a padding id: the padded rows of the (tied)
    # embedding are random weights, as in the reference
    if tuple(toks.shape) != (b, n_gen + 1) or not torch.isfinite(lg).all() \
            or int(toks.max()) >= arch.padded_vocab() or int(toks.min()) < 0:
        raise AssertionError(f"{arch.name} serve produced bad tokens or "
                             f"logits")
    log(f"  sample tokens: {toks[0, :8].tolist()}")
    del lg
    check_flash_families(dev, fm, card, kern, arch, gen, b, s, served)
    if dev.type == "cuda" and arch.moe is not None and arch.mla is None:
        prefill_profile(dev, model, params, prompts, extras, res, arch, gen)
    if dev.type == "cuda" and arch.mla is not None:
        decode_profile(dev, model, params, prompts, toks, b, s)
    if arch.moe is not None:
        moe_checks(dev, fm, arch, model, params, prompts, gen)
    else:
        greedy_route(dev, arch, model, params, prompts, extras, res)
    del res
    # prefill + decode_step == forward in f32 (no token dropped)
    c, cs = fm["check_at"], fm["check_prompt"]
    cut = arch.replace(n_layers=min(check_depth or arch.n_layers,
                                    arch.n_layers))
    if cut.moe is not None:
        cut = no_drops(cut)
    key = "dec_layers" if audio else "layers"
    # the f32 copy of the cut is all the check needs: the bf16 weights
    # go first (deepseek-v2's 34 GB beside its 20 GB f32 layer)
    p = _cast(dict(params, **{key: _first(params[key], cut.n_layers)}),
              torch.float32)
    del params, model
    cp, cx = family_inputs(arch, fm["check_batch"], cs, gen, dev)
    log(f"  consistency: {cut.name} at {cut.n_layers} of {base.n_layers} "
        f"layers"
        + (f", capacity factor {cut.moe.capacity_factor:.4g} (no token "
           f"dropped)" if cut.moe else "")
        + f", batch {fm['check_batch']} x {cs} tokens")
    consistency(c, cut, p, cp, extras=cx)
    return launches["flash_attention"]


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def no_drops(arch):
    """``arch`` with the capacity factor E/k: each expert can keep every
    token of its group (C = Tg), so no token is dropped at any batch.
    (tests/test_decode_consistency.py's factor 8 is enough for the smoke
    configs' 4 experts, not for deepseek-v2's 160 top-6: at a decode step
    of 2 tokens it gives C = 1, and two rows sharing an expert drop one.)"""
    moe = arch.moe
    return arch.replace(moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))


def _first(tree, n):
    """The first ``n`` entries of every leaf of a layer-stacked tree."""
    if isinstance(tree, dict):
        return {k: _first(v, n) for k, v in tree.items()}
    return tree[:n]


def family_inputs(arch, b, s, gen, dev):
    """Prompts (B, S) and the family's serve inputs: whisper's frame
    embeddings, N(0, 0.1^2) as the reference's launcher draws them;
    qwen2-vl's patch embeddings for the first n_patches positions, N(0,
    0.02^2) as its token embeddings, and (t, h, w) M-RoPE positions, the
    patches on a grid at t 0 and the text counting tokens on all three
    streams (where the serve's decode steps go on)."""
    import torch
    prompts = torch.randint(0, arch.vocab_size, (b, s), generator=gen,
                            device=dev)
    extras = {}
    if arch.family == "audio":
        extras["enc_frames"] = torch.randn(
            (b, arch.encoder.n_frames, arch.d_model), generator=gen,
            device=dev) * 0.1
    if arch.family == "vlm":
        n = arch.vision.n_patches
        rows = max(r for r in range(1, int(n ** 0.5) + 1) if n % r == 0)
        pos = torch.arange(s, device=dev)[None, None].repeat(3, b, 1)
        i = torch.arange(n, device=dev)
        pos[0, :, :n], pos[1, :, :n], pos[2, :, :n] = 0, i // (n // rows), \
            i % (n // rows)
        extras["mrope_positions"] = pos
        extras["vision_embeds"] = (torch.randn(
            (b, n, arch.d_model), generator=gen, device=dev) * 0.02).to(
                torch.bfloat16)
    return prompts, extras


def check_flash_families(dev, fm, card, kern, arch, gen, b, s, served):
    """The flash kernel against its plain version at the model's prefill
    shapes, on its (B,S,H,D).transpose(1, 2) views (KV heads repeated as
    the model repeats them), then kernel (both clocks), plain, bound and
    SDPA (same views) times. Each shape becomes a row of the kernels
    line's flash entry, with its launches in the serve's prefill as the
    wrapper counted them by problem (``served``: the serve's
    ``ops.FLASH_SHAPES``); on the card each must be one per layer of its
    role, and the rows must hold every launch of the serve."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention import layout_from_cfg, repeat_kv
    if arch.mla is not None:
        return
    h, d, gp = arch.n_heads, arch.head_dim, layout_from_cfg(arch).gp
    if arch.family == "audio":
        t, n = arch.encoder.n_frames, arch.n_layers
        cases = [("encoder self-attention", t, t, False,
                  arch.encoder.n_layers),
                 ("decoder self-attention", s, s, True, n),
                 ("cross-attention", s, t, False, n)]
    else:
        cases = [("self-attention", s, s, True, arch.n_layers)]
    counted = 0
    bf = torch.bfloat16
    fl = kern["flash_attention"]
    it = fm["iters"]
    for label, sq, sk, causal, per_layer in cases:
        def view(sl, heads):
            x = (torch.randn((b, sl, heads, d), generator=gen, device=dev)
                 * 0.5).to(bf)
            return repeat_kv(x, h // heads).transpose(1, 2)
        q, k, v = view(sq, h), view(sk, h // gp), view(sk, h // gp)
        n = served.get((*q.shape[:3], sk, d, causal), 0)
        counted += n
        if dev.type == "cuda" and n != per_layer:
            raise AssertionError(f"{arch.name} {label}: {n} flash launches "
                                 f"in the serve at {tuple(q.shape)} T {sk}, "
                                 f"not {per_layer} ({served})")
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal)
        out = flash_attention(q, k, v, causal=causal)
        err, ok = _close(out, want, *FLASH_BF16_TOL)
        same = out.transpose(1, 2).is_contiguous()
        shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
                 f"{'causal' if causal else 'not causal'}")
        log(f"  flash_attention {arch.name} {label}, {shape}, on (B,S,H,D) "
            f"views: max |err| {err:.3g} (atol, rtol {FLASH_BF16_TOL[0]:.3g}"
            f", {FLASH_BF16_TOL[1]:.3g}; mean |out| "
            f"{float(want.abs().mean()):.3g}); output in q's layout: {same}")
        if not ok or (dev.type == "cuda" and not same):
            raise AssertionError(f"flash_attention {arch.name} {label}: "
                                 f"{err}, layout {same}")
        fl["max_abs_err"] = max(fl["max_abs_err"], err)
        del want, out
        t = alternating(
            f"flash_attention {arch.name} {label} {shape}",
            (("kernel", lambda: flash_attention(q, k, v, causal=causal)),
             ("sdpa", lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=causal))), dev, it)
        pairs = sq * (sq + 1) / 2 if causal else sq * sk
        t_ops = 4.0 * b * h * d * pairs / card["bf16"]
        t_mem = 2.0 * b * h * d * 2 * (sq + sk) / card["bw"]
        row = dict(ms=t["kernel"]["ms"][0], library_ms=t["sdpa"]["ms"][0],
                   device_ms=t["kernel"]["device_ms"][0],
                   library_device_ms=t["sdpa"]["device_ms"][0],
                   plain_ms=time_ms(lambda: flash_attention_ref(
                       q, k, v, causal=causal), dev, it),
                   bound_ms=max(t_ops, t_mem) * 1e3,
                   bound_by="operations" if t_ops > t_mem else "bytes",
                   launches=n, max_abs_err=err,
                   shape=f"{shape}, (B,S,H,D).transpose(1, 2) views "
                         f"({arch.name} {label}, {n} launches in the "
                         f"serve's prefill)")
        log(f"  flash_attention {arch.name} {label}: kernel {row['ms']:.4f}"
            f" ms, plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms (CUDA events); device time kernel "
            f"{_ms(row['device_ms'])} ms, sdpa "
            f"{_ms(row['library_device_ms'])} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        fl.setdefault("other_shapes", []).append(row)
    log(f"  {arch.name} serve's flash launches by problem (B, H, S, T, D, "
        f"causal): {served}")
    if dev.type == "cuda" and counted != sum(served.values()):
        raise AssertionError(f"{arch.name}: serve flash launches {served} "
                             f"outside the rows' shapes")


def prefill_profile(dev, model, params, prompts, extras, res, arch, gen):
    """The bf16 prefill's device time by kernel and idle share; then one
    ``apply_moe`` at the prefill's tokens (the first layer's weights, the
    prefill's width): its device time split into the GEMMs (cuBLAS: the
    three expert products and the router's small one) and the rest
    (routing softmax and sorts, the token gather, the combine,
    elementwise), and its share of the prefill. CUPTI at times loses
    device events in a long run, so the call is profiled MOE_SESSIONS
    times, one call a session: a kernel's launches a call are the most
    any session saw, its time the median of all its launches."""
    import statistics

    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.models import ffn
    from repro_torch.models.transformer import _layers
    by = device_profile(lambda: serve(model, params, prompts, 0, device=dev,
                                      **extras),
                        dev, res.prefill_s, "prefill profile (bf16)") or {}
    busy = sum(us for _, us in by.values())
    lp = _layers(params["layers"], 1)[0]["moe"]
    x = torch.randn((prompts.shape[0], prompts.shape[1], arch.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    sessions = []
    for _ in range(MOE_SESSIONS):
        sessions.append({})
        device_ms(lambda: ffn.apply_moe(lp, x, arch), dev, 1, sessions[-1])
    per = {}                      # kernel -> (launches a call, us a launch)
    for kname in set().union(*sessions):
        runs = [sess.get(kname, []) for sess in sessions]
        per[kname] = (max(map(len, runs)),
                      statistics.median(us for r in runs for us in r))
    gemm = ("gemm", "xmma", "nvjet", "cutlass", "sm90")
    split = {"GEMMs": 0.0, "routing, gather, combine, elementwise": 0.0}
    for kname, (n, us) in per.items():
        key = ("GEMMs" if any(g in kname.lower() for g in gemm)
               else "routing, gather, combine, elementwise")
        split[key] += n * us
    one = sum(split.values())
    log(f"  one apply_moe at the prefill's {x.shape[0] * x.shape[1]} tokens "
        f"({MOE_SESSIONS} profiled calls): device {one / 1e3:.3f} ms in "
        f"{sum(n for n, _ in per.values())} launches; "
        + "; ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / max(one, 1e-9):.1f}%)"
                    for k, v in split.items())
        + (f"; x {arch.n_layers} layers = "
           f"{100 * one * arch.n_layers / busy:.1f}% of the prefill's device "
           f"time" if busy else ""))
    for kname, (n, us) in sorted(per.items(),
                                 key=lambda kv: -kv[1][0] * kv[1][1])[:8]:
        log(f"    apply_moe kernel {n * us / 1e3:8.3f} ms {n:4d}x "
            f"{kname[:90]}")


def decode_profile(dev, model, params, prompts, toks, b, s):
    """One bf16 decode step (batch b, s + 1 cached tokens), profiled."""
    from repro_torch.launch.serve import grow_cache
    _, cache = model.prefill(params, {"tokens": prompts})
    cache = grow_cache(cache, 2)
    step_in = {"tokens": toks[:, :1]}
    _sync(dev)
    t0 = time.perf_counter()
    model.decode(params, cache, step_in)
    _sync(dev)
    device_profile(lambda: model.decode(params, cache, step_in), dev,
                   time.perf_counter() - t0,
                   f"decode step profile (batch {b}, {s + 1} cached tokens, "
                   f"the absorbed MLA decode)")


def moe_checks(dev, fm, arch, model, params, prompts, gen):
    """(a) The first layer's ``apply_moe`` in f32 with no token dropped
    (``no_drops``) on ``moe_tokens`` tokens equals a per-token loop
    over each token's top-k experts in float64 on the card (MOE_LOOP_TOL).
    (b) On the prefill's tokens, at the published capacity factor, 0.5
    and 0.1: each expert keeps min(its routed tokens, capacity) tokens,
    and a token every one of its experts dropped gets exactly the shared
    experts' output (zero without them); some factor must drop a token
    from all its experts, or that branch went unchecked. (c) Two bf16 prefills give equal
    logits and caches (the combine sums in a fixed order)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import ffn
    from repro_torch.models.common import apply_norm
    from repro_torch.models.transformer import _layers
    lp = _layers(params["layers"], 1)[0]
    emb = params["embed"]["embedding"]
    f32 = no_drops(arch).replace(dtype="float32")
    m = fm["moe_tokens"]
    x = apply_norm({k: v.float() for k, v in lp["ln2"].items()},
                   emb[prompts[0, :m]].float()[None], f32)
    w = {k: (v.float() if torch.is_tensor(v) else
             {kk: vv.float() for kk, vv in v.items()})
         for k, v in lp["moe"].items()}
    out, _ = ffn.apply_moe(w, x, f32)
    r = ffn.route(w, x, f32, ffn.moe_capacity(m, f32))
    # the loop, in float64
    xd = x[0].double()
    probs = torch.softmax(xd @ w["w_router"].double(), -1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = arch.moe.top_k
    ids, wts = top.indices[:, :k], top.values[:, :k]
    wts = wts / wts.sum(-1, keepdim=True)
    gap = (top.values[:, k - 1] - top.values[:, k]) / top.values[:, k - 1]
    ref = torch.zeros_like(xd)

    def silu_mlp(v, g, u, dn):
        return (F.silu(v @ g.double()) * (v @ u.double())) @ dn.double()

    for e in ids.unique().tolist():
        rows, j = (ids == e).nonzero(as_tuple=True)
        ref[rows] += wts[rows, j, None] * silu_mlp(
            xd[rows], w["w_gate_e"][e], w["w_up_e"][e], w["w_down_e"][e])
    if "shared" in w:
        sh = w["shared"]
        ref += silu_mlp(xd, sh["w_gate"], sh["w_up"], sh["w_down"])
    same_route = (torch.sort(r.topi[0], -1).values
                  == torch.sort(ids, -1).values).all(-1)
    tie = gap < MOE_ROUTER_TIE
    err = (out[0].double() - ref).abs()
    ok = err <= MOE_LOOP_TOL[0] + MOE_LOOP_TOL[1] * ref.abs()
    bad = (~ok.all(-1) & ~(~same_route & tie)).nonzero()[:, 0].tolist()
    log(f"  apply_moe (f32, capacity factor "
        f"{f32.moe.capacity_factor:.4g}) on {m} tokens of the first "
        f"layer vs a per-token float64 loop on the card: max |err| "
        f"{float(err.max()):.3g} (atol, rtol {MOE_LOOP_TOL}); tokens routed "
        f"to other experts than the loop's: "
        f"{(~same_route).nonzero()[:, 0].tolist()} (router near-ties, gap "
        f"below {MOE_ROUTER_TIE} relative, among the {m}: "
        f"{tie.nonzero()[:, 0].tolist()})")
    if bad:
        raise AssertionError(f"{arch.name} apply_moe differs from the loop "
                             f"at tokens {bad}")
    del w, out, r, ref
    # (b) capacity and drops, at the serve's dtype and token count
    xb = apply_norm(lp["ln2"], emb[prompts], arch)
    t = xb.shape[0] * xb.shape[1]
    all_dropped = 0
    for factor in (arch.moe.capacity_factor, 0.5, 0.1):
        a = arch.replace(moe=dataclasses.replace(arch.moe,
                                                 capacity_factor=factor))
        cap = ffn.moe_capacity(t, a)
        r = ffn.route(lp["moe"], xb.reshape(1, t, -1), a, cap)
        routed = torch.zeros(a.moe.num_experts, dtype=torch.long,
                             device=dev).scatter_add_(
            0, r.topi.reshape(-1), torch.ones_like(r.topi.reshape(-1)))
        kept = (r.sel_gate[0] > 0).sum(-1)
        dropped = (r.slot[0] < 0).all(-1)
        all_dropped += int(dropped.sum())
        out, _ = ffn.apply_moe(lp["moe"], xb, a)
        out = out.reshape(t, -1)[dropped]
        want = (ffn.apply_mlp(lp["moe"]["shared"], xb.reshape(1, t, -1), a)
                [0][dropped] if "shared" in lp["moe"]
                else torch.zeros_like(out))
        held = torch.equal(kept, torch.clamp(routed, max=cap)) and \
            torch.equal(out, want)
        log(f"  routing at capacity factor {factor} over {t} tokens "
            f"(capacity {cap}): experts keep min(routed, capacity): "
            f"{torch.equal(kept, torch.clamp(routed, max=cap))} (routed "
            f"min {int(routed.min())} max {int(routed.max())}); "
            f"{int((r.slot[0] < 0).sum())} of {r.slot[0].numel()} choices "
            f"dropped, {int(dropped.sum())} tokens dropped by every expert, "
            f"their output equal to "
            f"{'the shared experts' if 'shared' in lp['moe'] else 'zero'}: "
            f"{torch.equal(out, want)}")
        if not held:
            raise AssertionError(f"{arch.name} capacity routing at {factor}")
    if not all_dropped:
        raise AssertionError(f"{arch.name}: no factor dropped a token from "
                             f"every expert; the dropped tokens' output "
                             f"was not checked")
    # (c) determinism of the bf16 prefill
    runs = [model.prefill(params, {"tokens": prompts}) for _ in range(2)]
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(_leaves(runs[0][1]),
                                          _leaves(runs[1][1])))
    log(f"  two bf16 prefills of {tuple(prompts.shape)}: logits and caches "
        f"torch.equal: {same}")
    if not same:
        raise AssertionError(f"{arch.name} prefill is not deterministic")


def greedy_route(dev, arch, model, params, prompts, extras, res):
    """The served greedy tokens against a second route: ``forward`` over
    the prompt and the served tokens (teacher forcing), its argmax at
    each generated position. A position that differs must be a bf16
    near-tie of forward's logits (counted and printed). (The MoE archs
    are held by their consistency check instead: at the published
    capacity factor a whole sequence drops other tokens than per-step
    decode does.)"""
    import torch
    b, s = prompts.shape
    seq = torch.cat([prompts, res.tokens[:, :-1]], 1)
    batch = dict(extras, tokens=seq)
    if "mrope_positions" in extras:
        n = seq.shape[1]
        pos = torch.arange(n, device=dev)[None, None].repeat(3, b, 1)
        pos[:, :, :s] = extras["mrope_positions"]
        batch["mrope_positions"] = pos
    logits, _, _ = model.forward(params, batch)
    logits = logits[:, s - 1:].float()
    differ = logits.argmax(-1) != res.tokens
    ties = near_ties(logits.topk(2, -1).values)
    log(f"  served greedy tokens vs forward over prompt + served tokens "
        f"(bf16): {int(differ.sum())} of {differ.numel()} positions differ, "
        f"{int((differ & ties).sum())} of them at near-ties (near-ties "
        f"among all: {int(ties.sum())})")
    if (differ & ~ties).any():
        raise AssertionError(f"{arch.name} greedy tokens leave forward's "
                             f"argmax away from a near-tie: "
                             f"{(differ & ~ties).nonzero().tolist()}")


# ----------------------------------------------------------- phase 4d --
def lm_training_path(dev, cfg, card, kern, seed):
    """zamba2-1.2b training through ``launch.train`` (full width and
    depth), the kernels' autograd route, the recovery drill, compressed
    steps and the training shapes' kernel rows. Returns the launch counts
    of the counted step, and the step's arch, shape config, micro-batch
    count, parameter count and median seconds (for the fleet phase)."""
    import shutil

    import torch

    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as lt
    from repro_torch.launch.steps import lm_loss
    from repro_torch.models.factory import count_params
    from repro_torch.models.transformer import hybrid_segments
    from repro_torch.train.optimizer import tree_map
    tr = cfg["lm_train"]
    log("== LM training")
    root = ROOT / "build" / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    args = lt.parse_args(
        ["--arch", "zamba2-1.2b", "--steps", str(tr["steps"]),
         "--batch", str(tr["batch"]), "--seq", str(tr["seq"]),
         "--lr", str(tr["lr"]), "--ckpt-dir", str(root / "full"),
         "--ckpt-every", str(tr["steps"] + 1), "--device", dev.type]
        + (["--full"] if tr["full"] else []))
    mem0 = _peak_reset(dev)
    t0 = time.perf_counter()
    st = lt.setup(args, log=lambda m: log(f"  {m}"))
    arch, info, rt, shape = st.cfg, st.info, st.runtime, st.shape
    n_params = count_params(st.params)
    log(f"  {arch.name}: {n_params:,} parameters ({arch.dtype}), "
        f"{arch.n_layers} Mamba-2 layers, remat {st.shape.remat_policy}, "
        f"n_micro {info['n_micro']}; set up in "
        f"{time.perf_counter() - t0:.3f} s")

    # step 0's first sequence (its first micro-batch), before training
    first = {k: torch.as_tensor(v[:1]).to(dev)
             for k, v in st.batches(0).items()}
    with torch.no_grad():
        before = float(lm_loss(st.model.forward(
            tree_map(_whole, st.params), first)[0], first["labels"],
            arch.vocab_size))

    # ---- the main path: the runtime's loop; step COUNTED_STEP's launches
    step_fn, calls, counted = rt.step_fn, [0], {}

    def step(p, o, batch):
        calls[0] += 1
        if calls[0] != COUNTED_STEP + 1:
            return step_fn(p, o, batch)
        ops.reset_launch_counts()
        out = step_fn(p, o, batch)
        counted.update(ops.LAUNCHES, shapes=dict(ops.FLASH_SHAPES))
        return out
    rt.step_fn = step
    params, opt_state, hist = rt.run(st.params, st.opt_state, st.batches,
                                     num_steps=args.steps)
    rt.step_fn = step_fn
    peak = _peak_extra(dev, mem0)
    # the runtime replays a step that raised: on the main path that is a
    # fault (the drill below injects its failures on purpose)
    if rt.recoveries or len(hist) != args.steps:
        raise AssertionError(f"a step of the main run failed: "
                             f"{rt.recoveries} recoveries, {len(hist)} "
                             f"steps logged for {args.steps}")
    passes = sum(1 for _, shared in hybrid_segments(arch) if shared)
    remat = 2 if st.shape.remat_policy != "none" else 1
    expect = {"ssd_scan": info["n_micro"] * arch.n_layers * remat,
              "flash_attention": info["n_micro"] * passes}
    got = {k: counted[k] for k in expect}
    log(f"  launches in step {COUNTED_STEP}: {got} (expected {expect}: "
        f"{info['n_micro']} micro-batches x {arch.n_layers} SSD layers x "
        f"{remat} (the checkpoint's recompute), and {passes} shared-block "
        f"passes, not checkpointed, as in the reference; the backwards "
        f"recompute the plain versions)")
    if dev.type == "cuda" and got != expect:
        raise AssertionError(f"training step launches {got} != {expect}")
    losses = [h["loss"] for h in hist]
    dts = [h["dt"] for h in hist[1:]] or [hist[0]["dt"]]
    mean, median = sum(dts) / len(dts), sorted(dts)[len(dts) // 2]
    tokens = args.batch * args.seq
    log(f"  losses: {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {len(hist)} steps of {args.batch} x {args.seq} tokens: "
        f"{1 / mean:.3f} steps/s, {tokens / mean:.1f} tokens/s, "
        f"{mean * 1e3:.3f} ms/step (median "
        f"{median * 1e3:.3f}; steps 1-{len(hist) - 1}, "
        f"the first {hist[0]['dt'] * 1e3:.3f} ms); model "
        f"{6 * n_params * tokens / mean / 1e12:.2f} TFLOP/s (6 N tokens); "
        f"peak memory {_mb(peak)} above the {_mb(mem0)} held before")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses {losses}: not finite")
    final = root / "full" / f"step_{args.steps}"
    nbytes = sum(f.stat().st_size for f in final.iterdir())
    log(f"  final checkpoint (params, m, v): {nbytes / 1e9:.3f} GB in "
        f"{rt.saves[-1][1]:.3f} s ({nbytes / 1e9 / rt.saves[-1][1]:.3f} "
        f"GB/s, host copy and write)")
    # one more step of the runtime's step function on the next batch,
    # profiled whole (its micro-batches, gradient reduction and AdamW
    # update), its idle share against the run's median step
    if dev.type == "cuda":
        nxt = st.batches(args.steps)
        t1 = time.perf_counter()
        device_profile(lambda: step_fn(params, opt_state, nxt), dev, median,
                       f"training step profile (one whole step: "
                       f"{info['n_micro']} micro-batches and the AdamW "
                       f"update)", cpu_ops=False)
        log(f"  (the profiled step and its reading took "
            f"{time.perf_counter() - t1:.1f} s)")
    # step 0's first micro-batch again, through the trained model: each
    # step is a fresh batch of uniform random tokens, and in 3 steps a
    # token id recurs ~0.2 times, so the per-step losses stay near their
    # start (they are printed, not held); a sequence the model was
    # trained on must have become likelier
    after, grads = micro_grads(st, params, first)
    log(f"  loss of step 0's first sequence: {before:.4f} before "
        f"training, {float(after):.4f} after (must fall by "
        f"{tr['loss_drop']}); the per-step losses on fresh batches moved "
        f"{losses[-1] - losses[0]:+.4f}")
    if not float(after) < before - tr["loss_drop"]:
        raise AssertionError(f"step 0's first sequence: loss {before} -> "
                             f"{float(after)}, not {tr['loss_drop']} lower")
    norms = {k: float(_whole(grads["layers"]["ssm"][k]).float().norm())
             for k in ("a_log", "dt_bias", "w_b", "w_c", "conv_b",
                       "conv_c")}
    log(f"  gradient norms of the SSD-only leaves: "
        f"{', '.join(f'{k} {v:.3g}' for k, v in norms.items())}")
    if not all(v > 0 and math.isfinite(v) for v in norms.values()):
        raise AssertionError(f"an SSD-only leaf has no gradient: {norms}")
    del params, opt_state, grads, st, rt, step_fn
    shutil.rmtree(root / "full")

    small = (get_arch("zamba2-1.2b").replace(n_layers=tr["drill_layers"])
             if tr["full"] else smoke_config("zamba2-1.2b"))
    spent = {"full-depth training": time.perf_counter() - t0}
    for name, part in (
            ("gradient checks", lambda: check_training_grads(
                dev, tr, small, seed)),
            ("recovery drill", lambda: recovery_drill(dev, tr, small, root)),
            ("compressed steps", lambda: compressed_steps(dev, tr, small,
                                                          root)),
            ("kernel rows", lambda: training_kernel_rows(
                dev, cfg, card, kern, arch, counted, seed))):
        t1 = time.perf_counter()
        part()
        spent[name] = time.perf_counter() - t1
    shutil.rmtree(root, ignore_errors=True)
    log(f"  the phase's seconds: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in spent.items())}")
    return ({k: counted[k] for k in ("flash_attention", "ssd_scan")},
            {"cfg": arch, "shape": shape, "n_micro": info["n_micro"],
             "n_params": n_params, "median_s": median})


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def micro_grads(st, params, batch):
    """(loss, gradients) of one micro-batch through ``st``'s model at its
    remat policy, as the train step computes each."""
    import torch

    from repro_torch.launch.steps import lm_loss
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    leaves = [_whole(x).detach().requires_grad_()
              for x in tree_leaves(params)]
    logits, _, _ = st.model.forward(tree_unflatten(params, leaves), batch,
                                    remat_policy=st.shape.remat_policy)
    loss = lm_loss(logits, batch["labels"], st.cfg.vocab_size)
    return loss.detach(), tree_unflatten(
        params, list(torch.autograd.grad(loss, leaves)))


def check_training_grads(dev, tr, small, seed):
    """The kernels' autograd route: ``ssd_scan`` under grad (``_SSD``)
    against ``ssd_scan_ref`` at the training shape, bf16 and f32 (outputs
    within SSD_TOL, gradients equal: the backward is the plain version's);
    then an f32 zamba2 of ``small``'s depth at batch 1 through the kernel
    route on this device against its CPU copy (plain route), leaf by leaf
    within TRAIN_GRAD_TOL of the leaf's largest gradient."""
    import torch

    from repro_torch.data.synthetic import lm_token_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.steps import lm_loss
    from repro_torch.models.factory import build_model
    from repro_torch.train.optimizer import (tree_leaves,
                                             tree_leaves_with_path,
                                             tree_unflatten)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    h, p, n = small.ssm_heads, small.ssm.head_dim, small.ssm.d_state
    s = tr["seq"]
    for dt in (torch.bfloat16, torch.float32):
        def leaf(*shape, scale=1.0, kind=torch.randn, dtype=dt):
            x = kind(shape, generator=gen, device=dev) * scale
            return x.to(dtype).requires_grad_()
        x = leaf(1, s, h, p, scale=0.5)
        dtv = leaf(1, s, h, scale=0.1, kind=torch.rand, dtype=torch.float32)
        a = (-torch.rand((h,), generator=gen, device=dev) * 2
             ).requires_grad_()
        bm, cm = leaf(1, s, n, scale=0.3), leaf(1, s, n, scale=0.3)
        args = (x, dtv, a, bm, cm)
        wy = torch.randn((1, s, h, p), generator=gen, device=dev)
        wf = torch.randn((1, h, p, n), generator=gen, device=dev)
        ops.reset_launch_counts()
        y, fin = ssd_scan(*args, chunk=small.ssm.chunk_size)
        launched = ops.LAUNCHES["ssd_scan"]
        got = torch.autograd.grad((y * wy).sum() + (fin * wf).sum(), args)
        yr, fr = ssd_scan_ref(*args, chunk=small.ssm.chunk_size)
        want = torch.autograd.grad((yr * wy).sum() + (fr * wf).sum(), args)
        ey, oky = _close(y.detach(), yr.detach(), *SSD_TOL)
        ef, okf = _close(fin.detach(), fr.detach(), *SSD_TOL)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        route = type(y.grad_fn).__name__
        log(f"  ssd_scan under autograd, x (1,{s},{h},{p}) {dt}, N {n}: "
            f"{route}, {launched} launch; max |err| y {ey:.3g}, final "
            f"state {ef:.3g} (tol {SSD_TOL}); gradients of x, dt, a, B, C "
            f"equal the plain version's: {same}")
        if not (oky and okf and same) or (dev.type == "cuda" and (
                launched != 1 or "SSD" not in route)):
            raise AssertionError(f"ssd_scan's autograd route ({dt})")

    f32 = small.replace(dtype="float32")
    model = build_model(f32)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 12),
                        device=dev)
    batch = next(lm_token_batches(f32.vocab_size, 1, tr["grad_seq"], 1,
                                  seed=seed))

    def grads(device, ps):
        leaves = [t.detach().to(device).requires_grad_()
                  for t in tree_leaves(ps)]
        p = tree_unflatten(ps, leaves)
        bt = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        logits, _, _ = model.forward(p, bt, remat_policy="full")
        return torch.autograd.grad(lm_loss(logits, bt["labels"],
                                           f32.vocab_size), leaves)
    t0 = time.perf_counter()
    on_dev = grads(dev, params)
    _sync(dev)
    t1 = time.perf_counter()
    on_cpu = grads(torch.device("cpu"), params)
    t2 = time.perf_counter()
    names = ["/" + "/".join(p) for p, _ in tree_leaves_with_path(params)]
    worst = (0.0, "")
    for name, g, w in zip(names, on_dev, on_cpu):
        scale = float(w.abs().max())
        rel = float((g.cpu() - w).abs().max()) / max(scale, 1e-30)
        if rel > worst[0]:
            worst = (rel, name)
        if not math.isfinite(rel) or rel > TRAIN_GRAD_TOL:
            raise AssertionError(f"gradient of {name}: {rel:.3g} of its "
                                 f"largest entry")
    log(f"  zamba2 f32 at {f32.n_layers} layers, 1 x {tr['grad_seq']} "
        f"tokens, remat full: gradients on {dev.type} (kernels) vs its "
        f"CPU copy (plain versions), {len(names)} leaves: worst "
        f"{worst[0]:.3g} of the leaf's largest |g| ({worst[1]}; tol "
        f"{TRAIN_GRAD_TOL}); {t1 - t0:.3f} s on {dev.type}, {t2 - t1:.3f} s "
        f"on the CPU ({torch.get_num_threads()} threads)")


def recovery_drill(dev, tr, small, root):
    """``small`` (zamba2 at full width, depth cut) trained twice through
    ``launch.train``: uninterrupted, then with failures injected and its
    checkpoints written by ``AsyncSaver``; under deterministic algorithms
    the two end ``torch.equal``, and the checkpoint ``AsyncSaver`` wrote
    before the last equals run a's byte for byte. Then a leaf changed in
    place right after ``AsyncSaver.save`` returns restores as it was."""
    import torch

    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.runtime import RuntimeConfig, TrainRuntime

    def run(name, fail, async_save):
        args = lt.parse_args(
            ["--arch", "zamba2-1.2b", "--steps", str(tr["drill_steps"]),
             "--batch", str(tr["drill_batch"]), "--seq", str(tr["seq"]),
             "--lr", str(tr["lr"]), "--ckpt-dir", str(root / name),
             "--ckpt-every", str(tr["every"]), "--device", dev.type])
        st = lt.setup(args, cfg=small, log=lambda _: None)
        rt = TrainRuntime(st.runtime.step_fn, RuntimeConfig(
            str(root / name), ckpt_every=tr["every"], async_save=async_save),
            mesh=st.mesh, log=lambda m: log(f"    {m}"))
        rt.inject_failure_at = set(fail)
        t0 = time.perf_counter()
        p, o, hist = rt.run(st.params, st.opt_state, st.batches,
                            num_steps=args.steps)
        wall = time.perf_counter() - t0
        if not fail and (rt.recoveries or len(hist) != args.steps):
            raise AssertionError(f"drill {name}, with no failure injected, "
                                 f"recovered {rt.recoveries} times")
        save_s = sum(s for _, s in rt.saves)
        log(f"  drill {name}: {len(hist)} steps run for {args.steps}, "
            f"failures at {sorted(fail)}, recoveries {rt.recoveries}, "
            f"{len(rt.saves)} saves "
            f"({'AsyncSaver' if async_save else 'save'}; {save_s:.3f} s on "
            f"the caller), {wall:.3f} s; last loss {hist[-1]['loss']:.4f}")
        return p, o, rt, st.mesh

    torch.use_deterministic_algorithms(True)
    try:
        pa, oa, _, _ = run("a", (), False)
        pb, ob, rtb, mesh = run("b", tr["fail_at"], True)
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(_whole(x), _whole(y)) for x, y in zip(
        tree_leaves((pa, oa)), tree_leaves((pb, ob))))
    step = ck.latest_step(root / "b")
    nbytes = sum(f.stat().st_size for f in (root / "b" / f"step_{step}")
                 .iterdir())
    log(f"  {small.name} at {small.n_layers} layers, deterministic "
        f"algorithms: recoveries {rtb.recoveries}; params and optimizer "
        f"state torch.equal to the uninterrupted run's: {same} "
        f"(a checkpoint {nbytes / 1e9:.3f} GB)")
    if rtb.recoveries != len(tr["fail_at"]) or not same:
        raise AssertionError("the recovery drill did not replay exactly")
    del pa, oa
    # run b's checkpoint before its last was written behind the loop by
    # AsyncSaver: the same bytes as run a's synchronous one
    import filecmp
    steps = sorted(int(d.name.split("_")[1]) for d in (root / "b").glob(
        "step_*"))[-2:-1]
    same = bool(steps) and all(
        (root / "a" / f"step_{k}" / "manifest.json").read_text()
        == (root / "b" / f"step_{k}" / "manifest.json").read_text()
        and all(filecmp.cmp(f, root / "a" / f"step_{k}" / f.name,
                            shallow=False)
                for f in (root / "b" / f"step_{k}").glob("*.npy"))
        for k in steps)
    log(f"  AsyncSaver's checkpoint of step {steps} (run b) byte for byte "
        f"the synchronous one of run a: {same}")
    # the host copy is made before save returns: a leaf changed in place
    # right after it is saved as it was
    saver = ck.AsyncSaver()
    probe = _whole(tree_leaves(pb)[0]).detach().clone()
    before = probe.clone()
    saver.save(root / "async", 1, {"probe": probe}, mesh=mesh)
    probe.add_(1.0)
    saver.wait()
    back = ck.restore(root / "async", 1, {"probe": before}, device=dev)
    kept = torch.equal(back["probe"], before)
    log(f"  AsyncSaver: a leaf changed in place right after save returned "
        f"restores as it was at save: {kept}")
    if not (same and kept):
        raise AssertionError("AsyncSaver's checkpoints")


def compressed_steps(dev, tr, small, root):
    """One step each with ``topk_compressor(0.05)`` and ``int8_compressor``
    through ``launch.train --compress``: error feedback holds on the
    step's reduced gradients (decompressed + new residual == gradient +
    old residual, within two f32 roundings of the leaf's largest entry),
    and each step's time."""
    import torch

    from repro_torch.launch import train as lt
    from repro_torch.train.compression import (int8_compressor,
                                               topk_compressor)
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.runtime import block_until_ready
    for name, comp in (("topk", topk_compressor(0.05)),
                       ("int8", int8_compressor())):
        args = lt.parse_args(
            ["--arch", "zamba2-1.2b", "--steps", "1", "--batch",
             str(tr["drill_batch"]), "--seq", str(tr["seq"]), "--compress",
             name, "--ckpt-dir", str(root / f"c_{name}"), "--device",
             dev.type])
        st = lt.setup(args, cfg=small, log=lambda _: None)
        batch = st.batches(0)
        _, g = st.info["grads"](st.params, batch)
        g = tree_map(_whole, g)
        r0 = tree_map(lambda x: torch.randn_like(x) * 1e-4, g)
        dec, res, stats = comp.apply(g, r0)
        worst = 0.0
        for d, r, gg, rr in zip(*(tree_leaves(t) for t in (dec, res, g,
                                                            r0))):
            want = gg.float() + rr
            err = float((d + r - want).abs().max())
            lim = 2 * torch.finfo(torch.float32).eps * float(
                want.abs().max())
            worst = max(worst, err / max(lim, 1e-30))
            if err > lim:
                raise AssertionError(f"{name}: error feedback lost {err}")
        step_fn = st.runtime.step_fn
        out = step_fn(st.params, st.opt_state, batch)     # warm
        block_until_ready(out[2])
        t0 = time.perf_counter()
        out = step_fn(st.params, st.opt_state, batch)
        block_until_ready(out[2])
        dt = time.perf_counter() - t0
        if not math.isfinite(float(out[2]["loss"])):
            raise AssertionError(f"{name}: compressed step loss")
        log(f"  compressed step ({name}, ratio {stats['ratio']}): "
            f"{dt * 1e3:.3f} ms, loss {float(out[2]['loss']):.4f}; error "
            f"feedback within {worst:.3g} of two f32 roundings")


def training_kernel_rows(dev, cfg, card, kern, arch, counted, seed):
    """The training step's kernel shapes as rows of the kernels line:
    flash (1, H, S, D) bf16 causal on the model's views beside SDPA, and
    ssd_scan x (1, S, H, P) bf16; each against its plain version, with its
    launches in the counted step."""
    import torch
    tr, it = cfg["lm_train"], cfg["iters"]
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    s = tr["seq"]
    path = (1, arch.n_heads, s, arch.head_dim)
    n = counted["shapes"].get(path[:3] + (s,) + path[3:] + (True,), 0)
    flash_row(dev, card, kern, it, gen, path, "training", "zamba2-1.2b "
              "training micro-batch", n)
    if dev.type == "cuda" and n != counted["flash_attention"]:
        raise AssertionError(f"training flash launches at {path}: {n} of "
                             f"{counted['flash_attention']}")
    ssd_row(dev, card, kern, it, gen, (1, s, arch.ssm_heads,
                                       arch.ssm.head_dim),
            arch.ssm.d_state, arch.ssm.chunk_size, "zamba2-1.2b training "
            "micro-batch", counted["ssd_scan"])


def flash_row(dev, card, kern, it, gen, path, role, note, n, t=None,
              causal=True):
    """flash_attention at q ``path`` (B, H, S, D) and k, v (B, H, T, D)
    bf16 (T: S by default), causal or not, on the (B,S,H,D).transpose(1,
    2) views a model passes: held against the plain version widened to
    f32 (FLASH_BF16_TOL), timed beside SDPA on the same views and the
    plain version, with its bound; appended to ``kern``'s flash
    ``other_shapes`` with ``n`` launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, s, d = path
    t = s if t is None else t
    q, k, v = ((torch.randn((b, sl, h, d), generator=gen, device=dev) * 0.5
                ).to(torch.bfloat16).transpose(1, 2) for sl in (s, t, t))
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal)
    err, ok = _close(flash_attention(q, k, v, causal=causal), want,
                     *FLASH_BF16_TOL)
    if not ok:
        raise AssertionError(f"flash_attention {path} T {t}: {err}")
    kind = "causal" if causal else "not causal"
    shape = (f"q,k,v {path}" if t == s else
             f"q {path}, k/v {(b, h, t, d)}") + f" bf16 {kind}"
    tm = alternating(
        f"flash_attention {shape} on (B,S,H,D) views",
        (("kernel", lambda: flash_attention(q, k, v, causal=causal)),
         ("sdpa", lambda: F.scaled_dot_product_attention(
             q, k, v, is_causal=causal))),
        dev, it)
    pairs = s * (s + 1) / 2 if causal else s * t
    t_ops = 4.0 * b * h * d * pairs / card["bf16"]
    t_mem = 2.0 * b * h * d * 2 * (s + t) / card["bw"]
    fl = dict(ms=tm["kernel"]["ms"][0], library_ms=tm["sdpa"]["ms"][0],
              device_ms=tm["kernel"]["device_ms"][0],
              library_device_ms=tm["sdpa"]["device_ms"][0],
              plain_ms=time_ms(lambda: flash_attention_ref(
                  q, k, v, causal=causal), dev, it),
              bound_ms=max(t_ops, t_mem) * 1e3,
              bound_by="operations" if t_ops > t_mem else "bytes",
              launches=n, max_abs_err=err,
              shape=f"{shape}, (B,S,H,D).transpose(1, 2) views ({note}, "
                    f"{n} launches)")
    log(f"  flash_attention {shape} ({role}): max |err| "
        f"{err:.3g}; kernel {fl['ms']:.4f} ms, plain {fl['plain_ms']:.4f} "
        f"ms, sdpa {fl['library_ms']:.4f} ms (CUDA events); device time "
        f"kernel {_ms(fl['device_ms'])} ms, sdpa "
        f"{_ms(fl['library_device_ms'])} ms; bound {fl['bound_ms']:.4f} ms "
        f"({fl['bound_by']}); {n} launches ({note})")
    kern["flash_attention"]["max_abs_err"] = max(
        kern["flash_attention"]["max_abs_err"], err)
    kern["flash_attention"].setdefault("other_shapes", []).append(fl)


def ssd_row(dev, card, kern, it, gen, xshape, nn, chunk, note, n):
    """ssd_scan at x ``xshape`` (B, S, H, P) bf16, state width ``nn``:
    held against the plain version (SSD_TOL), timed beside it, with its
    bound; appended to ``kern``'s SSD ``other_shapes`` with ``n``
    launches."""
    import torch

    from repro_torch.kernels.bindings import ssd_heads_per_block
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, s, hh, p = xshape
    args = ((torch.randn((b, s, hh, p), generator=gen, device=dev) * 0.5
             ).to(torch.bfloat16),
            torch.rand((b, s, hh), generator=gen, device=dev) * 0.1,
            -torch.rand((hh,), generator=gen, device=dev) * 2,
            (torch.randn((b, s, nn), generator=gen, device=dev) * 0.3
             ).to(torch.bfloat16),
            (torch.randn((b, s, nn), generator=gen, device=dev) * 0.3
             ).to(torch.bfloat16))
    (y, fin), (yr, fr) = (ssd_scan(*args, chunk=chunk),
                          ssd_scan_ref(*args, chunk=chunk))
    ey, oky = _close(y, yr, *SSD_TOL)
    ef, okf = _close(fin, fr, *SSD_TOL)
    if not (oky and okf):
        raise AssertionError(f"ssd_scan {xshape}: {ey}, {ef}")
    t_ops = 4.0 * b * s * hh * p * nn / card["bf16"]
    nbytes = b * (s * hh * p * 2 + s * hh * 4 + 2 * s * nn * 2
                  + s * hh * p * 4 + hh * p * nn * 4) + hh * 4
    t_mem = nbytes / card["bw"]
    row = dict(ms=time_ms(lambda: ssd_scan(*args, chunk=chunk), dev, it),
               device_ms=device_ms(lambda: ssd_scan(*args, chunk=chunk),
                                   dev, it),
               plain_ms=time_ms(lambda: ssd_scan_ref(*args, chunk=chunk),
                                dev, it),
               bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops > t_mem else "bytes",
               library_ms=None, launches=n, max_abs_err=max(ey, ef),
               shape=f"x ({b},{s},{hh},{p}) bf16, N {nn}, chunk {chunk}, "
                     f"{ssd_heads_per_block(b, hh, p, nn)} heads a block "
                     f"({note}, {n} launches)")
    log(f"  ssd_scan {row['shape']}: max |err| y {ey:.3g}, final {ef:.3g}; "
        f"kernel {row['ms']:.4f} ms (device {_ms(row['device_ms'])}), plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); no single PyTorch call computes it")
    kern["ssd_scan"]["max_abs_err"] = max(kern["ssd_scan"]["max_abs_err"],
                                          ey, ef)
    kern["ssd_scan"].setdefault("other_shapes", []).append(row)


# ----------------------------------------------------------- phase 4e --
def fleet_tooling(dev, cfg, card, train):
    """The fleet tooling: ``launch/hw``'s peaks for this card, the
    ``costing`` FLOPs and bytes of the training phase's step against its
    median time, one dry-run cell through the CLI, and ``pipeline_forward``
    on two ranks where the machine has two cards (NCCL, one card a rank;
    gloo ranks on the CPU in the rehearsal)."""
    from repro_torch.launch import hw
    fl = cfg["fleet"]
    log("== fleet tooling")
    if dev.type == "cuda":
        row = hw.peaks(card["name"])
        log(f"  launch/hw peaks for {card['name']!r} (row {row.part!r}): "
            f"HBM {row.hbm_bw / 1e12:.2f} TB/s, f32 FFMA "
            f"{row.f32_flops / 1e12:.0f} TFLOP/s, bf16 tensor cores "
            f"{row.bf16_flops / 1e12:.0f} TFLOP/s; NVLink 4 (SXM) "
            f"{hw.NVLINK_BW / 1e9:.0f} GB/s a GPU; the card: {card['smi']}")
    else:
        row = hw.SXM
        log(f"  launch/hw: no card in the rehearsal; the {row.part!r} row")
    step_costs(train, row)
    dryrun_cell(fl)
    pipeline_check(dev, fl["pipe"])


def step_costs(train, row):
    """``costing``'s FLOPs of the training phase's step, counted on CPU
    fake tensors (the kernels' plain versions: no mesh, no card): one
    micro-batch's forward, recompute and backward, as ``make_train_step``'s
    ``grads`` runs each, times the micro-batches, plus AdamW's update;
    ``analytic_bytes`` of the step; both against its median time."""
    import torch
    from torch._subclasses.fake_tensor import (FakeTensorMode,
                                               unset_fake_temporarily)

    from repro_torch.launch import costing, steps
    from repro_torch.models.factory import build_model
    from repro_torch.train.optimizer import (adamw, tree_leaves, tree_map,
                                             tree_unflatten)
    arch, shape, n_micro = train["cfg"], train["shape"], train["n_micro"]
    rows = shape.global_batch // n_micro
    model = build_model(arch)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype),
                          steps.abstract_params(model))
        micro = {k: torch.zeros((rows, shape.seq_len), dtype=torch.int32)
                 for k in ("tokens", "labels")}

        def grads():
            leaves = [x.requires_grad_() for x in tree_leaves(params)]
            logits, _, _ = model.forward(tree_unflatten(params, leaves),
                                         micro,
                                         remat_policy=shape.remat_policy)
            loss = steps.lm_loss(logits, micro["labels"], arch.vocab_size)
            return list(torch.autograd.grad(loss, leaves,
                                            materialize_grads=True))
        g, c_micro = costing.count_ops(grads)
        opt = adamw(1e-4)
        state = opt.init(params)
        with unset_fake_temporarily():
            state["count"] = torch.zeros((), dtype=torch.int32)
        _, c_opt = costing.count_ops(opt.update, tree_unflatten(params, g),
                                     state, params)
    t_count = time.perf_counter() - t0
    total = n_micro * c_micro.flops + c_opt.flops
    matmul = n_micro * c_micro.matmul_flops
    tokens = shape.global_batch * shape.seq_len
    six_nd = 6.0 * train["n_params"] * tokens
    log(f"  costing, {arch.name} train step ({n_micro} micro-batches of "
        f"{rows} x {shape.seq_len}, remat {shape.remat_policy!r}, "
        f"{arch.dtype}; counted on CPU fake tensors in {t_count:.1f} s): "
        f"a micro-batch {c_micro.flops:.4e} FLOPs (forward, recompute, "
        f"backward), x {n_micro} + AdamW {c_opt.flops:.4e} = {total:.4e} "
        f"FLOPs; matmul-class {matmul:.4e}, {100 * matmul / total:.1f}%; "
        f"6 N D = {six_nd:.4e} ({total / six_nd:.3f}x of it counted)")
    mem = costing.analytic_bytes("train", arch, shape, train["n_params"],
                                 n_micro, 0.0, 1)
    log(f"  analytic_bytes('train'): {mem.total:.4e} bytes ("
        + ", ".join(f"{k} {v:.3e}" for k, v in mem.breakdown.items()) + ")")
    med = train["median_s"]
    t_flops, t_bytes = total / row.bf16_flops, mem.total / row.hbm_bw
    bound = max(t_flops, t_bytes)
    log(f"  the training phase's median step {med * 1e3:.3f} ms: achieved "
        f"{total / med / 1e12:.3f} TFLOP/s counted ({six_nd / med / 1e12:.3f}"
        f" by 6 N D); roofline bound max({t_flops * 1e3:.3f} ms of FLOPs at "
        f"{row.bf16_flops / 1e12:.0f} TFLOP/s bf16, {t_bytes * 1e3:.3f} ms "
        f"of bytes at {row.hbm_bw / 1e12:.2f} TB/s) = {bound * 1e3:.3f} ms "
        f"({'operations' if t_flops >= t_bytes else 'bytes'}); share of the "
        f"bound reached {bound / med:.4f}")
    if not (total > matmul > 0 and mem.total > 0 and math.isfinite(med)):
        raise AssertionError(f"step costs: {total} FLOPs, {matmul} matmul, "
                             f"{mem.total} bytes, median {med}")


def dryrun_cell(fl):
    """One cell of the dry-run CLI, a process of its own (256 fake ranks
    on the CPU); a nonzero exit fails the run."""
    arch, shape = fl["dryrun"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--timeout",
         str(fl["timeout"])], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=fl["timeout"])
    if out.returncode != 0:
        raise AssertionError(f"dryrun {arch} x {shape}: exit "
                             f"{out.returncode}\n{out.stderr[-3000:]}")
    path = Path(out.stdout.strip().splitlines()[-1].split("artifact: ")[1])
    res = json.loads(path.read_text())
    terms = res["roofline_terms_s"]
    log(f"  dryrun {arch} x {shape} x single ({res['chips']} fake ranks) "
        f"in {time.perf_counter() - t0:.1f} s (set-up "
        f"{res['seconds']['setup']} s, counted run "
        f"{res['seconds']['count']} s): "
        + ", ".join(f"{k} {v:.4e}" for k, v in terms.items())
        + f"; dominant {res['dominant']}; useful_flops_ratio "
        f"{res['useful_flops_ratio']:.4f}; a roofline on launch/hw's "
        f"{res['hardware']['part']} figures, not a measurement; JSON "
        f"{path.relative_to(ROOT)}")
    if res["status"] != "ok" or not all(
            math.isfinite(v) and v > 0 for v in terms.values()):
        raise AssertionError(f"dryrun cell: {res}")


def _pipeline_stage(w, h):
    import torch
    return torch.tanh(h @ w)


def _pipeline_rank(rank, port, backend, pipe, out_dir):
    """One rank of ``pipeline_check``'s two (its stage on card ``rank``
    under NCCL, or on the CPU under gloo)."""
    sys.path.insert(0, str(SRC))
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train.pipeline_parallel import pipeline_forward
    dev = "cuda" if backend == "nccl" else "cpu"
    if dev == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_mesh_compat((2,), ("pod",), device=dev)
        d = torch.device(dev, rank) if dev == "cuda" else torch.device(dev)
        g = torch.Generator().manual_seed(0)
        w = (torch.randn(2, pipe["d"], pipe["d"], generator=g)
             / pipe["d"] ** 0.5).to(d)
        x = torch.randn(pipe["n_micro"], pipe["mb"], pipe["d"],
                        generator=g).to(d)
        pipeline_forward(_pipeline_stage, w, x, mesh=mesh)   # warm
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_forward(_pipeline_stage, w, x, mesh=mesh)
        if dev == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        stack = torch.stack([_pipeline_stage(w[1], _pipeline_stage(w[0], xi))
                             for xi in x])
        res = {"rank": rank, "ms": ms, "equal": bool(torch.equal(out, stack)),
               "max_abs": float((out - stack).abs().max())}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def pipeline_check(dev, pipe):
    """``pipeline_forward`` on two ranks against the stack run without a
    pipeline. NCCL refuses two ranks on one card, so on a machine with
    one card this prints that it did not run (tests/
    test_torch_fleet_pipeline.py holds it on four gloo ranks)."""
    import shutil
    import socket

    import torch
    import torch.multiprocessing as mp
    if dev.type == "cuda" and torch.cuda.device_count() < 2:
        log(f"  pipeline_forward: not run on the card: NCCL refuses two "
            f"ranks on one card and this machine has "
            f"{torch.cuda.device_count()}; tests/test_torch_fleet_pipeline"
            f".py holds it on four gloo ranks on the CPU")
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    out_dir = ROOT / "build" / "pipeline"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(_pipeline_rank,
                             args=(port, backend, pipe, str(out_dir)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.perf_counter() + pipe["timeout"]
    while not ctx.join(timeout=1):
        if time.perf_counter() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"pipeline_forward: the two ranks did not "
                                 f"finish in {pipe['timeout']} s")
    res = [json.loads((out_dir / f"rank{r}.json").read_text())
           for r in range(2)]
    shutil.rmtree(out_dir)
    log(f"  pipeline_forward, 2 {backend} ranks (stage a rank), "
        f"{pipe['n_micro']} micro-batches of ({pipe['mb']}, {pipe['d']}) "
        f"f32, tanh(h @ w) a stage, in {time.perf_counter() - t0:.1f} s: "
        + "; ".join(f"rank {r['rank']} {r['ms']:.3f} ms, torch.equal to "
                    f"the stack: {r['equal']} (max |diff| {r['max_abs']:.3g})"
                    for r in res))
    if not all(r["max_abs"] <= 1e-6 for r in res):
        raise AssertionError(f"pipeline_forward vs the stack: {res}")


# ----------------------------------------------------------- phase 4f --
def tensor_parallel_path(dev, cfg, card, kern, seed):
    """The steps of ``launch/steps`` on a (data 1, model 2) mesh: two
    ranks on the one card (gloo: NCCL refuses two ranks on one card; the
    collectives' CUDA tensors stage through the host), each computing its
    'model' shard (``tp_check``), then each per-rank kernel shape
    held against its plain version and timed. Returns the kernels'
    launches on both ranks."""
    import torch

    tp = cfg["tp"]
    log("== tensor parallel")
    res = tp_check(dev, tp, "gloo", seed)
    counts = {k: sum(part["launches"][k] for r in res
                     for part in r["serve"] + r["train"])
              for k in ("flash_attention", "ssd_scan")}
    # each served model's per-rank shapes (the train steps' are f32: the
    # kernels' FFMA paths, held by the earlier phases), both ranks' launches
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    for i, (name, *_) in enumerate(tp["serve"]):
        parts = [r["serve"][i] for r in res]
        note = f"{name} prefill on a rank of (1, {tp['model']})"
        for b, h, s, t, d, causal, _ in parts[0]["expect"]["flash_shapes"]:
            n = sum(dict((tuple(k), c) for k, c in p["flash_shapes"]).get(
                (b, h, s, t, d, causal), 0) for p in parts)
            flash_row(dev, card, kern, cfg["iters"], gen, (b, h, s, d),
                      "tensor-parallel rank", note, n, t=t, causal=causal)
        for b, s, h, pp, nn, _ in parts[0]["expect"]["ssd_shapes"]:
            n = sum(dict((tuple(k), c) for k, c in p["ssd_shapes"]).get(
                (b, s, h, pp, nn), 0) for p in parts)
            ssd_row(dev, card, kern, cfg["iters"], gen, (b, s, h, pp), nn,
                    parts[0]["chunk"], note, n)
    return counts


def tp_check(dev, tp, backend, seed):
    """``tp["model"]`` ranks on a (1, n) mesh (``_tp_rank``), joined by
    ``tp_join``: the ranks' run, printed and held."""
    return tp_join(ranks_spawn(dev, _tp_rank, tp["model"], "tensor_parallel",
                               tp, backend, seed))


def ranks_spawn(dev, fn, world, name, part, backend, seed):
    """Start ``world`` processes ``fn(rank, port, backend, device, part,
    seed, out_dir)`` (gloo ranks on one card, or on the CPU in the
    rehearsal, or NCCL ranks, one card each), each writing its results
    under ``build/<name>``; returns the handle ``ranks_wait`` takes."""
    import shutil
    import socket

    import torch
    import torch.multiprocessing as mp
    if dev.type == "cuda":
        torch.cuda.empty_cache()     # the earlier phases' cached blocks
    out_dir = ROOT / "build" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(fn, args=(port, backend, dev.type, part, seed,
                                       str(out_dir)),
                             nprocs=world, join=False, start_method="spawn")
    _LIVE_RANKS.append(ctx)
    return dict(ctx=ctx, dev=dev, part=part, backend=backend,
                out_dir=out_dir, name=name, world=world,
                t0=time.perf_counter(), t_done=None)


_LIVE_RANKS = []    # every rank group started: stopped if the run fails


def ranks_wait(h):
    """Wait for ``ranks_spawn``'s processes to exit (at most
    ``part["timeout"]`` s from their start; a rank's failure raises);
    returns the seconds from their start to their end."""
    if h["t_done"] is None:
        deadline = h["t0"] + h["part"]["timeout"]
        while not h["ctx"].join(timeout=1):
            if time.perf_counter() > deadline:
                ranks_stop()
                raise AssertionError(
                    f"{h['name']}: the {h['world']} ranks did not finish "
                    f"in {h['part']['timeout']} s")
        h["t_done"] = time.perf_counter()
    return h["t_done"] - h["t0"]


def ranks_stop():
    """Kill the processes of every rank group still running."""
    for ctx in _LIVE_RANKS:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


def _where(dev, backend, what):
    return (f"one card, gloo: {what} CUDA tensors stage through the host"
            if backend == "gloo" and dev.type == "cuda" else
            f"{backend}, one card a rank" if dev.type == "cuda" else
            "gloo on the CPU (rehearsal)")


def tp_join(h):
    """Wait for ``tp_check``'s ranks (at most ``tp["timeout"]`` s from
    their start), print each rank's lines and hold what they found;
    returns their results."""
    import shutil
    dev, tp, backend, out_dir = (h[k] for k in (
        "dev", "part", "backend", "out_dir"))
    n = tp["model"]
    secs = ranks_wait(h)
    res = [json.loads((out_dir / f"rank{r}.json").read_text())
           for r in range(n)]
    shutil.rmtree(out_dir)
    where = _where(dev, backend, "the all-reduces'")
    log(f"  {n} ranks on a (data 1, model {n}) mesh ({where}) in "
        f"{secs:.1f} s; correctness runs, not speed")
    for r in res:
        log(f"  rank {r['rank']} collectives on {r['device']} tensors: "
            + ", ".join(f"{k} {v}" for k, v in r["probe"].items()))
        if r["probe"]["all-reduce sum"] is not True or \
                r["probe"]["all-reduce max"] is not True:
            raise AssertionError(f"rank {r['rank']}: {r['probe']}")
    for cut in tp["cuts"]:
        log(f"  cut: {cut}")
    for i, spec in enumerate(tp["serve"]):
        _tp_serve_lines(dev, tp, [r["serve"][i] for r in res])
    for i, spec in enumerate(tp["train"]):
        _tp_train_lines(dev, tp, [r["train"][i] for r in res])
    return res


def _tp_serve_lines(dev, tp, parts):
    """Print and hold one served model's results on every rank."""
    p0 = parts[0]
    log(f"  {p0['name']} ({p0['cut']}): {p0['batch']} prompts x "
        f"{p0['prompt']} tokens + {p0['gen']} greedy steps, "
        f"tensor_parallel={p0['tensor_parallel']}")
    for p in parts:
        log(f"    rank {p['rank']}: parameters {_mb(p['local_bytes'])} of "
            f"the one-rank path's {_mb(p['whole_bytes'])} "
            f"({p['local_bytes'] / p['whole_bytes']:.3f}; {p['replicated']} "
            f"of {p['leaves']} leaves replicated, "
            f"{_mb(p['replicated_bytes'])}); bf16 peak {_mb(p['peak'])}; "
            f"prefill {p['prefill_ms']:.1f} ms, decode {p['decode_ms']:.1f} "
            f"ms/step; launches {p['launches']}, flash {p['flash_shapes']}, "
            f"ssd {p['ssd_shapes']}")
    if "routing" in p0:
        _tp_routing_lines(p0["name"], parts)
    for dt, c in p0["vs_one_rank"].items():
        tol = TP_LOGIT_TOL if dt == "bfloat16" else CONSIST_TOL
        log(f"    {dt} against the one-rank path on rank 0's card (prefill "
            f"{c['one_prefill_ms']:.1f} ms, decode {c['one_decode_ms']:.1f} "
            f"ms/step): prefill logits max |diff| {c['logit_diff']:.4g} of "
            f"max |logit| {c['logit_max']:.4g} ({c['logit_rel']:.4g}, tol "
            f"{tol:.4g}); greedy tokens equal in {c['rows_equal']} of "
            f"{p0['batch']} rows ({c['steps']} steps), {c['tie_rows']} "
            f"first differ at a bf16 "
            f"near-tie, {c['other_rows']} elsewhere (row, step, the "
            f"one-rank path's top-two gap: {c['firsts']}); "
            f"{c['near_ties']} near-ties among its "
            f"{p0['batch'] * (c['steps'] + 1)} tokens"
            + ("" if not c["routes"] else
               f"; routing against it over {c['routes']['calls']} calls "
               f"(the prefill's layers, then each step's): "
               f"{c['routes']['tokens']} of {c['routes']['choices']} "
               f"choices' tokens route to other experts; rows where that "
               f"first happens (row: call, layer, the one-rank path's "
               f"router gap there): {_rows_text(c['routes']['rows'])}; "
               f"prefill logits held on {c['logit_rows']} of "
               f"{p0['batch']} rows; {c['router_rows']} rows' tokens "
               f"first differ after a router near-tie (under "
               f"{MOE_ROUTER_TIE:g})"))
        if c["logit_rel"] > tol or (dt == "float32" and (
                c["other_rows"] or c["bad_route_rows"])):
            raise AssertionError(f"tensor-parallel {p0['name']} {dt}: {c}")
    if dev.type == "cuda":
        for p in parts:
            want = p["expect"]
            if p["launches"] != want["launches"] or \
                    [list(k) + [n] for k, n in p["flash_shapes"]] \
                    != want["flash_shapes"] or \
                    [list(k) + [n] for k, n in p["ssd_shapes"]] \
                    != want["ssd_shapes"]:
                raise AssertionError(f"rank {p['rank']} {p['name']} "
                                     f"launches: {p} != {want}")


def _rows_text(rows) -> str:
    """``_route_diffs``'s rows, in row order, gaps to 3 digits."""
    return "{" + ", ".join(f"{r}: ({v[0]}, {v[1]}, {v[2]:.3g})" for r, v in
                           sorted(rows.items(), key=lambda kv: int(kv[0])))\
        + "}"


def _tp_routing_lines(name, parts):
    """Print and hold the MoE routing on every rank: the same hashes on
    every rank and on the one-rank path, tokens dropped at the default
    capacity factor, the output within MOE_TP_TOL."""
    r0 = parts[0]["routing"]
    ranks = [p["routing"]["hash"] for p in parts]
    warm = [p["routing"]["warmup"] for p in parts]
    log(f"    routing at capacity factor {r0['factor']} (apply_moe on the "
        f"first layer's experts, {r0['tokens']} tokens, one input on every "
        f"rank): hashes of top-k, kept tokens and slots {ranks}, the "
        f"one-rank path's {r0['one_hash']}; equal: "
        f"{len(set(ranks + [r0['one_hash']])) == 1}; {r0['dropped']} of "
        f"{r0['choices']} choices dropped; output max |diff| "
        f"{r0['out_diff']:.4g} of max |out| {r0['out_max']:.4g} "
        f"({r0['out_rel']:.4g}, tol {MOE_TP_TOL:.4g}); the served warm-up "
        f"prefill's {len(warm[0])} layers' routings equal on every rank: "
        f"{all(w == warm[0] for w in warm)}, choices dropped there "
        f"{[p['routing']['served_dropped'] for p in parts]}")
    if len(set(ranks + [r0["one_hash"]])) != 1 or r0["dropped"] == 0 or \
            r0["out_rel"] > MOE_TP_TOL or any(w != warm[0] for w in warm):
        raise AssertionError(f"tensor-parallel {name} routing: "
                             f"{[p['routing'] for p in parts]}")


def _tp_train_lines(dev, tp, parts):
    """Print and hold the train step's results on every rank."""
    p0 = parts[0]
    rel = max(p["grad_rel"] for p in parts)
    worst = max(parts, key=lambda p: p["grad_rel"])
    log(f"  train step {p0['name']} f32 ({p0['cut']}), {p0['batch']} x "
        f"{p0['seq']} tokens, {p0['n_micro']} micro-batches, remat "
        f"{p0['remat']!r}, "
        f"tensor_parallel={p0['tensor_parallel']}: loss "
        f"{p0['loss']:.6f}, one-rank step {p0['one_loss']:.6f} (|diff| "
        f"{abs(p0['loss'] - p0['one_loss']):.3g}, tol {TP_LOSS_TOL} "
        f"relative); largest relative gradient error over a whole leaf "
        f"{rel:.3g} ({worst['grad_worst']}; max |diff| over the leaf's "
        f"max |g|, the ranks' shards together; tol {TRAIN_GRAD_TOL})")
    for p in parts:
        log(f"    rank {p['rank']}: step {p['step_ms']:.1f} ms, one-rank "
            f"step {p['one_step_ms']:.1f} ms; peak {_mb(p['peak'])}; "
            f"launches {p['launches']}")
    if abs(p0["loss"] - p0["one_loss"]) > TP_LOSS_TOL * abs(p0["one_loss"]) \
            or rel > TRAIN_GRAD_TOL or not p0["tensor_parallel"]:
        raise AssertionError(f"tensor-parallel train step: {parts}")
    if dev.type == "cuda" and any(
            (p["launches"][k] > 0) != want for p in parts
            for k, want in p["expect"].items()):
        raise AssertionError(f"train step launches: {parts}")


def _tp_rank(rank, port, backend, device, tp, seed, out_dir):
    """One rank of ``tp_check``: the collectives probed on the rank's
    tensors, each served model (``_tp_serve``) and the train step
    (``_tp_train``) on the (1, n) mesh; results to ``out_dir``."""
    sys.path.insert(0, str(SRC))
    one_card = backend == "gloo"
    os.environ["LOCAL_RANK"] = "0" if one_card else str(rank)
    # the ranks widen and free tens of GB of weights model after model
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh_compat
    dev = resolve_device(torch.device(device, 0 if one_card else rank)
                         if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=tp["model"])
    try:
        mesh = make_mesh_compat((1, tp["model"]), ("data", "model"),
                                device=dev.type)
        out = {"rank": rank, "device": dev.type,
               "probe": _tp_probe(mesh, dev)}
        out["serve"] = [_tp_serve(mesh, dev, rank, tp, seed + 21 + i, spec)
                        for i, spec in enumerate(tp["serve"])]
        out["train"] = [_tp_train(mesh, dev, rank, tp, seed + 25 + i, tr)
                        for i, tr in enumerate(tp["train"])]
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _tp_probe(mesh, dev):
    """Each collective of the model code (``sharding.policy``) on this
    rank's tensors: True (the right values), or why the backend refused."""
    import torch

    from repro_torch.sharding import policy
    with policy.use_ctx_mesh(mesh):
        tp = policy.ctx_tp()
    n, r = tp.size, tp.rank
    x = torch.full((4,), float(r + 1), device=dev)
    ones = torch.ones(4 * n, device=dev)

    def gather():
        xg = x.clone().requires_grad_()
        y = policy.gather_tp(xg, 0, tp)
        y.backward(ones)          # reduce-scatter
        return torch.cat([y.detach(), xg.grad])

    cases = (("all-reduce sum", lambda: policy.reduce_from_tp(x, tp),
              torch.full((4,), n * (n + 1) / 2, device=dev)),
             ("all-reduce max", lambda: policy.max_tp(x, tp),
              torch.full((4,), float(n), device=dev)),
             ("all-gather + reduce-scatter", gather, torch.cat([
                 torch.arange(1, n + 1, device=dev).float()
                 .repeat_interleave(4), torch.full((4,), float(n),
                                                   device=dev)])))
    out = {}
    for name, fn, want in cases:
        try:
            out[name] = bool(torch.equal(fn(), want))
        except RuntimeError as e:
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
    return out


def _tp_greedy(dev, prefill, decode, prompts, n_gen, host, extras=None):
    """Greedy decoding: (prefill logits, tokens (B, n_gen + 1), each
    step's top-two logits, prefill ms, decode ms a step). ``host``: the
    steps take host batches (``launch/steps``); ``extras``: the family's
    other prefill inputs (whisper's frames), on the host."""
    import torch

    from repro_torch.launch.serve import grow_cache
    batch = {"tokens": prompts, **(extras or {})}
    if not host:
        batch = {k: v.to(dev) for k, v in batch.items()}
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    first = logits
    cache = grow_cache(cache, n_gen)
    tok = logits.argmax(-1)
    _sync(dev)
    t1 = time.perf_counter()
    toks, top2 = [tok], [logits.float().topk(2, -1).values]
    for _ in range(n_gen):
        step = tok[:, None]
        logits, cache = decode(cache, {"tokens": step.cpu() if host
                                       else step})
        tok = logits.argmax(-1)
        toks.append(tok)
        top2.append(logits.float().topk(2, -1).values)
    _sync(dev)
    return (first, torch.stack(toks, 1), torch.stack(top2, 1),
            (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3 / max(n_gen, 1))


def _tp_vs_one(dev, models, params, prompts, extras, n_gen, got,
               kv_dtype, routes=None):
    """The one-rank path (the prefill and decode ``models`` on the whole
    weights, this card, its cache in ``kv_dtype`` as the ranks') on the
    same prompts against the ranks' greedy run ``got``: prefill logits'
    max |diff| over the largest |logit|, and each row's first differing
    token, whether the one-rank path's top two logits there are a
    near-tie (NEAR_TIE_BF16). ``routes``: the ranks' routings of that
    run (``_Routes``), held against the one-rank path's
    (``_route_diffs``). In f32 a row whose routing first differs at a
    router near-tie (the one-rank path's k-th and (k+1)-th probabilities
    within MOE_ROUTER_TIE: the two paths' f32 sums in another order pick
    the other expert) takes other experts from there on: its prefill
    logits are left out of the max when that was in the prefill, and a
    first differing token at or after it is counted apart (``router_rows``);
    a row whose routing first differs elsewhere is a fault
    (``bad_route_rows``)."""
    pre, dec = models
    with _Routes() as one_routes:
        one = _tp_greedy(dev, lambda bt: pre.prefill(params, bt,
                                                     kv_dtype=kv_dtype),
                         lambda c, bt: dec.decode(params, c, bt),
                         prompts, n_gen, False, extras)
    b = prompts.shape[0]
    rr = ({} if routes is None else
          _route_diffs(routes, one_routes, dec.cfg.n_layers, prompts.shape[1]))
    rows = rr.get("rows", {})
    f32 = kv_dtype == "float32"
    same = [r for r in range(b) if not (f32 and rows.get(r, (1,))[0] == 0)]
    g0, o0 = got[0].float()[same], one[0].float()[same]
    diff = float((g0 - o0).abs().max()) if same else 0.0
    top = float(one[0].float().abs().max())
    div = [first_divergence(g, w, t2)
           for g, w, t2 in zip(got[1], one[1], one[2])]
    firsts = [(r, i, round(float(one[2][r, i, 0] - one[2][r, i, 1]), 4))
              for r, (i, _) in enumerate(div) if i is not None]
    routed = [r for r, (i, _) in enumerate(div) if i is not None and r in rows
              and rows[r][0] <= i and rows[r][2] < MOE_ROUTER_TIE]
    return dict(steps=n_gen, one_prefill_ms=one[3], one_decode_ms=one[4],
                logit_diff=diff, logit_max=top, logit_rel=diff / top,
                logit_rows=len(same), routes=rr or None,
                bad_route_rows=[r for r, v in rows.items()
                                if v[2] >= MOE_ROUTER_TIE],
                router_rows=len(routed),
                rows_equal=sum(i is None for i, _ in div),
                tie_rows=sum(i is not None and t and r not in routed
                             for r, (i, t) in enumerate(div)),
                other_rows=sum(i is not None and not t and r not in routed
                               for r, (i, t) in enumerate(div)),
                firsts=firsts, near_ties=int(near_ties(one[2]).sum()))


class _Routes:
    """``with _Routes() as seen:`` each routing ``ffn.apply_moe`` takes
    (``ffn.route``) is appended to ``seen``."""

    def __enter__(self):
        from repro_torch.models import ffn
        self.ffn, self.route, self.seen = ffn, ffn.route, []

        def spy(*a, **kw):
            r = self.route(*a, **kw)
            self.seen.append(r)
            return r
        ffn.route = spy
        return self.seen

    def __exit__(self, *exc):
        self.ffn.route = self.route


def _route_diffs(got, want, n_layers, s):
    """Where two runs' routings (``_Routes`` lists, call by call: the
    prefill's ``n_layers``, then each decode step's) send a token to other
    top-k experts. -> {"calls", "tokens", "choices", "rows": {row: [call,
    layer, gap]}}: for each row (prefill token t is row t // s, a decode
    step's token t row t), the first call (0 the prefill, j the j-th decode
    step) and layer where one of its tokens does, and the largest of
    those tokens' gaps between the second run's k-th and (k+1)-th router
    probability over the k-th (a near-tie under MOE_ROUTER_TIE)."""
    tokens, choices, rows = 0, 0, {}
    for i, (a, b) in enumerate(zip(got, want)):
        k = b.topi.shape[-1]
        choices += b.topi.numel()
        diff = (a.topi.sort(-1).values != b.topi.sort(-1).values).any(-1)
        diff = diff.flatten()
        if not bool(diff.any()):
            continue
        tokens += int(diff.sum())
        call, layer = divmod(i, n_layers)
        top = b.probs.flatten(0, -2).topk(k + 1, -1).values
        gap = ((top[:, k - 1] - top[:, k]) / top[:, k - 1]).tolist()
        new = {}
        for t in diff.nonzero().flatten().tolist():
            row = t // s if call == 0 else t
            if row not in rows:
                new[row] = max(new.get(row, 0.0), gap[t])
        rows.update({r: [call, layer, g] for r, g in new.items()})
    return dict(calls=min(len(got), len(want)), tokens=tokens,
                choices=choices, rows=rows)


def _route_hash(r) -> str:
    """A digest of one routing's top-k experts, kept tokens and slots."""
    import hashlib

    import torch
    return hashlib.sha256(torch.cat([r.topi.flatten(), r.sel_idx.flatten(),
                                     r.slot.flatten()]).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def _tp_routing(mesh, dev, rank, arch, params, b, s, seed):
    """``apply_moe`` at ``arch``'s own capacity factor on the first
    layer's experts, one bf16 input (b, s, d) on every rank (tokens that
    share a direction crowd the same experts, so some are dropped), under
    the mesh context on the rank's experts and on one card (the whole
    layer):
    the routing's hash on every rank and on one card, the choices
    dropped, the output against one card's."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import ffn
    from repro_torch.sharding import policy
    def first(tree):
        return ({k: first(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[0])
    layer = first(params["layers"]["moe"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = arch.d_model
    x = (torch.randn((b, s, d), generator=gen, device=dev)
         + 2.0 * torch.randn((d,), generator=gen, device=dev)).to(
             torch.bfloat16)
    mine = steps._locals(policy.place(layer, mesh), mesh)
    with _Routes() as seen, torch.no_grad():
        with policy.use_ctx_mesh(mesh):
            out, _ = ffn.apply_moe(mine, x, arch)
        one, _ = ffn.apply_moe(layer, x, arch)
    hashes = [None] * mesh.size()
    dist.all_gather_object(hashes, _route_hash(seen[0]))
    diff = float((out.float() - one.float()).abs().max())
    top = float(one.float().abs().max())
    del mine, x, out, one
    return dict(hash=hashes[rank], one_hash=_route_hash(seen[1]),
                factor=arch.moe.capacity_factor, tokens=b * s,
                choices=b * s * arch.moe.top_k,
                dropped=int((seen[0].slot < 0).sum()), out_diff=diff,
                out_max=top, out_rel=diff / top)


def _tp_serve(mesh, dev, rank, tp, seed, spec):
    """One model served on the (1, n) mesh through the steps, greedy, in
    bf16, with the launch counts reset just before and read just after;
    then the same weights widened to f32, greedy again. On rank 0 the
    one-rank path (the model on its whole weights) runs on the same
    prompts in both dtypes and is held against the ranks'. A MoE model
    serves where no token is dropped (the two paths' bf16 sums differ,
    and a token dropped on one path only would move its logits by their
    scale): its prefill at TP_MOE_PREFILL_FACTOR (the choices dropped are
    counted), its decode steps at ``no_drops``; its routing at its own
    factor is checked first (``_tp_routing``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.attention import layout_from_cfg
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place
    from repro_torch.train.optimizer import tree_leaves, tree_map
    name, layers, b, s, n_gen, f32_gen = spec
    n = tp["model"]
    arch = get_arch(name) if tp["full"] else smoke_config(name)
    cut = "published widths" if tp["full"] else "smoke config"
    cut += (f", {layers} of its {arch.n_layers} layers" if layers
            else ", all its layers")
    if layers is not None:
        arch = arch.replace(n_layers=layers)
    if arch.n_heads % n:
        # whisper-tiny's 6 heads on 4 ranks: padded with zero-masked
        # heads, as the reference pads them for its meshes
        arch = arch.replace(head_pad_to=n)
        cut += f", q heads padded to {layout_from_cfg(arch).hp}"
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = build_model(arch).init(gen, device=dev)
    prompts, extras = family_inputs(arch, b, s, gen, dev)
    prompts, extras = prompts.cpu(), {k: v.cpu() for k, v in extras.items()}
    out = dict(rank=rank, name=arch.name, cut=cut, batch=b, prompt=s,
               gen=n_gen, vs_one_rank={})
    pre_arch = arch
    if arch.moe is not None:
        out["routing"] = _tp_routing(mesh, dev, rank, arch, params, b, s,
                                     seed + 1)
        pre_arch = arch.replace(moe=dataclasses.replace(
            arch.moe, capacity_factor=TP_MOE_PREFILL_FACTOR))
        arch = no_drops(arch)
        out["cut"] += (f", prefill at capacity factor "
                       f"{TP_MOE_PREFILL_FACTOR:g}, decode at "
                       f"{arch.moe.capacity_factor:g} (no drops)")
    placed = None
    for dt, n_steps in (("bfloat16", n_gen), ("float32", f32_gen)):
        models = (build_model(pre_arch.replace(dtype=dt)),
                  build_model(arch.replace(dtype=dt)))
        if dt == "bfloat16":
            placed = place(params, mesh)
            if rank != 0:   # the shards alone: the whole weights freed
                placed = tree_map(torch.clone, placed)
                params = None
        elif rank == 0:     # the one-rank path needs the whole f32 weights
            del placed
            params = tree_map(lambda x: x.to(torch.float32), params)
            placed = place(params, mesh)
        else:               # the shards widened
            placed = tree_map(lambda x: x.to(torch.float32), placed)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        pre = steps.make_prefill_step(models[0], mesh, ShapeConfig(
            "tp", "prefill", s, b, kv_dtype=dt))
        dec = steps.make_decode_step(models[1], mesh, ShapeConfig(
            "tp", "decode", s + n_gen, b, kv_dtype=dt))

        def run(k):
            return _tp_greedy(dev, lambda bt: pre(placed, bt),
                              lambda c, bt: dec(placed, c, bt), prompts, k,
                              True, extras)
        if dt == "bfloat16":
            with _Routes() as seen:
                run(2)                # warm-up
            if arch.moe is not None:
                out["routing"]["warmup"] = [_route_hash(r)
                                            for r in seen[:arch.n_layers]]
                out["routing"]["served_dropped"] = int(sum(
                    (r.slot < 0).sum() for r in seen[:arch.n_layers]))
            del seen
            mem0 = _peak_reset(dev)
            ops.reset_launch_counts()
        with _Routes() as seen:
            got = run(n_steps)
        if dt == "bfloat16":         # the served run: counts and bytes
            out["launches"] = {k: ops.LAUNCHES[k]
                               for k in ("flash_attention", "ssd_scan")}
            out["flash_shapes"] = sorted(ops.FLASH_SHAPES.items())
            out["ssd_shapes"] = sorted(ops.SSD_SHAPES.items())
            out.update(peak=_peak_extra(dev, mem0), prefill_ms=got[3],
                       decode_ms=got[4],
                       tensor_parallel=pre.tensor_parallel)
            local = [x.to_local() for x in tree_leaves(placed)]
            whole = [math.prod(x.shape) * x.element_size()
                     for x in tree_leaves(placed)]
            rep = [a.numel() * a.element_size() == w
                   for a, w in zip(local, whole)]
            out.update(local_bytes=sum(a.numel() * a.element_size()
                                       for a in local),
                       whole_bytes=sum(whole), leaves=len(whole),
                       replicated=sum(rep), replicated_bytes=sum(
                           w for w, r in zip(whole, rep) if r))
            del local
        if rank == 0:
            out["vs_one_rank"][dt] = _tp_vs_one(
                dev, models, params, prompts, extras, n_steps, got, dt,
                seen if arch.moe is not None else None)
        del got, seen
        _sync(dev)
        dist.barrier()
    del placed, params
    out["chunk"] = arch.ssm.chunk_size if arch.ssm is not None else None
    out["expect"] = _tp_expect(arch, n, b, s)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_expect(arch, n, b, s):
    """A rank's flash and SSD launches in one prefill of ``arch`` on a
    'model' axis of ``n``: by kernel, and by problem (sorted as
    ``ops.FLASH_SHAPES``/``SSD_SHAPES`` items), a layer each."""
    from repro_torch.models.attention import layout_from_cfg
    flash = {}
    if arch.family == "audio":
        hq, d = layout_from_cfg(arch).hp // n, arch.head_dim
        t = arch.encoder.n_frames
        flash = {(b, hq, t, t, d, False): arch.encoder.n_layers,
                 (b, hq, s, s, d, True): arch.n_layers,
                 (b, hq, s, t, d, False): arch.n_layers}
    elif arch.uses_attention and arch.mla is None:
        n_attn = (arch.n_layers // arch.hybrid_attn_every
                  if arch.family == "hybrid" else arch.n_layers)
        flash = {(b, layout_from_cfg(arch).hp // n, s, s, arch.head_dim,
                  True): n_attn}
    n_ssm = arch.n_layers if arch.ssm is not None else 0
    return {"launches": {"flash_attention": sum(flash.values()),
                         "ssd_scan": n_ssm},
            "flash_shapes": [list(k) + [c] for k, c in sorted(
                flash.items())],
            "ssd_shapes": [[b, s, arch.ssm_heads // n, arch.ssm.head_dim,
                            arch.ssm.d_state, n_ssm]] if n_ssm else []}


def _tp_train(mesh, dev, rank, tp, seed, tr):
    """One train step of ``tr`` (f32, an identity optimizer: its output is
    the gradients) on the (1, n) mesh, and on every rank the one-rank
    step's loss and gradients (the model on its whole weights, the same
    micro-batches and normalization as ``make_train_step``, the MoE aux
    term included); each rank compares its gradient shards, and the
    ranks' worst per leaf are combined (a max over the ranks: the whole
    leaf's error). A MoE model trains at the capacity factor that drops
    no token (``no_drops``), as it serves."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.factory import build_model
    from repro_torch.sharding import policy
    from repro_torch.train.optimizer import (Optimizer, tree_leaves,
                                             tree_leaves_with_path,
                                             tree_unflatten)
    arch = (get_arch(tr["arch"]) if tp["full"] else smoke_config(tr["arch"])
            ).replace(dtype="float32")
    cut = "published widths" if tp["full"] else "smoke config"
    cut += (f", {tr['layers']} of its {arch.n_layers} layers"
            if tr["layers"] else ", all its layers")
    if tr["layers"]:
        arch = arch.replace(n_layers=tr["layers"])
    if arch.moe is not None:
        arch = no_drops(arch)
        cut += f", capacity factor {arch.moe.capacity_factor:g} (no drops)"
    model = build_model(arch)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    placed = policy.place(params, mesh)
    b, s = tr["batch"], tr["seq"]
    toks = np.random.default_rng(seed).integers(
        0, arch.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    shape = ShapeConfig("tp", "train", s, b, microbatch_seqs_per_shard=1)
    ident = Optimizer(init=lambda p: {}, update=lambda g, st, p: (g, st, {}))
    fn, info = steps.make_train_step(model, mesh, shape, ident)
    mem0 = _peak_reset(dev)
    _sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    g, _, m = fn(placed, {}, batch)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "ssd_scan")}
    peak = _peak_extra(dev, mem0)
    del placed

    # the one-rank step on this rank's card
    t0 = time.perf_counter()
    n_micro = info["n_micro"]
    rows = b // n_micro
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    acc = [torch.zeros_like(x) for x in leaves]
    one_loss = 0.0
    for i in range(n_micro):
        micro = {k: torch.as_tensor(v[i * rows:(i + 1) * rows]).to(dev)
                 for k, v in batch.items()}
        logits, aux, _ = model.forward(tree_unflatten(params, leaves),
                                       micro, remat_policy=shape.remat_policy)
        ce, count = steps.lm_loss_parts(logits, micro["labels"],
                                        arch.vocab_size)
        loss = ce / torch.clamp(count, min=1.0)
        for a, x in zip(acc, torch.autograd.grad(
                loss + steps.MOE_AUX_COEF * aux, leaves, allow_unused=True,
                materialize_grads=True)):
            a += x
        one_loss += float(loss.detach()) / n_micro
    _sync(dev)
    one_ms = (time.perf_counter() - t0) * 1e3

    # this rank's block of each whole gradient against its shard
    names = ["/".join(map(str, path))
             for path, _ in tree_leaves_with_path(params)]
    errs = []
    for a, x in zip(acc, tree_leaves(g)):
        want = a / n_micro
        for dim, p in enumerate(x.placements):
            if p.is_shard():
                want = want.chunk(mesh.size(dim), p.dim)[
                    mesh.get_local_rank(dim)]
        got = x.to_local()
        errs.append([float((got - want).abs().max()),
                     float(want.abs().max())])
    e = torch.tensor(errs, dtype=torch.float64, device=dev)
    dist.all_reduce(e, op=dist.ReduceOp.MAX)
    rel = (e[:, 0] / e[:, 1].clamp(min=1e-30)).tolist()
    worst = max(range(len(rel)), key=rel.__getitem__)
    del params, leaves, acc, g
    _sync(dev)
    dist.barrier()
    return dict(rank=rank, name=arch.name, cut=cut, batch=b, seq=s,
                n_micro=n_micro, expect={   # the kernels the step launches
                    "flash_attention": arch.uses_attention
                    and arch.mla is None, "ssd_scan": arch.ssm is not None},
                remat=shape.remat_policy,
                tensor_parallel=info["tensor_parallel"],
                loss=float(m["loss"]), one_loss=one_loss, step_ms=step_ms,
                one_step_ms=one_ms, peak=peak, launches=launches,
                grad_rel=rel[worst], grad_worst=names[worst])


# ----------------------------------------------------------- phase 4g --
def context_parallel_path(dev, cfg, card, kern, seed):
    """Context-parallel decode (``launch/steps`` on a batch that does not
    split over the data-parallel axes): two gloo ranks on the one card on
    a (data 2, model 1) mesh, zamba2-1.2b at long_500k, each rank holding
    its block of the decode cache's sequence, held against the one-rank
    path (``cp_check``). Then the prefill's per-rank flash and SSD shapes
    are held against their plain versions and timed. Returns both ranks'
    launches in the bf16 run."""
    import torch
    cp = cfg["cp"]
    log("== context parallel")
    t0 = time.perf_counter()
    res = cp_check(dev, cp, "gloo", seed + 31)
    parts = [r["runs"]["bfloat16"] for r in res]
    counts = {k: sum(p["launches"][k] for p in parts)
              for k in ("flash_attention", "ssd_scan")}
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    note = f"{res[0]['name']} prefill on a rank of ({cp['data']}, 1)"
    for b, h, s, t, d, causal, _ in parts[0]["expect"]["flash_shapes"]:
        flash_row(dev, card, kern, cfg["iters"], gen, (b, h, s, d),
                  "context-parallel rank", note,
                  counts["flash_attention"], t=t, causal=causal)
    for b, s, h, pp, nn, _ in parts[0]["expect"]["ssd_shapes"]:
        ssd_row(dev, card, kern, cfg["iters"], gen, (b, s, h, pp), nn,
                parts[0]["chunk"], note, counts["ssd_scan"])
    log(f"  the phase: {time.perf_counter() - t0:.1f} s")
    return counts


def cp_check(dev, cp, backend, seed):
    """``cp["data"] x cp.get("model", 1)`` ranks on a (data, model) mesh
    (``_cp_rank``: gloo ranks on one card, or on the CPU in the
    rehearsal, or NCCL ranks, one card each), each holding its block of
    the decode cache's sequence; after they exit (their blocks beside a
    whole cache would not fit one card), the one-rank path on the first
    card against their logits and tokens (``_cp_one``, ``_cp_hold``).
    Prints each rank's lines; returns the ranks' results."""
    import shutil

    import torch
    world = cp["data"] * cp.get("model", 1)
    h = ranks_spawn(dev, _cp_rank, world, "context_parallel", cp, backend,
                    seed)
    out_dir, n_model = h["out_dir"], cp.get("model", 1)
    secs = ranks_wait(h)
    res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
           for r in range(world)]
    shutil.rmtree(out_dir)
    where = _where(dev, backend, "the collectives'")
    r0 = res[0]
    log(f"  {world} ranks on a (data {cp['data']}, model {n_model}) mesh "
        f"({where}) in {secs:.1f} s; a correctness run, not speed")
    log(f"  {r0['name']} ({r0['cut']}), long_500k: batch 1; a "
        f"{cp['prompt']}-token prompt prefilled whole on every rank (flash "
        f"+ SSD) and placed into its blocks; {cp['short']} greedy steps from "
        f"position {cp['prompt']} (only the first block holds valid keys); "
        f"then positions [0, at) filled from the seed at the prefill's k/v "
        f"RMS, the prompt's SSM state kept, and {cp['steps']} greedy steps "
        f"from at = seq_len / 2 - 4 (across the edge of the middle blocks)")
    for dt in ("bfloat16", "float32"):
        parts = [r["runs"][dt] for r in res]
        p0 = parts[0]
        log(f"  {dt} cache: seq_len {p0['seq']}, at {p0['at']}; weights "
            f"{p0['weights']}")
        for p in parts:
            log(f"    rank {p['rank']} (data {p['coord'][0]}, model "
                f"{p['coord'][1]}): cache {_mb(p['cache_bytes'])} of the "
                f"one-rank path's {_mb(p['whole_bytes'])} "
                f"({p['cache_bytes'] / p['whole_bytes']:.3f}; its "
                f"shared-attention k/v {p['kv_frac']:.3f} of theirs); peak "
                f"allocated {_mb(p['peak'])}; prefill {p['prefill_ms']:.1f} "
                f"ms; decode {p['short_ms']:.1f} ms/step from "
                f"{cp['prompt']}, {p['long_ms']:.1f} ms/step from "
                f"{p['at']} ({where.split(':')[0]}); the combine's "
                f"collectives a step {p['collectives']}; the weights' "
                f"gather over 'data', whole, once (``steps._locals``) "
                + (f"{p['gather_ms']:.1f} ms" if p["gather_ms"]
                   is not None else "not run (whole weights)")
                + (f"; launches {p['launches']}, flash {p['flash_shapes']}, "
                   f"ssd {p['ssd_shapes']}" if dt == "bfloat16" else ""))
        same = all(torch.equal(p["tokens"][k], p0["tokens"][k])
                   and torch.equal(p["logits"][k], p0["logits"][k])
                   for p in parts[1:] for k in ("short", "long"))
        one = _cp_one(dev, cp, seed, dt)
        _cp_hold(dt, p0, one, same, n_model)
        if dev.type == "cuda" and dt == "bfloat16":
            for p in parts:
                if p["launches"] != p["expect"]["launches"] or \
                        [list(k) + [n] for k, n in p["flash_shapes"]] \
                        != p["expect"]["flash_shapes"] or \
                        [list(k) + [n] for k, n in p["ssd_shapes"]] \
                        != p["expect"]["ssd_shapes"]:
                    raise AssertionError(f"context-parallel rank "
                                         f"{p['rank']} launches: "
                                         f"{p['launches']} != {p['expect']}")
    return res


def _cp_hold(dt, got, one, ranks_equal, n_model=1):
    """Print and hold one dtype's run of the ranks (``got``: rank 0's;
    every rank's tokens and logits equal, ``ranks_equal``) against the
    one-rank path's (``one``): logits within CP_LOGIT_TOL[dt] of the
    largest |logit| up to each run's first differing token (on a 'model'
    axis of ``n_model`` > 1 the tensor-parallel phase's tolerances: its
    row-parallel sums move the prefill's logits too), and tokens equal
    (in bf16 but for a first difference at a near-tie)."""
    tol = (CP_LOGIT_TOL[dt] if n_model == 1 else
           TP_LOGIT_TOL if dt == "bfloat16" else CONSIST_TOL)
    pre = float((got["prefill_logits"] - one["prefill_logits"]).abs().max())
    line = [f"    {dt} against the one-rank path (mesh (1, 1), the whole "
            f"cache; decode {one['long_ms']:.1f} ms/step from "
            f"{got['at']}): prefill logits max |diff| {pre:.4g}; every rank's "
            f"tokens and logits equal: {ranks_equal}"]
    bad = not ranks_equal
    for k in ("short", "long"):
        g, w, top2 = got["tokens"][k], one["tokens"][k], one["top2"][k]
        first, tie = first_divergence(g[0], w[0], top2[0])
        upto = len(g[0]) if first is None else first + 1
        diff = float((got["logits"][k][:upto] - one["logits"][k][:upto])
                     .abs().max())
        top = float(one["logits"][k][:upto].abs().max())
        line.append(f"{k} ({len(g[0]) - 1} steps from "
                    f"{got['at'] if k == 'long' else got['prompt']}): logits "
                    f"max |diff| {diff:.4g} of max |logit| {top:.4g} "
                    f"({diff / top:.3g}, tol {tol:g}) up to "
                    + ("the end" if first is None else f"step {first}")
                    + f"; tokens {g[0].tolist()} vs {w[0].tolist()}: "
                    + ("equal" if first is None else
                       f"first differ at step {first}"
                       + (" (a near-tie)" if tie else ""))
                    + f"; {int(near_ties(top2).sum())} near-ties among the "
                      f"one-rank path's tokens")
        bad |= diff / top > tol or (first is not None and (
            dt == "float32" or not tie))
    log("; ".join(line))
    if bad:
        raise AssertionError(f"context-parallel {dt}: {line}")


def _cp_arch(cp, dt):
    from repro_torch.configs.registry import get_arch, smoke_config
    arch = get_arch(cp["arch"]) if cp["full"] else smoke_config(cp["arch"])
    return arch.replace(dtype=dt)


def _cp_greedy(dev, step, cache, logits, n):
    """``n`` greedy steps from the prefill's ``logits`` (1, Vp) through
    ``step`` (cache, host batch) -> (logits, cache): (tokens (1, n + 1),
    the logits each token was taken from (n + 1, Vp) f32 on the host,
    their top two (1, n + 1, 2), ms a step)."""
    import torch
    tok = logits.argmax(-1)
    toks, lgs = [tok], [logits.float()]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        logits, cache = step(cache, {"tokens": tok[:, None].cpu()})
        tok = logits.argmax(-1)
        toks.append(tok)
        lgs.append(logits.float())
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    lg = torch.cat(lgs).cpu()
    return (torch.stack(toks, 1).cpu(), lg, lg.topk(2, -1).values[None],
            ms)


def _cp_sumsq(cache, n):
    """(2, J): the sum of squares of the shared-attention k and v at the
    prompt's positions [0, n) that this rank's blocks hold, a pass each."""
    import torch
    kv = cache["shared_attn"]
    return torch.stack([kv[k][:, :, :n].float().pow(2).sum((1, 2, 3, 4))
                        for k in ("k", "v")]).cpu()


def _cp_fill(cache, rms, at, seed, chunk, start, heads):
    """Positions [0, at) of the shared-attention k/v that this block (from
    position ``start``; KV heads from ``heads[0]`` of ``heads[1]``)
    holds, drawn chunk by chunk on the card from generators seeded by
    (pass, k or v, chunk): the same values on every rank and on the
    one-rank path; N(0, rms^2) a pass and leaf."""
    import torch
    kv = cache["shared_attn"]
    for i, name in enumerate(("k", "v")):
        x = kv[name]                          # (J, B, t, KH, D)
        t, kh = x.shape[2], x.shape[3]
        for j in range(x.shape[0]):
            for c0 in range(0, at, chunk):
                lo, hi = max(c0, start), min(c0 + chunk, at, start + t)
                if lo >= hi:
                    continue
                g = torch.Generator(device=x.device).manual_seed(
                    seed * 1_000_003 + (2 * j + i) * 100_003 + c0 // chunk)
                vals = torch.randn((x.shape[1], chunk, heads[1],
                                    x.shape[4]), generator=g,
                                   device=x.device)
                x[j, :, lo - start:hi - start] = (
                    vals[:, lo - c0:hi - c0, heads[0]:heads[0] + kh]
                    * rms[i, j]).to(x.dtype)


def _cp_run(dev, cp, seed, dt, prefill, step, start, heads=None,
            reduce=None, long_step=None):
    """One dtype's run on a rank (``step`` the decode step, ``start`` and
    ``heads`` the rank's first position and (first KV head, all KV
    heads)) or on the one-rank path: prefill, the short greedy steps,
    the fill and the long greedy steps (through ``long_step()``'s step
    where it is given). ``reduce``: the ranks' squares of the prompt's
    k/v summed (their RMS)."""
    import torch

    from repro_torch.models.attention import layout_from_cfg
    from repro_torch.train.optimizer import tree_map
    arch = _cp_arch(cp, dt)
    heads = heads or (0, layout_from_cfg(arch).khp)
    seq = cp["seq"][dt]
    at = seq // 2 - 4
    prompt = torch.randint(0, arch.vocab_size, (1, cp["prompt"]),
                           generator=torch.Generator().manual_seed(seed))
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill({"tokens": prompt})
    _sync(dev)
    out = dict(seq=seq, at=at, prompt=cp["prompt"],
               prefill_ms=(time.perf_counter() - t0) * 1e3,
               prefill_logits=logits.float().cpu(), tokens={}, logits={},
               top2={})
    state = tree_map(torch.clone, cache["ssm"])
    sq = _cp_sumsq(cache, cp["prompt"])
    if reduce is not None:
        sq = reduce(sq)
    kv = cache["shared_attn"]["k"]
    rms = (sq / (cp["prompt"] * kv.shape[1] * heads[1] * kv.shape[4])
           ).sqrt()
    for k, n in (("short", cp["short"]), ("long", cp["steps"])):
        if k == "long":
            for name, x in state.items():
                cache["ssm"][name].copy_(x)
            _cp_fill(cache, rms, at, seed, cp["chunk"], start, heads)
            cache["pos"].fill_(at)
            if long_step is not None:
                step = long_step()
        toks, lg, top2, ms = _cp_greedy(dev, step, cache, logits, n)
        out["tokens"][k], out["logits"][k], out["top2"][k] = toks, lg, top2
        out[f"{k}_ms"] = ms
    return out, cache


def _cp_one(dev, cp, seed, dt):
    """The one-rank path: the model on its whole weights (the ranks'
    seed), the whole cache (``steps.place_cache`` on a (1, 1) mesh)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import MeshShape
    model = build_model(_cp_arch(cp, dt))
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    sc = ShapeConfig("cp", "decode", cp["seq"][dt], 1, kv_dtype=dt)
    one = MeshShape(("data", "model"), (1, 1))

    def prefill(batch):
        logits, cache = model.prefill(
            params, {k: v.to(dev) for k, v in batch.items()}, kv_dtype=dt)
        return logits, steps.place_cache(cache, model, one, sc)
    def decode(c, bt):
        return model.decode(params, c, {k: v.to(dev) for k, v in bt.items()})
    out, cache = _cp_run(dev, cp, seed, dt, prefill, decode, 0)
    del cache, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _cp_rank(rank, port, backend, device, cp, seed, out_dir):
    """One rank of ``cp_check``: each dtype's run (``_cp_serve``) on the
    (data, model) mesh; results to ``out_dir``."""
    sys.path.insert(0, str(SRC))
    one_card = backend == "gloo"
    os.environ["LOCAL_RANK"] = "0" if one_card else str(rank)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh_compat
    dev = resolve_device(torch.device(device, 0 if one_card else rank)
                         if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shape = (cp["data"], cp.get("model", 1))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=shape[0] * shape[1])
    try:
        mesh = make_mesh_compat(shape, ("data", "model"), device=dev.type)
        out = {"rank": rank, "runs": {}}
        for dt in ("bfloat16", "float32"):
            out["runs"][dt] = _cp_serve(mesh, dev, rank, cp, seed, dt)
        arch = _cp_arch(cp, "bfloat16")
        out["name"] = arch.name
        out["cut"] = ("published widths, all its layers" if cp["full"]
                      else "smoke config")
        torch.save(out, Path(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cp_serve(mesh, dev, rank, cp, seed, dt):
    """One dtype's run through the steps on this rank, launch counts
    reset just before the prefill and read after the last step, the
    combine's collectives counted. The weights: whole on every rank, or
    (``cp["zero"]``) ZeRO over 'data', the reference's long_500k
    placement, for the prefill and the short steps (each gathers a
    layer's leaves as the layer runs), then gathered whole once
    (``steps._locals``), timed, and placed whole for the long steps
    (CP_WHOLE_WHY)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import costing, steps
    from repro_torch.models.attention import layout_from_cfg
    from repro_torch.models.factory import build_model
    from repro_torch.sharding import policy
    from repro_torch.train.optimizer import tree_map
    arch = _cp_arch(cp, dt)
    model = build_model(arch)
    seq = cp["seq"][dt]
    sc = ShapeConfig("cp", "decode", seq, 1, kv_dtype=dt)
    zero = cp["zero"][dt]
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    _, specs = steps.params_sds(model, mesh, tp_only=not zero)
    placed = tree_map(torch.clone, policy.place(
        params, mesh, policy.tree_map_with_path(
            lambda _, s: policy.placements(s, mesh), specs)))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    pre = steps.make_prefill_step(model, mesh, sc)
    dec = steps.make_decode_step(model, mesh, sc)
    if not (pre.context_parallel and dec.context_parallel):
        raise AssertionError(f"rank {rank}: the steps are not "
                             f"context-parallel")
    start = mesh.get_local_rank("data") * (seq // mesh.size(0))
    lo = layout_from_cfg(arch)
    heads = (0, lo.khp)
    if mesh.size(1) > 1:
        heads = (lo.rank_heads(mesh.size(1), mesh.get_local_rank("model"))
                 .kv0, lo.khp)
    calls = {"max": 0, "sum": 0}
    wrapped = policy.max_dp, policy.sum_dp

    def counting(name, fn):
        def run(x, dp):
            calls[name] += 1
            return fn(x, dp)
        return run

    def reduce(sq):        # every rank's heads and blocks
        return policy._all_reduce(sq.to(dev), "sum", dist.group.WORLD).cpu()
    gather = []

    def whole_step():
        """The long steps' decode step, on the weights gathered whole."""
        nonlocal placed
        if zero:
            _sync(dev)
            t0 = time.perf_counter()
            local = steps._locals(placed, mesh)
            _sync(dev)
            gather.append((time.perf_counter() - t0) * 1e3)
            _, specs = steps.params_sds(model, mesh, tp_only=True)
            placed = policy.tree_map_with_path(
                lambda path, x: DTensor.from_local(x, mesh, policy.placements(
                    policy.at_path(specs, path), mesh), run_check=False),
                local)
            del local
        return lambda c, bt: dec(placed, c, bt)
    ops.reset_launch_counts()
    policy.max_dp, policy.sum_dp = (counting("max", wrapped[0]),
                                    counting("sum", wrapped[1]))
    try:
        out, cache = _cp_run(dev, cp, seed, dt,
                             lambda bt: pre(placed, bt),
                             lambda c, bt: dec(placed, c, bt), start, heads,
                             reduce, whole_step)
    finally:
        policy.max_dp, policy.sum_dp = wrapped
    n_steps = cp["short"] + cp["steps"]
    out.update(rank=rank, coord=tuple(mesh.get_coordinate()),
               launches={k: ops.LAUNCHES[k] for k in (
                   "flash_attention", "ssd_scan")},
               flash_shapes=sorted(ops.FLASH_SHAPES.items()),
               ssd_shapes=sorted(ops.SSD_SHAPES.items()),
               collectives={k: v / n_steps for k, v in calls.items()},
               peak=(torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else None),
               cache_bytes=costing.tree_bytes(cache),
               whole_bytes=costing.tree_bytes(steps.cache_specs_sds(
                   model, sc, policy.MeshShape(("data", "model"), (1, 1)))),
               kv_frac=cache["shared_attn"]["k"].shape[2] / seq,
               weights=("ZeRO over 'data' (the reference's long_500k "
                        "placement) for the prefill and the short steps, "
                        "gathered a layer at a time as it runs; whole for "
                        "the long steps: " if zero else "whole: ")
               + CP_WHOLE_WHY,
               expect=_tp_expect(arch, mesh.size(1), 1, cp["prompt"]),
               chunk=arch.ssm.chunk_size)
    out["gather_ms"] = gather[0] if gather else None
    del cache, placed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return out


# ----------------------------------------------------------- phase 4i --
def zero_layers_path(dev, cfg, card, kern, seed, ranks):
    """ZeRO layers (``launch/steps`` on a data-parallel axis of more than
    1): two gloo ranks on the one card on a (data 2, model 1) mesh, each
    holding its shard of zamba2-1.2b's weights and AdamW state, a train
    step gathering each layer's leaves as the layer runs (``ranks``:
    ``zero_spawn``'s, started beside the fleet phase; ``zero_join``).
    Then the step's per-rank flash and SSD shapes are held against their
    plain versions and timed. Returns both ranks' launches in the bf16
    step."""
    import torch
    zc = cfg["zero"]
    log("== ZeRO layers")
    t0 = time.perf_counter()
    res = zero_join(ranks, seed + 41)
    parts = [r["bfloat16"] for r in res]
    counts = {k: sum(p["launches"][k] for p in parts)
              for k in ("flash_attention", "ssd_scan")}
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    note = f"{parts[0]['name']} train step on a rank of ({zc['data']}, 1)"
    for b, h, s, t, d, causal, _ in parts[0]["expect"]["flash_shapes"]:
        flash_row(dev, card, kern, cfg["iters"], gen, (b, h, s, d),
                  "ZeRO rank", note, counts["flash_attention"], t=t,
                  causal=causal)
    for b, s, h, pp, nn, _ in parts[0]["expect"]["ssd_shapes"]:
        ssd_row(dev, card, kern, cfg["iters"], gen, (b, s, h, pp), nn,
                parts[0]["chunk"], note, counts["ssd_scan"])
    log(f"  the phase: {time.perf_counter() - t0:.1f} s")
    return counts


def zero_check(dev, zc, backend, seed):
    """``zero_join(zero_spawn(...))``: the ranks' run, printed and held."""
    return zero_join(zero_spawn(dev, zc, backend, seed), seed)


def zero_spawn(dev, zc, backend, seed):
    """Start ``zc["data"] x zc.get("model", 1)`` ranks on a (data, model)
    mesh (``_zero_rank``), a bf16 and an f32 train step each; returns
    the handle ``zero_join`` takes."""
    return ranks_spawn(dev, _zero_rank, zc["data"] * zc.get("model", 1),
                       "zero_layers", zc, backend, seed)


def zero_join(h, seed):
    """Wait for ``zero_spawn``'s ranks; after they exit, the f32 step
    against the one-rank path on the first card (``_zero_hold``). Prints
    each rank's lines and holds them; returns the ranks' results."""
    import shutil

    import torch
    dev, zc, backend, out_dir, world = (h[k] for k in (
        "dev", "part", "backend", "out_dir", "world"))
    n_model = zc.get("model", 1)
    secs = ranks_wait(h)
    res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
           for r in range(world)]
    shutil.rmtree(out_dir)
    where = _where(dev, backend, "the collectives'")
    log(f"  {world} ranks on a (data {zc['data']}, model {n_model}) mesh "
        f"({where}) in {secs:.1f} s"
        + (f", {h['beside']}" if h.get("beside") else "")
        + "; a correctness run, not speed")
    for dt in ("bfloat16", "float32"):
        parts = [r[dt] for r in res]
        p0 = parts[0]
        log(f"  {dt} step, {p0['name']} ({p0['cut']}): {zc['batch']} x "
            f"{zc['seq']} tokens, {p0['n_micro']} micro-batches of one row "
            f"a rank, remat {p0['remat']!r}; ZeRO over 'data' on "
            f"{p0['sharded']} of {p0['leaves']} leaves")
        for p in parts:
            frac = p["shard_bytes"] / p["whole_bytes"]
            log(f"    rank {p['rank']} (data {p['coord'][0]}, model "
                f"{p['coord'][1]}): weights {_mb(p['shard_bytes'])} of "
                f"{_mb(p['whole_bytes'])} ({frac:.3f}); "
                f"the gradients' rise over {_mb(p['before'])} allocated "
                f"{_mb(p['rise'])} (peak {_mb(p['peak'])}; the optimizer's "
                f"f32 passes then {_mb(p['opt_peak'])}); bound (the "
                f"whole weights gathered + an f32 accumulator of the "
                f"shard) {_mb(p['bound'])}; counted a layer at a time: "
                f"accumulator {_mb(p['acc_bytes'])} + gathered "
                f"{_mb(p['gathered_bytes'])} (the largest layer's and the "
                f"leaves outside the stacks) + activations; gradients "
                f"{p['grads_ms']:.1f} ms ({where.split(':')[0]}), of it "
                f"all-gathers {p['gather_ms']:.1f} ms "
                f"({p['gather_ms'] / p['layer_passes']:.2f} ms a layer's "
                f"pass) and reduce-scatters {p['scatter_ms']:.1f} ms; "
                f"collectives a micro-batch {p['collectives']} (from the "
                f"specs {p['expect']['collectives']}); launches "
                f"{p['launches']} (expected {p['expect']['launches']})")
            if p["collectives"] != p["expect"]["collectives"] or (
                    p["rise"] is not None and p["rise"] >= p["bound"]):
                raise AssertionError(f"ZeRO rank {p['rank']} {dt}: {p}")
            if dev.type == "cuda" and dt == "bfloat16" and (
                    p["launches"] != p["expect"]["launches"]
                    or [list(k) + [n] for k, n in p["flash_shapes"]]
                    != p["expect"]["flash_shapes"]
                    or [list(k) + [n] for k, n in p["ssd_shapes"]]
                    != p["expect"]["ssd_shapes"]):
                raise AssertionError(f"ZeRO rank {p['rank']} launches: "
                                     f"{p['launches']}")
    _zero_hold(dev, zc, seed, [r["float32"] for r in res], (zc["data"],
                                                            n_model))
    return res


def _zero_arch(zc, dt):
    """zamba2-1.2b (or its smoke config) in ``dt``; the f32 step at one
    segment's depth (its SSM layers and the shared block)."""
    from repro_torch.configs.registry import get_arch, smoke_config
    arch = (get_arch(zc["arch"]) if zc["full"] else smoke_config(zc["arch"])
            ).replace(dtype=dt)
    return arch if dt == "bfloat16" else arch.replace(
        n_layers=arch.hybrid_attn_every)


def _zero_batch(zc, arch, seed):
    import numpy as np
    toks = np.random.default_rng(seed).integers(
        0, arch.vocab_size, (zc["batch"], zc["seq"] + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _zero_rank(rank, port, backend, device, zc, seed, out_dir):
    """One rank of ``zero_check``: the bf16 and f32 steps
    (``_zero_step``) on the (data, 1) mesh; results to ``out_dir``."""
    sys.path.insert(0, str(SRC))
    one_card = backend == "gloo"
    os.environ["LOCAL_RANK"] = "0" if one_card else str(rank)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh_compat
    dev = resolve_device(torch.device(device, 0 if one_card else rank)
                         if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shape = (zc["data"], zc.get("model", 1))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=shape[0] * shape[1])
    try:
        mesh = make_mesh_compat(shape, ("data", "model"), device=dev.type)
        out = {dt: _zero_step(mesh, dev, rank, zc, seed, dt)
               for dt in ("bfloat16", "float32")}
        torch.save(out, Path(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _zero_step(mesh, dev, rank, zc, seed, dt):
    """One train step of ``_zero_arch`` on this rank: the weights placed
    under the policy's ZeRO placements, AdamW's m and v as shards of
    theirs; the gradients (``info["grads"]``) with the memory peak reset
    just before and read just after, the launch counts and the policy's
    collectives (counted and timed) likewise; then the optimizer. Returns
    the rank's figures and, in f32, its shards of the loss, gradients,
    parameters, m and v (with each leaf's sharded dim)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import costing, dryrun, steps
    from repro_torch.models.factory import build_model
    from repro_torch.sharding import policy
    from repro_torch.train.optimizer import (adamw, tree_leaves,
                                             tree_leaves_with_path, tree_map)
    arch = _zero_arch(zc, dt)
    model = build_model(arch)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    whole_bytes = costing.tree_bytes(params)
    placed = tree_map(torch.clone, policy.place(params, mesh))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    opt = adamw(zc["lr"], eps=ZERO_ADAMW_EPS)
    state = {k: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         placed) for k in ("m", "v")}
    state["count"] = torch.zeros((), dtype=torch.int32)
    sc = ShapeConfig("zero", "train", zc["seq"], zc["batch"],
                     microbatch_seqs_per_shard=1, remat_policy="full")
    _, info = steps.make_train_step(model, mesh, sc, opt)
    n_micro = info["n_micro"]

    # what the specs say a micro-batch gathers and scatters, and holds
    shapes = steps.abstract_params(model)
    _, specs = steps.params_sds(model, mesh)
    axes = policy.mesh_axes(mesh)
    per_leaf = policy.tree_map_with_path(lambda _, sp: sum(
        axes[a] > 1 for part in sp if part is not None
        for a in ((part,) if isinstance(part, str) else part)
        if a in ("pod", "data")), specs)
    layers = sum(n * arch.n_layers for path, n in tree_leaves_with_path(
        per_leaf) if path[0] in dryrun.STACKS)
    total = sum(n for path, n in tree_leaves_with_path(per_leaf)
                if path[0] not in dryrun.STACKS) + layers
    _, gathered_bytes = dryrun.zero_bytes(shapes, specs, mesh, sc)
    shards = [x.to_local() for x in tree_leaves(placed)]
    shard_bytes = sum(x.numel() * x.element_size() for x in shards)
    acc_bytes = sum(x.numel() * 4 for x in shards)

    calls = {"all-gather": [0, 0.0], "reduce-scatter": [0, 0.0]}
    wrapped = policy._all_gather0, policy._reduce_scatter0

    def timed(kind, fn):
        def run(x, group):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(x, group)
            _sync(dev)
            calls[kind][0] += 1
            calls[kind][1] += (time.perf_counter() - t0) * 1e3
            return out
        return run
    batch = _zero_batch(zc, arch, seed)
    policy._all_gather0 = timed("all-gather", wrapped[0])
    policy._reduce_scatter0 = timed("reduce-scatter", wrapped[1])
    try:
        ops.reset_launch_counts()
        mem0 = _peak_reset(dev)
        _sync(dev)
        t0 = time.perf_counter()
        loss, g = info["grads"](placed, batch)
        _sync(dev)
        grads_ms = (time.perf_counter() - t0) * 1e3
        rise = _peak_extra(dev, mem0)
        peak = None if mem0 is None else mem0 + rise
        launches = {k: ops.LAUNCHES[k] for k in ("flash_attention",
                                                 "ssd_scan")}
        flash_shapes = sorted(ops.FLASH_SHAPES.items())
        ssd_shapes = sorted(ops.SSD_SHAPES.items())
    finally:
        policy._all_gather0, policy._reduce_scatter0 = wrapped
    p2, s2, _ = opt.update(g, state, placed)
    opt_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
    expect = _tp_expect(arch, mesh.size(1), 1, zc["seq"])
    expect["launches"] = {"flash_attention": n_micro * expect["launches"][
        "flash_attention"], "ssd_scan": 2 * n_micro * arch.n_layers}
    expect["flash_shapes"] = [k[:-1] + [k[-1] * n_micro]
                              for k in expect["flash_shapes"]]
    expect["ssd_shapes"] = [k[:-1] + [2 * k[-1] * n_micro]
                            for k in expect["ssd_shapes"]]
    expect["collectives"] = {"all-gather": total + layers,
                             "reduce-scatter": total}
    out = dict(rank=rank, coord=tuple(mesh.get_coordinate()), name=arch.name,
               n_micro=n_micro, remat="full",
               cut=("published widths, " if zc["full"] else "smoke config, ")
               + (f"{arch.n_layers} layers" if dt == "bfloat16" else
                  f"one segment: {arch.n_layers} SSM layers and the shared "
                  f"block"),
               leaves=len(shards), sharded=sum(
                   any(p.is_shard() for p in x.placements)
                   for x in tree_leaves(placed)),
               shard_bytes=shard_bytes, whole_bytes=whole_bytes,
               before=mem0, rise=rise, peak=peak, opt_peak=opt_peak,
               bound=whole_bytes + acc_bytes, acc_bytes=acc_bytes,
               gathered_bytes=gathered_bytes, grads_ms=grads_ms,
               gather_ms=calls["all-gather"][1],
               scatter_ms=calls["reduce-scatter"][1],
               layer_passes=n_micro * (2 * arch.n_layers + 1),
               collectives={k: v[0] / n_micro for k, v in calls.items()},
               launches=launches, flash_shapes=flash_shapes,
               ssd_shapes=ssd_shapes, expect=expect,
               chunk=arch.ssm.chunk_size)
    if dt == "float32":
        def local(tree):        # each leaf's shard, its dim on each axis
            return [(x.to_local().cpu(), tuple(
                p.dim if p.is_shard() else None for p in x.placements))
                for x in tree_leaves(tree)]
        out.update(loss=float(loss), grads=local(g), params=local(p2),
                   m=local(s2["m"]), v=local(s2["v"]))
    del placed, state, g, p2, s2
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _zero_one(dev, zc, seed):
    """The one-rank path of the f32 step on ``dev``: the model on its
    whole weights (the ranks' seed), the same micro-batches and
    normalization, AdamW on the mean gradient. Returns (loss, {name:
    [leaf, ...]}) in ``tree_leaves`` order."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models.factory import build_model
    from repro_torch.train.optimizer import (adamw, tree_leaves,
                                             tree_unflatten)
    arch = _zero_arch(zc, "float32")
    model = build_model(arch)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    batch = _zero_batch(zc, arch, seed)
    n_micro = zc["batch"] // zc["data"]
    rows = zc["batch"] // n_micro
    acc = [torch.zeros_like(x) for x in leaves]
    loss_sum = 0.0
    for i in range(n_micro):
        micro = {k: torch.as_tensor(v[i * rows:(i + 1) * rows]).to(dev)
                 for k, v in batch.items()}
        logits, _, _ = model.forward(tree_unflatten(params, leaves), micro)
        ce, count = steps.lm_loss_parts(logits, micro["labels"],
                                        arch.vocab_size)
        loss = ce / torch.clamp(count, min=1.0)
        for a, x in zip(acc, torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True)):
            a += x
        loss_sum += float(loss.detach())
    g = tree_unflatten(params, [a / n_micro for a in acc])
    opt = adamw(zc["lr"], eps=ZERO_ADAMW_EPS)
    p2, s2, _ = opt.update(g, opt.init(params), params)
    return loss_sum / n_micro, {n: tree_leaves(t) for n, t in (
        ("grads", g), ("params", p2), ("m", s2["m"]), ("v", s2["v"]))}


def _zero_whole(parts, name, i, shape):
    """Leaf ``i`` of ``name`` whole, from the ranks' shards (``parts``)
    on a (data, model) mesh of ``shape``."""
    import torch
    blocks = {p["coord"]: p[name][i][0] for p in parts}
    dd, md = parts[0][name][i][1]
    rows = [[blocks[d, m] for m in range(shape[1] if md is not None else 1)]
            for d in range(shape[0] if dd is not None else 1)]
    rows = [torch.cat(r, md) if md is not None else r[0] for r in rows]
    return torch.cat(rows, dd) if dd is not None else rows[0]


def _zero_hold(dev, zc, seed, parts, shape):
    """The ranks' f32 step (``parts``: each rank's shards, on a mesh of
    ``shape``) against the one-rank path on ``dev``: the loss within
    TP_LOSS_TOL relative; each leaf, the ranks' shards put together,
    within TRAIN_GRAD_TOL of the one-rank leaf's largest |x|, for the
    gradients, the parameters after one AdamW step and its m and v."""
    import torch

    from repro_torch.launch.steps import abstract_params
    from repro_torch.models.factory import build_model
    from repro_torch.train.optimizer import tree_leaves_with_path
    names = ["/".join(map(str, path)) for path, _ in tree_leaves_with_path(
        abstract_params(build_model(_zero_arch(zc, "float32"))))]
    one_loss, one = _zero_one(dev, zc, seed)
    worst = {}
    for name, want in one.items():
        for i, w in enumerate(want):
            got = _zero_whole(parts, name, i, shape).to(w.device)
            rel = float((got - w).abs().max()
                        / w.abs().max().clamp(min=1e-30))
            if rel > worst.get(name, (0.0, ""))[0] or name not in worst:
                worst[name] = (rel, names[i])
    loss = parts[0]["loss"]
    log(f"  float32 step against the one-rank path (the whole weights on "
        f"the same card): loss {loss:.6f}, one-rank {one_loss:.6f} (|diff| "
        f"{abs(loss - one_loss):.3g}, tol {TP_LOSS_TOL} relative); the "
        f"largest error over a leaf's largest |x|, the ranks' shards "
        f"together (tol {TRAIN_GRAD_TOL}): "
        + ", ".join(f"{n} {r:.3g} ({leaf})"
                    for n, (r, leaf) in worst.items()))
    if abs(loss - one_loss) > TP_LOSS_TOL * abs(one_loss) or any(
            r > TRAIN_GRAD_TOL for r, _ in worst.values()):
        raise AssertionError(f"ZeRO float32 step: {loss} vs {one_loss}, "
                             f"{worst}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 5 --
def ops_path(dev, cfg, card, kern, seed):
    """The two transform kernels through the ``kernels/ops`` entry points
    at the query path's chunk and base; returns their launch counts."""
    import torch

    from repro_torch.core.transforms import COLOR_REPS
    from repro_torch.kernels import ops
    log("== kernel entry points (kernels/ops)")
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    b, base = cfg["chunk"], cfg["base"]
    specs = tuple((r, c) for r in cfg["resolutions"] for c in COLOR_REPS)
    imgs = dyadic(b, base, gen, dev)

    def run(x):
        return {"fused_pyramid_transform": ops.pyramid_transform_op(
                    x, specs=specs),
                "fused_transform": [ops.transform_op(x, res=r, color=c)
                                    for r, c in specs]}

    # ---- the main path, with the launch counts read around it
    ops.reset_launch_counts()
    outs = run(imgs)
    _sync(dev)
    names = ("fused_transform", "fused_pyramid_transform")
    launches = {k: ops.LAUNCHES[k] for k in names}
    expect = {"fused_transform": len(specs), "fused_pyramid_transform": 1}
    log(f"  {len(specs)} specs {specs[0]}..{specs[-1]} on {b} x {base} px "
        f"frames; launches on the entry points: {launches} (expected "
        f"{expect})")
    if dev.type == "cuda" and launches != expect:
        raise AssertionError(f"entry-point launches {launches} != {expect}")

    worst = dict.fromkeys(names, 0.0)

    def hold(label, x, got):
        for name in names:
            err_by = check_transform(f"{name} on {label} frames", x, specs,
                                     got[name], label == "dyadic")
            worst[name] = max(worst[name], *err_by.values())

    hold("dyadic", imgs, outs)
    del outs
    x = torch.rand((b, base, base, 3), generator=gen, device=dev)
    hold("torch.rand", x, run(x))
    transform_times(dev, cfg, card, kern, imgs, specs, worst)
    kern["fused_pyramid_transform"]["other_shapes"] = pyramid_other_shapes(
        dev, cfg, gen)
    return launches


def check_transform(label, x, specs, outs, exact_input):
    """Each (res, color) output against its plain version: on dyadic
    frames (``exact_input``) rgb/r/g/b torch.equal and gray within
    TRANSFORM_GRAY_TOL, else within TRANSFORM_TOL. Raises on a miss;
    returns the max |err| of gray and of the other colors."""
    import torch
    err_by = {"gray": 0.0, "other": 0.0}
    for o, (r, c) in zip(outs, specs):
        want = _transform_ref(x, r, c)
        if o.shape != want.shape or not torch.isfinite(o).all():
            raise AssertionError(f"{label} ({r}, {c}): bad output")
        err = float((o - want).abs().max())
        if exact_input and c != "gray":
            ok = torch.equal(o, want)
        else:
            ok = err <= (TRANSFORM_GRAY_TOL if exact_input
                         else TRANSFORM_TOL)
        if not ok:
            raise AssertionError(f"{label} ({r}, {c}): max |err| {err}")
        key = "gray" if c == "gray" else "other"
        err_by[key] = max(err_by[key], err)
    log(f"  {label}, all {len(specs)} outputs: " + (
        f"rgb/r/g/b equal, gray max |err| {err_by['gray']:.3g} (tol "
        f"{TRANSFORM_GRAY_TOL})" if exact_input else
        f"max |err| {max(err_by.values()):.3g} (tol {TRANSFORM_TOL})"))
    return err_by


def pyramid_cases(cfg):
    """fused_pyramid_transform's other paths: (label, frames, base,
    (res, color) specs, storage offset of the frames in floats)."""
    from repro_torch.core.transforms import COLOR_REPS
    b, base = cfg["chunk"], cfg["base"]
    main = tuple((r, c) for r in cfg["resolutions"] for c in COLOR_REPS)
    return (
        ("no chain: 32 px straight from 224 px (factor 7)", b, 224,
         ((112, "rgb"), (32, "gray"), (224, "g")), 0),
        ("a (3, 3) projection that is no identity (bgr)", b, base,
         ((base, "bgr"), (base // 2, "bgr"), (base // 8, "bgr")), 0),
        ("chain at 84 px (no multiple of 16)", b, 84,
         tuple((r, c) for r in (42, 21) for c in COLOR_REPS), 0),
        ("frames at storage offset 1 (off 16-byte alignment)", b, base,
         main, 1),
        ("B = 1", 1, base, main, 0),
        (f"B = {b + 1} (no multiple of the grid)", b + 1, base, main, 0),
    )


def pyramid_case_inputs(case, gen, dev):
    """The dyadic frames of a ``pyramid_cases`` case (at its storage
    offset) and its (res, channel weights) specs."""
    import torch

    _, b, base, specs, offset = case
    flat = torch.empty(offset + b * base * base * 3, device=dev)
    x = flat[offset:].view(b, base, base, 3)
    x.copy_(dyadic(b, base, gen, dev))
    return x, [(r, _weights(c)) for r, c in specs]


def pyramid_other_shapes(dev, cfg, gen):
    """Every ``pyramid_cases`` case through the entry point, held against
    the plain version (check_transform, dyadic frames), and the kernel
    alone timed (a prepared launch; the entry point on the CPU)."""
    from repro_torch.kernels import bindings
    from repro_torch.kernels.image_transform import (fused_pyramid_transform,
                                                     transform_params)
    rows = []
    for case in pyramid_cases(cfg):
        label, b, base, specs, _ = case
        x, cws = pyramid_case_inputs(case, gen, dev)
        err_by = check_transform(f"fused_pyramid_transform, {label}", x,
                                 specs, fused_pyramid_transform(x, cws), True)
        if dev.type == "cuda":
            prm, _outs = transform_params(x, cws)   # outputs kept alive
            ms = time_ms(lambda: bindings.launch_fused_pyramid_transform(prm),
                         dev, cfg["iters"] * 10)
            path = "strips" if prm.chain else "tiles"
        else:
            ms = time_ms(lambda: fused_pyramid_transform(x, cws), dev, 1)
            path = "plain"
        rows.append({"case": label, "kernel": path, "ms": ms,
                     "max_abs_err": max(err_by.values())})
        log(f"    {b} x {base} px -> {len(specs)} specs: {path} kernel "
            f"{ms:.4f} ms")
    return rows


def _weights(color):
    """ops.COLOR_WEIGHTS[color], or for "bgr" the channels reversed: a
    (3, 3) matrix that is no identity (exact on dyadic frames)."""
    import numpy as np

    from repro_torch.kernels.ops import COLOR_WEIGHTS
    if color == "bgr":
        return np.ascontiguousarray(np.eye(3, dtype=np.float32)[:, ::-1])
    return COLOR_WEIGHTS[color]


def _transform_ref(x, res, color):
    from repro_torch.kernels.ref import fused_transform_ref
    return fused_transform_ref(x, _weights(color), res)


def transform_times(dev, cfg, card, kern, imgs, specs, worst):
    """Each transform kernel's time at one stated shape: the kernel alone
    (a prepared launch; through the entry point on the CPU), the entry
    point, the plain version, one F.conv2d where one computes the same
    function, and the bytes/operations bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.transforms import plan_pyramid
    from repro_torch.kernels import bindings, ops
    from repro_torch.kernels.image_transform import transform_params
    from repro_torch.kernels.ref import fused_pyramid_transform_ref
    b, base = imgs.shape[0], imgs.shape[1]
    it = cfg["iters"] * 10
    r1, c1 = cfg["resolutions"][1], "gray"    # 224 -> 56: factor 4
    cases = (("fused_transform", ((r1, c1),), bindings.launch_fused_transform,
              lambda: ops.transform_op(imgs, res=r1, color=c1)),
             ("fused_pyramid_transform", specs,
              bindings.launch_fused_pyramid_transform,
              lambda: ops.pyramid_transform_op(imgs, specs=specs)))
    for name, sp, launch, entry in cases:
        cws = [(r, ops.COLOR_WEIGHTS[c]) for r, c in sp]
        entry_ms = time_ms(entry, dev, it)
        if dev.type == "cuda":
            prm, _outs = transform_params(imgs, cws)   # outputs kept alive
            ms = time_ms(lambda: launch(prm), dev, it)
            dev_ms = device_ms(lambda: launch(prm), dev, it)
        else:
            ms = dev_ms = entry_ms
        plain = time_ms(lambda: fused_pyramid_transform_ref(imgs, cws), dev,
                        it)
        nbytes = 4 * b * (base * base * 3 + sum(
            r * r * ops.COLOR_WEIGHTS[c].shape[1] for r, c in sp))
        # pooling adds along the plan, then 3 products + 2 adds per output
        # value and its normalization (2)
        nops = b * (sum(st.source ** 2 * 3 for st in plan_pyramid(
            [r for r, _ in sp], base)) + sum(
                r * r * ops.COLOR_WEIGHTS[c].shape[1] * 7 for r, c in sp))
        t_mem, t_ops = nbytes / card["bw"], nops / card["flops"]
        k = {"max_abs_err": worst[name], "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain, "tb_per_s": nbytes / ms / 1e9,
             "bound_ms": max(t_mem, t_ops) * 1e3,
             "bound_by": "bytes" if t_mem > t_ops else "operations",
             "library_ms": None,
             "shape": f"{b} x {base} px -> " + (
                 f"{sp[0]}" if len(sp) == 1 else f"all {len(sp)} specs")}
        lib = ""
        if name == "fused_transform":
            r, c = sp[0]
            f = base // r
            cw = torch.as_tensor(ops.COLOR_WEIGHTS[c], device=dev)
            w = (cw.T / (f * f * 0.25)).reshape(-1, 3, 1, 1).expand(
                -1, 3, f, f).contiguous()
            bias = torch.full((cw.shape[1],), -0.5 / 0.25, device=dev)
            nchw = imgs.permute(0, 3, 1, 2)      # channels-last view
            k["library_ms"] = time_ms(
                lambda: F.conv2d(nchw, w, bias, stride=f), dev, it)
            got = F.conv2d(nchw, w, bias, stride=f).permute(0, 2, 3, 1)
            lib_err = float((got - _transform_ref(imgs, r, c)).abs().max())
            lib = (f", F.conv2d {k['library_ms']:.4f} ms (max |diff| "
                   f"{lib_err:.3g})")
        kern[name] = k
        log(f"  {name} {k['shape']}: kernel {ms:.4f} ms (device "
            f"{_ms(dev_ms)} ms; {k['tb_per_s']:.3f} TB/s of {nbytes / 1e6:.1f}"
            f" MB; entry point {entry_ms:.4f} ms), plain {plain:.4f} ms{lib}, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})")


# ------------------------------------------------------------ phase 6 --
def kernels_line(kern, launches):
    meta = {
        "fused_pyramid_stage0": (
            "src/repro_torch/kernels/csrc/pyramid_stage0.cu",
            "src/repro/kernels/image_transform.py:280", kern["stage0"]),
        "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:46", kern["matmul"]),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:78",
                            kern["flash_attention"]),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:81", kern["ssd_scan"]),
        "fused_transform": ("src/repro_torch/kernels/csrc/image_transform.cu",
                            "src/repro/kernels/image_transform.py:73",
                            kern["fused_transform"]),
        "fused_pyramid_transform": (
            "src/repro_torch/kernels/csrc/image_transform.cu",
            "src/repro/kernels/image_transform.py:125",
            kern["fused_pyramid_transform"]),
    }
    out = []
    for name, (src, replaces, k) in meta.items():
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                    "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                    "bound_by": k["bound_by"],
                    "library_ms": k.get("library_ms"),
                    "shape": k["shape"],
                    **{key: k[key] for key in ("device_ms",
                                               "library_device_ms",
                                               "tb_per_s", "other_shapes",
                                               "ingest_launches",
                                               "sharded_launches",
                                               "serving_launches",
                                               "dense_launches",
                                               "families_launches",
                                               "training_launches",
                                               "tp_launches", "cp_launches",
                                               "zero_launches")
                       if key in k}})
    print(json.dumps({"kernels": out}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
